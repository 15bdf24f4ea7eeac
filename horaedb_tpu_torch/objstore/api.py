"""ObjectStore interface (ref: object_store crate get/put/list/delete/head,
consumed at src/storage/src/manifest/mod.rs:139-156, storage.rs:213-217)."""

from __future__ import annotations

import abc
from dataclasses import dataclass

from horaedb_tpu_torch.common.error import Error


class NotFoundError(Error):
    """Raised by get/head/delete when the object does not exist."""


@dataclass(frozen=True)
class ObjectMeta:
    path: str
    size: int


# default chunk for streamed whole-object reads (get_stream): large
# enough to amortize per-chunk overhead, small enough that a stream's
# resident footprint stays two orders of magnitude under a big SST
DEFAULT_STREAM_CHUNK = 8 << 20


class ObjectStore(abc.ABC):
    """Async key→bytes store; paths are '/'-separated keys, not OS paths."""

    @abc.abstractmethod
    async def put(self, path: str, data: bytes) -> None:
        """Atomically create/replace the object at `path`."""

    @abc.abstractmethod
    async def get(self, path: str) -> bytes:
        """Read the whole object; raises NotFoundError."""

    @abc.abstractmethod
    async def get_range(self, path: str, start: int, end: int) -> bytes:
        """Read bytes [start, end); raises NotFoundError."""

    @abc.abstractmethod
    async def head(self, path: str) -> ObjectMeta:
        """Object metadata; raises NotFoundError."""

    @abc.abstractmethod
    async def delete(self, path: str) -> None:
        """Delete the object.

        Memory/local backends raise NotFoundError for a missing key.
        S3 is idempotent by default (missing keys succeed — deletes are
        best-effort background fan-outs in the engine); opt into the
        probing NotFoundError contract with S3Options.strict_delete.
        Callers must not rely on NotFoundError from delete() for
        correctness."""

    @abc.abstractmethod
    async def list(self, prefix: str) -> list[ObjectMeta]:
        """All objects whose path starts with `prefix`, sorted by path."""

    async def get_stream(self, path: str,
                         chunk_size: int = DEFAULT_STREAM_CHUNK):
        """Read the whole object as an async iterator of byte chunks.

        Streaming-capable backends bound peak RSS by `chunk_size` —
        Local reads file chunks, S3 issues ranged GETs — so a whole-SST
        fetch of a multi-GiB object never materializes it in the
        caller's memory (the consumer decides where the bytes land:
        a spooled temp file for parquet decode, a socket for a proxy).
        This default falls back to ONE `get` (correct for the in-RAM
        memory store, where the object IS a resident buffer already)
        and re-chunks it, so every store satisfies the contract.
        Raises NotFoundError like get()."""
        data = await self.get(path)
        for off in range(0, len(data), max(1, chunk_size)):
            yield data[off:off + chunk_size]

    async def put_stream(self, path: str, chunks) -> int:
        """Atomically create/replace `path` from an async iterator of
        byte chunks; returns total bytes written.

        Streaming-capable backends (local files, S3 multipart) bound
        peak memory by the chunk/part size — a 1 GiB compaction output
        costs one row group of RSS, not 1 GiB (ref: the reference
        streams AsyncArrowWriter -> ParquetObjectWriter,
        storage.rs:192-212).  This default buffers (correct for the
        in-RAM memory store, where the object IS the buffer).  Partial
        failures must not leave a readable object at `path`."""
        buf = bytearray()
        async for chunk in chunks:
            buf += chunk
        await self.put(path, bytes(buf))
        return len(buf)
