"""Local-filesystem ObjectStore (ref: object_store::local::LocalFileSystem,
the store used by the server at src/server/src/main.rs:112).

Puts are atomic (temp file + rename) to preserve the manifest's
crash-consistency: a torn snapshot write must never be observable.
Blocking syscalls run in the default thread pool via asyncio.to_thread.
"""

from __future__ import annotations

import asyncio
import os
import tempfile

from horaedb_tpu_torch.common.error import Error
from horaedb_tpu_torch.objstore.api import (
    DEFAULT_STREAM_CHUNK,
    NotFoundError,
    ObjectMeta,
    ObjectStore,
)


class LocalObjectStore(ObjectStore):
    def __init__(self, root: str) -> None:
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)

    def _fs_path(self, path: str) -> str:
        fs = os.path.normpath(os.path.join(self.root, path.lstrip("/")))
        if not fs.startswith(self.root + os.sep) and fs != self.root:
            raise Error(f"path escapes store root: {path}")
        return fs

    async def put(self, path: str, data: bytes) -> None:
        def _put() -> None:
            fs = self._fs_path(path)
            os.makedirs(os.path.dirname(fs), exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=os.path.dirname(fs), prefix=".tmp-put-")
            try:
                with os.fdopen(fd, "wb") as f:
                    f.write(data)
                os.replace(tmp, fs)
            except BaseException:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise

        await asyncio.to_thread(_put)

    async def put_stream(self, path: str, chunks) -> int:
        """Stream chunks to a temp file, then rename — peak RSS is one
        chunk; the atomic-replace crash contract of put() holds."""
        fs = self._fs_path(path)

        def _open():
            os.makedirs(os.path.dirname(fs), exist_ok=True)
            return tempfile.mkstemp(dir=os.path.dirname(fs),
                                    prefix=".tmp-put-")

        fd, tmp = await asyncio.to_thread(_open)
        total = 0
        f = os.fdopen(fd, "wb")
        try:
            async for chunk in chunks:
                await asyncio.to_thread(f.write, chunk)
                total += len(chunk)
            await asyncio.to_thread(f.flush)
            f.close()
            await asyncio.to_thread(os.replace, tmp, fs)
            return total
        except BaseException:
            try:
                f.close()
            except OSError:
                pass
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    async def get(self, path: str) -> bytes:
        def _get() -> bytes:
            try:
                with open(self._fs_path(path), "rb") as f:
                    return f.read()
            except FileNotFoundError:
                raise NotFoundError(f"object not found: {path}") from None

        return await asyncio.to_thread(_get)

    async def get_stream(self, path: str,
                         chunk_size: int = DEFAULT_STREAM_CHUNK):
        """File chunks: peak RSS is one chunk, whatever the object
        size."""
        try:
            f = await asyncio.to_thread(open, self._fs_path(path), "rb")
        except FileNotFoundError:
            raise NotFoundError(f"object not found: {path}") from None
        try:
            while True:
                chunk = await asyncio.to_thread(f.read, chunk_size)
                if not chunk:
                    return
                yield chunk
        finally:
            await asyncio.to_thread(f.close)

    async def get_range(self, path: str, start: int, end: int) -> bytes:
        def _get_range() -> bytes:
            try:
                with open(self._fs_path(path), "rb") as f:
                    # clamp to the file size: read(count) PREALLOCATES
                    # count bytes, so a past-EOF range (callers use it
                    # for "the rest of the object") must not allocate
                    # the nominal span
                    f.seek(0, 2)
                    size = f.tell()
                    f.seek(start)
                    return f.read(max(0, min(end, size) - start))
            except FileNotFoundError:
                raise NotFoundError(f"object not found: {path}") from None

        return await asyncio.to_thread(_get_range)

    async def head(self, path: str) -> ObjectMeta:
        def _head() -> ObjectMeta:
            try:
                st = os.stat(self._fs_path(path))
            except FileNotFoundError:
                raise NotFoundError(f"object not found: {path}") from None
            return ObjectMeta(path=path, size=st.st_size)

        return await asyncio.to_thread(_head)

    async def delete(self, path: str) -> None:
        def _delete() -> None:
            try:
                os.unlink(self._fs_path(path))
            except FileNotFoundError:
                raise NotFoundError(f"object not found: {path}") from None

        await asyncio.to_thread(_delete)

    async def list(self, prefix: str) -> list[ObjectMeta]:
        def _list() -> list[ObjectMeta]:
            # Walk only the subtree the prefix's directory part points at —
            # the manifest merger lists the delta dir every few seconds and
            # must not pay for a scan of the (much larger) data/ tree.
            dir_part = prefix.rsplit("/", 1)[0] if "/" in prefix else ""
            walk_root = self._fs_path(dir_part) if dir_part else self.root
            if not os.path.isdir(walk_root):
                return []
            out: list[ObjectMeta] = []
            for dirpath, _dirnames, filenames in os.walk(walk_root):
                for name in filenames:
                    if name.startswith(".tmp-put-"):
                        continue
                    fs = os.path.join(dirpath, name)
                    key = os.path.relpath(fs, self.root).replace(os.sep, "/")
                    if key.startswith(prefix):
                        out.append(ObjectMeta(path=key, size=os.stat(fs).st_size))
            out.sort(key=lambda m: m.path)
            return out

        return await asyncio.to_thread(_list)

    def local_path(self, path: str) -> str:
        """Filesystem path for zero-copy reads (parquet mmap fast path)."""
        return self._fs_path(path)
