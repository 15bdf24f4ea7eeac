"""In-memory ObjectStore — the universal test fake (the reference uses
LocalFileSystem for this role; memory is faster and hermetic)."""

from __future__ import annotations

import asyncio

from horaedb_tpu_torch.common.memledger import ledger as memledger
from horaedb_tpu_torch.objstore.api import NotFoundError, ObjectMeta, ObjectStore


class MemoryObjectStore(ObjectStore):
    def __init__(self) -> None:
        self._objects: dict[str, bytes] = {}
        self._lock = asyncio.Lock()
        # memory plane: the resident parquet+sidecar copy is a ledger
        # account (O(1) running total), anchored weakly — an abandoned
        # store prunes on the next sweep (there is no close API)
        self._resident_bytes = 0
        self._mem_account = memledger.register(
            "objstore_memory", lambda s: s._resident_bytes,
            anchor=self, kind="objstore_memory", owner="objstore")

    async def put(self, path: str, data: bytes) -> None:
        async with self._lock:
            old = self._objects.get(path)
            self._objects[path] = bytes(data)
            self._resident_bytes += len(data) - (
                0 if old is None else len(old))

    async def get(self, path: str) -> bytes:
        async with self._lock:
            try:
                return self._objects[path]
            except KeyError:
                raise NotFoundError(f"object not found: {path}") from None

    async def get_range(self, path: str, start: int, end: int) -> bytes:
        data = await self.get(path)
        if start == 0 and end >= len(data):
            # whole-object range: skip the slice COPY — header probes
            # over small objects hit this constantly on the cold path
            return data
        return data[start:end]

    async def head(self, path: str) -> ObjectMeta:
        data = await self.get(path)
        return ObjectMeta(path=path, size=len(data))

    async def delete(self, path: str) -> None:
        async with self._lock:
            if path not in self._objects:
                raise NotFoundError(f"object not found: {path}")
            self._resident_bytes -= len(self._objects[path])
            del self._objects[path]

    async def list(self, prefix: str) -> list[ObjectMeta]:
        async with self._lock:
            return sorted(
                (ObjectMeta(path=p, size=len(d))
                 for p, d in self._objects.items() if p.startswith(prefix)),
                key=lambda m: m.path,
            )
