"""Object-storage abstraction (ref: object_store 0.11 crate usage): an
async ABC, a local-filesystem store and an in-memory store."""

from horaedb_tpu_torch.objstore.api import NotFoundError, ObjectMeta, ObjectStore
from horaedb_tpu_torch.objstore.local import LocalObjectStore
from horaedb_tpu_torch.objstore.memory import MemoryObjectStore

__all__ = ["LocalObjectStore", "MemoryObjectStore", "NotFoundError",
           "ObjectMeta", "ObjectStore"]
