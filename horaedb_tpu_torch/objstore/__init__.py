"""Object-storage abstraction (ref: object_store 0.11 crate usage): an
async ABC, a local-filesystem store, an in-memory store, an
S3-compatible store (objstore/s3.py), and the retry / fault-injection /
metrics middleware that wraps any of them."""

from horaedb_tpu_torch.objstore.api import NotFoundError, ObjectMeta, ObjectStore
from horaedb_tpu_torch.objstore.local import LocalObjectStore
from horaedb_tpu_torch.objstore.memory import MemoryObjectStore
from horaedb_tpu_torch.objstore.middleware import (
    DeadlineExceededError,
    FaultInjectingStore,
    InjectedCrash,
    InjectedFault,
    InstrumentedStore,
    RetryingObjectStore,
    RetryPolicy,
    WrappedObjectStore,
)
from horaedb_tpu_torch.objstore.s3 import S3ObjectStore, S3Options, SigV4Signer

__all__ = [
    "DeadlineExceededError",
    "FaultInjectingStore",
    "InjectedCrash",
    "InjectedFault",
    "InstrumentedStore",
    "LocalObjectStore",
    "MemoryObjectStore",
    "NotFoundError",
    "ObjectMeta",
    "ObjectStore",
    "RetryPolicy",
    "RetryingObjectStore",
    "S3ObjectStore",
    "S3Options",
    "SigV4Signer",
    "WrappedObjectStore",
]
