"""TimeMergeStorage: LSM-on-object-store engine (ref: src/storage)."""

from horaedb_tpu_torch.storage.config import (
    ManifestConfig,
    StorageConfig,
    UpdateMode,
    WriteConfig,
)
from horaedb_tpu_torch.storage.types import (
    BUILTIN_COLUMN_NUM,
    RESERVED_COLUMN_NAME,
    SEQ_COLUMN_NAME,
    StorageSchema,
    Timestamp,
    TimeRange,
)

__all__ = [
    "BUILTIN_COLUMN_NUM", "ManifestConfig", "RESERVED_COLUMN_NAME",
    "SEQ_COLUMN_NAME", "StorageConfig", "StorageSchema", "TimeRange",
    "Timestamp", "UpdateMode", "WriteConfig",
]
