"""Durable ingest subsystem: WAL + memtables in front of
CloudObjectStorage (see wal/ingest.py for the architecture note)."""

from horaedb_tpu_torch.wal.config import WalConfig
from horaedb_tpu_torch.wal.ingest import IngestStorage
from horaedb_tpu_torch.wal.log import Wal, WalError, WalRecord
from horaedb_tpu_torch.wal.memtable import MemEntry, Memtable

__all__ = ["IngestStorage", "MemEntry", "Memtable", "Wal", "WalConfig",
           "WalError", "WalRecord"]
