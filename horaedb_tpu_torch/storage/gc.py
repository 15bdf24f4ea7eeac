"""Orphan scrubber: manifest-aware object-store garbage reconciliation
(the port's copy of the JAX package's storage/gc.py).

The engine's order of operations deliberately LEAKS objects rather than
lose data: a failed write strands an SST the manifest never saw,
compaction's best-effort input deletes can fail, sidecar deletes are
silent.  The scrubber closes the loop:

  1. Build the referenced id set from BOTH the live manifest cache
     (`manifest.all_ssts()`) and a store-side fold of snapshot + delta
     files.  A delta whose put landed but whose ack was lost is durable
     but not cached, and its SSTs must never be scrubbed.
  2. List `data/`, parse `{id}.sst` / `{id}.enc` keys, and diff.
     Unparseable keys are never touched.
  3. Delete an unreferenced object only after it has been CONTINUOUSLY
     unreferenced for a grace period, tracked by a first-seen map of
     this scrubber's own observations.  The grace window is what makes
     the in-flight write race (SST put before manifest add) safe.

Delta files are not scrub targets: the manifest merger deletes folded
deltas.  The scrubber only reads them for the referenced set.
"""

from __future__ import annotations

import asyncio
import logging
import time
from dataclasses import dataclass, field
from typing import Optional

from horaedb_tpu_torch.objstore import NotFoundError, ObjectStore
from horaedb_tpu_torch.storage.manifest import (
    DELTA_PREFIX,
    PREFIX_PATH,
    SNAPSHOT_FILENAME,
    Manifest,
    _read_snapshot,
)
from horaedb_tpu_torch.storage.manifest.encoding import decode_manifest_update
from horaedb_tpu_torch.storage.sidecar import SIDECAR_SUFFIX
from horaedb_tpu_torch.storage.sst import DATA_PREFIX
from horaedb_tpu_torch.utils import op_trace, registry

logger = logging.getLogger(__name__)

_SCRUB_PASSES = registry.counter(
    "storage_scrub_passes_total", "orphan scrub passes completed")
_SCRUB_DELETED = registry.counter(
    "storage_scrub_orphans_deleted_total",
    "unreferenced data objects deleted by the scrubber")
_SCRUB_BYTES = registry.counter(
    "storage_scrub_orphan_bytes_total",
    "bytes of unreferenced data objects deleted by the scrubber")


@dataclass
class ScrubReport:
    """One scrub pass, in numbers."""

    data_objects: int = 0       # objects listed under data/
    referenced: int = 0         # distinct referenced sst ids
    orphans_seen: int = 0       # unreferenced data objects observed
    orphans_deleted: int = 0    # past grace -> deleted
    orphans_in_grace: int = 0   # observed but younger than grace
    orphan_bytes_deleted: int = 0
    unparseable: int = 0        # unknown keys under data/ (never touched)
    delta_files: int = 0        # delta log files present (informational)
    errors: int = 0             # delete failures (retried next pass)

    def as_dict(self) -> dict:
        return dict(self.__dict__)


@dataclass
class Scrubber:
    """Reconciles `{root}/data/` against the manifest.

    One instance per storage; `first_seen` persists across passes (it IS
    the grace clock).  A restart resets it — conservative: orphans then
    wait one extra grace period, never less."""

    root_path: str
    store: ObjectStore
    manifest: Optional[Manifest]
    grace_period_s: float
    first_seen: dict[str, float] = field(default_factory=dict)

    def _now(self) -> float:
        """The grace clock (a seam tests replace)."""
        return time.monotonic()

    async def referenced_ids(self) -> tuple[set[int], int]:
        """Union of the live manifest cache and a store-side fold of
        snapshot + deltas (add-all-then-delete-all, the merger's own
        order).  Returns (referenced ids, delta files seen)."""
        refs: set[int] = set()
        if self.manifest is not None:
            refs.update(f.id for f in await self.manifest.all_ssts())

        base = self.root_path.rstrip("/")
        snapshot_path = f"{base}/{PREFIX_PATH}/{SNAPSHOT_FILENAME}"
        delta_dir = f"{base}/{PREFIX_PATH}/{DELTA_PREFIX}/"
        snapshot = await _read_snapshot(self.store, snapshot_path)
        delta_metas = await self.store.list(delta_dir)
        ids = set(snapshot.ids)
        to_deletes: list[int] = []
        bufs = await asyncio.gather(
            *(self.store.get(m.path) for m in delta_metas),
            return_exceptions=True)
        for buf in bufs:
            if isinstance(buf, NotFoundError):
                continue  # folded and deleted mid-scrub
            if isinstance(buf, BaseException):
                raise buf
            update = decode_manifest_update(buf)
            ids.update(f.id for f in update.to_adds)
            to_deletes.extend(update.to_deletes)
        ids.difference_update(to_deletes)
        refs.update(ids)
        return refs, len(delta_metas)

    async def scrub(self, grace_override_s: Optional[float] = None
                    ) -> ScrubReport:
        """One reconcile pass.  Never raises on per-object failures —
        a failed delete is an orphan for the next pass.  Each pass is its
        own op trace (the store's list/get/delete traffic attributes to
        it), whether the scrub loop or POST /admin/scrub ran it."""
        with op_trace("scrub", slow_s=120.0, root=self.root_path):
            return await self._scrub_traced(grace_override_s)

    async def _scrub_traced(self, grace_override_s: Optional[float]
                            ) -> ScrubReport:
        grace = (self.grace_period_s if grace_override_s is None
                 else grace_override_s)
        report = ScrubReport()
        now = self._now()

        refs, delta_files = await self.referenced_ids()
        report.referenced = len(refs)
        report.delta_files = delta_files

        data_dir = f"{self.root_path.rstrip('/')}/{DATA_PREFIX}/"
        listed = await self.store.list(data_dir)
        report.data_objects = len(listed)

        live: set[str] = set()
        for meta in listed:
            name = meta.path[len(data_dir):]
            stem, _, suffix = name.partition(".")
            if not stem.isdigit() or ("." + suffix) not in (
                    ".sst", SIDECAR_SUFFIX):
                report.unparseable += 1
                continue
            if int(stem) in refs:
                continue
            report.orphans_seen += 1
            live.add(meta.path)
            seen = self.first_seen.setdefault(meta.path, now)
            if now - seen < grace:
                report.orphans_in_grace += 1
                continue
            try:
                await self.store.delete(meta.path)
            except NotFoundError:
                pass  # already gone (raced a compaction's own delete)
            except Exception as e:  # noqa: BLE001 — next pass retries
                logger.warning("scrub failed to delete %s: %s",
                               meta.path, e)
                report.errors += 1
                continue
            logger.info("scrubbed orphan object %s (%d bytes)",
                        meta.path, meta.size)
            report.orphans_deleted += 1
            report.orphan_bytes_deleted += meta.size
            live.discard(meta.path)
            self.first_seen.pop(meta.path, None)

        # paths that vanished or became referenced restart their grace
        # clock if they ever reappear unreferenced
        for path in list(self.first_seen):
            if path not in live:
                del self.first_seen[path]

        _SCRUB_PASSES.inc()
        if report.orphans_deleted:
            _SCRUB_DELETED.inc(report.orphans_deleted)
            _SCRUB_BYTES.inc(report.orphan_bytes_deleted)
        return report
