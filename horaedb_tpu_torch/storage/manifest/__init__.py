"""Manifest: SST metadata store with snapshot + delta log on object storage
(ref: src/storage/src/manifest/mod.rs).

Design (identical to the reference):
- Every update = one delta file put, THEN the in-memory cache mutation
  (crash between the two loses nothing: recovery folds deltas).
- A background merger folds deltas into the snapshot every
  `merge_interval` (or on signal) once more than `min_merge_threshold`
  deltas exist; crossing `soft_merge_threshold` nudges it, crossing
  `hard_merge_threshold` FAILS the write — that is the engine's write
  backpressure (ref: manifest/mod.rs:248-262).
- Startup recovery = read snapshot, fold ALL deltas, rewrite snapshot
  (`first_run`, ref: manifest/mod.rs:212-214, 274-333).
"""

from __future__ import annotations

import asyncio
import logging

from horaedb_tpu_torch.common.error import Error
from horaedb_tpu_torch.common.id_alloc import MonotonicIdAllocator
from horaedb_tpu_torch.common.tasks import cancel_and_wait
from horaedb_tpu_torch.objstore import NotFoundError, ObjectStore
from horaedb_tpu_torch.storage.config import ManifestConfig
from horaedb_tpu_torch.storage.manifest.encoding import (
    ManifestUpdate,
    Snapshot,
    decode_manifest_update,
    encode_manifest_update,
)
from horaedb_tpu_torch.storage.sst import FileId, FileMeta, SstFile
from horaedb_tpu_torch.storage.types import TimeRange
from horaedb_tpu_torch.utils import span

logger = logging.getLogger(__name__)

PREFIX_PATH = "manifest"
SNAPSHOT_FILENAME = "snapshot"
DELTA_PREFIX = "delta"

_DELTA_IDS = MonotonicIdAllocator()


def _delta_order(path: str) -> int:
    """Numeric delta-file ordering (lexicographic order breaks when id
    digit counts differ)."""
    name = path.rsplit("/", 1)[-1]
    return int(name) if name.isdigit() else -1


async def _read_snapshot_bytes(store: ObjectStore, path: str) -> bytes:
    """A missing snapshot reads as empty bytes (the single home for the
    snapshot-missing rule)."""
    try:
        return await store.get(path)
    except NotFoundError:
        return b""


async def _read_snapshot(store: ObjectStore, path: str) -> Snapshot:
    return Snapshot.from_bytes(await _read_snapshot_bytes(store, path))


class _Merger:
    """Background delta→snapshot folder (ref: ManifestMerger, mod.rs:184-333)."""

    def __init__(self, snapshot_path: str, delta_dir: str, store: ObjectStore,
                 config: ManifestConfig, runtimes=None):
        self.snapshot_path = snapshot_path
        self.delta_dir = delta_dir
        self.store = store
        self.config = config
        self.runtimes = runtimes
        self.deltas_num = 0
        self._signal: asyncio.Queue[None] = asyncio.Queue(maxsize=config.channel_size)
        self._task: asyncio.Task | None = None
        # checked each loop turn: merge signals racing stop() can make
        # wait_for swallow the cancellation (bpo-37658)
        self._stopping = False
        # Serializes folds: the reference funnels every merge through one
        # consumer task; we allow trigger_merge() alongside the background
        # loop, so an explicit lock keeps a delta from being folded twice
        # concurrently.
        self._merge_lock = asyncio.Lock()

    def start(self) -> None:
        self._stopping = False
        self._task = asyncio.ensure_future(self._merge_loop())

    async def stop(self) -> None:
        self._stopping = True
        if self._task is not None:
            # merge signals race stop() exactly like compaction triggers
            # do — re-deliver the cancel past the wait_for swallow race
            # (see common/tasks.py)
            await cancel_and_wait(self._task)
            self._task = None

    async def _merge_loop(self) -> None:
        interval = self.config.merge_interval.seconds
        logger.info("start manifest merge background job, interval=%ss", interval)
        while not self._stopping:
            try:
                await asyncio.wait_for(self._signal.get(), timeout=interval)
            except TimeoutError:
                pass
            except asyncio.TimeoutError:  # Python < 3.11 alias
                pass
            if self._stopping:
                return
            if self.deltas_num > self.config.min_merge_threshold:
                try:
                    await self.do_merge(first_run=False)
                except Exception:  # noqa: BLE001 — retried later
                    logger.exception("failed to merge manifest deltas")

    def _schedule_merge(self) -> None:
        try:
            self._signal.put_nowait(None)
        except asyncio.QueueFull:
            logger.debug("merge signal channel full, merge already pending")

    def maybe_schedule_merge(self) -> None:
        """Backpressure gate run before every update (ref: mod.rs:248-262)."""
        current = self.deltas_num
        hard = self.config.hard_merge_threshold
        if current > hard:
            self._schedule_merge()
            raise Error(
                f"Manifest has too many delta files, value:{current}, hard_limit:{hard}"
            )
        if current > self.config.soft_merge_threshold:
            self._schedule_merge()

    async def do_merge(self, first_run: bool) -> None:
        async with self._merge_lock:
            await self._do_merge_locked(first_run)

    async def _do_merge_locked(self, first_run: bool) -> None:
        with span("manifest.merge", first_run=first_run):
            await self._do_merge_inner(first_run)

    async def _do_merge_inner(self, first_run: bool) -> None:
        metas = await self.store.list(self.delta_dir + "/")
        paths = [m.path for m in metas]
        if not paths:
            return
        if first_run:
            self.deltas_num = len(paths)

        delta_bufs = await asyncio.gather(*(self.store.get(p) for p in paths))
        snapshot_buf = await _read_snapshot_bytes(self.store,
                                                  self.snapshot_path)

        def fold() -> bytes:
            # pure CPU (protowire decode + snapshot codec) — runs on the
            # manifest pool (ref: manifest_compact_runtime,
            # storage.rs:91-104) so folds never block the event loop
            updates = [decode_manifest_update(buf) for buf in delta_bufs]
            snapshot = Snapshot.from_bytes(snapshot_buf)
            # Deltas are unsorted, so add all new files first, then
            # delete (ref: mod.rs:296-300).
            to_deletes: list[FileId] = []
            for update in updates:
                snapshot.add_records(update.to_adds)
                to_deletes.extend(update.to_deletes)
            snapshot.delete_records(to_deletes)
            return snapshot.into_bytes()

        if self.runtimes is not None:
            new_snapshot = await self.runtimes.run("manifest", fold)
        else:
            new_snapshot = await asyncio.to_thread(fold)

        # 1. Persist the snapshot, 2. then delete merged deltas — OLDEST
        # FIRST, stopping at the first failure so survivors always form
        # a SUFFIX of the folded batch.  Ids are never reused, so the
        # delta deleting file X always has a larger id than the delta
        # that added X; suffix survival therefore keeps every add with
        # its matching delete, and recovery's re-fold stays a no-op.  A
        # parallel best-effort delete could reap the delete-delta while
        # its add-delta survived — the re-fold would then RESURRECT a
        # manifest entry whose object is long gone (a permanent ghost
        # every scan trips over).
        await self.store.put(self.snapshot_path, new_snapshot)
        for path in sorted(paths, key=_delta_order):
            try:
                await self.store.delete(path)
            except NotFoundError:
                pass  # already reaped (e.g. by a prior partial pass)
            except Exception as e:  # noqa: BLE001 — next fold retries
                logger.error(
                    "failed to delete delta %s: %s (stopping; remaining "
                    "deltas re-fold on the next merge)", path, e)
                break
            self.deltas_num -= 1


class Manifest:
    """SST metadata store (ref: Manifest, mod.rs:67-176)."""

    def __init__(self, root_dir: str, store: ObjectStore,
                 config: ManifestConfig, runtimes=None):
        base = root_dir.rstrip("/")
        self.snapshot_path = f"{base}/{PREFIX_PATH}/{SNAPSHOT_FILENAME}"
        self.delta_dir = f"{base}/{PREFIX_PATH}/{DELTA_PREFIX}"
        self.store = store
        self._merger = _Merger(self.snapshot_path, self.delta_dir, store,
                               config, runtimes=runtimes)
        self._ssts: list[SstFile] = []
        self._cache_lock = asyncio.Lock()

    @classmethod
    async def open(cls, root_dir: str, store: ObjectStore,
                   config: ManifestConfig | None = None,
                   runtimes=None) -> "Manifest":
        m = cls(root_dir, store, config or ManifestConfig(),
                runtimes=runtimes)
        # Recovery: fold all deltas into the snapshot before serving.
        await m._merger.do_merge(first_run=True)
        snapshot = await _read_snapshot(store, m.snapshot_path)
        m._ssts = snapshot.into_ssts()
        logger.debug("loaded manifest snapshot at startup, ssts=%d", len(m._ssts))
        m._merger.start()
        return m

    async def close(self) -> None:
        await self._merger.stop()

    async def add_file(self, file_id: FileId, meta: FileMeta) -> None:
        await self.update(ManifestUpdate(to_adds=[SstFile(file_id, meta)]))

    async def update(self, update: ManifestUpdate) -> None:
        self._merger.maybe_schedule_merge()
        if self._merger.deltas_num > self._merger.config.soft_merge_threshold:
            # Soft backpressure: THROTTLE the writer (bounded) until the
            # background fold drains below the soft threshold.  With an
            # in-memory/local store no await in the write path truly
            # suspends, so a tight writer loop would otherwise starve
            # the merger until the hard limit failed every write (the
            # reference runs its merger on separate tokio threads; a
            # single asyncio loop needs an explicit pause).  The wait is
            # bounded so a wedged store degrades to the hard-limit error
            # instead of hanging writers.
            deadline = (asyncio.get_running_loop().time()
                        + self._merger.config.soft_merge_max_wait.seconds)
            while (self._merger.deltas_num
                   > self._merger.config.soft_merge_threshold
                   and asyncio.get_running_loop().time() < deadline):
                await asyncio.sleep(0.001)
        self._merger.deltas_num += 1
        try:
            await self._update_inner(update)
        except BaseException:
            self._merger.deltas_num -= 1
            raise

    async def _update_inner(self, update: ManifestUpdate) -> None:
        path = f"{self.delta_dir}/{_DELTA_IDS.allocate()}"
        # 1. Persist the delta, 2. then mutate the cache (ref: mod.rs:139-156).
        await self.store.put(path, encode_manifest_update(update))
        async with self._cache_lock:
            self._ssts.extend(update.to_adds)
            if update.to_deletes:
                dels = set(update.to_deletes)
                self._ssts = [f for f in self._ssts if f.id not in dels]

    async def find_ssts(self, time_range: TimeRange) -> list[SstFile]:
        async with self._cache_lock:
            return [f for f in self._ssts if f.meta.time_range.overlaps(time_range)]

    # test/introspection hooks
    @property
    def deltas_num(self) -> int:
        return self._merger.deltas_num

    async def trigger_merge(self) -> None:
        """Force a synchronous fold (tests and shutdown)."""
        await self._merger.do_merge(first_run=False)
