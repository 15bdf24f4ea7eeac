"""Near-data scan agent: a small HTTP service colocated with a store
shard that executes aggregate scan plans over its LOCALLY-resident SSTs
and returns per-segment partials instead of segments (PAPERS.md "Near
Data Processing in Taurus Database": push filter + partial-aggregate to
where the bytes live).

The agent wraps any `ObjectStore` and reuses the engine's OWN read
path — `ParquetReader.aggregate_segments` with the fused sidecar
decode, leaf-filter/merge-dedup/bucket-aggregate pipeline, tier-2
cache, and device-decode routing all intact — so an agent-served
partial is produced by exactly the code the coordinator would have run,
which is what makes the end-to-end grids byte-identical with the
direct scan (tests/test_scanagent.py asserts it under seeded chaos).

Request surface:

  GET  /            liveness probe
  POST /v1/tables   register a table (schema travels as Arrow IPC)
  POST /v1/scan     one segment's aggregate partials (wire.py)

Headers honored end to end: `X-Deadline-Ms` binds the ambient deadline
so an expired budget aborts the scan at the next cooperative
checkpoint and answers 504; `X-Tenant` binds the tenant scope so the
scan-byte quota is charged AT the agent — the 429 carries the bucket's
deficit-derived Retry-After for the coordinator to surface;
`X-Trace-Id` adopts the coordinator's trace and the agent's spans ride
back on `X-Trace-Export` for stitching under the routing span.

The agent's reader runs on `device` — the card ("cuda") unless the
caller asks for the CPU; without a card it refuses to start.  Its
partials leave the device once per segment (the parts path's grids
come back as host arrays), so they encode exactly as a coordinator's
local parts would.
"""

from __future__ import annotations

import asyncio
import base64
import logging
import math
import time
from typing import Optional

import pyarrow as pa

from aiohttp import web

from horaedb_tpu_torch.common.deadline import (
    Deadline,
    DeadlineExceeded,
    deadline_scope,
)
from horaedb_tpu_torch.common.error import Error, ensure
from horaedb_tpu_torch.common.tenant import (
    QuotaExceeded,
    TenantRegistry,
    tenant_scope,
)
from horaedb_tpu_torch.objstore import NotFoundError, ObjectStore
from horaedb_tpu_torch.scanagent import wire
from horaedb_tpu_torch.scanagent.config import ScanAgentConfig
from horaedb_tpu_torch.storage.config import StorageConfig, UpdateMode
from horaedb_tpu_torch.storage.read import ParquetReader, ScanRequest
from horaedb_tpu_torch.storage.types import StorageSchema
from horaedb_tpu_torch.utils import registry, tracing

logger = logging.getLogger(__name__)

_SCANS = registry.counter(
    "scanagent_agent_scans_total",
    "near-data scan requests served by this agent, by outcome")
_PARTIAL_BYTES = registry.counter(
    "scanagent_agent_partial_bytes_total",
    "serialized partial bytes returned by this agent")
_SCAN_SECONDS = registry.histogram(
    "scanagent_agent_scan_seconds",
    "per-segment aggregate scan latency at the agent")

PARTIAL_CONTENT_TYPE = "application/vnd.horaedb.scanagent-partial"


class _AgentTable:
    """One registered table: its schema + a ParquetReader over the
    agent's local store.  The reader keeps its tier-2/scan caches, so
    repeat dashboard scans at the agent are as cache-served as they
    would be at the coordinator — the cache just lives near the data
    now."""

    __slots__ = ("schema", "reader", "segment_duration_ms")

    def __init__(self, schema: StorageSchema, reader: ParquetReader,
                 segment_duration_ms: int):
        self.schema = schema
        self.reader = reader
        self.segment_duration_ms = segment_duration_ms


class AgentService:
    """The near-data scan service for one store shard.

    Construct with the shard's `ObjectStore`, `register_table` each
    served table root (or let coordinators auto-register via
    POST /v1/tables), then `start()` — or mount `build_app()` into an
    existing aiohttp runner."""

    def __init__(self, store: ObjectStore,
                 config: Optional[ScanAgentConfig] = None,
                 storage_config: Optional[StorageConfig] = None,
                 tenants: Optional[TenantRegistry] = None,
                 runtimes=None, device="cuda"):
        import torch

        from horaedb_tpu_torch.common import runtimes as runtimes_mod

        dev = torch.device("cuda" if device is None else device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise Error("AgentService needs a CUDA device and none is "
                        "available; pass device='cpu' to run on the CPU")
        self.device = dev
        self.store = store
        self.config = config or ScanAgentConfig()
        self.storage_config = storage_config or StorageConfig()
        self.tenants = tenants
        self._own_runtimes = runtimes is None
        self.runtimes = runtimes or runtimes_mod.from_config(
            self.storage_config.threads,
            sst_override=self.storage_config.scan.decode_workers)
        self._tables: dict[str, _AgentTable] = {}
        self._runner: Optional[web.AppRunner] = None
        self.url: Optional[str] = None

    # ---- table registry ---------------------------------------------------

    def register_table(self, root_path: str, user_schema: pa.Schema,
                       num_primary_keys: int,
                       segment_duration_ms: int) -> None:
        root = root_path.rstrip("/")
        if root in self._tables:
            return
        schema = StorageSchema.try_new(user_schema, num_primary_keys,
                                       UpdateMode.OVERWRITE)
        reader = ParquetReader(self.store, root, schema,
                               self.storage_config, segment_duration_ms,
                               runtimes=self.runtimes, device=self.device)
        self._tables[root] = _AgentTable(schema, reader,
                                         segment_duration_ms)
        logger.info("scanagent: registered table %r (segment %dms)",
                    root, segment_duration_ms)

    # ---- lifecycle --------------------------------------------------------

    async def start(self, host: str = "127.0.0.1",
                    port: int = 0) -> str:
        """Serve on `host:port` (port 0 = ephemeral); returns the base
        URL."""
        self._runner = web.AppRunner(self.build_app())
        await self._runner.setup()
        site = web.TCPSite(self._runner, host, port)
        await site.start()
        bound = self._runner.addresses[0][1]
        self.url = f"http://{host}:{bound}"
        return self.url

    async def close(self) -> None:
        if self._runner is not None:
            await self._runner.cleanup()
            self._runner = None
        for t in self._tables.values():
            # release the reader's cache tiers, their process-wide byte
            # gauges and ledger accounts
            t.reader.close()
        self._tables.clear()
        if self._own_runtimes:
            self.runtimes.close()

    # ---- HTTP surface -----------------------------------------------------

    def build_app(self) -> web.Application:
        app = web.Application(client_max_size=64 << 20)
        app.router.add_get("/", self._hello)
        app.router.add_post("/v1/tables", self._register)
        app.router.add_post("/v1/scan", self._scan)
        return app

    async def _hello(self, _req: web.Request) -> web.Response:
        return web.json_response({"ok": True,
                                  "tables": sorted(self._tables)})

    async def _register(self, req: web.Request) -> web.Response:
        try:
            body = await req.json()
            schema = pa.ipc.read_schema(pa.BufferReader(
                base64.b64decode(body["schema"])))
            self.register_table(body["table"], schema,
                                int(body["num_primary_keys"]),
                                int(body["segment_duration_ms"]))
            return web.json_response({"ok": True})
        except Exception as e:  # noqa: BLE001 — registration surface
            return web.json_response({"error": str(e)}, status=400)

    def _deadline_of(self, req: web.Request) -> Optional[Deadline]:
        raw = req.headers.get("X-Deadline-Ms")
        if raw is None:
            return None
        return Deadline.after(max(0.0, int(raw) / 1000.0),
                              reason="scanagent")

    async def _scan(self, req: web.Request) -> web.Response:
        """One segment's aggregate partials.  Status codes are the
        protocol the coordinator's fallback dispatches on:

          200  Arrow IPC partial payload (wire.encode_parts)
          404  code=unknown_table — register, then retry
          409  code=stale_ssts — the plan's SSTs are not (all) at this
               shard: stale shard map or a racing compaction
          413  code=partial_too_large — partial exceeds
               [scanagent] max_partial_bytes; scanning it here would
               ship MORE than the rows, so the coordinator reads direct
          429  tenant scan-byte quota charged at this agent fired
          504  the propagated deadline expired mid-scan
        """
        incoming = req.headers.get(tracing.TRACE_HEADER)
        trace = None
        if incoming:
            trace = tracing.recorder.start("scanagent/scan",
                                           trace_id=incoming, forced=True)

        def _respond(resp: web.Response, outcome: str) -> web.Response:
            _SCANS.labels(outcome=outcome).inc()
            if trace is not None:
                done = tracing.recorder.finish(
                    trace, status="ok" if resp.status == 200 else "error")
                resp.headers[tracing.TRACE_HEADER] = trace.trace_id
                resp.headers[tracing.EXPORT_HEADER] = \
                    tracing.export_payload(done)
            return resp

        try:
            deadline = self._deadline_of(req)
        except ValueError:
            return _respond(web.json_response(
                {"error": "bad X-Deadline-Ms"}, status=400), "error")
        if deadline is not None and deadline.remaining() <= 0.0:
            return _respond(web.json_response(
                {"error": "deadline exceeded before scan",
                 "code": "deadline"}, status=504), "deadline")
        tenant = None
        if self.tenants is not None:
            try:
                tenant = self.tenants.resolve(req.headers.get("X-Tenant"))
            except Error as e:
                return _respond(web.json_response(
                    {"error": str(e)}, status=400), "error")
        try:
            with tracing.trace_scope(trace), deadline_scope(deadline), \
                    tenant_scope(tenant):
                return _respond(*await self._scan_governed(req, deadline))
        except QuotaExceeded as e:
            # the quota charged AT the agent: the coordinator re-raises
            # this as its own QuotaExceeded so the server's 429 carries
            # the same tenant/resource/Retry-After
            return _respond(web.json_response(
                {"error": str(e), "code": "quota", "quota": e.resource,
                 "tenant": e.tenant,
                 "retry_after_s": e.retry_after_s},
                status=429,
                headers={"Retry-After":
                         str(max(1, math.ceil(e.retry_after_s)))}),
                "quota")
        except (DeadlineExceeded, asyncio.TimeoutError):
            return _respond(web.json_response(
                {"error": "deadline exceeded mid-scan",
                 "code": "deadline"}, status=504), "deadline")
        except NotFoundError as e:
            # an SST named by the plan is not at this shard: stale
            # shard map, or a compaction deleted it mid-scan — the
            # coordinator replans/falls back either way
            return _respond(web.json_response(
                {"error": str(e), "code": "stale_ssts"}, status=409),
                "stale")
        except Error as e:
            return _respond(web.json_response(
                {"error": str(e)}, status=400), "error")
        except Exception as e:  # noqa: BLE001 — service boundary
            logger.exception("scanagent scan failed")
            return _respond(web.json_response(
                {"error": str(e)}, status=500), "error")

    async def _scan_governed(self, req: web.Request,
                             deadline: Optional[Deadline]
                             ) -> tuple[web.Response, str]:
        t0 = time.perf_counter()
        body = await req.json()
        (table, segment_start, ssts, rng, predicate, spec,
         projections) = wire.decode_scan_request(body)
        entry = self._tables.get(table.rstrip("/"))
        if entry is None:
            return (web.json_response(
                {"error": f"unknown table {table!r}",
                 "code": "unknown_table"}, status=404), "unknown_table")
        scan_req = ScanRequest(range=rng, predicate=predicate,
                               projections=projections)
        plan = entry.reader.build_plan(ssts, scan_req)
        columns = body.get("columns")
        if columns is not None:
            # the coordinator's exact column set: cache keys and decode
            # behavior must match the plan it would have executed
            for seg in plan.segments:
                seg.columns = list(columns)
        parts_out: list = []

        async def run() -> None:
            agg_iter = entry.reader.aggregate_segments(plan, spec)
            try:
                async for seg_start, parts in agg_iter:
                    ensure(seg_start == segment_start,
                           f"scan produced segment {seg_start}, "
                           f"expected {segment_start}")
                    parts_out.extend(parts)
            finally:
                await agg_iter.aclose()

        if deadline is not None:
            # hard backstop around the cooperative checkpoints, like
            # the server's query path
            await asyncio.wait_for(run(), deadline.remaining())
        else:
            await run()
        payload = wire.encode_parts(parts_out)
        if len(payload) > self.config.max_partial_bytes:
            return (web.json_response(
                {"error": f"partial is {len(payload)} bytes "
                          f"(> {self.config.max_partial_bytes})",
                 "code": "partial_too_large", "bytes": len(payload)},
                status=413), "oversized")
        _PARTIAL_BYTES.inc(len(payload))
        _SCAN_SECONDS.observe(time.perf_counter() - t0)
        return (web.Response(body=payload,
                             content_type=PARTIAL_CONTENT_TYPE), "ok")
