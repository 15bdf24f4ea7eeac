"""Remote region backend: the MetricEngine API over the server's HTTP
endpoints — the cluster's network plane (SURVEY.md P6: the legacy reference
forwards via HoraeMeta + gRPC; our control/data plane is the aiohttp
server, so a region can live in any process that runs one).

RemoteRegion duck-types the MetricEngine surface the Cluster facade uses
(write / query / query_downsample / label_values / close), so a Cluster
can mix in-process and remote regions freely.

Every RPC is bounded: each call gets an `aiohttp.ClientTimeout` of
`min(timeout_s, ambient deadline remaining)` — aiohttp's 5-minute
default total timeout is never inherited (docs/robustness.md).  The
remaining budget also rides ahead of the request as `X-Deadline-Ms`,
so the peer's server can bind the same deadline for ITS downstream
work instead of scanning for a client that already gave up.
"""

from __future__ import annotations

import math
from typing import Optional

import pyarrow as pa

import aiohttp

from horaedb_tpu_torch.common.deadline import current_deadline, remaining_budget
from horaedb_tpu_torch.common.error import Error
from horaedb_tpu_torch.common.tenant import current_tenant
from horaedb_tpu_torch.metric_engine.types import Sample
from horaedb_tpu_torch.storage.types import TimeRange
from horaedb_tpu_torch.utils import span, tracing

# default per-RPC total timeout when no deadline is bound and no
# override is configured; generous for bulk ingest, far below aiohttp's
# 5-minute default
DEFAULT_RPC_TIMEOUT_S = 60.0


def _stale_owner_error(base_url: str, path: str, text: str):
    """Typed 409 stale-owner answer; carries the region/new-owner hint
    from the JSON body when the peer knows it."""
    import json

    from horaedb_tpu_torch.cluster.replication import StaleOwnerError

    region = owner = None
    try:
        body = json.loads(text)
        region = body.get("region")
        owner = body.get("owner")
    except (ValueError, AttributeError):
        pass
    return StaleOwnerError(
        f"remote region {base_url}{path} answered 409 stale-owner: "
        f"{text[:200]}", region=region, owner=owner)


class RemoteRegion:
    def __init__(self, base_url: str,
                 session: Optional[aiohttp.ClientSession] = None,
                 timeout_s: float = DEFAULT_RPC_TIMEOUT_S):
        self.base_url = base_url.rstrip("/")
        self.timeout_s = timeout_s
        self._session = session
        self._own_session = session is None

    async def _ensure_session(self) -> aiohttp.ClientSession:
        if self._session is None:
            self._session = aiohttp.ClientSession()
        return self._session

    async def close(self) -> None:
        if self._own_session and self._session is not None:
            await self._session.close()
            self._session = None

    def _rpc_budget(self) -> tuple[aiohttp.ClientTimeout, dict]:
        """Per-call (timeout, deadline headers).  Raises rather than
        firing an RPC whose request is already out of time."""
        dl = current_deadline()
        if dl is not None:
            dl.check()
        budget = remaining_budget(self.timeout_s)
        headers = {}
        if dl is not None and dl.deadline_at is not None:
            # remaining budget in whole ms, floored so the peer's view
            # is never LONGER than ours
            headers["X-Deadline-Ms"] = str(
                max(1, math.floor((budget or 0.0) * 1000)))
        # the trace context rides the same plumbing as the deadline: the
        # peer traces its share of the work under OUR trace id and hands
        # its spans back on X-Trace-Export for stitching
        trace = tracing.active_trace()
        if trace is not None and not trace.finished:
            headers[tracing.TRACE_HEADER] = trace.trace_id
        # tenant identity + node-tier weight ride along so the peer's
        # fair scheduler grants this tenant its configured share even
        # when the peer's own [tenants] table doesn't know the name
        # (auto-minted tenants there default to weight 1.0 otherwise)
        tenant = current_tenant()
        if tenant is not None:
            headers["X-Tenant"] = tenant.name
            headers["X-Tenant-Weight"] = repr(tenant.limits.weight)
        return aiohttp.ClientTimeout(total=budget), headers

    async def _post_raw(self, path: str, **kwargs) -> bytes:
        """POST with the shared status-first error contract; returns the
        raw response body.  Every call carries an explicit timeout
        derived from the propagated deadline (capped by `timeout_s`)."""
        session = await self._ensure_session()
        with span("rpc", path=path, url=self.base_url):
            timeout, dl_headers = self._rpc_budget()
            headers = {**dl_headers, **kwargs.pop("headers", {})}
            async with session.post(self.base_url + path, timeout=timeout,
                                    headers=headers, **kwargs) as resp:
                if resp.status == 409:
                    # stale owner: the peer lost this region's lease
                    # mid-failover.  Typed so the coordinator's gather
                    # can re-resolve ownership and retry ONE hop
                    # instead of degrading immediately.
                    raise _stale_owner_error(self.base_url, path,
                                             await resp.text())
                if resp.status != 200:
                    # body may be a non-JSON error page (404, 500 html)
                    text = await resp.text()
                    raise Error(f"remote region {self.base_url}{path} "
                                f"returned {resp.status}: {text[:200]}")
                # stitch the peer's spans under this RPC span
                tracing.ingest_export(
                    resp.headers.get(tracing.EXPORT_HEADER))
                return await resp.read()

    async def _post(self, path: str, body: dict) -> dict:
        import json

        return json.loads(await self._post_raw(path, json=body))

    async def ping(self, timeout_s: float = 2.0) -> bool:
        """Cheap liveness probe (the server's hello endpoint).  False on
        any failure — the health monitor turns repeated falses into a
        dead mark so queries fail fast instead of at gather time."""
        try:
            session = await self._ensure_session()
            async with session.get(
                    self.base_url + "/",
                    timeout=aiohttp.ClientTimeout(total=timeout_s)) as resp:
                return resp.status == 200
        except Exception:
            return False

    async def stats(self, timeout_s: float = 10.0) -> dict:
        """Remote region data volume (rows/bytes) via the server's
        /stats endpoint — the cluster's real load signal.  Bounded by
        its own timeout: a blackholed peer must degrade the stats
        survey, not stall it for aiohttp's 5-minute default."""
        import json

        session = await self._ensure_session()
        async with session.get(
                self.base_url + "/stats",
                timeout=aiohttp.ClientTimeout(total=timeout_s)) as resp:
            if resp.status != 200:
                raise Error(f"remote region {self.base_url}/stats "
                            f"returned {resp.status}")
            return json.loads(await resp.read())

    # ---- MetricEngine surface ---------------------------------------------

    async def write(self, samples: list[Sample]) -> None:
        body = {"samples": [
            {"name": s.name,
             "labels": {l.name: l.value for l in s.labels},
             "timestamp": s.timestamp, "value": s.value,
             "field": s.field_name}
            for s in samples
        ]}
        await self._post("/write", body)

    async def write_arrow(self, metric: str, tag_columns: list[str],
                          batch: pa.RecordBatch,
                          field: str = "value") -> None:
        """Bulk ingest over the Arrow-IPC data plane (zstd buffers for
        the network hop; the server's pyarrow reader auto-detects)."""
        from horaedb_tpu_torch.common.ipc import serialize_stream

        await self._post_raw(
            "/write_arrow",
            params={"metric": metric, "tags": ",".join(tag_columns),
                    "field": field},
            data=serialize_stream(batch, "zstd"),
            headers={"Content-Type": "application/vnd.apache.arrow.stream"})

    async def query(self, metric: str, filters: list[tuple[str, str]],
                    time_range: TimeRange, field: str = "value") -> pa.Table:
        """Row queries ride the Arrow-IPC plane (no per-row JSON); the
        region-to-region hop opts into zstd buffers."""
        import pyarrow.ipc

        body = await self._post_raw("/query_arrow", json={
            "metric": metric, "filters": [list(f) for f in filters],
            "start": int(time_range.start), "end": int(time_range.end),
            "field": field, "compression": "zstd"})
        return pyarrow.ipc.open_stream(body).read_all()

    async def query_downsample(self, metric: str,
                               filters: list[tuple[str, str]],
                               time_range: TimeRange, bucket_ms: int,
                               field: str = "value") -> dict:
        """Downsample grids ride the Arrow-IPC plane like row queries:
        zstd'd FixedSizeList buffers instead of JSON decimal text (2.6x
        fewer wire bytes even on random grids; NaN preserved without a
        null round trip)."""
        import pyarrow.ipc

        from horaedb_tpu_torch.common.ipc import downsample_from_arrow

        body = await self._post_raw("/query_arrow", json={
            "metric": metric, "filters": [list(f) for f in filters],
            "start": int(time_range.start), "end": int(time_range.end),
            "bucket_ms": bucket_ms, "field": field,
            "compression": "zstd"})
        return downsample_from_arrow(pyarrow.ipc.open_stream(body).read_all())

    async def label_values(self, metric: str, tag_key: str,
                           time_range: TimeRange) -> list[str]:
        session = await self._ensure_session()
        with span("rpc", path="/label_values", url=self.base_url):
            timeout, dl_headers = self._rpc_budget()
            # status FIRST (the _post_raw contract): a non-JSON error
            # page (404 text, 500 html) must surface as Error, not as a
            # ContentTypeError from reading the body as JSON
            async with session.get(self.base_url + "/label_values",
                                   params={
                    "metric": metric, "key": tag_key,
                    "start": str(int(time_range.start)),
                    "end": str(int(time_range.end))},
                    timeout=timeout, headers=dl_headers) as resp:
                if resp.status == 409:
                    raise _stale_owner_error(self.base_url,
                                             "/label_values",
                                             await resp.text())
                if resp.status != 200:
                    text = await resp.text()
                    raise Error(
                        f"remote region {self.base_url}/label_values "
                        f"returned {resp.status}: {text[:200]}")
                tracing.ingest_export(
                    resp.headers.get(tracing.EXPORT_HEADER))
                data = await resp.json()
                return data["values"]
