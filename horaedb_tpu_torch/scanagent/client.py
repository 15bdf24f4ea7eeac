"""Coordinator side of the near-data scan plane: the per-agent HTTP
client (deadline-budgeted, circuit-broken) and the ScanRouter the
reader consults from `aggregate_segments`.

Routing contract (docs/robustness.md, near-data failure domains):

  * the shard map is config-declared ([scanagent]); covered segments'
    aggregate RPCs run CONCURRENTLY with the normal pipeline scanning
    the uncovered rest;
  * every agent failure is handled PER SEGMENT: error / timeout /
    breaker-open / oversized-partial / stale-SSTs all fall back to the
    direct store read (`scanagent_fallback_total{reason=}`), so a dead
    agent degrades a query's latency, never its answer;
  * with `[scanagent] fallback = false` a failed shard instead DROPS
    its segments with degraded-gather accounting
    (`scanagent_degraded_segments_total`) — the cluster tier's
    partial-results discipline, for deployments where the coordinator
    has no direct path to the shard's bytes;
  * a tenant quota 429 from the agent re-raises as QuotaExceeded — a
    quota breach must surface to the client as the same 429 it would
    get from a local scan, not burn MORE resources falling back.

Every RPC carries an explicit `aiohttp.ClientTimeout` of
`min([scanagent] timeout, ambient deadline remaining)` plus the
X-Deadline-Ms / X-Trace-Id / X-Tenant headers, so the agent's work is
bounded, attributed, and charged exactly like the coordinator's own.
"""

from __future__ import annotations

import asyncio
import math
from typing import Optional

import aiohttp

from horaedb_tpu_torch.cluster.breaker import BreakerConfig, CircuitBreaker
from horaedb_tpu_torch.common.deadline import (
    current_deadline,
    remaining_budget,
)
from horaedb_tpu_torch.common.error import Error
from horaedb_tpu_torch.common.tenant import QuotaExceeded, current_tenant
from horaedb_tpu_torch.scanagent import wire
from horaedb_tpu_torch.scanagent.config import AgentSpec, ScanAgentConfig
from horaedb_tpu_torch.utils import registry, span, tracing

_REQUESTS = registry.counter(
    "scanagent_requests_total",
    "near-data scan RPCs issued by the coordinator, by agent and "
    "outcome")
_PARTIAL_BYTES = registry.counter(
    "scanagent_partial_bytes_total",
    "serialized partial bytes received from agents (the coordinator's "
    "data-plane bytes on agent-served segments)")
_FALLBACKS = registry.counter(
    "scanagent_fallback_total",
    "covered segments that fell back to direct store reads, by reason")
_DEGRADED = registry.counter(
    "scanagent_degraded_segments_total",
    "covered segments DROPPED because their shard was lost and "
    "[scanagent] fallback is disabled (degraded gather)")

# memory plane (common/memledger.py): serialized partials buffered
# between receive and decode.  Transient — a gather holds at most
# max_inflight_per_agent responses per agent — but at 32 MB per
# partial cap that is real RSS the coordinator must attribute
from horaedb_tpu_torch.common.memledger import ledger as _memledger  # noqa: E402

_WIRE_ACCOUNT = _memledger.flow(
    "scanagent_wire", kind="scanagent_wire", owner="scanagent/client")


class AgentError(Error):
    """A per-segment agent failure the router may fall back on.
    `reason` feeds scanagent_fallback_total{reason=}."""

    def __init__(self, reason: str, detail: str = ""):
        self.reason = reason
        super().__init__(f"scanagent {reason}"
                         + (f": {detail}" if detail else ""))


class ScanAgentClient:
    """HTTP client for the agent protocol, shared by every routed
    table: one session, one circuit breaker per agent."""

    def __init__(self, config: ScanAgentConfig,
                 session: Optional[aiohttp.ClientSession] = None):
        self.config = config
        self._session = session
        self._own_session = session is None
        bc = BreakerConfig(failure_threshold=config.breaker_failures,
                           open_cooldown=config.breaker_cooldown,
                           rpc_timeout=config.timeout, retries=0)
        self.breakers = {a.name: CircuitBreaker(f"agent:{a.name}", bc)
                         for a in config.agents}

    async def _ensure_session(self) -> aiohttp.ClientSession:
        if self._session is None:
            self._session = aiohttp.ClientSession()
        return self._session

    async def close(self) -> None:
        if self._own_session and self._session is not None:
            await self._session.close()
            self._session = None

    def _budget(self) -> tuple[aiohttp.ClientTimeout, dict]:
        """(per-RPC timeout, propagation headers) — the RemoteRegion
        discipline: never inherit aiohttp's 5-minute default, never
        outlive the ambient deadline, and raise rather than fire an RPC
        whose request is already out of time."""
        dl = current_deadline()
        if dl is not None:
            dl.check()
        budget = remaining_budget(self.config.timeout.seconds)
        headers = {}
        if dl is not None and dl.deadline_at is not None:
            headers["X-Deadline-Ms"] = str(
                max(1, math.floor((budget or 0.0) * 1000)))
        trace = tracing.active_trace()
        if trace is not None and not trace.finished:
            headers[tracing.TRACE_HEADER] = trace.trace_id
        tenant = current_tenant()
        if tenant is not None:
            headers["X-Tenant"] = tenant.name
        return aiohttp.ClientTimeout(total=budget), headers

    async def _register_table(self, agent: AgentSpec,
                              table_meta: dict) -> None:
        import base64

        session = await self._ensure_session()
        timeout, headers = self._budget()
        body = dict(table_meta)
        body["schema"] = base64.b64encode(body["schema"]).decode("ascii")
        async with session.post(agent.url + "/v1/tables", json=body,
                                timeout=timeout,
                                headers=headers) as resp:
            if resp.status != 200:
                raise AgentError(
                    "error", f"table registration returned "
                             f"{resp.status}: "
                             f"{(await resp.text())[:200]}")

    # AgentError reasons that are protocol ANSWERS from a live agent
    # (oversized refusal, stale plan, its deadline share expired, an
    # unknown table after the registration retry): these settle the
    # breaker as a SUCCESS — without it, a half-open probe ending in a
    # refusal would leak the probe slot (breaker.allow admits exactly
    # one probe) and disable the agent for the life of the process
    _PROTOCOL_REASONS = frozenset({"oversized", "stale", "deadline",
                                   "unknown_table"})

    async def scan_segment(self, agent: AgentSpec, body: dict,
                           table_meta: dict) -> list:
        """One covered segment's partials from its owning agent, or
        AgentError(reason) for the router's fallback dispatch.
        QuotaExceeded propagates (never a direct read that spends
        more); an agent 504 first re-checks the AMBIENT deadline — an
        expired query propagates DeadlineExceeded, while a 504 caused
        only by the per-RPC cap falls back with the budget that
        remains."""
        breaker = self.breakers[agent.name]
        if not breaker.allow():
            _REQUESTS.labels(agent=agent.name,
                             outcome="breaker_open").inc()
            raise AgentError("breaker_open", agent.name)
        try:
            parts = await self._scan_once(agent, body, table_meta)
        except QuotaExceeded:
            breaker.record_success()  # the agent answered; the quota
            raise                     # is the tenant's outcome
        except AgentError as e:
            if e.reason in self._PROTOCOL_REASONS:
                breaker.record_success()
            # "error" answers recorded their failure at the classify
            # site; connect failures below record theirs here
            raise
        except asyncio.CancelledError:
            breaker.abort_probe()
            raise
        except (asyncio.TimeoutError, TimeoutError) as e:
            breaker.record_failure()
            _REQUESTS.labels(agent=agent.name, outcome="timeout").inc()
            raise AgentError("timeout", str(e)) from e
        except Exception as e:  # noqa: BLE001 — RPC boundary
            breaker.record_failure()
            _REQUESTS.labels(agent=agent.name, outcome="error").inc()
            raise AgentError("error", str(e)) from e
        breaker.record_success()
        return parts

    async def _scan_once(self, agent: AgentSpec, body: dict,
                         table_meta: dict) -> list:
        session = await self._ensure_session()
        for attempt in (0, 1):
            timeout, headers = self._budget()
            async with session.post(agent.url + "/v1/scan", json=body,
                                    timeout=timeout,
                                    headers=headers) as resp:
                if resp.status == 200:
                    # wire bytes are resident from the body read until
                    # decode returns (the decoded parts re-own the
                    # values as numpy).  Charged at Content-Length
                    # BEFORE the read await — concurrent gathers'
                    # in-flight bodies must overlap in the account,
                    # which a charge around the synchronous decode
                    # alone can never show — then trued up to the
                    # actual size
                    held = int(resp.headers.get("Content-Length") or 0)
                    _WIRE_ACCOUNT.charge(held)
                    try:
                        data = await resp.read()
                        if len(data) > held:
                            _WIRE_ACCOUNT.charge(len(data) - held)
                        elif held > len(data):
                            _WIRE_ACCOUNT.credit(held - len(data))
                        held = len(data)
                        tracing.ingest_export(
                            resp.headers.get(tracing.EXPORT_HEADER))
                        _REQUESTS.labels(agent=agent.name,
                                         outcome="ok").inc()
                        _PARTIAL_BYTES.inc(len(data))
                        tracing.trace_add("scanagent_partial_bytes",
                                          len(data))
                        return wire.decode_parts(data)
                    finally:
                        _WIRE_ACCOUNT.credit(held)
                tracing.ingest_export(
                    resp.headers.get(tracing.EXPORT_HEADER))
                err = await self._classify_error(agent, resp)
                if err == "unknown_table" and attempt == 0:
                    await self._register_table(agent, table_meta)
                    continue
                raise AgentError(err)
        raise AgentError("error", "unreachable")  # pragma: no cover

    async def _classify_error(self, agent: AgentSpec,
                              resp) -> str:
        """Map a non-200 agent response to a fallback reason — or
        raise, for statuses that must propagate (tenant quota).  The
        agent ANSWERED: these are protocol outcomes, not breaker
        failures (a healthy agent refusing an oversized partial must
        not open its circuit)."""
        try:
            payload = await resp.json()
        except Exception:  # noqa: BLE001 — error body may be html
            payload = {}
        code = payload.get("code", "")
        if resp.status == 429 and code == "quota":
            _REQUESTS.labels(agent=agent.name, outcome="quota").inc()
            raise QuotaExceeded(payload.get("tenant", "?"),
                                payload.get("quota", "scan_bytes"),
                                float(payload.get("retry_after_s", 1.0)))
        if resp.status == 504:
            # the agent's budget was min(rpc cap, query remaining): if
            # the QUERY deadline is what expired, propagate — a
            # fallback would burn time the request no longer has.  If
            # only the per-RPC cap fired, the direct read still has
            # budget and the segment falls back (reason="deadline").
            dl = current_deadline()
            if dl is not None:
                dl.check()
        outcome = {
            413: "oversized",
            504: "deadline",
            409: "stale",
            404: "unknown_table" if code == "unknown_table" else "error",
        }.get(resp.status, "error")
        _REQUESTS.labels(agent=agent.name, outcome=outcome).inc()
        if outcome == "error":
            # a 500-class answer counts against the breaker: the agent
            # is failing scans, not refusing one
            self.breakers[agent.name].record_failure()
        return outcome


class ScanRouter:
    """Per-table routing state the reader consults: the shard map
    (from [scanagent]) plus everything needed to phrase a segment's
    plan as an agent request."""

    def __init__(self, config: ScanAgentConfig, client: ScanAgentClient,
                 table_root: str, schema, num_primary_keys: int,
                 segment_duration_ms: int):
        self.config = config
        self.client = client
        self.table_root = table_root.rstrip("/")
        self.segment_duration_ms = segment_duration_ms
        # the agent rebuilds the table from this on auto-registration
        self._table_meta = {
            "table": self.table_root,
            "num_primary_keys": num_primary_keys,
            "segment_duration_ms": segment_duration_ms,
            "schema": schema.serialize().to_pybytes(),
        }

    @property
    def active(self) -> bool:
        return self.config.active

    def split(self, segments: list) -> tuple[list, list]:
        """(covered [(agent, segment)], uncovered [segment])."""
        covered, uncovered = [], []
        for seg in segments:
            agent = self.config.owner(seg.segment_start,
                                      self.segment_duration_ms)
            if agent is None:
                uncovered.append(seg)
            else:
                covered.append((agent, seg))
        return covered, uncovered

    def covers_any(self, segments: list) -> bool:
        return self.active and any(
            self.config.owner(s.segment_start,
                              self.segment_duration_ms) is not None
            for s in segments)

    async def gather(self, plan, spec, covered: list
                     ) -> tuple[list, list]:
        """All covered segments' partials, concurrently: returns
        (served [(segment_start, parts)], failed [SegmentPlan]) —
        `failed` is what the reader's declared fallback seam scans
        directly.  QuotaExceeded / DeadlineExceeded abort the whole
        gather and propagate."""

        # per-agent in-flight bound: a queued segment's RPC budget must
        # not tick while it waits for a slot (the timeout is derived
        # inside scan_segment, after acquisition) — see
        # [scanagent] max_inflight_per_agent
        sems = {a.name: asyncio.Semaphore(
            self.config.max_inflight_per_agent)
            for a, _seg in covered}

        async def one(agent: AgentSpec, seg):
            body = wire.encode_scan_request(
                self.table_root, seg.segment_start, seg.ssts,
                plan.range, plan.predicate, spec)
            body["columns"] = list(seg.columns)
            async with sems[agent.name]:
                with span("scanagent_rpc", agent=agent.name,
                          segment=seg.segment_start):
                    return await self.client.scan_segment(
                        agent, body, self._table_meta)

        tasks = [asyncio.create_task(one(agent, seg))
                 for agent, seg in covered]
        try:
            results = await asyncio.gather(*tasks,
                                           return_exceptions=True)
        except asyncio.CancelledError:
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)
            raise
        served, failed = [], []
        for (agent, seg), res in zip(covered, results):
            if isinstance(res, AgentError):
                if self.config.fallback:
                    _FALLBACKS.labels(reason=res.reason).inc()
                    tracing.trace_add("scanagent_fallback_segments")
                    failed.append(seg)
                else:
                    _DEGRADED.inc()
                    tracing.trace_add("scanagent_degraded_segments")
                continue
            if isinstance(res, BaseException):
                # QuotaExceeded, DeadlineExceeded, cancellation, bugs:
                # not fallback material — the query's outcome
                raise res
            served.append((seg.segment_start, res))
            tracing.trace_add("scanagent_served_segments")
        return served, failed
