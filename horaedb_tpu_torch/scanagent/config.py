"""[scanagent] configuration: the near-data shard map + client policy.

The shard map is CONFIG-DECLARED (PAPERS.md "Near Data Processing in
Taurus Database": the coordinator knows which storage node holds which
rows; here, which agent is colocated with which store shard).  Segments
hash onto `num_slots` round-robin slots by segment index
(segment_start // segment_duration), and each agent declares the slots
it owns.  A segment whose slot no agent owns is UNCOVERED and scans
through the normal direct path; a covered segment routes to its owning
agent and falls back per segment on agent failure.

`mode = "off"` (the default) detaches routing entirely and reproduces
the direct scan byte-for-byte — THE control the seeded chaos suite
compares against (tests/test_scanagent.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from horaedb_tpu_torch.common import Error, ReadableDuration, ensure

SCANAGENT_MODES = ("off", "on")


@dataclass(frozen=True)
class AgentSpec:
    """One near-data agent: a name (metric label), its HTTP base URL,
    and the shard slots it owns."""

    name: str
    url: str
    slots: tuple = ()


@dataclass
class ScanAgentConfig:
    """[scanagent]: near-data aggregate routing (scanagent/)."""

    # "on" routes covered segments' aggregate scans to their agents;
    # "off" (default) is the direct-scan bit-identity control
    mode: str = "off"
    # shard slots in the map; slot(segment) = segment_index % num_slots
    num_slots: int = 1
    agents: tuple = ()
    # per-RPC total timeout cap; the effective budget is
    # min(timeout, ambient deadline remaining), like every remote RPC
    timeout: ReadableDuration = field(
        default_factory=lambda: ReadableDuration.parse("10s"))
    # agents refuse to serialize a per-segment partial beyond this
    # (HTTP 413); the coordinator falls back to the direct read — a
    # pathological group-cardinality segment must not ship a "partial"
    # bigger than the rows it summarizes
    max_partial_bytes: int = 32 << 20
    # per-segment fallback to direct store reads on agent error/
    # timeout/breaker-open.  False = degraded gather: failed segments
    # are DROPPED from the grid with scanagent_degraded_segments_total
    # accounting (the cluster tier's partial-results discipline; see
    # docs/robustness.md near-data failure domains)
    fallback: bool = True
    # consecutive per-agent failures that open its circuit, and how
    # long an open circuit waits before admitting a probe
    breaker_failures: int = 3
    breaker_cooldown: ReadableDuration = field(
        default_factory=lambda: ReadableDuration.parse("5s"))
    # concurrent segment RPCs per agent: excess segments queue at the
    # coordinator WITHOUT their RPC budget ticking (the timeout is
    # taken after the slot) — an unbounded gather over a 1000-segment
    # cold scan would otherwise queue on the connector with the clock
    # running, time out spuriously, and open breakers under exactly
    # the load routing exists for
    max_inflight_per_agent: int = 16

    def __post_init__(self):
        ensure(self.mode in SCANAGENT_MODES,
               f"unknown [scanagent] mode {self.mode!r}; expected one "
               f"of {SCANAGENT_MODES}")
        ensure(self.num_slots >= 1,
               "[scanagent] num_slots must be >= 1")
        ensure(self.max_inflight_per_agent >= 1,
               "[scanagent] max_inflight_per_agent must be >= 1")
        for a in self.agents:
            for s in a.slots:
                ensure(0 <= s < self.num_slots,
                       f"[scanagent] agent {a.name!r} slot {s} outside "
                       f"[0, {self.num_slots})")

    @property
    def active(self) -> bool:
        return self.mode == "on" and bool(self.agents)

    def slot_of(self, segment_start: int, segment_duration_ms: int) -> int:
        return (segment_start // max(1, segment_duration_ms)) \
            % self.num_slots

    def owner(self, segment_start: int,
              segment_duration_ms: int) -> "AgentSpec | None":
        """The agent owning a segment's slot, or None (uncovered)."""
        slot = self.slot_of(segment_start, segment_duration_ms)
        for a in self.agents:
            if slot in a.slots:
                return a
        return None


_AGENT_KEYS = {"name", "url", "slots"}
_CONFIG_KEYS = {"mode", "num_slots", "agents", "timeout",
                "max_partial_bytes", "fallback", "breaker_failures",
                "breaker_cooldown", "max_inflight_per_agent"}
_DURATION_KEYS = {"timeout", "breaker_cooldown"}


def _agent_from_dict(data: dict, where: str) -> AgentSpec:
    ensure(isinstance(data, dict), f"{where} expects a table")
    unknown = set(data) - _AGENT_KEYS
    if unknown:
        raise Error(f"unknown {where} keys: {sorted(unknown)}")
    name = data.get("name", "")
    url = data.get("url", "")
    ensure(isinstance(name, str) and name,
           f"{where} requires a non-empty name")
    ensure(isinstance(url, str) and url,
           f"{where} requires a non-empty url")
    slots = data.get("slots", [])
    ensure(isinstance(slots, (list, tuple))
           and all(isinstance(s, int) and not isinstance(s, bool)
                   for s in slots),
           f"{where} slots expects a list of integers")
    return AgentSpec(name=name, url=url.rstrip("/"), slots=tuple(slots))


def scanagent_from_dict(data: dict) -> ScanAgentConfig:
    """[scanagent] TOML table -> ScanAgentConfig; unknown keys rejected
    (the repo-wide deny_unknown_fields discipline)."""
    ensure(isinstance(data, dict), "[scanagent] must be a table")
    unknown = set(data) - _CONFIG_KEYS
    if unknown:
        raise Error(f"unknown config keys for [scanagent]: "
                    f"{sorted(unknown)}")
    kwargs: dict = {}
    for key, value in data.items():
        if key in _DURATION_KEYS:
            if not isinstance(value, ReadableDuration):
                ensure(isinstance(value, str),
                       f'[scanagent] {key} expects a duration string '
                       f'like "10s"')
                value = ReadableDuration.parse(value)
            kwargs[key] = value
        elif key == "agents":
            ensure(isinstance(value, (list, tuple)),
                   "[scanagent] agents expects an array of tables")
            kwargs[key] = tuple(
                _agent_from_dict(a, f"[scanagent.agents[{i}]]")
                for i, a in enumerate(value))
        elif key == "fallback":
            ensure(isinstance(value, bool),
                   "[scanagent] fallback expects a boolean")
            kwargs[key] = value
        elif key == "mode":
            ensure(isinstance(value, str),
                   "[scanagent] mode expects a string")
            kwargs[key] = value
        else:  # num_slots / max_partial_bytes / breaker_failures
            ensure(isinstance(value, int) and not isinstance(value, bool),
                   f"[scanagent] {key} expects an integer")
            kwargs[key] = value
    names = [a.name for a in kwargs.get("agents", ())]
    ensure(len(names) == len(set(names)),
           "[scanagent] agent names must be unique")
    return ScanAgentConfig(**kwargs)
