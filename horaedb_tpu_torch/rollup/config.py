"""[rollup] configuration: standing downsample queries maintained as
incremental materialized rollup tiers (rollup/manager.py).  The port's
copy of the JAX package's rollup/config.py.

With rollups enabled, a standing query registered per (metric, field)
keeps pre-aggregated cells (count/sum/min/max/last partials per series
per bucket) in one extra table per tier, updated from the ingest path
and compacted and scrubbed by the same machinery as raw SSTs, so
repeated dashboard traffic stops re-walking raw rows.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from horaedb_tpu_torch.common import Error, ReadableDuration, ensure


@dataclass
class RollupConfig:
    """Knobs for the rollup subsystem.

    Tiers: each entry is a bucket duration ("1m", "1h"); every
    registered standing query is materialized at EVERY tier.  A tier
    must evenly divide the engine's segment duration: maintenance and
    serving are segment-granular.

    Specs: standing queries registered at startup, as "metric" (field
    defaults to "value") or "metric:field" strings.
    """

    enabled: bool = False
    tiers: list[str] = field(default_factory=lambda: ["1m", "1h"])
    # background maintenance pass period (a write/flush also wakes it)
    roll_interval: ReadableDuration = field(
        default_factory=lambda: ReadableDuration.from_secs(2))
    # standing queries registered at engine open
    specs: list[str] = field(default_factory=list)

    def tier_millis(self) -> list[int]:
        out = []
        for t in self.tiers:
            ms = ReadableDuration.parse(t).millis
            ensure(ms > 0, f"[rollup] tier {t!r} must be positive")
            out.append(int(ms))
        ensure(len(set(out)) == len(out),
               f"[rollup] duplicate tiers: {self.tiers}")
        return out

    def spec_pairs(self) -> list[tuple[str, str]]:
        out = []
        for s in self.specs:
            ensure(isinstance(s, str) and s,
                   "[rollup] specs entries must be non-empty strings")
            metric, _, fld = s.partition(":")
            out.append((metric, fld or "value"))
        return out


def rollup_from_dict(data: dict) -> RollupConfig:
    """[rollup] TOML table -> RollupConfig."""
    known = {"enabled", "tiers", "roll_interval", "specs"}
    unknown = set(data) - known
    if unknown:
        raise Error(f"unknown config keys for RollupConfig: "
                    f"{sorted(unknown)}")
    kwargs: dict = {}
    if "enabled" in data:
        ensure(isinstance(data["enabled"], bool),
               "[rollup] enabled expects a boolean")
        kwargs["enabled"] = data["enabled"]
    if "tiers" in data:
        ensure(isinstance(data["tiers"], list)
               and all(isinstance(t, str) for t in data["tiers"]),
               '[rollup] tiers expects a list of duration strings '
               '(e.g. ["1m", "1h"])')
        kwargs["tiers"] = list(data["tiers"])
    if "roll_interval" in data:
        v = data["roll_interval"]
        ensure(isinstance(v, str),
               '[rollup] roll_interval expects a duration string')
        kwargs["roll_interval"] = ReadableDuration.parse(v)
    if "specs" in data:
        ensure(isinstance(data["specs"], list)
               and all(isinstance(s, str) for s in data["specs"]),
               '[rollup] specs expects a list of "metric" or '
               '"metric:field" strings')
        kwargs["specs"] = list(data["specs"])
    cfg = RollupConfig(**kwargs)
    cfg.tier_millis()  # validate tier durations at load time
    cfg.spec_pairs()
    return cfg
