"""Range-partition routing with per-rule TTL (ref: RFC 20240827:36-76).

Key space: hash(metric + sorted labels) masked to [0, 2^63) — the same
canonical series key the TSID uses, so one series always routes to one
region.  Rules are half-open key ranges [start_key, end_key) with:

  - created_at: when the rule became active (ms),
  - ttl_expire_at: when the rule's data stops being queryable
    (MAX_TTL = forever for live rules).

Writes go to the covering rule with the LARGEST ttl_expire_at (the RFC's
"find the rule with the max TTL in the interval").  Queries return every
covering rule whose [created_at, ttl_expire_at) intersects the query
time window — after a split, old data is still in the pre-split region
until the old rule's TTL lapses, so both regions are consulted.

split() implements the RFC's `alter table root split partition` flow:
the old rule gets ttl_expire_at = now + table_ttl, the new sub-ranges
get MAX_TTL.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional

from horaedb_tpu_torch.common.error import Error, ensure
from horaedb_tpu_torch.common.seahash import hash64
from horaedb_tpu_torch.metric_engine.types import series_key_of

KEY_SPACE = 1 << 63
MAX_TTL = (1 << 63) - 1


def routing_key(metric: str, labels) -> int:
    """hash(metric + sorted_tags) into [0, 2^63) (RFC:34)."""
    return hash64(series_key_of(metric, list(labels))) % KEY_SPACE


@dataclass(frozen=True)
class PartitionRule:
    start_key: int
    end_key: int  # exclusive
    region_id: int
    created_at: int = 0
    ttl_expire_at: int = MAX_TTL

    def covers(self, key: int) -> bool:
        return self.start_key <= key < self.end_key

    def alive_for_query(self, q_start: int, q_end: int,
                        strict_time_routing: bool = False) -> bool:
        """Whether this rule's region must be consulted for a query window.

        Always: not yet TTL-expired at the window start.  With
        strict_time_routing (the RFC's routing table, which assumes data
        time == ingest time), additionally prune rules created after the
        window ends — unsafe under backfill, where late writes carry old
        timestamps into post-split regions, so it is opt-in.  (Data
        timestamps inside the region are filtered by the engine either
        way.)"""
        if self.ttl_expire_at <= q_start:
            return False
        if strict_time_routing and self.created_at >= q_end:
            return False
        return True


@dataclass
class RoutingTable:
    rules: list[PartitionRule] = field(default_factory=list)
    # RFC-style timestamp pruning of post-split rules; leave False when
    # backfill (writes with old timestamps) is possible
    strict_time_routing: bool = False

    @classmethod
    def uniform(cls, region_ids: list[int]) -> "RoutingTable":
        """Initial layout: equal key ranges, one per region."""
        ensure(region_ids, "at least one region required")
        n = len(region_ids)
        step = KEY_SPACE // n
        rules = []
        for i, rid in enumerate(region_ids):
            end = KEY_SPACE if i == n - 1 else (i + 1) * step
            rules.append(PartitionRule(i * step, end, rid))
        return cls(rules)

    def route_write(self, key: int, now_ms: int) -> int:
        """Region for a write: covering rule with the largest TTL
        (RFC: "找到对应区间内 TTL 最大的")."""
        best: Optional[PartitionRule] = None
        for r in self.rules:
            if r.covers(key) and r.ttl_expire_at > now_ms:
                if best is None or r.ttl_expire_at > best.ttl_expire_at:
                    best = r
        if best is None:
            raise Error(f"no live partition rule covers key {key}")
        return best.region_id

    def route_query(self, key: Optional[int], q_start: int,
                    q_end: int) -> list[int]:
        """Regions a query must consult.  key=None (no full tag set to
        hash) fans out to every live rule — the RFC accepts this for
        un-pinnable queries."""
        out: list[int] = []
        for r in self.rules:
            if key is not None and not r.covers(key):
                continue
            if (r.alive_for_query(q_start, q_end, self.strict_time_routing)
                    and r.region_id not in out):
                out.append(r.region_id)
        return out

    def split(self, region_id: int, pivot_key: int, new_region_id: int,
              now_ms: int, table_ttl_ms: int) -> None:
        """Split a hot region's range at pivot_key: [a,p) stays, [p,b)
        moves to the new region.  The old rule lives on with
        ttl = now + table_ttl so existing data stays queryable until it
        ages out (RFC's split table: old rule TTL = t+30d)."""
        live = [r for r in self.rules
                if r.region_id == region_id and r.ttl_expire_at == MAX_TTL
                and r.covers(pivot_key)]
        ensure(len(live) == 1,
               f"expected exactly one live rule covering pivot {pivot_key} "
               f"in region {region_id}, found {len(live)}")
        old = live[0]
        ensure(old.start_key < pivot_key < old.end_key,
               "pivot must fall strictly inside the rule's range")
        self.rules.remove(old)
        # old rule expires after the table TTL; until then queries fan out
        self.rules.append(replace(old, ttl_expire_at=now_ms + table_ttl_ms))
        self.rules.append(PartitionRule(old.start_key, pivot_key,
                                        region_id, created_at=now_ms))
        self.rules.append(PartitionRule(pivot_key, old.end_key,
                                        new_region_id, created_at=now_ms))

    def gc_expired(self, now_ms: int) -> list[PartitionRule]:
        """Drop rules whose TTL fully lapsed; returns the dropped rules
        so the caller can reclaim region data."""
        dead = [r for r in self.rules if r.ttl_expire_at <= now_ms]
        self.rules = [r for r in self.rules if r.ttl_expire_at > now_ms]
        return dead

    def region_ids(self) -> list[int]:
        out: list[int] = []
        for r in self.rules:
            if r.region_id not in out:
                out.append(r.region_id)
        return out

    # ---- persistence (the cluster's "root table" state) -------------------

    def to_json(self) -> str:
        import json

        return json.dumps({
            "strict_time_routing": self.strict_time_routing,
            "rules": [{"start_key": r.start_key, "end_key": r.end_key,
                       "region_id": r.region_id,
                       "created_at": r.created_at,
                       "ttl_expire_at": r.ttl_expire_at}
                      for r in self.rules],
        })

    @classmethod
    def from_json(cls, data: str) -> "RoutingTable":
        import json

        doc = json.loads(data)
        return cls(
            rules=[PartitionRule(**r) for r in doc["rules"]],
            strict_time_routing=doc.get("strict_time_routing", False))
