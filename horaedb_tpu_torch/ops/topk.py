"""Top-k over per-group aggregates (BASELINE config 4: the top-k hosts by
max(cpu) across 64 SSTs), and the exact double-float (hi, lo) pair
arithmetic of the additive top-k score plane.

Plain PyTorch on float32 tensors, on whatever device they lie on: each
function has a faithful torch primitive, so none is a hand kernel.  The
pair arithmetic must keep IEEE order: torch's eager elementwise ops do,
and nothing here may be compiled with fast-math or reassociation.
`two_sum` has no multiply for an FMA to contract.

One difference from the JAX package, in its CPU backend only: XLA's CPU
backend flushes subnormals to zero, torch does not (on the CPU or the
card), so on subnormal inputs these functions keep the IEEE result
where the reference reads 0.  On normal-range inputs they agree byte
for byte.
"""

from __future__ import annotations

import torch


def two_sum(a: torch.Tensor, b: torch.Tensor):
    """Knuth 2Sum: s + e == a + b exactly (s = fl(a+b))."""
    s = a + b
    bv = s - a
    av = s - bv
    e = (a - av) + (b - bv)
    return s, e


def pair_add(hi: torch.Tensor, lo: torch.Tensor, x: torch.Tensor):
    """Add f32 `x` into the (hi, lo) pair.

    Returns (hi', lo', exact): `exact` is True when hi' + lo' provably
    equals the exact real sum hi + lo + x AND the pair stays dense
    enough (|lo'| * 2^28 >= |hi'|, or lo' == 0) that a host f64 fold of
    the same addends reproduces it.  Over-flagging only costs a counted
    downgrade, never a wrong answer."""
    s, e = two_sum(hi, x)
    lo2, e1 = two_sum(lo, e)
    hi2, lo3 = two_sum(s, lo2)
    dense = (lo3 == 0.0) | (torch.abs(lo3) * 2.0 ** 28 >= torch.abs(hi2))
    exact = (e1 == 0.0) & dense & torch.isfinite(hi2)
    return hi2, lo3, exact


def pair_max_normalized(hi: torch.Tensor, lo: torch.Tensor,
                        mask: torch.Tensor, axis: int,
                        largest: bool = True):
    """Reduce normalized (hi, lo) pairs along `axis` to the extreme REAL
    value: compare hi first, break ties on lo.  Masked-out cells never
    win; with nothing masked in the result is (-inf, 0) [(+inf, 0) for
    smallest].  Returns (hi_ext, lo_ext)."""
    if not largest:
        h2, l2 = pair_max_normalized(-hi, -lo, mask, axis, largest=True)
        return -h2, -l2
    neg = torch.tensor(float("-inf"), dtype=hi.dtype, device=hi.device)
    mh = torch.where(mask, hi, neg)
    m_hi = torch.amax(mh, dim=axis, keepdim=True)
    at_max = mask & (mh == m_hi)
    m_lo = torch.amax(torch.where(at_max, lo, neg), dim=axis, keepdim=True)
    m_lo = torch.where(torch.isfinite(m_lo), m_lo, torch.zeros_like(m_lo))
    return m_hi.squeeze(axis), m_lo.squeeze(axis)


def _total_order_key(x: torch.Tensor) -> torch.Tensor:
    """int32 key whose order is the IEEE total order of float32 `x`
    (-0.0 below +0.0), the order XLA's top-k compares in."""
    bits = x.contiguous().view(torch.int32)
    return bits ^ ((bits >> 31) & 0x7FFFFFFF)


def top_k_groups(scores: torch.Tensor, k: int, largest: bool = True):
    """Return (values, group_indices int32) of the top-k groups.

    `scores` is (num_groups,) float32.  NaN scores (empty groups) always
    lose.  Ties go to the lower index, as lax.top_k's do: a stable
    descending sort of a total-order key (torch.topk promises no tie
    order).  A winner whose value is +-inf after the NaN wash is
    reported as NaN/-1, and so is a real -inf score (+inf for
    largest=False), as in the reference.  If k > num_groups the tail is
    NaN/-1."""
    num_groups = scores.shape[0]
    inf = float("inf")
    clean = torch.where(torch.isnan(scores),
                        torch.full_like(scores, -inf if largest else inf),
                        scores)
    work = clean if largest else -clean
    kk = min(k, num_groups)
    idxs = torch.sort(_total_order_key(work), descending=True,
                      stable=True).indices[:kk]
    vals = work[idxs]
    vals = vals if largest else -vals
    invalid = torch.isinf(vals)
    vals = torch.where(invalid, torch.full_like(vals, float("nan")), vals)
    idxs = torch.where(invalid, torch.full_like(idxs, -1),
                       idxs).to(torch.int32)
    if kk < k:
        vals = torch.cat([vals, torch.full((k - kk,), float("nan"),
                                           dtype=vals.dtype,
                                           device=vals.device)])
        idxs = torch.cat([idxs, torch.full((k - kk,), -1, dtype=torch.int32,
                                           device=idxs.device)])
    return vals, idxs
