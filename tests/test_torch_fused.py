"""The port's fused device steps (acc init -> rounds -> finalize,
storage/read.py) against the JAX package's _fused_acc_init_jit ->
_fused_round_accumulate_jit -> _fused_finalize_jit on the same seeded
round stacks: three rounds whose windows overlap in bucket range, with
`last` ties inside a round and across rounds (the later window wins).

Tolerances: count/min/max/last/last_ts exact, sum/avg within rtol 1e-5
(window partial sums fold into the accumulator in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horaedb_tpu.storage import read as ref_read
from horaedb_tpu_torch.ops.downsample import ALL_AGGS
from horaedb_tpu_torch.storage import read as port_read

BUCKET = 60_000


def _rounds(seed: int, n_rounds: int, W: int, cap: int, G: int, width: int,
            total: int):
    rng = np.random.default_rng(seed)
    out = []
    for r in range(n_rounds):
        ts = rng.integers(-BUCKET, (width + 2) * BUCKET,
                          (W, cap)).astype(np.int32)
        gid = rng.integers(-1, 6, (W, cap)).astype(np.int32)
        vals = (rng.random((W, cap)) * 100 - 50).astype(np.float32)
        remap = np.stack([rng.permutation(G).astype(np.int32)
                          for _ in range(W)])
        shift = rng.integers(0, 3 * BUCKET, W).astype(np.int32)
        # overlapping bucket ranges: every window starts within a few
        # buckets of the others, and some reach past `total`
        lo = rng.integers(0, 6, W).astype(np.int32)
        if r == 0:
            lo[:] = 2  # same span for the whole round
        # a cell whose max ts is shared by every window of every round:
        # local group 0 -> union row 1, the last ms of global bucket 5,
        # on each window's last row (tie across windows and rounds)
        for d in range(W):
            remap[d, 0] = 1
            ts[d, cap - 1] = 6 * BUCKET - 1 - int(shift[d])
            gid[d, cap - 1] = 0
            vals[d, cap - 1] = 1000.0 * (r + 1) + d
        out.append((ts, gid, vals, remap, shift, lo))
    return out


@pytest.mark.parametrize("which", [ALL_AGGS, ("avg",), ("last", "max")],
                         ids=lambda w: "-".join(w))
def test_fused_rounds_match_reference(which):
    G, W, cap, width, total = 8, 4, 512, 16, 20
    which = tuple(sorted(set(which)))
    rounds = _rounds(7, 3, W, cap, G, width, total)

    acc_r = ref_read._fused_acc_init_jit(num_groups=G, num_buckets=total,
                                         which=which)
    for ts, gid, vals, remap, shift, lo in rounds:
        acc_r = ref_read._fused_round_accumulate_jit(
            acc_r, jnp.asarray(ts), jnp.asarray(gid), jnp.asarray(vals),
            jnp.asarray(remap), jnp.asarray(shift), jnp.asarray(lo),
            jnp.int32(total), jnp.int32(BUCKET), num_groups=G, width=width,
            which=which)
    ref = {k: np.asarray(v) for k, v in
           ref_read._fused_finalize_jit(acc_r, which).items()}

    t = torch.from_numpy
    acc = port_read.fused_acc_init(num_groups=G, num_buckets=total,
                                   which=which, device="cpu")
    for ts, gid, vals, remap, shift, lo in rounds:
        port_read.fused_round_accumulate(
            acc, t(ts), t(gid), t(vals), t(remap), t(shift), t(lo), lo,
            total, BUCKET, num_groups=G, width=width, which=which)
    got = {k: v.numpy() for k, v in
           port_read.fused_finalize(acc, which).items()}

    assert sorted(got) == sorted(ref)
    for k in ref:
        if k in ("sum", "avg"):
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    if "last" in which:
        # the shared max-ts cell: the last window of the last round wins
        assert got["last"][1, 5] == 1000.0 * 3 + (W - 1)
    has_r = np.asarray(ref_read._group_has_data_jit(jnp.asarray(ref["count"])))
    has = port_read.group_has_data(torch.from_numpy(got["count"])).numpy()
    np.testing.assert_array_equal(has, has_r)


def test_fused_acc_init_identities_match_reference():
    which = tuple(sorted(ALL_AGGS))
    ref = ref_read._fused_acc_init_jit(num_groups=8, num_buckets=5,
                                       which=which)
    got = port_read.fused_acc_init(num_groups=8, num_buckets=5,
                                   which=which, device="cpu")
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))
        assert got[k].numpy().dtype == np.asarray(ref[k]).dtype
