"""The port's device merge (horaedb_tpu_torch/ops/merge.py) against the
JAX package's (horaedb_tpu/ops/merge.py) on the same seeded inputs:
kway_merge_perm_plain byte for byte against kway_merge_perm (whose pad
bit the port derives from n_valid) and against np.lexsort; lex_sort
against jax.lax.sort with the row index as the final key;
runs_lex_sorted_np against the reference; and the wrapper's dispatch
and build on the CPU.  The CUDA kernel itself runs only on the card
(chip_smoke.py holds it against kway_merge_perm_plain there)."""

import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from horaedb_tpu.ops import merge as ref_merge
from horaedb_tpu_torch.common.error import Error
from horaedb_tpu_torch.ops import device_decode, merge, nvcc

I32_LO, I32_HI = -(2**31), 2**31 - 1


def _runs_case(seed: int, real_runs: int, *, max_len=40, empty=False,
               ties=False, extremes=False, nkeys=3, lens=None, layout=None):
    """Presorted runs of int32 keys, the pad zone as its own run, padded
    to a power of two with empty runs (ops/device_decode.plan_dispatch's
    layout).  `lens` fixes the run lengths.  `layout` cuts one sorted
    sequence into the runs: "in order" (each run above the one before),
    "reverse" (each below it) or "junction" (in order, each run starting
    with the row that ends the one before); "tie block" gives every run
    equal keys but for 3 low rows at its head and 3 high rows at its
    tail, so each pair still merges.  Returns (keys (nkeys, cap),
    offsets, num_runs, n)."""
    rng = np.random.default_rng(seed)
    lens = (rng.integers(1, max_len, real_runs) if lens is None
            else np.asarray(lens, np.int64))
    if empty:
        lens[rng.random(real_runs) < 0.4] = 0
    n = int(lens.sum())
    cap = max(128, 1 << max(0, n - 1).bit_length())
    hi = 2 if ties else 50
    bounds = np.cumsum(lens)[:-1]
    if layout in ("in order", "reverse", "junction"):
        rows = rng.integers(-hi, hi, (n, nkeys)).astype(np.int32)
        rows = rows[np.lexsort(rows.T[::-1])]
        if layout == "junction":
            rows[bounds] = rows[bounds - 1]
        if layout == "reverse":  # run r takes the r-th slice from the top
            runs = [r[::-1] for r in np.split(rows[::-1], bounds)]
        else:
            runs = np.split(rows, bounds)
    else:
        runs = []
        for length in lens:
            k = rng.integers(-hi, hi, (int(length), nkeys)).astype(np.int32)
            if extremes:
                k[:, 0] = rng.choice(np.array([I32_LO, I32_HI, 0], np.int32),
                                     int(length))
            if layout == "tie block":
                k[:] = 0
                k[:3, 0], k[-3:, 0] = -1, 1
            runs.append(k[np.lexsort(k.T[::-1])])
    keys = np.zeros((cap, nkeys), np.int32)
    if n:
        keys[:n] = np.concatenate(runs)
    # the pad zone holds unsorted garbage: the pad bit must sink it whole
    keys[n:] = rng.integers(-hi, hi, (cap - n, nkeys))
    num_runs = 1 << max(1, real_runs).bit_length()
    offs = np.full(num_runs + 1, cap, np.int32)
    offs[:real_runs + 1] = np.concatenate([[0], np.cumsum(lens)])
    offs[real_runs] = n
    return np.ascontiguousarray(keys.T), offs, num_runs, n


def _config1_case(series=6, ticks=720, split=640):
    """BASELINE config 1's two-SST segment at a few series: the data
    table's merge keys (metric_id, tsid, field_id, timestamp, __seq__),
    run 0 every series' first `split` ticks and run 1 the rest, each in
    (series, tick) order, so the merged rows interleave the runs by
    series; then the pad zone and an empty run."""
    runs = []
    for r, (t0, t1) in enumerate(((0, split), (split, ticks))):
        m = series * (t1 - t0)
        runs.append(np.stack([
            np.zeros(m, np.int32),
            np.repeat(np.arange(series, dtype=np.int32), t1 - t0),
            np.zeros(m, np.int32),
            np.tile(np.arange(t0, t1, dtype=np.int32) * 10_000, series),
            np.full(m, r, np.int32)]))
    n = series * ticks
    cap = 1 << (n - 1).bit_length()
    keys = np.zeros((5, cap), np.int32)
    keys[:, :n] = np.concatenate(runs, axis=1)
    return keys, np.array([0, series * split, n, cap, cap], np.int32), 4, n


T = merge.TILE
CASES = {
    "2 runs": dict(real_runs=2),
    "3 runs": dict(real_runs=3),
    "4 runs": dict(real_runs=4),
    "7 runs": dict(real_runs=7),
    "63 runs": dict(real_runs=63, max_len=8),
    "empty runs": dict(real_runs=6, empty=True),
    "ties across runs": dict(real_runs=5, ties=True),
    "int32 extremes": dict(real_runs=4, extremes=True),
    "one key": dict(real_runs=3, nkeys=1, ties=True),
    # the shapes the tiled kernel treats apart (chip_smoke.py runs the
    # same kinds on the card)
    "pairs in order": dict(real_runs=5, max_len=900, layout="in order"),
    "pairs in reverse": dict(real_runs=5, max_len=900, layout="reverse"),
    "pairs equal at the junction": dict(real_runs=5, max_len=900,
                                        layout="junction"),
    "runs of TILE-1, TILE, TILE+1, 2 TILE+3": dict(
        real_runs=4, lens=[T - 1, T, T + 1, 2 * T + 3]),
    "a tile of equal keys across two runs": dict(
        real_runs=2, lens=[T + 500, T + 700], layout="tie block"),
    "config 1 layout": "config 1",
    "64 runs over several tiles": dict(real_runs=64, max_len=200),
}


@pytest.mark.parametrize("name", list(CASES))
def test_kway_plain_matches_reference_byte_for_byte(name):
    if CASES[name] == "config 1":
        keys, offs, num_runs, n = _config1_case()
    else:
        keys, offs, num_runs, n = _runs_case(sum(map(ord, name)),
                                             **CASES[name])
    cap = keys.shape[1]
    pad = (np.arange(cap) >= n).astype(np.int32)
    want = np.asarray(ref_merge.kway_merge_perm(
        (jnp.asarray(pad),) + tuple(jnp.asarray(k) for k in keys), offs,
        num_runs=num_runs))
    got = merge.kway_merge_perm(
        tuple(torch.from_numpy(k) for k in keys), torch.from_numpy(offs),
        num_runs=num_runs, n_valid=n)
    assert got.dtype == torch.int32
    assert got.numpy().tobytes() == want.astype(np.int32).tobytes()
    # and the stable sort by (pad, keys..., row) on the valid prefix
    order = np.lexsort((np.arange(cap),) + tuple(keys[::-1]) + (pad,))
    assert np.array_equal(got.numpy()[:n], order[:n])
    assert sorted(got.numpy().tolist()) == list(range(cap))


def test_kway_one_run_is_the_identity():
    keys, offs, _num_runs, n = _runs_case(5, 1)
    got = merge.kway_merge_perm(
        tuple(torch.from_numpy(k) for k in keys),
        torch.from_numpy(offs[[0, 2]].copy()), num_runs=1, n_valid=n)
    assert np.array_equal(got.numpy(), np.arange(keys.shape[1]))


@pytest.mark.parametrize("num_keys", [1, 2, 3])
def test_lex_sort_matches_lax_sort_with_row_key(num_keys):
    rng = np.random.default_rng(num_keys)
    n = 500
    ops = [rng.integers(-3, 3, n).astype(np.int32) for _ in range(num_keys)]
    ops += [rng.integers(I32_LO, I32_HI, n, dtype=np.int64).astype(np.int32),
            rng.random(n).astype(np.float32)]
    iota = np.arange(n, dtype=np.int32)
    ref = jax.lax.sort(tuple(jnp.asarray(o) for o in ops[:num_keys])
                       + (jnp.asarray(iota),)
                       + tuple(jnp.asarray(o) for o in ops[num_keys:]),
                       num_keys=num_keys + 1)
    ref = [np.asarray(r) for r in ref[:num_keys] + ref[num_keys + 1:]]
    got = merge.lex_sort(tuple(torch.from_numpy(o) for o in ops),
                         num_keys=num_keys)
    for r, g in zip(ref, got):
        assert g.numpy().tobytes() == r.tobytes()


@pytest.mark.parametrize("seed", range(6))
def test_runs_lex_sorted_np_agrees_with_reference(seed):
    rng = np.random.default_rng(seed)
    keys, offs, _num_runs, n = _runs_case(seed, 4, ties=True)
    cols = [k[:n] for k in keys]
    real = np.concatenate([offs[:4], [n]]).astype(np.int64)
    if seed % 2:  # break one run's order
        i = int(rng.integers(0, max(1, n - 1)))
        cols[0] = cols[0].copy()
        cols[0][i], cols[0][i + 1] = 5, -5
    assert merge.runs_lex_sorted_np(cols, real) \
        == ref_merge.runs_lex_sorted_np(cols, real)
    if seed % 2 == 0:
        assert merge.runs_lex_sorted_np(cols, real)


def test_wrapper_runs_plain_only_for_cpu_tensors():
    keys, offs, num_runs, n = _runs_case(7, 3)
    before = merge.LAUNCHES["kway_merge_perm"]
    tk = tuple(torch.from_numpy(k) for k in keys)
    merge.kway_merge_perm(tk, torch.from_numpy(offs), num_runs=num_runs,
                          n_valid=n)
    assert merge.LAUNCHES["kway_merge_perm"] == before
    with pytest.raises(Error, match="cuda or cpu"):
        merge.kway_merge_perm(tuple(k.to("meta") for k in tk),
                              torch.from_numpy(offs).to("meta"),
                              num_runs=num_runs, n_valid=n)
    with pytest.raises(Error, match="power of two"):
        merge.kway_merge_perm(tk, torch.from_numpy(offs[:4].copy()),
                              num_runs=3, n_valid=n)
    with pytest.raises(Error, match="run_offsets"):
        merge.kway_merge_perm(tk, torch.from_numpy(offs).long(),
                              num_runs=num_runs, n_valid=n)


def test_python_mirrors_equal_the_kernel_defines():
    with open(merge.SOURCE) as f:
        defs = dict(re.findall(r"^#define (\w+) (.+)$", f.read(), re.M))
    for name in ("MAX_KEYS", "MAX_RUNS", "THREADS", "ITEMS"):
        assert int(defs[name]) == getattr(merge, name), name
    assert defs["TILE"] == "(THREADS * ITEMS)"
    assert merge.TILE == merge.THREADS * merge.ITEMS
    # the k-way route's most runs, plus the pad zone, padded to a power
    # of two, fit the kernel
    assert 1 << device_decode._KWAY_MAX_RUNS.bit_length() <= merge.MAX_RUNS


def test_build_targets_hopper_and_keys_the_library_by_source(tmp_path):
    cmd = nvcc.nvcc_command(merge.SOURCE, "out.so")
    assert cmd[cmd.index("-gencode") + 1] == "arch=compute_90a,code=sm_90a"
    assert cmd[-1] == merge.SOURCE and merge.SOURCE.endswith("merge_path.cu")
    src = tmp_path / "k.cu"
    src.write_text("// one")
    first = nvcc.library_path(str(src))
    src.write_text("// two")
    assert nvcc.library_path(str(src)) != first
    assert first.startswith(nvcc.BUILD_DIR)
    assert "libk_" in first
