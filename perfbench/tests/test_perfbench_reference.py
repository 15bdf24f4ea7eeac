import numpy as np

from perfbench.reference import tsbs_downsample


def brute(values, lo, window, bucket, start, interval):
    hosts, ticks = values.shape
    nb = -(-window // bucket)
    sums = np.zeros((hosts, nb))
    count = np.zeros((hosts, nb), dtype=np.int64)
    for h in range(hosts):
        for t in range(ticks):
            ts = start + t * interval
            if lo <= ts < lo + window:
                b = (ts - lo) // bucket
                sums[h, b] += values[h, t]
                count[h, b] += 1
    with np.errstate(invalid="ignore"):
        return sums / count, count


def test_reference_matches_a_loop():
    rng = np.random.default_rng(1)
    values = rng.random((4, 200)) * 100
    for lo, window, bucket in [(1_000, 600_000, 60_000),
                               (123_000, 1_000_000, 300_000),
                               (-50_000, 400_000, 70_000),
                               (1_900_000, 600_000, 60_000)]:
        got = tsbs_downsample.downsample(values, lo, window, bucket, 0,
                                         10_000)
        want_avg, want_count = brute(values, lo, window, bucket, 0, 10_000)
        assert set(got) == {"avg", "count"}
        np.testing.assert_array_equal(got["count"], want_count)
        np.testing.assert_allclose(got["avg"], want_avg, rtol=1e-12)


def test_bfloat16_rounding():
    x = np.array([1.0, 1.00390625, 1.005859375, 100.3, 0.0], np.float32)
    got = tsbs_downsample.to_bfloat16(x)
    # 8 significant bits: ties go to the even neighbour
    np.testing.assert_array_equal(got[:3], [1.0, 1.0, 1.0078125])
    assert abs(got[3] - 100.3) <= 0.25 and got[4] == 0.0


def brute_extremes(values, hosts, lo, window, bucket, start, interval):
    nb = -(-window // bucket)
    hi = np.full((len(hosts), nb), -np.inf)
    low = np.full((len(hosts), nb), np.inf)
    for j, h in enumerate(hosts):
        for t in range(values.shape[1]):
            ts = start + t * interval
            if lo <= ts < lo + window:
                b = (ts - lo) // bucket
                hi[j, b] = max(hi[j, b], values[h, t])
                low[j, b] = min(low[j, b], values[h, t])
    return hi, low


def test_max_and_min_over_a_host_subset_match_a_loop():
    rng = np.random.default_rng(2)
    values = rng.random((9, 200)) * 100
    hosts = np.array([7, 2, 5])
    # the last window runs past the data: its late buckets are empty
    for lo, window, bucket in [(1_000, 600_000, 60_000),
                               (-50_000, 400_000, 70_000),
                               (1_900_000, 600_000, 60_000)]:
        got = tsbs_downsample.downsample(values, lo, window, bucket, 0,
                                         10_000, aggs=("max", "min"),
                                         hosts=hosts)
        hi, low = brute_extremes(values, hosts, lo, window, bucket, 0,
                                 10_000)
        assert set(got) == {"max", "min", "count"}
        np.testing.assert_array_equal(got["max"], hi)
        np.testing.assert_array_equal(got["min"], low)
    assert np.isneginf(got["max"][:, -1]).all()
    assert np.isposinf(got["min"][:, -1]).all()
    assert (got["count"][:, -1] == 0).all()
