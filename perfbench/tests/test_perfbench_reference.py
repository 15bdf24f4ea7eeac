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
        avg, count = tsbs_downsample.downsample(values, lo, window, bucket,
                                                0, 10_000)
        want_avg, want_count = brute(values, lo, window, bucket, 0, 10_000)
        np.testing.assert_array_equal(count, want_count)
        np.testing.assert_allclose(avg, want_avg, rtol=1e-12)


def test_bfloat16_rounding():
    x = np.array([1.0, 1.00390625, 1.005859375, 100.3, 0.0], np.float32)
    got = tsbs_downsample.to_bfloat16(x)
    # 8 significant bits: ties go to the even neighbour
    np.testing.assert_array_equal(got[:3], [1.0, 1.0, 1.0078125])
    assert abs(got[3] - 100.3) <= 0.25 and got[4] == 0.0
