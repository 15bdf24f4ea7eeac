import numpy as np

from perfbench import tsbs


def test_shapes_tags_and_value_sets():
    cfg = tsbs.TsbsConfig(num_hosts=50, span_ms=3_600_000, seed=3)
    d = tsbs.generate(cfg)
    assert d.values.shape == (10, 50, 360)
    assert d.fields == tsbs.CPU_FIELDS
    assert list(d.tags) == tsbs.TAG_KEYS
    for h in range(50):
        t = d.host_tags(h)
        assert t["hostname"] == f"host_{h}"
        assert t["datacenter"] in tsbs.DATACENTERS[t["region"]]
        for k, choices in tsbs.CHOICES.items():
            assert t[k] in choices
    assert d.values.min() >= 0.0 and d.values.max() <= 100.0
    # a clamped walk of N(0, 1) steps
    steps = np.diff(d.values, axis=2)
    assert 0.7 < steps.std() < 1.1


def test_seed_fixes_data_and_sizes():
    cfg = lambda s: tsbs.TsbsConfig(num_hosts=20, span_ms=600_000, seed=s)
    a, b, c = (tsbs.generate(cfg(s)) for s in (5, 5, 2**40 + 5))
    np.testing.assert_array_equal(a.values, b.values)
    assert all((a.tags[k] == b.tags[k]).all() for k in tsbs.TAG_KEYS)
    assert a.values.shape == c.values.shape
    assert not np.array_equal(a.values, c.values)
