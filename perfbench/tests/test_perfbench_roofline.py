import pytest

from perfbench import roofline

CARD = "NVIDIA H100 80GB HBM3"


def test_field_scan_work_counts_the_query():
    w = roofline.field_scan_work(1000, 43_200_000, 10_000, 3_600_000,
                                 ["avg"])
    assert w.rows == 4_320_000
    assert w.cells == 12_000
    # avg and count per cell
    assert w.bytes == 4_320_000 * 12 + 12_000 * 2 * 4
    assert w.flops == 2 * 4_320_000 + 12_000


def test_least_time_is_memory_bound():
    w = roofline.field_scan_work(1000, 43_200_000, 10_000, 3_600_000,
                                 ["avg"])
    seconds, bound = roofline.least_seconds(w, 10, CARD)
    assert bound == "memory"
    assert seconds == pytest.approx(10 * w.bytes / 3.35e12)
