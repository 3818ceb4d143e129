"""The roofline's byte counts and the profile arithmetic, on hand-worked cases."""
import pytest

from plarbench import counts
from plarbench.profiling import Ops, _tie_clocks, idle_gaps, top_device_ops


def test_iteration_bytes_by_hand():
    # 100 granules, 3 candidates: codes 4·100·3, ids/decisions/weights 12·100, scores 4·3
    assert counts.theta_iteration_bytes(100, 3) == 1200 + 1200 + 12


def test_remaining_candidates_and_whole_reduction():
    assert counts.remaining_per_iteration(41, 3, 4) == [38, 37, 36, 35]
    assert counts.remaining_per_iteration(5201, 0, 0) == []
    assert counts.theta_bytes(10, [2, 1]) == (80 + 120 + 8) + (40 + 120 + 4)


def test_roofline_seconds_at_the_published_peak():
    assert counts.roofline_seconds(3.35e12) == pytest.approx(1.0)
    assert counts.HBM_BYTES_PER_S == 3.35e12 and counts.F32_FLOPS_PER_S == 67e12


def test_union_and_clipping():
    ops = Ops([2.0, 0.0, 2.2], [2.5, 1.0, 3.0], [1, 0, 0], ["a", "b"])
    s, e, ids = ops.clip(0.5, 2.3)
    assert s.tolist() == [0.5, 2.0, 2.2] and e.tolist() == [1.0, 2.3, 2.3]
    assert [ops.names[i] for i in ids] == ["a", "b", "a"]
    assert ops.busy(0.0, 1.5) + ops.busy(1.5, 4.0) == pytest.approx(2.0)
    assert ops.busy(0.5, 2.3) == pytest.approx(0.8)
    assert ops.busy(0.0, 4.0) == pytest.approx(2.0)
    assert ops.seconds(0.0, 4.0, "^b$").sum() == pytest.approx(0.5)
    assert top_device_ops(ops, [(0, 3)]) == [["a", pytest.approx(1.8)], ["b", 0.5]]
    gaps = idle_gaps(ops, [(0.0, 4.0)], [("loop", 0.0, 4.0), ("inner", 1.0, 2.0)])
    assert gaps == [["inner", 1.0], ["loop", 1.0]]
    assert Ops().busy(0.0, 1.0) == 0.0 and Ops().gaps(0.0, 1.0) == [(0.0, 1.0)]


def test_clock_tie_survives_a_lost_mark():
    hosts = [0.0, 1.0, 2.0, 3.0]
    dev = [10.000004, 12.000002, 13.000003]          # the mark at host 1.0 was lost
    assert _tie_clocks(dev, hosts) == pytest.approx(10.000002)
