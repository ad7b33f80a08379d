"""The trace's reductions on synthetic timelines: the busy time is the
union of overlapping device intervals, idle gaps are named by the
shortest host operation spanning them, kernel patterns match whole
identifiers."""

import pytest

from cudabench import trace
from cudabench.trace import Op, Timeline


def _tl():
    ops = [Op(trace.WINDOW, 0.0, 10.0, False, "host"),
           Op("step", 0.0, 10.0, False, "host"),
           Op("aten::item", 4.0, 6.0, False, "host"),
           Op("k_a", 1.0, 3.0, True, "kernel"),
           Op("k_b", 2.0, 4.0, True, "kernel"),      # overlaps k_a
           Op("k_c", 2.5, 3.5, True, "kernel"),      # inside both
           Op("Memcpy HtoD", 6.0, 7.0, True, "memcpy"),
           Op("k_a", 8.0, 9.0, True, "kernel")]
    return Timeline(ops, steps=2)


def test_union_of_overlapping_intervals():
    assert trace.union([(1, 3), (2, 4), (2.5, 3.5), (6, 7)]) == [(1, 4),
                                                                (6, 7)]


def test_busy_idle_and_launches():
    s = trace.summarize(_tl())
    assert s["busy_s"] == pytest.approx(3.0 + 1.0 + 1.0)
    assert s["window_s"] == pytest.approx(10.0)
    assert s["idle_share"] == pytest.approx(0.5)
    assert s["launches"] == 4
    assert s["kernels"]["k_a"] == (pytest.approx(3.0), 2)


def test_gaps_named_by_the_host():
    s = trace.summarize(_tl())
    gaps = dict(s["breakdown"]["idle_gaps"])
    # gaps 0-1, 4-6, 7-8, 9-10; 4-6 lies inside aten::item
    assert gaps["aten::item"] == pytest.approx(2.0)
    assert gaps["step"] == pytest.approx(3.0)
    ops = dict(s["breakdown"]["device_ops"])
    assert ops["k_a"] == pytest.approx(3.0)


def test_kernel_patterns_match_whole_identifiers():
    kernels = {"(anonymous namespace)::zband_grid_fwd_kernel(float)": (1.0, 2),
               "band_grid_fwd_kernel(float const*)": (0.5, 3)}
    assert trace.matching(kernels, "band_grid_fwd_kernel") == (0.5, 3)
    assert trace.matching(kernels, "zband_grid_fwd_kernel") == (1.0, 2)
