"""The arithmetic of the benchmark's numbers on made-up readings."""
import math
import statistics

import pytest

from perfbench import readings, stats
from perfbench.spans import between_ms, span_ms


def test_rate():
    assert stats.rate(120, 40.0) == 3.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


@pytest.mark.parametrize("values,q,want", [
    ([5, 1, 4, 2, 3, 6, 8, 7, 10, 9], 90, 9),
    (list(range(1, 101)), 90, 90),
    (list(range(1, 102)), 90, 91),
    ([1.0], 90, 1.0),
    ([1, 2, 3, math.inf], 90, math.inf),
])
def test_percentile(values, q, want):
    assert stats.percentile(values, q) == want


def test_failed_request_counts_as_slowest():
    walls = [0.2] * 95 + [math.inf] * 5
    assert stats.percentile(walls, 90) == 0.2
    assert stats.percentile(walls, 96) == math.inf


def test_spread_uses_statistics_quartiles():
    v = [10.0, 10.2, 9.9, 10.4, 10.1, 9.7]
    q1, med, q3 = statistics.quantiles(v, n=4)
    assert stats.spread(v) == pytest.approx((q3 - q1) / med)


@pytest.mark.parametrize("intervals,want", [
    ([(0, 1), (2, 3)], 2),
    ([(0, 2), (1, 3)], 3),
    ([(0, 5), (1, 2), (3, 4)], 5),
    ([(3, 4), (0, 1), (0.5, 1.5)], 2.5),
    ([], 0),
])
def test_busy_union(intervals, want):
    assert stats.union_length(intervals) == pytest.approx(want)


def test_gaps():
    assert stats.gaps([(1, 2), (3, 5), (4, 6)], 0, 8) == [(0, 1), (2, 3), (6, 8)]
    assert stats.gaps([], 0, 1) == [(0, 1)]


def test_idle_share():
    run = {"profile": {"busy_s": 0.6, "window_s": 1.0, "calls": 3},
           "step_s": 0.25}
    assert readings.idle_share(run) == pytest.approx(20.0)
    served = {"profile": {"busy_s": 0.3, "window_s": 1.0, "calls": 2},
              "walls": [0.2, 0.2, math.inf]}
    assert readings.idle_share(served) == pytest.approx(25.0)
    assert readings.idle_share({"profile": {"busy_s": 0.0, "window_s": 1.0,
                                            "calls": 1}, "step_s": 1.0}) is None
    assert readings.idle_share({"step_s": 1.0}) is None


def test_spans_of_a_row():
    row = [("begin", 0.0), ("attention.start", 1.0), ("attention.end", 4.0),
           ("mark.forward_loss", 5.0), ("mark.backward", 7.5),
           ("mark.forward_loss", 8.0), ("mark.backward", 9.0)]
    assert span_ms(row, "attention") == 3.0
    assert between_ms(row, "mark.forward_loss", "mark.backward") == 3.5
    run = {"rows": [row, row]}
    assert readings.span_mean(run, "attention") == 3.0
    assert readings.span_mean(run, "pyramid") is None


def test_roofline_share():
    assert readings.share(0.001, 10.0) == pytest.approx(10.0)
    assert readings.share(0.001, None) is None


def test_device_annotations_are_no_work():
    from types import SimpleNamespace

    from perfbench.spans import _annotation

    assert _annotation(SimpleNamespace(name="attention", is_user_annotation=False),
                       {"attention"})
    assert _annotation(SimpleNamespace(name="Optimizer.step#Adam.step",
                                       is_user_annotation=True), set())
    assert not _annotation(SimpleNamespace(name="sm90_xmma_gemm",
                                           is_user_annotation=False), {"attention"})
