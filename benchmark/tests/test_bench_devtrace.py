"""The device trace's arithmetic on a hand-built trace: busy time, the
top operations, the kernels the profiler lost, the labelled idle gaps,
and a roofline share that a lost event silences."""

import pytest

import devtrace
import roofline

TRACE = {"device": [("sweep_kernel<a>", 0.0, 10.0), ("copy", 5.0, 12.0),
                    ("sweep_kernel<a>", 15.0, 20.0)],
         "ranges": [("frame.all", 0.0, 50.0), ("frame.primary", 0.0, 14.0),
                    ("frame.poll", 14.0, 50.0)]}
COUNTED = [("sweep_kernel<", ("sweep_blocks", "sweep_blocks_anyhit"))]


def test_busy_time_is_the_union_of_device_intervals():
    assert devtrace.busy_seconds(TRACE) == pytest.approx(17e-6)
    assert devtrace.top_ops(TRACE) == [["sweep_kernel<a>", pytest.approx(
        15e-6)], ["copy", pytest.approx(7e-6)]]


def test_idle_gaps_are_labelled_by_the_host_s_step():
    assert devtrace.idle_gaps(TRACE) == [
        ["frame.poll", pytest.approx(30e-6)],
        ["frame.primary", pytest.approx(3e-6)]]


def test_a_lost_kernel_is_named_and_silences_the_share():
    assert devtrace.lost_events(TRACE, {"sweep_blocks": 2}, COUNTED) == []
    lost = devtrace.lost_events(TRACE, {"sweep_blocks": 1,
                                        "sweep_blocks_anyhit": 2}, COUNTED)
    assert lost == ["sweep_kernel< seen 2, launched 3"]
    peaks = {"bytes_per_s": 3.35e12, "flops_per_s": 67e12}
    rec = {"profile": {"trace": TRACE, "launches": {"sweep_blocks": 2},
                       "traces": [(1000, 10)], "whole": True}}
    share = roofline.kernel_share(rec, ("sweep_kernel<",), COUNTED[0][1],
                                  peaks)
    assert share == pytest.approx(
        100 * (1000 * 48 + 10 * 48) / 3.35e12 / 15e-6)
    rec["profile"]["whole"] = False
    assert roofline.kernel_share(rec, ("sweep_kernel<",), COUNTED[0][1],
                                 peaks) is None
