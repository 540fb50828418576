"""The traced window's arithmetic: busy time, idle gaps by host span,
the device operations that took most time."""

import pytest

from harness.trace import DeviceOp, Span, TraceData


def _trace():
    ops = [DeviceOp("k_a", 10, 20), DeviceOp("k_b", 15, 30), DeviceOp("k_a", 50, 54),
           DeviceOp("memcpy", 80, 90)]
    spans = [Span("bench.reset", 0, 12), Span("bench.upload", 12, 40), Span("bench.step", 40, 100)]
    return TraceData(ops, spans, (0, 100))


def test_busy_and_window():
    tr = _trace()
    assert tr.window_s == pytest.approx(100e-9)
    assert tr.busy_s() == pytest.approx((30 - 10 + 4 + 10) * 1e-9)


def test_idle_gaps_by_the_span_the_host_was_in():
    got = dict(_trace().idle_by_span())
    # gaps: [0,10) in reset, [30,50) in upload, [54,80) and [90,100) in step
    assert got["reset"] == pytest.approx(10e-9)
    assert got["upload"] == pytest.approx(20e-9)
    assert got["step"] == pytest.approx(36e-9)


def test_top_ops_by_summed_device_time():
    top = _trace().top_ops(2)
    assert [name for name, _ in top] == ["k_b", "k_a"]
    assert top[1][1] == pytest.approx(14e-9)


def test_device_seconds_of_one_kernel():
    assert _trace().device_seconds(lambda n: n == "k_a") == pytest.approx(14e-9)
