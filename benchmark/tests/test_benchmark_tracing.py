"""The device time of a span: the work launched inside it on the host
clock, on any thread, counted once (benchmark/tracing.py)."""

import pytest

from benchmark.tracing import Profile


def profile(launches, spans):
    return Profile(units=2, wall_s=1.0, busy_s=0.5, device_ops=[], gaps={},
                   launches=launches, spans=spans)


def test_work_is_counted_for_the_spans_it_was_launched_in():
    spans = [("stretch", 0, 100), ("call", 0, 50), ("call", 50, 100),
             ("step.render", 1, 10), ("binning", 4, 6),
             ("step.autograd", 20, 40), ("step.render", 51, 60),
             ("step.adam", 41, 45)]
    launches = [(2, 1e-3), (5, 2e-3), (30, 4e-3),   # render, binning, bwd
                (42, 8e-3), (52, 16e-3), (48, 32e-3)]   # adam, render, none
    p = profile(launches, spans)
    assert p.span_device_s("binning") == pytest.approx(2e-3)
    assert p.span_device_s("step.render") == pytest.approx(19e-3)
    assert p.span_device_s("step.adam") == pytest.approx(8e-3)
    assert p.span_device_s("step.render", "step.autograd") == \
        pytest.approx(23e-3)
    assert p.attributed_s == pytest.approx(63e-3)
    assert p.span_device_s("no such span") == 0


def test_a_launch_at_a_span_edge_is_inside_it():
    p = profile([(10, 1e-3), (20, 2e-3)], [("step.adam", 10, 20)])
    assert p.span_device_s("step.adam") == pytest.approx(3e-3)
