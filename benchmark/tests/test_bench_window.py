"""How a window's device time per call is summarised in the result."""

from __future__ import annotations

import pytest

from benchmark import harness


def test_a_slow_start_is_measured():
    calls = [13.0] * 100 + [12.35] * 300
    lv = harness.call_levels(calls)
    assert lv["device_ms_p10"] == pytest.approx(12.35)
    assert lv["device_ms_p90"] == pytest.approx(13.0)
    assert lv["slow_share"] == pytest.approx(0.25)
    assert lv["last_slow_s"] == pytest.approx(1.3)


def test_a_steady_window_reads_no_slow_calls():
    lv = harness.call_levels([10.6, 10.61, 10.59] * 50)
    assert lv["slow_share"] == 0.0 and lv["last_slow_s"] == 0.0


def test_too_few_calls_give_nothing():
    assert harness.call_levels([]) is None
    assert harness.call_levels([1.0] * 9) is None
