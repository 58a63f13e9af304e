"""Device time from a ``torch.profiler`` trace (``tools/measure.py``,
``chip_smoke.py:device_ms``): a trace that dropped some launches of a
kernel reads low, so it is left out.  The traces are stood in for, so the
CPU runs these."""

import importlib.util
from pathlib import Path

import pytest

from sdtk_tpu_torch.tools import measure

REPO = Path(__file__).resolve().parent.parent
WHOLE = [("log_mel_wave_kernel", 9500.0, 20), ("Memcpy HtoD", 1000.0, 20)]
DROPPED = [("log_mel_wave_kernel", 475.0, 1), ("Memcpy HtoD", 1000.0, 20)]  # 19 of 20 lost


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _traces(monkeypatch, *traces):
    it = iter(traces)
    monkeypatch.setattr(measure, "traced_kernels", lambda fn, reps: next(it))


@pytest.mark.parametrize("traces,want", [
    ((WHOLE, WHOLE), 10500 / 20 / 1e3),
    ((DROPPED, WHOLE), 10500 / 20 / 1e3),
    ((WHOLE, DROPPED), 10500 / 20 / 1e3),
    ((DROPPED, DROPPED), "not measured"),
], ids=["whole", "first-dropped", "second-dropped", "both-dropped"])
def test_device_ms_total_leaves_out_a_trace_that_dropped_launches(monkeypatch, traces, want):
    _traces(monkeypatch, *traces)
    got = measure.device_ms_total(None, reps=20)
    assert got == (pytest.approx(want) if isinstance(want, float) else want)


@pytest.mark.parametrize("traces,want", [
    ((WHOLE,), 9500 / 20 / 1e3),
    ((DROPPED, DROPPED, WHOLE), 9500 / 20 / 1e3),
    ((DROPPED, DROPPED, DROPPED), "not measured"),
    (([("other", 10.0, 20)],) * 3, "not measured"),
], ids=["whole", "third-whole", "all-dropped", "no-device-time"])
def test_chip_smoke_device_ms_retakes_a_trace_that_dropped_launches(monkeypatch, traces, want):
    _traces(monkeypatch, *traces)
    got = _chip_smoke().device_ms(None, "log_mel_", reps=20)
    assert got == (pytest.approx(want) if isinstance(want, float) else want)


def test_whole():
    assert measure.whole(WHOLE, 20) and measure.whole([("k", 1.0, 60)], 20)
    assert not measure.whole(DROPPED, 20) and measure.whole([], 20)
