"""The trace reduction and the metric arithmetic on a canned trace."""

from types import SimpleNamespace

import pytest

from benchlib import manifest, trace, yardstick

FE = {"sample_rate": 16000, "win_length": 400, "hop_length": 160, "n_fft": 512, "n_mels": 80,
      "window": "hann", "preemphasis": 0.97, "log_floor": 1e-6, "mean_norm": True,
      "compute_dtype": "bfloat16", "log_scale": "ln", "mel_fmin": 20.0, "center": False}
MODEL = {"n_mels": 80, "channels": 512, "emb_dim": 192, "scale": 8, "se_bottleneck": 128,
         "attention_channels": 128, "mfa_channels": 1536, "dilations": [2, 3, 4],
         "dtype": "bfloat16", "mfa_bn": False, "asp_tdnn": False}


def ev(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


# a 1000 µs window: embed span launches K1 (100 µs) and a conv (300 µs); the
# cluster span a kernel of 200 µs and a copy of 50 µs that overlaps it
CANNED = [
    ev("user_annotation", "bench.window", 0, 1000),
    ev("user_annotation", "bench.embed", 10, 100),
    ev("cuda_runtime", "cudaLaunchKernel", 20, 5, corr=1),
    ev("cuda_runtime", "cudaLaunchKernel", 40, 5, corr=2),
    ev("user_annotation", "bench.cluster", 500, 100),
    ev("cuda_runtime", "cudaLaunchKernel", 510, 5, corr=3),
    ev("cuda_runtime", "cudaMemcpyAsync", 520, 5, corr=4),
    ev("cpu_op", "aten::linalg_eigh", 800, 150),
    ev("kernel", "void dft::log_mel_mma_kernel<WaveFrames, true>", 100, 100, corr=1),
    ev("kernel", "sm90_xmma_fprop", 200, 300, corr=2),
    ev("kernel", "geqrf", 550, 200, corr=3),
    ev("gpu_memcpy", "Memcpy HtoD", 700, 100, corr=4),
    ev("kernel", "outside", 1200, 50, corr=99),
]


@pytest.fixture
def tr():
    return trace.parse(CANNED)


def test_busy_idle_and_spans(tr):
    assert tr.window_s() == pytest.approx(1e-3)
    # union: [100, 500) + [550, 800) clipped to the window = 650 µs
    assert tr.busy_s() == pytest.approx(650e-6)
    assert tr.idle_gaps() == [(0.0, 100.0), (500.0, 550.0), (800.0, 1000.0)]
    assert tr.device_s(span="embed") == pytest.approx(400e-6)
    assert tr.device_s(span="embed", exclude="log_mel") == pytest.approx(300e-6)
    assert tr.device_s(span="cluster") == pytest.approx(300e-6)
    assert tr.device_s(span="cluster", kernels_only=True) == pytest.approx(200e-6)
    assert tr.span_count("cluster") == 1


def test_breakdown_names_gaps_by_the_host(tr):
    b = tr.breakdown()
    assert b["device_ops"][0] == ["sm90_xmma_fprop", pytest.approx(300e-6)]
    assert len(b["device_ops"]) == 5
    longest = b["idle_gaps"][0]
    assert longest[1] == pytest.approx(200e-6) and longest[0] == "aten::linalg_eigh"
    assert b["idle_gaps"][1][0].startswith("bench.")


def read(name, tr, work):
    return manifest.module("metrics", name).read(SimpleNamespace(trace=tr, work=work))


def test_request_spans_make_the_window():
    """Where a loop marks requests, the traced window is their time, and
    what lies between them (the load generator's work) is not idle."""
    tr = trace.parse(CANNED + [ev("user_annotation", "bench.request", 0, 400),
                               ev("user_annotation", "bench.request", 500, 400)])
    assert tr.window_s() == pytest.approx(800e-6)
    # device in [0, 400) + [500, 900): [100, 400) + [550, 800) = 550 µs
    assert tr.busy_s() == pytest.approx(550e-6)
    assert tr.idle_gaps() == [(0.0, 100.0), (500.0, 550.0), (800.0, 900.0)]
    assert tr.device_s(span="embed") == pytest.approx(400e-6)


def test_readers_on_the_canned_trace(tr):
    work = {"config": {"frontend": FE, "model": MODEL}, "k1_launches": [(2, 48000)],
            "windows": 2, "n_frames": 298, "cluster_s": [0.01, 0.03, 0.02]}
    nbytes, flops = yardstick.k1_work(2, 48000, FE)
    least = yardstick.bound_s(nbytes, flops)
    assert read("k1_roofline.batch", tr, work) == pytest.approx(100 * least / 100e-6)
    tower = 2 * yardstick.ecapa_flops_per_window(MODEL, 298)
    assert read("tower_mfu.recording", tr, work) == pytest.approx(100 * tower / 300e-6 / 989e12)
    step = tower + 2 * yardstick.frontend_flops_per_window(FE, 298)
    assert read("step_mfu.batch", tr, work) == pytest.approx(100 * step / 1e-3 / 989e12)
    assert read("cluster_ms.batch", tr, work) == pytest.approx(0.3)
    assert read("cluster_ms.recording", tr, work) == pytest.approx(20.0)
    for name in ("idle_share.batch", "idle_share.recording"):
        assert read(name, tr, work) == pytest.approx(35.0)


def test_work_counts_of_the_yardstick():
    # the probe's count for ECAPA c512 at 298 frames: 3.09 GFLOP a window
    assert yardstick.ecapa_flops_per_window(MODEL, 298) == pytest.approx(3.0906e9, rel=1e-3)
    assert yardstick.kernel_frames(48000, FE) == 298
    assert yardstick.kernel_frames(48000, dict(FE, center=True)) == 301
    nbytes, flops = yardstick.k1_work(1024, 48000, FE)
    assert flops == 2 * 1024 * 298 * 400 * 257 * 2 + 2 * 1024 * 298 * 257 * 80
    # K1 at (1024, 48 000) is bound by its operations: 0.1396 ms, the bound chip_smoke reports
    assert yardstick.bound_s(nbytes, flops) * 1e3 == pytest.approx(0.1396, rel=2e-3)
