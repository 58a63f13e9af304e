"""The card's peaks and the work counts the per-layer metrics divide by.

Frozen copies: the data-sheet peaks and ``bound`` of
``sdtk_tpu_torch/tools/measure.py``; the analytic FLOP counts of
``sdtk_tpu_torch/evals/mfu_probe.py`` (convolutions, attention and dense
products; elementwise work left out); the log-mel kernel's (K1's) operations
and bytes as ``chip_smoke.py:k1_timing`` counts them.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates at the 700 W limit.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12


def bound_s(nbytes: float, flops: float, dtype: str = "bfloat16") -> float:
    """The least time the card could take: bytes over the HBM rate or
    operations over the peak rate of ``dtype``, whichever is larger."""
    return max(nbytes / PEAK_BYTES, flops / PEAK_FLOPS[dtype])


def kernel_frames(n: int, fe: dict) -> int:
    """Frames the log-mel kernel computes for an n-sample row, which are
    the frames the tower sees (a centred frontend's wrapper hands the kernel
    the row padded by win // 2 a side)."""
    if fe["center"]:
        n += 2 * (fe["win_length"] // 2)
    return 1 + (n - fe["win_length"]) // fe["hop_length"]


def k1_work(b: int, n: int, fe: dict) -> tuple[float, float]:
    """(bytes, operations) of one K1 launch on (b, n) samples: the samples
    and the features once, the bases and mel matrix once in the compute
    type; the windowed DFT's two products and the mel product."""
    t = kernel_frames(n, fe)
    n_in = n + (2 * (fe["win_length"] // 2) if fe["center"] else 0)
    bins = fe["n_fft"] // 2 + 1
    item = 2 if fe["compute_dtype"] == "bfloat16" else 4
    nbytes = (b * n_in * 4 + b * t * fe["n_mels"] * 4
              + (2 * fe["win_length"] * bins + bins * fe["n_mels"]) * item)
    flops = 2 * b * t * fe["win_length"] * bins * 2 + 2 * b * t * bins * fe["n_mels"]
    return float(nbytes), float(flops)


def frontend_flops_per_window(fe: dict, n_frames: int) -> float:
    bins = fe["n_fft"] // 2 + 1
    return float(n_frames * 2 * (fe["win_length"] * bins * 2 + bins * fe["n_mels"]))


def ecapa_flops_per_window(m: dict, n_frames: int) -> float:
    """Analytic multiply-adds × 2 of one window through ECAPA."""
    c, s = m["channels"], m["scale"]
    w = c // s
    f = n_frames * 5 * m["n_mels"] * c
    for _ in m["dilations"]:
        f += n_frames * c * c
        f += (s - 1) * n_frames * 3 * w * w
        f += n_frames * c * c
        f += c * m["se_bottleneck"] * 2
    f += n_frames * 3 * c * m["mfa_channels"]
    f += n_frames * 3 * m["mfa_channels"] * m["attention_channels"]
    f += n_frames * m["attention_channels"] * m["mfa_channels"]
    f += 2 * m["mfa_channels"] * m["emb_dim"]
    return 2.0 * f
