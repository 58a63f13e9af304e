"""Rounding through a lower precision, for the control of ``correct``.

The configurations state bfloat16 for the frontend and the tower; there the
control is the plain reference with the operands of every product (frames,
power spectrum, convolution and dense inputs and weights) rounded to float8
e4m3 under a per-tensor scale that maps the tensor's largest magnitude onto
e4m3's largest finite value, 448, as an fp8 GEMM takes them.  Sums stay in
float32.  The clustering runs in float32 with TF32 off; there the control
computes in float32 with the operands of its products rounded to TF32 (10
mantissa bits, to nearest, ties to even).
"""

from __future__ import annotations

import numpy as np
import torch

E4M3_MAX = 448.0


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to e4m3 under a per-tensor scale, back in float32."""
    scale = torch.clamp(x.detach().abs().amax(), min=1e-30) / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def tf32(x: np.ndarray) -> np.ndarray:
    """float32 ``x`` rounded to TF32's 10 mantissa bits."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    bits = (bits + np.uint32(0xFFF) + ((bits >> np.uint32(13)) & np.uint32(1))) & np.uint32(0xFFFFE000)
    return bits.view(np.float32)


PRECISIONS = {"float32": None, "fp8": fp8}
