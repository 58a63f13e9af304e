"""The tower's epilogue after a convolution: the CUDA kernel and its wrapper.

After each convolution of ECAPA's ``TdnnBlock``, each Res2 split, the MFA
and SpeechBrain's attention TDNN, the eager tower runs ReLU, a cast to f32,
eval BatchNorm, a cast back to bf16, the mask's cast and the mask multiply
(and, after a Res2 split, the next split's add).  On the serving route
(``models/ecapa.py``) one launch of ``csrc/tower_epilogue.cu`` does all of
it; its header holds the design and the bound.  The kernel replaces no TPU
kernel: XLA fuses the chain on the TPU.

BatchNorm enters as the per-channel f32 ``(scale, shift)`` of
:func:`bn_affine`, the constants PyTorch's eval ``batch_norm`` applies on
the CPU, so the plain version below gives the eager chain's bits there.

On a CPU tensor :func:`tower_epilogue` runs :func:`tower_epilogue_plain`;
on a CUDA tensor it launches the kernel or raises, never falling back.
``tower_epilogue.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import build
from ..utils.profiling import launched

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_P, _P, _P, _P, _P, _L, _P, _L, _P, _I, _I, _I, _P]


def bn_affine(mean: torch.Tensor, var: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
              eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Eval BatchNorm as f32 ``(scale, shift)``, as PyTorch's CPU
    ``batch_norm`` forms them: scale = weight · (1 / √(var + ε)), each step
    rounded to f32, and shift = bias − mean · scale rounded once (its fma).
    Each step runs in f64 and rounds to f32, which gives the correctly
    rounded f32 result (f64 holds more than twice f32's digits) on any
    device, where a vectorized f32 ``sqrt`` may miss it by an ulp."""
    d = torch.float64
    root = torch.sqrt((var.float() + eps).to(d)).float()
    scale = (weight.to(d) * (1.0 / root.to(d)).float().to(d)).float()
    shift = (bias.to(d) - mean.to(d) * scale.to(d)).float()
    return scale, shift


def tower_epilogue_plain(y: torch.Tensor, mask: torch.Tensor | None = None,
                         scale: torch.Tensor | None = None, shift: torch.Tensor | None = None,
                         out: torch.Tensor | None = None, add: torch.Tensor | None = None):
    """What the kernel computes, in plain PyTorch, for (B, C, T) ``y``:
    ReLU, then ``y · scale + shift`` in f32 rounded once to y's dtype
    (``scale`` None: no BatchNorm), then times the (B, T) bool ``mask``
    (None: no mask).  Written into ``out`` when given (a (B, C, T) view),
    else into a new tensor.  With ``add`` ((B, C, T)), returns
    ``(out, add + out)``, else ``out``."""
    e = torch.relu(y)
    if scale is not None:
        e = (e.double() * scale.double()[:, None] + shift.double()[:, None]).float().to(y.dtype)
    if mask is not None:
        e = e * mask[:, None, :].to(e.dtype)
    if out is None:
        out = e
    else:
        out.copy_(e)
    return out if add is None else (out, add + out)


def _check(name: str, t: torch.Tensor, shape: tuple, dtype: torch.dtype, inner: bool) -> None:
    """``t`` has ``shape`` and ``dtype`` on the card, and is contiguous
    (``inner``: inside each batch row, any batch stride)."""
    ok = (t.device.type == "cuda" and t.dtype == dtype and tuple(t.shape) == shape
          and (t.is_contiguous() if not inner
               else t.dim() == 3 and t.stride(2) == 1 and t.stride(1) == shape[2]))
    if not ok:
        raise ValueError(f"tower_epilogue: {name} must be {dtype} {shape} on cuda, "
                         f"{'row-contiguous' if inner else 'contiguous'}; got {t.dtype} "
                         f"{tuple(t.shape)} stride {t.stride()} on {t.device}")


def tower_epilogue_cuda(y: torch.Tensor, mask: torch.Tensor | None = None,
                        scale: torch.Tensor | None = None, shift: torch.Tensor | None = None,
                        out: torch.Tensor | None = None, add: torch.Tensor | None = None):
    """Launch the kernel on the current stream: same contract as
    :func:`tower_epilogue_plain`, for a bf16 CUDA ``y`` (``y`` and ``mask``
    made contiguous);
    ``out`` and ``add`` may be channel slices of wider buffers."""
    if y.dim() != 3:
        raise ValueError(f"tower_epilogue: y must be (B, C, T), got {tuple(y.shape)}")
    y = y.contiguous()
    b, c, t = y.shape
    _check("y", y, (b, c, t), torch.bfloat16, False)
    if mask is not None:
        mask = mask.contiguous()
        _check("mask", mask, (b, t), torch.bool, False)
    if (scale is None) != (shift is None):
        raise ValueError("tower_epilogue: scale and shift go together")
    if scale is not None:
        _check("scale", scale, (c,), torch.float32, False)
        _check("shift", shift, (c,), torch.float32, False)
    if out is None:
        out = torch.empty_like(y)
    _check("out", out, (b, c, t), torch.bfloat16, True)
    total = None
    if add is not None:
        _check("add", add, (b, c, t), torch.bfloat16, True)
        total = torch.empty_like(y)

    def ptr(x):
        return x.data_ptr() if x is not None else None

    build.launch("tower_epilogue", _ARGTYPES, y.data_ptr(), ptr(scale), ptr(shift), ptr(mask),
                 out.data_ptr(), out.stride(0), ptr(add), add.stride(0) if add is not None else 0,
                 ptr(total), b, c, t, torch.cuda.current_stream(y.device).cuda_stream)
    launched(tower_epilogue)
    return out if add is None else (out, total)


def tower_epilogue(y: torch.Tensor, mask: torch.Tensor | None = None,
                   scale: torch.Tensor | None = None, shift: torch.Tensor | None = None,
                   out: torch.Tensor | None = None, add: torch.Tensor | None = None):
    """The epilogue on ``y``'s device: the kernel for a CUDA tensor,
    :func:`tower_epilogue_plain` for a CPU one."""
    if y.device.type == "cuda":
        return tower_epilogue_cuda(y, mask, scale, shift, out, add)
    if y.device.type == "cpu":
        return tower_epilogue_plain(y, mask, scale, shift, out, add)
    raise ValueError(f"tower_epilogue runs on cuda or cpu, not {y.device}")


tower_epilogue.launches = 0
