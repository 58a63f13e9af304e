"""Fused waveform→log-mel frontend: the CUDA kernel and its wrapper.

The port of ``sdtk_tpu/ops/research/fbank_wave.py:log_mel_wave`` (a
Pallas kernel for the TPU).  :func:`log_mel_wave` is a drop-in for
``ops.fbank.log_mel`` — (B, N) waveform → ((B, T, n_mels) f32 feats,
(B, T) mask).  The kernel (``csrc/log_mel_wave.cu``; its header holds the
design and the bound) computes the raw log-mel; the wrapper computes the
frame mask, CMN over valid frames and the mask multiply around it, as the
TPU kernel's wrapper does.

On a CPU tensor the wrapper runs :func:`log_mel_wave_plain`, the plain
PyTorch version of the kernel's function.  On a CUDA tensor it launches
the kernel or raises; it never falls back.  ``log_mel_wave.launches``
counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import build
from ..utils.profiling import launched
from . import melbank
from .fbank import (FrontendConfig, bases, check_kernel_range, mask_for, normalize,
                    pad_centered, packed_bases, preemphasize, raw_log_mel)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I, _F, _I, _P]


def log_mel_wave_plain(x: torch.Tensor, cfg: FrontendConfig, coeff: float) -> torch.Tensor:
    """What the kernel computes, in plain PyTorch: (B, N) → (B, T, n_mels)
    raw log-mel of frames at ``center=False`` after preemphasis by
    ``coeff`` (no CMN, no mask)."""
    return raw_log_mel(preemphasize(x.float(), coeff), cfg)


def log_mel_wave_cuda(x: torch.Tensor, cfg: FrontendConfig, coeff: float) -> torch.Tensor:
    """Launch the kernel on the current stream: same contract as
    :func:`log_mel_wave_plain`, for a CUDA tensor."""
    if x.device.type != "cuda" or x.dtype != torch.float32 or x.dim() != 2:
        raise ValueError(f"expected a 2-D float32 CUDA tensor, got {x.dtype} {tuple(x.shape)} "
                         f"on {x.device}")
    check_kernel_range(cfg)
    x = x.contiguous()
    b, n = x.shape
    t = melbank.num_frames(n, cfg.win_length, cfg.hop_length)  # center=False framing
    if t <= 0:
        raise ValueError(f"signal of {n} samples is shorter than one window")
    bf16 = cfg.compute_dtype == "bfloat16"
    # bf16: the packed operands for the tensor cores; f32: wr, wi, mel as they are
    operands = ((None, None, None, packed_bases(cfg, x.device)) if bf16
                else (*bases(cfg, x.device, torch.float32), None))
    out = torch.empty((b, t, cfg.n_mels), dtype=torch.float32, device=x.device)
    build.launch(
        "log_mel_wave", _ARGTYPES,
        x.data_ptr(), *(a.data_ptr() if a is not None else None for a in operands),
        out.data_ptr(), b, n, t, cfg.hop_length, cfg.win_length, cfg.n_fft // 2 + 1, cfg.n_mels,
        float(coeff), int(cfg.log_scale == "db"), float(cfg.log_floor), int(bf16),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    launched(log_mel_wave)
    return out


def raw_log_mel_wave(x: torch.Tensor, cfg: FrontendConfig, coeff: float) -> torch.Tensor:
    """The kernel's function on ``x``'s device: the kernel for a CUDA
    tensor, :func:`log_mel_wave_plain` for a CPU one."""
    if x.device.type == "cuda":
        return log_mel_wave_cuda(x, cfg, coeff)
    if x.device.type == "cpu":
        return log_mel_wave_plain(x, cfg, coeff)
    raise ValueError(f"log_mel_wave runs on cuda or cpu, not {x.device}")


def log_mel_wave(
    x: torch.Tensor, cfg: FrontendConfig = FrontendConfig(),
    lengths: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Drop-in for ``ops.fbank.log_mel`` through the fused kernel.

    ``center=True`` keeps ``fbank.log_mel``'s semantics: the wrapper
    preemphasizes and zero-pads the signal, then runs the kernel with
    coefficient 0."""
    x = x.float()
    xk, coeff = x, cfg.preemphasis
    if cfg.center:
        xk, coeff = pad_centered(preemphasize(x, coeff), cfg), 0.0
    feats = raw_log_mel_wave(xk, cfg, coeff)
    mask = mask_for(lengths, x, feats.shape[1], cfg)
    return normalize(feats, mask, cfg), mask


log_mel_wave.launches = 0
