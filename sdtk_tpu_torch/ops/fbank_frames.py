"""Log-mel from materialized frames: the CUDA kernel and its wrapper.

The port of the Pallas kernel
``sdtk_tpu/ops/research/fbank_frames.py:fbank_frames_pallas`` and its
wrapper ``log_mel_fused``.  :func:`fbank_frames` maps (M, win) frames to
(M, n_mels) log-mel (``csrc/fbank_frames.cu``; its header holds the design
and the bound).  It computes what the JAX function computes, including
what that function hard-codes whatever ``cfg`` says: the mel bank at
``mel_filterbank``'s default ``fmin`` of 20 Hz, and the natural log.
:func:`log_mel_fused` frames at ``center=False``, as the JAX wrapper does.
No serving path calls it; the diarizer and the backends use the
waveform kernel (``ops/fbank_wave.py``).

On a CPU tensor :func:`fbank_frames` runs :func:`fbank_frames_plain`; on a
CUDA tensor it launches the kernel or raises.  ``fbank_frames.launches``
counts kernel launches.
"""

from __future__ import annotations

import ctypes
from dataclasses import replace

import torch

from ..utils import build
from ..utils.profiling import launched
from .fbank import (FrontendConfig, bases, check_kernel_range, mask_for, normalize,
                    packed_bases, preemphasize)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P]
JAX_MEL_FMIN = 20.0  # fbank_frames_pallas builds its mel bank at this fmin


def _jax_cfg(cfg: FrontendConfig) -> FrontendConfig:
    return replace(cfg, mel_fmin=JAX_MEL_FMIN)


def _bases(cfg: FrontendConfig, device: torch.device, dtype: torch.dtype):
    return bases(_jax_cfg(cfg), device, dtype)


def fbank_frames_plain(frames: torch.Tensor, cfg: FrontendConfig = FrontendConfig()
                       ) -> torch.Tensor:
    """What the kernel computes, in plain PyTorch: frames rounded to the
    compute type, windowed DFT summed in f32, power rounded to the compute
    type, mel product, ln(x + floor)."""
    wr, wi, mel = _bases(cfg, frames.device, torch.float32)
    f = frames.to(cfg.torch_dtype).float()
    re, im = f @ wr, f @ wi
    power = (re * re + im * im).to(cfg.torch_dtype).float()
    return torch.log(power @ mel + cfg.log_floor)


def fbank_frames_cuda(frames: torch.Tensor, cfg: FrontendConfig = FrontendConfig()
                      ) -> torch.Tensor:
    """Launch the kernel on the current stream: same contract as
    :func:`fbank_frames_plain`, for a CUDA tensor."""
    if frames.device.type != "cuda" or frames.dtype != torch.float32 or frames.dim() != 2:
        raise ValueError(f"expected a 2-D float32 CUDA tensor, got {frames.dtype} "
                         f"{tuple(frames.shape)} on {frames.device}")
    if frames.shape[1] != cfg.win_length:
        raise ValueError(f"frames of {frames.shape[1]} samples, cfg.win_length {cfg.win_length}")
    check_kernel_range(cfg)
    frames = frames.contiguous()
    m = frames.shape[0]
    out = torch.empty((m, cfg.n_mels), dtype=torch.float32, device=frames.device)
    if m == 0:
        return out
    bf16 = cfg.compute_dtype == "bfloat16"
    # bf16: the packed operands for the tensor cores; f32: wr, wi, mel as they are
    operands = ((None, None, None, packed_bases(_jax_cfg(cfg), frames.device)) if bf16
                else (*_bases(cfg, frames.device, torch.float32), None))
    build.launch("fbank_frames", _ARGTYPES,
                 frames.data_ptr(), *(a.data_ptr() if a is not None else None for a in operands),
                 out.data_ptr(), m, cfg.win_length, cfg.n_fft // 2 + 1, cfg.n_mels,
                 float(cfg.log_floor), int(bf16),
                 torch.cuda.current_stream(frames.device).cuda_stream)
    launched(fbank_frames)
    return out


def fbank_frames(frames: torch.Tensor, cfg: FrontendConfig = FrontendConfig()) -> torch.Tensor:
    """(M, win) frames → (M, n_mels) log-mel: the kernel on CUDA, the plain
    version on the CPU."""
    if frames.device.type == "cuda":
        return fbank_frames_cuda(frames, cfg)
    if frames.device.type == "cpu":
        return fbank_frames_plain(frames, cfg)
    raise ValueError(f"fbank_frames runs on cuda or cpu, not {frames.device}")


fbank_frames.launches = 0


def log_mel_fused(x: torch.Tensor, cfg: FrontendConfig = FrontendConfig(),
                  lengths: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, N) waveform → ((B, T, n_mels) feats, (B, T) mask) through
    :func:`fbank_frames`: preemphasis, ``center=False`` frames, the
    kernel, then CMN over the valid frames and the mask."""
    x = x.float()
    b = x.shape[0]
    frames = preemphasize(x, cfg.preemphasis).unfold(1, cfg.win_length, cfg.hop_length)
    t = frames.shape[1]
    feats = fbank_frames(frames.reshape(b * t, cfg.win_length), cfg).reshape(b, t, cfg.n_mels)
    mask = mask_for(lengths, x, t, cfg)
    return normalize(feats, mask, cfg), mask
