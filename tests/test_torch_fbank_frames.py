"""The port's log-mel from frames (sdtk_tpu_torch/ops/fbank_frames.py)
against the JAX package's ``fbank_frames_pallas`` / ``log_mel_fused``
(Pallas in interpret mode on the CPU).

f32: atol 2e-3, the bar of tests/test_fbank.py for the JAX kernel
against the FFT oracle.  bf16: both sides round frames, bases and power
to bf16 and sum exact products in f32 in another order; where that flips
the bf16 rounding of one power bin, a narrow low mel band moves by up to
~4e-3 in ln, so the bar is 0.05 (the bar the CUDA kernel is held to)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdtk_tpu.ops import fbank as jfbank
from sdtk_tpu.ops.research import fbank_frames as jframes
from sdtk_tpu_torch.ops import fbank, fbank_frames

F32 = fbank.FrontendConfig(compute_dtype="float32")
TOL = {"float32": 2e-3, "bfloat16": 0.05}


def _signal(n: int, seed: int, b: int = 1) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    x = 0.3 * np.sin(2 * np.pi * (220 + 60 * np.arange(b))[:, None] * t) \
        + 0.05 * rng.standard_normal((b, n))
    return x.astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,b", [(16000, 1), (7000, 1), (7000, 3)])
def test_log_mel_fused_matches_jax(dtype, n, b):
    """Ragged 7000 samples: 41 frames, not a multiple of the JAX tile."""
    x = _signal(n, seed=n + b, b=b)
    lengths = np.full(b, n)
    lengths[-1] = n - 1700
    cfg = fbank.FrontendConfig(compute_dtype=dtype)
    jcfg = jfbank.FrontendConfig(compute_dtype=dtype)
    got, gmask = fbank_frames.log_mel_fused(torch.from_numpy(x), cfg,
                                            lengths=torch.from_numpy(lengths))
    want, wmask = jframes.log_mel_fused(jnp.asarray(x), jcfg, lengths=jnp.asarray(lengths))
    np.testing.assert_array_equal(gmask.numpy(), np.asarray(wmask))
    assert got.shape == want.shape == (b, F32.num_frames(n), 80)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL[dtype])


def test_log_mel_fused_f32_matches_fft_oracle():
    """As tests/test_fbank.py holds the JAX kernel: against the NumPy FFT
    oracle at f32 on a ragged 7000-sample signal."""
    x = _signal(7000, seed=4)[0]
    got, _ = fbank_frames.log_mel_fused(torch.from_numpy(x)[None], F32)
    np.testing.assert_allclose(got[0].numpy(), fbank.log_mel_reference(x, F32),
                               atol=2e-3, rtol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [1, 37, 300])
def test_fbank_frames_plain_matches_pallas(dtype, m):
    frames = 0.1 * np.random.default_rng(m).standard_normal((m, 400)).astype(np.float32)
    cfg = fbank.FrontendConfig(compute_dtype=dtype)
    got = fbank_frames.fbank_frames(torch.from_numpy(frames), cfg)
    want = jframes.fbank_frames_pallas(jnp.asarray(frames),
                                       jfbank.FrontendConfig(compute_dtype=dtype))
    assert got.shape == (m, 80) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL[dtype])


def test_hard_coded_fmin_and_ln_as_in_jax():
    """Like the JAX kernel, the port builds its mel bank at fmin 20 Hz and
    takes the natural log whatever ``cfg`` says."""
    frames = 0.1 * np.random.default_rng(9).standard_normal((20, 400)).astype(np.float32)
    odd = fbank.FrontendConfig(compute_dtype="float32", mel_fmin=0.0, log_scale="db")
    got = fbank_frames.fbank_frames(torch.from_numpy(frames), odd)
    np.testing.assert_array_equal(got.numpy(),
                                  fbank_frames.fbank_frames(torch.from_numpy(frames), F32).numpy())
    want = jframes.fbank_frames_pallas(
        jnp.asarray(frames), jfbank.FrontendConfig(compute_dtype="float32", mel_fmin=0.0,
                                                   log_scale="db"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-3)


def test_cpu_runs_plain_and_cuda_entry_refuses_cpu():
    frames = torch.zeros(4, 400)
    before = fbank_frames.fbank_frames.launches
    fbank_frames.fbank_frames(frames, F32)
    assert fbank_frames.fbank_frames.launches == before
    with pytest.raises(ValueError):
        fbank_frames.fbank_frames_cuda(frames, F32)
    with pytest.raises(ValueError):
        fbank_frames.fbank_frames(frames.to("meta"), F32)
