"""The port's frontend (sdtk_tpu_torch/ops/fbank.py, ops/fbank_wave.py)
held against the JAX package's log_mel, its NumPy oracle and the Pallas
log_mel_wave kernel (interpret mode on the CPU).  The CUDA kernel itself
runs only on the card (tests/test_torch_kernels_cuda.py, chip_smoke.py);
here the wrapper takes its plain version because the tensors lie on the
CPU."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from sdtk_tpu.ops import fbank as jfbank
from sdtk_tpu.ops.research.fbank_wave import log_mel_wave as jax_log_mel_wave
from sdtk_tpu_torch.ops import fbank, fbank_wave
from sdtk_tpu_torch.utils import build


def _sig(b: int, n: int, seed: int = 0) -> np.ndarray:
    """Tones + noise: non-silent in every band (as tests/test_fbank_wave.py)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    tones = np.stack([np.sin(2 * np.pi * (180 + 60 * i) * t) for i in range(b)])
    return (0.3 * tones + 0.01 * rng.standard_normal((b, n))).astype(np.float32)


def _cfgs(dtype):
    return [
        (jfbank.FrontendConfig(compute_dtype=dtype), fbank.FrontendConfig(compute_dtype=dtype)),
        (jfbank.FrontendConfig(compute_dtype=dtype, log_scale="db", mel_fmin=0.0, center=True),
         fbank.FrontendConfig(compute_dtype=dtype, log_scale="db", mel_fmin=0.0, center=True)),
    ]


@pytest.mark.parametrize("which", [0, 1], ids=["default", "db-fmin0-center"])
def test_log_mel_matches_jax_f32(which):
    """f32: same algorithm, only the summation order differs → 2e-4 (the
    bar tests/test_fbank_wave.py holds the Pallas kernel to); ×10/ln10
    on the dB scale."""
    jcfg, tcfg = _cfgs("float32")[which]
    x = _sig(3, 12000, seed=1)
    lengths = np.asarray([12000, 7000, 3000], np.int32)
    want, wmask = jfbank.log_mel(x, jcfg, lengths=lengths)
    got, gmask = fbank.log_mel(torch.from_numpy(x), tcfg, lengths=torch.from_numpy(lengths))
    np.testing.assert_array_equal(gmask.numpy(), np.asarray(wmask))
    tol = 2e-4 * (10 / np.log(10) if tcfg.log_scale == "db" else 1.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("which", [0, 1], ids=["default", "db-fmin0-center"])
def test_log_mel_matches_jax_bf16(which):
    """bf16 serving dtype: within the 0.6 ln bar tests/test_fbank_wave.py
    holds the TPU kernel to (bf16 rounding lands in other places in XLA
    and PyTorch), scaled by 10/ln10 for dB."""
    jcfg, tcfg = _cfgs("bfloat16")[which]
    x = _sig(2, 8000, seed=2)
    want, _ = jfbank.log_mel(x, jcfg)
    got, _ = fbank.log_mel(torch.from_numpy(x), tcfg)
    bar = 0.6 * (10 / np.log(10) if tcfg.log_scale == "db" else 1.0)
    assert np.abs(got.numpy() - np.asarray(want)).max() < bar


def test_log_mel_reference_copy_is_exact():
    x = _sig(1, 8000, seed=3)[0]
    for jcfg, tcfg in _cfgs("float32"):
        np.testing.assert_array_equal(fbank.log_mel_reference(x, tcfg),
                                      jfbank.log_mel_reference(x, jcfg))


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-4), ("bfloat16", 0.6)])
def test_plain_matches_pallas_log_mel_wave(dtype, tol):
    """The wrapper's CPU path against the TPU kernel in interpret mode at
    (2, 8000), non-silent input.  f32: 2e-4 (summation order); bf16: the
    0.6 bar of tests/test_fbank_wave.py (the Pallas kernel folds
    preemphasis into its bases, the port does not)."""
    jcfg = jfbank.FrontendConfig(compute_dtype=dtype)
    tcfg = fbank.FrontendConfig(compute_dtype=dtype)
    x = _sig(2, 8000, seed=4)
    lengths = np.asarray([8000, 5000], np.int32)
    want, wmask = jax_log_mel_wave(x, jcfg, lengths=lengths)
    before = fbank_wave.log_mel_wave.launches
    got, gmask = fbank_wave.log_mel_wave(torch.from_numpy(x), tcfg,
                                         lengths=torch.from_numpy(lengths))
    assert fbank_wave.log_mel_wave.launches == before  # CPU tensor: plain version
    np.testing.assert_array_equal(gmask.numpy(), np.asarray(wmask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("center", [False, True])
def test_wrapper_equals_plain_log_mel(center):
    """log_mel_wave is a drop-in for fbank.log_mel (center handled by the
    wrapper: preemphasis and padding outside the kernel, coefficient 0)."""
    cfg = fbank.FrontendConfig(center=center, log_scale="db", mel_fmin=0.0)
    x = torch.from_numpy(_sig(2, 6400, seed=5))
    lengths = torch.tensor([6400, 2000])
    got, gm = fbank_wave.log_mel_wave(x, cfg, lengths=lengths)
    want, wm = fbank.log_mel(x, cfg, lengths=lengths)
    assert torch.equal(gm, wm)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_kernel_entry_refuses_cpu_and_other_devices():
    """No silent fallback: the kernel call takes only CUDA tensors, and the
    wrapper only cpu or cuda."""
    cfg = fbank.FrontendConfig()
    with pytest.raises(ValueError):
        fbank_wave.log_mel_wave_cuda(torch.zeros(2, 1600), cfg, 0.97)
    with pytest.raises(ValueError):
        fbank_wave.log_mel_wave(torch.zeros(2, 1600, device="meta"), cfg)


def test_build_raises_without_nvcc(monkeypatch):
    monkeypatch.setenv("PATH", "")
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    with pytest.raises(RuntimeError, match="nvcc"):
        build.nvcc()


def test_build_paths_track_the_source():
    assert build.kernel_names() == ["cosine", "fbank_frames", "identify_topk", "log_mel_wave",
                                   "tower_epilogue"]
    p = build.library_path("log_mel_wave")
    assert p.parent == build.BUILD_DIR and p.name.startswith("liblog_mel_wave-")
