"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  A CUDA kernel has no CPU mode, so these tests skip where no GPU
is present; run them on a GPU machine with
``python -m pytest -m cuda tests/test_torch_kernels_cuda.py``.
This file imports only torch and the port."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from sdtk_tpu_torch.ops import fbank, fbank_wave

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _signal(b, n, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    x = 0.3 * np.sin(2 * np.pi * (150 + 40 * np.arange(b))[:, None] * t) \
        + 0.02 * rng.standard_normal((b, n))
    return torch.from_numpy(x.astype(np.float32))


# Both sides sum exact products in f32; only the order may differ, which
# can flip a bf16 rounding of one power bin (≤ ~4e-3 in ln): bars with 10x room.
@pytest.mark.parametrize("cfg,tol", [
    (fbank.FrontendConfig(), 0.05),
    (fbank.FrontendConfig(log_scale="db", mel_fmin=0.0), 0.25),
    (fbank.FrontendConfig(compute_dtype="float32"), 2e-3),
    (fbank.FrontendConfig(center=True, preemphasis=0.0), 0.05),
], ids=["bf16", "bf16-db-fmin0", "f32", "center-nopreemph"])
@pytest.mark.parametrize("shape", [(3, 4000), (128, 16000)])
def test_log_mel_wave_kernel_matches_plain(cuda, cfg, tol, shape):
    x = _signal(*shape).to(cuda)
    lengths = torch.full((shape[0],), shape[1], device=cuda)
    lengths[0] = 1234
    before = fbank_wave.log_mel_wave.launches
    got, gmask = fbank_wave.log_mel_wave(x, cfg, lengths=lengths)
    want, wmask = fbank.log_mel(x, cfg, lengths=lengths)
    torch.cuda.synchronize()
    assert fbank_wave.log_mel_wave.launches == before + 1
    assert torch.equal(gmask, wmask)
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= tol
