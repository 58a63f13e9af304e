"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  A CUDA kernel has no CPU mode, so these tests skip where no GPU
is present; run them on a GPU machine with
``python -m pytest -m cuda tests/test_torch_kernels_cuda.py``.
This file imports only torch and the port."""

from __future__ import annotations

import re

import numpy as np
import pytest
import torch

from sdtk_tpu_torch.ops import cosine, fbank, fbank_frames, fbank_wave, topk, topk_fused

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
# can flip a bf16 rounding of one power bin (≤ ~8e-3 in ln): bars with 6x room.
# (The bf16 kernel's hardware logarithm adds ~1e-6.)
# (1, 400) is one frame; (32, 48000) the identify path's chunk of 3 s windows;
# (16, 24000) the streaming path's chunk of 1.5 s windows; (1024, 48000) the
# embed + cluster batch; (200, 400) and (40, 1000) put 128 and 26 waveform rows
# into one tile of frames.
@pytest.mark.parametrize("cfg,tol", [
    (fbank.FrontendConfig(), 0.05),
    (fbank.FrontendConfig(log_scale="db", mel_fmin=0.0), 0.25),
    (fbank.FrontendConfig(compute_dtype="float32"), 2e-3),
    (fbank.FrontendConfig(center=True, preemphasis=0.0), 0.05),
], ids=["bf16", "bf16-db-fmin0", "f32", "center-nopreemph"])
@pytest.mark.parametrize("shape", [(3, 4000), (128, 16000), (32, 48000), (1, 400), (200, 400),
                                   (40, 1000), (16, 24000), (1024, 48000)])
def test_log_mel_wave_kernel_matches_plain(cuda, cfg, tol, shape):
    x = _signal(*shape).to(cuda)
    lengths = torch.full((shape[0],), shape[1], device=cuda)
    lengths[0] = min(1234, shape[1])
    before = fbank_wave.log_mel_wave.launches
    got, gmask = fbank_wave.log_mel_wave(x, cfg, lengths=lengths)
    want, wmask = fbank.log_mel(x, cfg, lengths=lengths)
    torch.cuda.synchronize()
    assert fbank_wave.log_mel_wave.launches == before + 1
    assert torch.equal(gmask, wmask)
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= tol


def _rows(n, d, seed, dtype=torch.float32):
    x = np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)
    return torch.from_numpy(x).to(dtype)


# 3xTF32 products (f32-accurate) with the norms applied after them, against
# f32 products of the normalized rows: a few ulps of a cosine.
# (29, 8192, 192) is the dense identify shape, (199, 8192, 192) a 5-minute
# query (7 query chunks), D = 512 the x-vector width (128-column slabs, one
# and three chunks), D = 225 the first width past a resident tile, D = 7 and
# 33 unaligned rows (4-byte copies), N = 4093 and 513 ragged tiles.
@pytest.mark.parametrize("q,n,d", [
    (32, 4096, 192), (29, 4093, 192), (1, 1, 7), (130, 70, 33), (29, 8192, 192),
    (199, 8192, 192), (29, 8192, 512), (65, 513, 192), (29, 300, 7), (33, 301, 33),
    (65, 1000, 512), (40, 100, 225),
])
def test_cosine_kernel_matches_plain(cuda, q, n, d):
    qs, ps = _rows(q, d, 1).to(cuda), _rows(n, d, 2).to(cuda)
    qs[0] = 0.0  # a zero row scores 0 against everything
    ps[n // 2] = 0.0
    before = cosine.cosine.launches
    got = cosine.cosine(qs, ps)
    torch.cuda.synchronize()
    assert cosine.cosine.launches == before + 1
    assert got.shape == (q, n) and float(got[0].abs().max()) == 0.0
    assert float(got[:, n // 2].abs().max()) == 0.0
    assert float((got - cosine.cosine_plain(qs, ps)).abs().max()) <= 1e-5


@pytest.mark.parametrize("d", [192, 8])
def test_cosine_kernel_reads_storage_off_16_bytes(cuda, d):
    """Profiles whose storage starts one float past a 16-byte boundary take
    the kernel's 4-byte copies; queries the same, at another offset."""
    n, q = 777, 29
    pbuf = _rows(n * d + 1, 1, 5).reshape(-1).to(cuda)
    qbuf = _rows(q * d + 3, 1, 6).reshape(-1).to(cuda)
    ps, qs = pbuf[1:].view(n, d), qbuf[3:].view(q, d)
    assert ps.is_contiguous() and ps.data_ptr() % 16 == 4 and qs.data_ptr() % 16 == 12
    before = cosine.cosine.launches
    got = cosine.cosine(qs, ps)
    torch.cuda.synchronize()
    assert cosine.cosine.launches == before + 1
    assert float((got - cosine.cosine_plain(qs, ps)).abs().max()) <= 1e-5


@pytest.mark.parametrize("w,n,d,k,dtype", [
    (64, 100_000, 192, 64, torch.float32),
    (64, 100_000, 192, 128, torch.bfloat16),
    (8, 8193, 192, 64, torch.float32),
    (5, 300, 192, 7, torch.float32),
    (200, 4096, 64, 16, torch.float32),
    (9, 17, 192, 17, torch.bfloat16),
    (3, 130, 192, 128, torch.float32),
    (32, 8192, 192, 192, torch.float32),  # the identify path with 3 embeddings per speaker
    (16, 3000, 192, 512, torch.bfloat16),  # k = the tile: every row of a tile survives
    (8, 2000, 192, 700, torch.float32),
    (3, 130, 192, 512, torch.float32),
    (64, 20_000, 512, 64, torch.float32),  # the x-vector width
    (64, 5000, 512, 192, torch.bfloat16),
    (512, 3000, 192, 64, torch.float32),  # a bucketed 10-minute query
    (100, 1500, 33, 40, torch.float32),  # ragged chunks: scalar copies
    (7, 900, 7, 9, torch.bfloat16),
    (16, 1000, 7, 12, torch.float32),
    (8, 1, 192, 64, torch.float32),  # one profile row
    (32, 8192, 192, 192, torch.bfloat16),
    (3, 700, 1100, 20, torch.float32),  # D past one query slab of 512
])
def test_identify_topk_kernel_matches_plain(cuda, w, n, d, k, dtype):
    qs, ps = _rows(w, d, 3).to(cuda), _rows(n, d, 4, dtype).to(cuda)
    before = topk_fused.identify_topk_fused.launches
    s, i = topk_fused.identify_topk_fused(qs, ps, k)
    torch.cuda.synchronize()
    assert topk_fused.identify_topk_fused.launches == before + 1
    ws, wi = topk.identify_topk_plain(qs, ps, k)
    assert s.shape == (min(k, n),) and set(i.tolist()) == set(wi.tolist())
    assert bool((s[:-1] >= s[1:]).all())
    assert float((s - ws).abs().max()) <= 1e-5


def test_identify_topk_launches_both_passes(cuda):
    """One call runs the queries' split, the window-max pass and the
    tile-select pass, each a kernel whose name starts with identify_topk_."""
    from torch.profiler import ProfilerActivity, profile

    qs, ps = _rows(32, 192, 3).to(cuda), _rows(8192, 192, 4).to(cuda)
    topk_fused.identify_topk_cuda(qs, ps, 64)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        topk_fused.identify_topk_cuda(qs, ps, 64)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()]
    for kernel in ("identify_topk_split", "identify_topk_max", "identify_topk_select"):
        assert any(re.search(rf"(^|[\s:]){kernel}\b", key) for key in names), (kernel, names)


@pytest.mark.parametrize("cfg,tol", [
    (fbank.FrontendConfig(), 0.05),
    (fbank.FrontendConfig(compute_dtype="float32"), 2e-3),
], ids=["bf16", "f32"])
@pytest.mark.parametrize("m", [12_544, 7, 33, 1, 63, 64, 65, 127, 129])
def test_fbank_frames_kernel_matches_plain(cuda, cfg, tol, m):
    frames = (0.1 * _rows(m, cfg.win_length, 5)).to(cuda)
    before = fbank_frames.fbank_frames.launches
    got = fbank_frames.fbank_frames(frames, cfg)
    torch.cuda.synchronize()
    assert fbank_frames.fbank_frames.launches == before + 1
    assert got.shape == (m, cfg.n_mels) and bool(torch.isfinite(got).all())
    assert float((got - fbank_frames.fbank_frames_plain(frames, cfg)).abs().max()) <= tol


# Shapes off the default: a window that is no multiple of 16 with an odd hop,
# more than one group of 80 mels, an n_fft of 1024 (bf16 only), a short n_fft
# with 30 mels.  Same bars as above.
@pytest.mark.parametrize("cfg,tol", [
    (fbank.FrontendConfig(win_length=250, hop_length=101), 0.05),
    (fbank.FrontendConfig(n_mels=96, log_scale="db"), 0.25),
    (fbank.FrontendConfig(win_length=576, hop_length=160, n_fft=1024, n_mels=128), 0.05),
    (fbank.FrontendConfig(win_length=200, hop_length=80, n_fft=256, n_mels=30), 0.05),
    (fbank.FrontendConfig(win_length=250, hop_length=101, compute_dtype="float32"), 2e-3),
], ids=["win250-hop101", "mels96-db", "win576-fft1024-mels128", "fft256-mels30", "win250-f32"])
def test_log_mel_kernels_off_default_shapes(cuda, cfg, tol):
    x = _signal(5, 9000).to(cuda)
    got, _ = fbank_wave.log_mel_wave(x, cfg)
    want, _ = fbank.log_mel(x, cfg)
    torch.cuda.synchronize()
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= tol
    frames = (0.1 * _rows(70, cfg.win_length, 6)).to(cuda)
    got = fbank_frames.fbank_frames(frames, cfg)
    torch.cuda.synchronize()
    assert got.shape == (70, cfg.n_mels) and bool(torch.isfinite(got).all())
    assert float((got - fbank_frames.fbank_frames_plain(frames, cfg)).abs().max()) <= tol


def test_log_mel_kernels_raise_outside_their_range(cuda):
    x = _signal(2, 4000).to(cuda)
    with pytest.raises(ValueError, match="win_length 640"):
        fbank_wave.log_mel_wave(x, fbank.FrontendConfig(win_length=640, n_fft=1024))
    with pytest.raises(ValueError, match="n_fft 1024"):
        fbank_frames.fbank_frames(x[:, :400].contiguous(),
                                  fbank.FrontendConfig(compute_dtype="float32", n_fft=1024))
