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

from sdtk_tpu_torch.ops import (cosine, fbank, fbank_frames, fbank_wave, topk, topk_fused,
                               tower_epilogue)
from sdtk_tpu_torch.tools.convert_ecapa import SB_FRONTEND

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
# into one tile of frames.  "speechbrain" is a converted SpeechBrain tower's
# frontend: n_fft 400 (201 bins, the last of 7 chunks partial), Hamming,
# centered, dB from 0 Hz, floor 1e-10.
@pytest.mark.parametrize("cfg,tol", [
    (fbank.FrontendConfig(), 0.05),
    (fbank.FrontendConfig(log_scale="db", mel_fmin=0.0), 0.25),
    (fbank.FrontendConfig(compute_dtype="float32"), 2e-3),
    (fbank.FrontendConfig(center=True, preemphasis=0.0), 0.05),
    (fbank.FrontendConfig(**SB_FRONTEND), 0.25),
], ids=["bf16", "bf16-db-fmin0", "f32", "center-nopreemph", "speechbrain"])
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


# One training step on the card (K1 featurizes, cuDNN convolutions without
# TF32) against the same step on the CPU (K1's plain version) from one state
# and batch.  f32: loss within 1e-4 relative, all gradients together at
# cosine >= 0.9999.  bf16 (the trainer's dtype): 5e-2 and 0.999.  All
# updated parameters together at cosine >= 0.9999 with the CPU's (one tensor
# alone can fall lower: a zero-initialized bias moves by ±lr, the sign of a
# gradient that may be rounding noise).
@pytest.mark.parametrize("dtype,loss_rtol,grad_cos", [("float32", 1e-4, 0.9999),
                                                      ("bfloat16", 5e-2, 0.999)])
def test_train_step_on_card_matches_cpu(cuda, dtype, loss_rtol, grad_cos):
    from sdtk_tpu_torch.data.batches import BatchSpec, make_batch
    from sdtk_tpu_torch.models.ecapa import EcapaConfig, EcapaTdnn
    from sdtk_tpu_torch.parallel.train import TrainConfig, create_train_state
    from sdtk_tpu_torch.training import featurize_step

    torch.backends.cudnn.allow_tf32 = False
    spec = BatchSpec(family_ids=(0, 1, 2), n_speakers=8, batch=16, seconds=1.5, crop_seconds=1.0,
                     aug_prob=0.5, noise_prob=0.5)
    wavs, cls = make_batch(np.random.default_rng(0), spec)
    cfg = TrainConfig(n_classes=spec.n_classes)
    fcfg = fbank.FrontendConfig(compute_dtype=dtype)
    runs = {}
    for dev in (cuda, torch.device("cpu")):
        state = create_train_state(EcapaTdnn(EcapaConfig(channels=64, dtype=dtype)),
                                   torch.Generator().manual_seed(0), cfg, dev)
        before = fbank_wave.log_mel_wave.launches
        m = featurize_step(state, wavs, cls, cfg, fcfg, dev)
        assert fbank_wave.log_mel_wave.launches == before + (dev.type == "cuda")
        params = [*state.model.parameters(), state.aam_weights]
        runs[dev.type] = (float(m["loss"]), [p.detach().cpu().double() for p in params],
                          torch.cat([p.grad.detach().cpu().double().flatten() for p in params]))
    (loss_g, p_g, g_g), (loss_c, p_c, g_c) = runs["cuda"], runs["cpu"]
    assert abs(loss_g - loss_c) <= loss_rtol * abs(loss_c)
    assert float(torch.nn.functional.cosine_similarity(g_g, g_c, dim=0)) >= grad_cos
    flat_g, flat_c = torch.cat([a.flatten() for a in p_g]), torch.cat([b.flatten() for b in p_c])
    assert float(torch.nn.functional.cosine_similarity(flat_g, flat_c, dim=0)) >= 0.9999


# The long-form frontend's rows: one rank's chunk plus the 240-sample halo,
# preemphasized, through the kernel with coefficient 0 (ops/longform.py).
# 57 600 240 samples are an hour on one card (360 000 frames, the largest
# frame index of any path); 14 400 240 a quarter of it, one of 4 ranks.
@pytest.mark.parametrize("n", [57_600_000 + 240, 14_400_000 + 240])
def test_log_mel_wave_kernel_at_the_longform_shape(cuda, n):
    x = fbank.preemphasize(_signal(1, n, seed=3), 0.97).to(cuda)
    cfg = fbank.FrontendConfig()
    before = fbank_wave.log_mel_wave.launches
    got = fbank_wave.raw_log_mel_wave(x, cfg, 0.0)
    want = fbank_wave.log_mel_wave_plain(x, cfg, 0.0)
    torch.cuda.synchronize()
    assert fbank_wave.log_mel_wave.launches == before + 1
    assert got.shape == want.shape == (1, (n - 240) // 160, 80)
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= 0.05


def test_sharded_log_mel_on_card_matches_cpu(cuda):
    """One rank without a group: K1 launched once, against the CPU's plain
    path within the bf16 bar."""
    from sdtk_tpu_torch.ops.longform import sharded_log_mel

    x = _signal(1, 16000 * 30 + 160 * 7, seed=4)[0]
    before = fbank_wave.log_mel_wave.launches
    got = sharded_log_mel(x.to(cuda))
    torch.cuda.synchronize()
    assert fbank_wave.log_mel_wave.launches == before + 1
    want = sharded_log_mel(x)
    assert got.shape == want.shape
    assert float((got.cpu() - want).abs().max()) <= 0.05


def test_longform_diarizer_on_card_matches_cpu(cuda):
    """A random ECAPA-64 (bf16, from the same seed on both devices) on the
    220 / 520 / 220 Hz pair of tests/test_torch_longform.py: the same
    windows kept and labels up to a permutation."""
    from sdtk_tpu_torch.pipeline.longform import LongformConfig, LongformDiarizer

    sr = 16000
    t = np.arange(4 * sr) / sr

    def voice(f):
        x = sum((0.5 / (k + 1)) * np.sin(2 * np.pi * f * (k + 1) * t) for k in range(4))
        return 0.4 * x / np.max(np.abs(x))

    wav = np.concatenate([voice(220), voice(520), voice(220)]).astype(np.float32)
    wav += 0.005 * np.random.default_rng(11).standard_normal(len(wav)).astype(np.float32)
    runs = {}
    for dev in ("cuda", "cpu"):
        d = LongformDiarizer(LongformConfig(n_speakers=2), channels=64, device=dev)
        runs[dev] = d.diarize_waveform(wav)
    a, b = np.asarray(runs["cuda"]["window_labels"]), np.asarray(runs["cpu"]["window_labels"])
    assert runs["cuda"]["windows_kept"] == runs["cpu"]["windows_kept"]
    assert len(set(zip(a.tolist(), b.tolist()))) == len(set(a.tolist())) == 2


def _ragged_mask(b, t, seed):
    """(B, T) bool: ragged lengths, the first row whole, the last with no
    valid frame."""
    g = torch.Generator().manual_seed(seed)
    lengths = torch.randint(1, t + 1, (b,), generator=g)
    lengths[0], lengths[-1] = t, 0
    return torch.arange(t)[None, :] < lengths[:, None]


def _bn_constants(c, seed):
    g = torch.Generator().manual_seed(seed)
    return tower_epilogue.bn_affine(2 * torch.randn(c, generator=g),
                                    3 * torch.rand(c, generator=g) + 1e-3,
                                    torch.randn(c, generator=g), torch.randn(c, generator=g), 1e-5)


# The tower epilogue against its plain version: the same f32 fma and the
# same roundings, so equal to the bit.  (1024, 512, 298) is the c512 batch
# cell's TDNN output, (1024, 1024, 301) c1024's, (128, 512, 98) a diarizer
# chunk of 1 s windows; C T = 1500 x 301 is not a multiple of 8 (scalar
# accesses).
@pytest.mark.parametrize("shape", [(1024, 512, 298), (1024, 1024, 301), (128, 512, 98),
                                   (3, 1500, 301)])
@pytest.mark.parametrize("with_bn", [True, False])
@pytest.mark.parametrize("with_mask", [True, False])
def test_tower_epilogue_kernel_matches_plain(cuda, shape, with_bn, with_mask):
    b, c, t = shape
    y = (3 * torch.randn(shape, generator=torch.Generator().manual_seed(c + t))).to(
        torch.bfloat16).to(cuda)
    mask = _ragged_mask(b, t, c).to(cuda) if with_mask else None
    scale, shift = ((x.to(cuda) for x in _bn_constants(c, t)) if with_bn else (None, None))
    before = tower_epilogue.tower_epilogue.launches
    got = tower_epilogue.tower_epilogue(y, mask, scale, shift)
    want = tower_epilogue.tower_epilogue_plain(y, mask, scale, shift)
    torch.cuda.synchronize()
    assert tower_epilogue.tower_epilogue.launches == before + 1
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    if mask is not None:
        assert not got.masked_select(~mask[:, None, :]).any()


# A Res2 split: the output into its channel slice of the block's buffer and
# the next split's input, add + out; at the c512 and c1024 splits (64 and
# 128 of 512 and 1024 channels) and a diarizer chunk's.
@pytest.mark.parametrize("b,c,t,scale", [(1024, 512, 298, 8), (1024, 1024, 301, 8),
                                         (128, 512, 98, 8)])
def test_tower_epilogue_kernel_res2_split(cuda, b, c, t, scale):
    w = c // scale
    g = torch.Generator().manual_seed(t)
    x = torch.randn(b, c, t, generator=g).to(torch.bfloat16).to(cuda)
    y = torch.randn(b, w, t, generator=g).to(torch.bfloat16).to(cuda)
    mask = _ragged_mask(b, t, w).to(cuda)
    scale_, shift = (v.to(cuda) for v in _bn_constants(w, c))
    bufs = [torch.full_like(x, 7.0) for _ in range(2)]
    for buf, fn in zip(bufs, (tower_epilogue.tower_epilogue, tower_epilogue.tower_epilogue_plain)):
        out, nxt = fn(y, mask, scale_, shift, out=buf[:, 2 * w : 3 * w], add=x[:, 3 * w : 4 * w])
        assert out.data_ptr() == buf[:, 2 * w :].data_ptr() and nxt.is_contiguous()
        buf.nxt = nxt
    torch.cuda.synchronize()
    assert torch.equal(bufs[0], bufs[1]) and torch.equal(bufs[0].nxt, bufs[1].nxt)
    assert bool((bufs[0][:, : 2 * w] == 7).all()) and bool((bufs[0][:, 3 * w :] == 7).all())


def test_tower_epilogue_kernel_raises_on_what_it_does_not_take(cuda):
    y = torch.zeros(2, 8, 5, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="mask"):
        tower_epilogue.tower_epilogue(y, torch.ones(2, 5, device=cuda))
    with pytest.raises(ValueError, match="together"):
        tower_epilogue.tower_epilogue(y, None, torch.ones(8, device=cuda))
    with pytest.raises(ValueError, match="y must be"):
        tower_epilogue.tower_epilogue(y.float())


def _serving_towers():
    from sdtk_tpu_torch.models.ecapa import EcapaConfig, EcapaTdnn
    from sdtk_tpu_torch.models.xvector import XVector, XVectorConfig

    return {"c512": lambda: EcapaTdnn(EcapaConfig()),
            "c1024-speechbrain": lambda: EcapaTdnn(EcapaConfig(
                channels=1024, mfa_channels=3072, attention_channels=128, mfa_bn=True,
                asp_tdnn=True)),
            "xvector": lambda: XVector(XVectorConfig())}


# Eval towers at full width with random weights and BatchNorm statistics:
# the serving route (the epilogue kernel, bf16 serving copies) against the
# eager route (autograd on) on the card.  Each TDNN block and Res2 conv is
# run again on the serving route from the input the eager route gave it,
# so each block's difference is its own: cuDNN's BatchNorm and the
# kernel's fma round apart by at most 1 bf16 ulp, on >= 99.9 % of
# elements; padded frames exactly 0.  Whole embeddings at cosine 0.9999.
@pytest.mark.parametrize("name", ["c512", "c1024-speechbrain", "xvector"])
def test_serving_tower_matches_eager_on_card(cuda, name):
    from sdtk_tpu_torch.models.ecapa import BatchNorm, Res2Conv, TdnnBlock

    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator().manual_seed(21)
    model = _serving_towers()[name]()
    model.reset_parameters(g)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, BatchNorm):
                c = mod.weight.shape[0]
                mod.running_mean.copy_(0.3 * torch.randn(c, generator=g))
                mod.running_var.copy_(torch.rand(c, generator=g) + 0.2)
                mod.weight.copy_(1 + 0.2 * torch.randn(c, generator=g))
                mod.bias.copy_(0.2 * torch.randn(c, generator=g))
    model.to(cuda).eval()
    b, t = 64, 301
    feats = torch.randn(b, t, 80, generator=g).to(cuda)
    mask = _ragged_mask(b, t, 5).to(cuda)
    seen = []
    hooks = [mod.register_forward_hook(lambda mod, args, out: seen.append((mod, args, out)))
             for mod in model.modules() if isinstance(mod, (TdnnBlock, Res2Conv))]
    eager = model(feats, mask).detach()
    for h in hooks:
        h.remove()
    before = tower_epilogue.tower_epilogue.launches
    with torch.inference_mode():
        served = model(feats, mask)
        assert tower_epilogue.tower_epilogue.launches > before
        for mod, args, want in seen:
            got = mod(*(a.detach() if torch.is_tensor(a) else a for a in args))
            want = want.detach()
            assert not got.masked_select(~mask[:, None, :]).any()
            a, w = got.float(), want.float()
            ulp = torch.maximum(a.abs(), w.abs()).clamp_min(2.0 ** -126)
            ulp = torch.exp2(torch.floor(torch.log2(ulp)) - 7)  # bf16: 8 significant bits
            within = ((a - w).abs() <= ulp).float().mean().item()
            assert within >= 0.999, (type(mod).__name__, within)
    cos = torch.nn.functional.cosine_similarity(served.float(), eager.float(), dim=1)
    assert float(cos[:-1].min()) >= 0.9999  # the last row has no valid frame
    assert bool(torch.isfinite(served).all())
