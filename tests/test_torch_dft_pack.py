"""The operands packed for the tensor-core log-mel kernels
(``ops/fbank.py:pack_dft_operands``), checked on the CPU: shapes, zero
padding, and that products taken on the packed operands, read at the
offsets ``csrc/dft_mma.cuh`` reads them, give ``raw_log_mel`` and
``fbank_frames_plain`` exactly (padding adds exact zeros)."""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import pytest
import torch

from sdtk_tpu_torch.ops import fbank, fbank_frames, fbank_wave
from sdtk_tpu_torch.ops.fbank import DFT_BINS, DFT_MEL_GROUP, FrontendConfig

CONFIGS = {
    "default": FrontendConfig(),
    "db-fmin0": FrontendConfig(log_scale="db", mel_fmin=0.0),
    "win250": FrontendConfig(win_length=250, hop_length=100),  # K = 250 -> 256
    "mels30-fft256": FrontendConfig(win_length=200, hop_length=80, n_fft=256, n_mels=30),
}


def _geometry(cfg):
    kp = -(-cfg.win_length // 16) * 16
    n_freqs = cfg.n_fft // 2 + 1
    return kp, -(-n_freqs // DFT_BINS), -(-cfg.n_mels // DFT_MEL_GROUP) * DFT_MEL_GROUP, n_freqs


def _core_offset(row, k, kp):
    """Where a descriptor without swizzle finds (row, k) of an operand of
    ``kp`` values a row, in values: the next 8 rows 8·kp on, the next 8
    along k 64 on, a row of a core matrix 8 on."""
    return (row // 8) * (8 * kp) + (k // 8) * 64 + (row % 8) * 8 + k % 8


def _unpack(packed, cfg):
    """(wr, wi) as (kp, chunks·32) and mel as (chunks·32, nmp), gathered
    element by element at the kernel's offsets: chunk j holds basis row r
    (re rows first, im rows DFT_BINS on) at ``_core_offset(r, k, kp)`` and,
    after its 2·DFT_BINS·kp basis values, mel m of bin r at group m // 80's
    80·32 values, ``_core_offset(m % 80, r, 32)``."""
    kp, n_chunks, nmp, _ = _geometry(cfg)
    flat = packed.float().numpy()
    wr = np.zeros((kp, n_chunks * DFT_BINS), np.float32)
    wi = np.zeros_like(wr)
    mel = np.zeros((n_chunks * DFT_BINS, nmp), np.float32)
    k, m = np.arange(kp), np.arange(nmp)
    mel_at = 2 * DFT_BINS * kp + (m // DFT_MEL_GROUP) * (DFT_MEL_GROUP * DFT_BINS)
    for j in range(n_chunks):
        for r in range(DFT_BINS):
            wr[:, j * DFT_BINS + r] = flat[j, _core_offset(r, k, kp)]
            wi[:, j * DFT_BINS + r] = flat[j, _core_offset(DFT_BINS + r, k, kp)]
            mel[j * DFT_BINS + r, :] = flat[j, mel_at + _core_offset(m % DFT_MEL_GROUP, r, DFT_BINS)]
    return torch.from_numpy(wr), torch.from_numpy(wi), torch.from_numpy(mel)


@pytest.fixture()
def one_thread():
    """Exact equality of two float32 products needs each to sum in one
    fixed order.  With several threads a CPU BLAS may split a product's
    sums between threads and combine the parts in an order that can change
    from call to call under load; one thread sums in one order."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _signal(b, n, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    x = 0.3 * np.sin(2 * np.pi * (150 + 40 * np.arange(b))[:, None] * t) \
        + 0.02 * rng.standard_normal((b, n))
    return torch.from_numpy(x.astype(np.float32))


@pytest.mark.parametrize("name", CONFIGS)
def test_packed_shapes_and_zero_padding(name):
    cfg = CONFIGS[name]
    kp, n_chunks, nmp, n_freqs = _geometry(cfg)
    wr, wi, mel = fbank.bases(cfg, torch.device("cpu"), torch.bfloat16)
    packed = fbank.packed_bases(cfg, torch.device("cpu"))
    assert packed.dtype == torch.bfloat16 and packed.is_contiguous()
    assert packed.shape == (n_chunks, 2 * DFT_BINS * kp + nmp * DFT_BINS)
    assert (packed.shape[1] * 2) % 16 == 0 and kp % 16 == 0  # 16-byte cp.async, whole k-steps
    pwr, pwi, pmel = _unpack(packed, cfg)
    win = cfg.win_length
    assert torch.equal(pwr[:win, :n_freqs], wr.float()) and torch.equal(pwi[:win, :n_freqs], wi.float())
    assert torch.equal(pmel[:n_freqs, :cfg.n_mels], mel.float())
    # everything else is zero: K rows past win, bins past n_freqs, mels past n_mels
    total = sum(float(a.abs().sum()) for a in (wr.float(), wi.float(), mel.float()))
    assert float(packed.float().abs().sum()) == pytest.approx(total, rel=1e-6)
    for a, rows, cols in ((pwr, win, n_freqs), (pwi, win, n_freqs), (pmel, n_freqs, cfg.n_mels)):
        assert float(a[rows:].abs().sum()) == 0.0 and float(a[:, cols:].abs().sum()) == 0.0


def _log_mel_on_packed(frames, packed, cfg):
    """frames (M, win) f32 -> (M, n_mels): the kernel's function by plain f32
    matmuls on the padded operands."""
    kp = _geometry(cfg)[0]
    wr, wi, mel = _unpack(packed, cfg)
    f = torch.nn.functional.pad(frames.to(torch.bfloat16).float(), (0, kp - cfg.win_length))
    re, im = f @ wr, f @ wi
    power = (re * re + im * im).to(torch.bfloat16).float()
    return fbank.log_of_mel(power @ mel, cfg)[:, :cfg.n_mels]


@pytest.mark.parametrize("name", CONFIGS)
def test_products_on_packed_operands_equal_raw_log_mel(name, one_thread):
    cfg = CONFIGS[name]
    x = _signal(3, 4000)
    xp = fbank.preemphasize(x, cfg.preemphasis)
    want = fbank.raw_log_mel(xp, cfg)
    frames = xp.unfold(1, cfg.win_length, cfg.hop_length).reshape(-1, cfg.win_length)
    got = _log_mel_on_packed(frames, fbank.packed_bases(cfg, torch.device("cpu")), cfg)
    assert float((got.reshape(want.shape) - want).abs().max()) == 0.0
    assert torch.equal(want, fbank_wave.log_mel_wave_plain(x, cfg, cfg.preemphasis))


@pytest.mark.parametrize("name", ["default", "win250", "mels30-fft256"])
def test_products_on_packed_operands_equal_fbank_frames_plain(name, one_thread):
    cfg = CONFIGS[name]
    rng = np.random.default_rng(5)
    frames = torch.from_numpy(0.1 * rng.standard_normal((37, cfg.win_length)).astype(np.float32))
    jax_cfg = replace(cfg, mel_fmin=fbank_frames.JAX_MEL_FMIN)  # as the wrapper packs them
    got = _log_mel_on_packed(frames, fbank.packed_bases(jax_cfg, torch.device("cpu")), jax_cfg)
    assert float((got - fbank_frames.fbank_frames_plain(frames, cfg)).abs().max()) == 0.0


def test_chunked_mel_sum_matches_one_product():
    """The kernel takes the DFT and adds the mel product chunk by chunk (32
    bins at a time) in f32; against one product over all bins only the
    order of the f32 sums differs."""
    cfg = CONFIGS["default"]
    kp, n_chunks, nmp, _ = _geometry(cfg)
    packed = fbank.packed_bases(cfg, torch.device("cpu")).float()
    frames = fbank.preemphasize(_signal(2, 4000), 0.97).unfold(1, 400, 160).reshape(-1, 400)
    f = frames.to(torch.bfloat16).float()
    acc = torch.zeros((f.shape[0], nmp))
    for j in range(n_chunks):
        basis = packed[j, :2 * DFT_BINS * kp].reshape(2 * DFT_BINS // 8, kp // 8, 8, 8)
        basis = basis.permute(0, 2, 1, 3).reshape(2, DFT_BINS, kp)  # core matrices -> (re/im, row, k)
        melc = packed[j, 2 * DFT_BINS * kp:].reshape(nmp // 8, DFT_BINS // 8, 8, 8)
        melc = melc.permute(0, 2, 1, 3).reshape(nmp, DFT_BINS)
        re, im = f @ basis[0].T, f @ basis[1].T
        acc += (re * re + im * im).to(torch.bfloat16).float() @ melc.T
    got = fbank.log_of_mel(acc, cfg)[:, :cfg.n_mels]
    want = fbank_frames.fbank_frames_plain(frames, cfg)  # default fmin: the same mel bank
    assert float((got - want).abs().max()) <= 0.05  # a flipped bf16 rounding of one power bin


@pytest.mark.parametrize("cfg,match", [
    (FrontendConfig(win_length=640, n_fft=1024), "win_length 640"),
    (FrontendConfig(compute_dtype="float32", n_fft=1024), "n_fft 1024"),
    (FrontendConfig(compute_dtype="float16"), "float16"),
])
def test_kernel_range_is_checked_by_name(cfg, match):
    with pytest.raises(ValueError, match=match):
        fbank.check_kernel_range(cfg)


@pytest.mark.parametrize("cfg", [
    FrontendConfig(), FrontendConfig(win_length=576, n_fft=1024),  # bf16: any n_fft
    FrontendConfig(compute_dtype="float32"), FrontendConfig(compute_dtype="float32", n_fft=574),
])
def test_kernel_range_accepts(cfg):
    fbank.check_kernel_range(cfg)
