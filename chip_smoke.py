#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``sdtk_tpu_torch``) on one GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It imports nothing of JAX or of ``sdtk_tpu``.  Phases, one JSON line each;
any failure raises and exits non-zero:

1. env     — card, power limit, torch and CUDA versions;
2. build   — every kernel under ``sdtk_tpu_torch/csrc`` built with nvcc
             (one process per source, started together), timed;
3. kernel  — each kernel against its plain PyTorch version on the card at
             the main path's shape, with stated tolerances; kernel, plain
             and library times (CUDA events around the wrapper, median of
             30 launches after warm-up, L2 warm), the kernel's device time
             alone (``torch.profiler``) and the bound from this run's inputs;
4. tower   — ECAPA embeddings on the card (bf16) against the port on the
             CPU (f32) for a few windows, by cosine;
5. main    — ``Diarizer(device="cuda")`` on a synthesized 3-speaker
             meeting of ~60 s: launch counts (reset just before, read just
             after), speaker count, DER at collar 0.75, wall time and
             per-stage host seconds; then a second (warm) run, timed;
6. embed   — embed throughput of one 128-window chunk, audio-s per s;
7. spectral — the spectral device path (dense and subspace) on 1536
             windows against the host path, labels up to permutation;
8. cli     — the diarize CLI on the meeting written as a WAV;
9. identify — the profile side at full width: three synthetic speakers
             enrolled from WAVs (one of them three times, so the fused
             route keeps k = 64 * 3 = 192 rows), 8 187 distractor
             profiles (N = 8 192 rows),
             a held-out ~45 s query of each identified on the fused top-k
             route and on the dense cosine route (launch counts reset just
             before enrolling, read after verifying), wall seconds and
             where an identify call spends them;
10. cli-detection — ``cli.detection`` add / enroll / identify / verify on
             a small store;
11. streaming — ``OnlineDiarizer`` (default ECAPA tower) fed the meeting
             in 0.5 s chunks: chunk latency p50 / p95 / max, real-time
             factor, speaker count, live and ``finalize()`` DER at collar
             0.75 (fails above the main phase's bar or at a count other
             than 3), launch counts;
12. tower-xvector — the bundled x-vector (``SDTK_BACKEND_TOWER=xvector``)
             on the card (bf16) against its f32 run on the CPU, 8 windows
             of 3 s, by cosine;
13. identify-xvector — phase 9 with the x-vector: 512-d profiles,
             N = 2 048 rows (a short store load; the width is full), both
             routes forced by ``SDTK_IDENTIFY_TOPK_N``, so the identify
             top-k and the cosine kernel run at D = 512;
14. embed-cluster — what ``bench.py`` times: log-mel kernel -> ECAPA
             c512 (bundled, bf16) -> L2 -> ``cluster_stage(max_speakers=8,
             use_subspace=True)`` on a (1024, 48 000) batch, 20 steps each
             chained on the one before, by CUDA events; embed-only and
             embed + cluster audio-s per s and the cluster's share;

The kernel phase holds all four kernels (log-mel from the waveform, the
cosine scores, the fused identify top-k, log-mel from frames) at the
shapes their path gives them and at the shapes named beside them.  The two
log-mel kernels run their bf16 instances on the tensor cores; their
CUDA-core predecessors took 0.4121 ms at (128, 16000) and 0.3361 ms at
(12544, 400) by the same CUDA-event timing (NVIDIA H100 80GB HBM3,
700 W; PERF.md).  The identify top-k runs its products on the tensor
cores in 3xTF32 (f32-accurate); its single-kernel CUDA-core predecessor
took 0.3470 ms on the device at (64, 100 000, 192) f32 (same card;
PERF.md).  The cosine kernel does too; its CUDA-core predecessor took
0.0234 ms on the device at (29, 8 192, 192) (same card; PERF.md).  Then
the ``kernels`` line (each kernel's launches on its main path, and on
every path driven, ``launches_by_path``), the card's name and power limit
as ``nvidia-smi`` prints them, and ``{"ok": true, "device": {...}}`` last.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM data-sheet peaks (dense): bf16 tensor cores, f32 CUDA cores, HBM3.
# "tf32x3" is f32-accurate work at the card's fastest route for it: three
# TF32 tensor-core products (3xTF32) per f32 product, 495 / 3 TFLOP/s.
# "tf32x2" is the same with one operand exact in TF32 (bf16 values, say):
# two products, 495 / 2 TFLOP/s.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "tf32x3": 495e12 / 3,
              "tf32x2": 495e12 / 2}
PEAK_BYTES = 3.35e12

# Kernel vs plain, same inputs and compute dtype.  Both sum exact products
# in f32 but in another order, so power values differ by a few f32 ulps;
# where that flips a bf16 rounding of a power bin (one bf16 ulp = 0.4 %),
# a narrow low mel band (1-2 bins) moves by up to ~4e-3 in ln.  The bars
# leave 10x room; dB is 10/ln(10) times the ln scale.
TOL = {"bf16-ln": 0.05, "bf16-db-fmin0": 0.25, "f32-ln": 2e-3}
# Cosine and identify top-k: f32-accurate products on both sides (3xTF32 in
# the kernels, f32 in the plain versions), summed in another order, a few
# f32 ulps of a cosine.
SCORE_TOL = 1e-5
D = 192  # ECAPA embedding width
IDENTIFY_N = 8192  # profile rows of the identify phase: the fused route's threshold
XVECTOR_IDENTIFY_N = 2048  # the x-vector identify phase's rows (full width, 512)
DER_BAR = 0.05
TOWER_COS_BAR = 0.995  # bf16 on the card vs f32 on the CPU, per window


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps: int = 30, warmup: int = 5) -> float:
    """Median device time of ``fn`` over ``reps`` launches (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(reps)]
    for a, b in events:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in events)


def device_ms(fn, kernel: str, reps: int = 20):
    """Mean device time of the CUDA kernel whose name contains ``kernel``
    over ``reps`` calls of ``fn`` (``torch.profiler``): the kernel alone,
    without the wrapper's host work.  A trace that shows no device time
    is taken once more; "not measured" where the second shows none
    either."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total_us = sum(float(getattr(e, "self_device_time_total", 0.0)
                             or getattr(e, "self_cuda_time_total", 0.0))
                       for e in prof.key_averages()
                       if kernel in e.key and str(e.device_type).endswith("CUDA"))
        if total_us > 0:
            return total_us / reps / 1e3
    return "not measured"


def with_device_time(row: dict, fn, kernel: str) -> dict:
    """``row`` with the kernel's device time and the share of its bound that
    time reaches."""
    ms = device_ms(fn, kernel)
    share = row["bound_ms"] / ms if isinstance(ms, float) else "not measured"
    return {**row, "device_ms": ms, "bound_share_of_device_ms": share}


def mma_counts() -> dict:
    """Tensor-core instructions in the SASS of the two log-mel libraries,
    the identify top-k library and the cosine library (``cuobjdump``): HMMA
    is ``mma.sync``, HGMMA is ``wgmma``."""
    from sdtk_tpu_torch.utils import build

    names = ("log_mel_wave", "fbank_frames", "identify_topk", "cosine")
    tool = shutil.which("cuobjdump") or os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return {name: "not checked" for name in names}
    counts = {}
    for name in names:
        sass = subprocess.run([tool, "-sass", str(build.library_path(name))],
                              capture_output=True, text=True, timeout=120).stdout
        counts[name] = {op: sum(f" {op}." in line for line in sass.splitlines())
                        for op in ("HMMA", "HGMMA")}
    return counts


def bound(nbytes: float, flops: float, dtype: str = "float32") -> dict:
    """The least time the card could take: bytes over HBM rate against
    operations over the peak rate of ``dtype``, whichever is larger."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes > t_ops else "operations",
            "bytes": nbytes, "flops": flops}


def summary(name: str, source: str, replaces: str, row: dict, path: str | None) -> dict:
    """One entry of the ``kernels`` line from a kernel-phase row."""
    keys = ("max_abs_err", "ms", "device_ms", "bound_share_of_device_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    extra = ("library_device_ms", "host_ms", "library_host_ms")  # where the phase took them
    return {"name": name, "route": "cuda", "source": f"sdtk_tpu_torch/csrc/{source}",
            "replaces": replaces, "path": path, "shape": row["shape"],
            **{k: row[k] for k in keys}, **{k: row[k] for k in extra if k in row}}


def speechlike_batch(b: int, n: int, seed: int):
    """(b, n) synthetic voices with ragged lengths (tails zeroed, as the
    diarizer pads), plus the lengths.  Above 128 rows, 32 utterances are
    repeated at random gains (one utterance takes ~60 ms to synthesize)."""
    import numpy as np

    from sdtk_tpu_torch.data.synth import synth_utterance

    rng = np.random.default_rng(seed)
    n_utt = b if b <= 128 else 32
    x = np.stack([synth_utterance(i % 16, 100 + i, n / 16000) for i in range(n_utt)])
    if n_utt < b:
        x = x[np.arange(b) % n_utt] * rng.uniform(0.5, 1.5, size=(b, 1))
    lengths = np.where(rng.uniform(size=b) < 0.25, rng.integers(400, n, size=b), n)
    x[np.arange(n)[None, :] >= lengths[:, None]] = 0.0
    return x.astype(np.float32), lengths.astype(np.int64)


def phase_kernel(device) -> dict:
    """K1: (B, N) waveform -> (B, T, 80) log-mel at the diarizer's chunk
    (128 one-second windows), bf16 in both log scales and f32; in bf16 also
    at the identify path's chunk (32 three-second windows), at a small
    ragged shape (3 x 4000: 23 frames a row, less than one tile), at the
    streaming path's chunk (16 windows of 1.5 s) and at the embed + cluster
    batch (1024 three-second windows, 196 MB of f32 input)."""
    import torch

    from sdtk_tpu_torch.ops import fbank, fbank_wave
    from sdtk_tpu_torch.ops.fbank import FrontendConfig

    configs = {
        "bf16-ln": FrontendConfig(),
        "bf16-db-fmin0": FrontendConfig(log_scale="db", mel_fmin=0.0),
        "f32-ln": FrontendConfig(compute_dtype="float32"),
    }
    cases = [(name, (128, 16000)) for name in configs]
    cases += [("bf16-ln", (32, 48000)), ("bf16-db-fmin0", (32, 48000)), ("bf16-ln", (3, 4000)),
              ("bf16-ln", (16, 24000)), ("bf16-ln", (1024, 48000))]
    f32 = configs["f32-ln"]
    win = torch.from_numpy(fbank.melbank.window(f32.win_length, f32.window)).to(device)
    mel = torch.from_numpy(fbank.melbank.mel_filterbank(
        f32.n_mels, f32.n_fft, f32.sample_rate, fmin=f32.mel_fmin)).to(device)
    rows = {}
    for name, (b, n) in cases:
        cfg = configs[name]
        x_np, len_np = speechlike_batch(b, n, seed=b)
        x = torch.from_numpy(x_np).to(device)
        lengths = torch.from_numpy(len_np).to(device)
        got, gmask = fbank_wave.log_mel_wave(x, cfg, lengths=lengths)
        want, wmask = fbank.log_mel(x, cfg, lengths=lengths)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{name} {(b, n)}: kernel output not finite")
        if not torch.equal(gmask, wmask):
            raise AssertionError(f"{name} {(b, n)}: frame masks differ")
        err = float((got - want).abs().max())
        if err > TOL[name]:
            raise AssertionError(f"{name} {(b, n)}: kernel vs plain max|d| {err} > {TOL[name]}")
        coeff = cfg.preemphasis
        raw_err = float((fbank_wave.log_mel_wave_cuda(x, cfg, coeff)
                         - fbank_wave.log_mel_wave_plain(x, cfg, coeff)).abs().max())

        def kernel(x=x, cfg=cfg, coeff=coeff):
            return fbank_wave.log_mel_wave_cuda(x, cfg, coeff)

        # yardstick: one PyTorch FFT pipeline for the same function (f32)
        def library(x=x):
            frames = fbank.preemphasize(x, f32.preemphasis).unfold(1, f32.win_length,
                                                                   f32.hop_length)
            spec = torch.fft.rfft(frames * win, n=f32.n_fft)
            return torch.log((spec.real ** 2 + spec.imag ** 2) @ mel + f32.log_floor)

        t = got.shape[1]
        n_freqs = cfg.n_fft // 2 + 1
        item = 2 if cfg.compute_dtype == "bfloat16" else 4
        nbytes = (x.numel() * 4 + b * t * cfg.n_mels * 4
                  + (2 * cfg.win_length * n_freqs + n_freqs * cfg.n_mels) * item)
        flops = 2 * b * t * cfg.win_length * n_freqs * 2 + 2 * b * t * n_freqs * cfg.n_mels
        row = {"shape": [b, n], "frames": t, "max_abs_err": err, "raw_max_abs_err": raw_err,
               "tol": TOL[name], "ms": cuda_ms(kernel),
               "plain_ms": cuda_ms(lambda: fbank_wave.log_mel_wave_plain(x, cfg, coeff)),
               "library_ms": cuda_ms(library), **bound(nbytes, flops, cfg.compute_dtype)}
        rows[name, b] = with_device_time(row, kernel, "log_mel_")
        emit({"phase": "kernel", "name": "log_mel_wave", "config": name,
              "library": "torch.fft.rfft + mel matmul (f32)", **rows[name, b]})
    return summary("log_mel_wave", "log_mel_wave.cu", "sdtk_tpu/ops/research/fbank_wave.py:148",
                   rows["bf16-ln", 128], "diarize")


def _gauss(shape, seed: int, device, dtype=None):
    import numpy as np
    import torch

    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32))
    return x.to(device=device, dtype=dtype or torch.float32)


def phase_kernel_cosine(device) -> dict:
    """K3: (Q, D) x (N, D) cosine, at the dense identify route's shape of
    the identify phase (29 windows x 8 192 profiles), at (32, 4096) and a
    ragged (29, 4093), for a 5-minute query (199 windows) and at the
    x-vector width (D = 512).  The bound counts f32-accurate products at the
    card's fastest route for them, 3xTF32; beside the kernel's times, the
    library call's device time (all its kernels) and the host time of both
    calls."""
    import torch
    import torch.nn.functional as F

    from sdtk_tpu_torch.ops import cosine
    from sdtk_tpu_torch.tools.measure import device_ms_by_kernel, host_ms

    rows = {}
    for q_n, p_n, d in ((29, IDENTIFY_N, D), (32, 4096, D), (29, 4093, D), (199, IDENTIFY_N, D),
                        (29, IDENTIFY_N, 512)):
        q, p = _gauss((q_n, d), q_n, device), _gauss((p_n, d), p_n + d, device)
        got = cosine.cosine_cuda(q, p)
        want = cosine.cosine_plain(q, p)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not bool(torch.isfinite(got).all()) or err > SCORE_TOL:
            raise AssertionError(f"cosine ({q_n}, {p_n}, {d}): kernel vs plain max|d| {err}")

        def kernel(q=q, p=p):
            return cosine.cosine_cuda(q, p)

        def library(q=q, p=p):
            return F.normalize(q, dim=1) @ F.normalize(p, dim=1).T

        row = {"shape": [q_n, p_n, d], "max_abs_err": err, "tol": SCORE_TOL,
               "ms": cuda_ms(kernel), "plain_ms": cuda_ms(lambda: cosine.cosine_plain(q, p)),
               "library_ms": cuda_ms(library),
               "library_device_ms": sum(device_ms_by_kernel(library).values()),
               "host_ms": host_ms(kernel), "library_host_ms": host_ms(library),
               **bound(4 * (q_n * d + p_n * d + q_n * p_n), 2 * q_n * p_n * d, "tf32x3")}
        row = with_device_time(row, kernel, "cosine_kernel")
        emit({"phase": "kernel", "name": "cosine",
              "library": "F.normalize(q) @ F.normalize(p).T", **row})
        rows[(q_n, p_n, d)] = row
    return summary("cosine", "cosine.cu", "sdtk_tpu/ops/cosine.py:94",
                   rows[(29, IDENTIFY_N, D)], "identify")


def phase_kernel_topk(device) -> dict:
    """K2: cosine -> max over windows -> top-k, at the identify phase's
    shape (32 windows x 8 192 profiles, k 192), at catalog scale (64 x
    100 000, k 64 and 128, f32 and bf16 profiles, and k 512, a whole tile
    of survivors; and 512 columns, the x-vector width) and at a ragged
    8 193 profiles with one window (bucketed to 8 as the dispatcher
    buckets).  The survivor sets must equal the plain version's.  Device
    time covers both passes (kernels named ``identify_topk_*``); the bound
    counts f32-accurate products at the card's fastest route for them,
    3xTF32 on the tensor cores, or two TF32 products where the profiles are
    bf16 (exact in TF32, so they have no small half)."""
    import torch
    import torch.nn.functional as F

    from sdtk_tpu_torch.ops import topk, topk_fused

    cases = [(32, IDENTIFY_N, D, 192, torch.float32)]
    cases += [(64, 100_000, D, k, dt) for dt in (torch.float32, torch.bfloat16) for k in (64, 128)]
    cases += [(64, 100_000, D, 512, torch.float32), (1, 8193, D, 64, torch.float32),
              (64, 100_000, 512, 64, torch.float32)]
    rows = {}
    for w, n, d, k, dt in cases:
        q = topk.bucket_windows(_gauss((w, d), w, device)).contiguous()
        p = _gauss((n, d), n, device, dt)
        s, i = topk_fused.identify_topk_cuda(q, p, k)
        ws, wi = topk.identify_topk_plain(q, p, k)
        torch.cuda.synchronize()
        err = float((s - ws).abs().max())
        same = set(i.tolist()) == set(wi.tolist())
        ordered = bool((s[:-1] >= s[1:]).all())
        name = f"w{q.shape[0]}-n{n}-k{k}-{str(dt).split('.')[-1]}" + ("" if d == D else f"-d{d}")
        if not (same and ordered and err <= SCORE_TOL):
            raise AssertionError(f"identify_topk {name}: survivors equal {same}, "
                                 f"sorted {ordered}, max|d| {err}")

        def library(q=q, p=p, k=k):
            return torch.topk((F.normalize(q, dim=1) @ F.normalize(p.float(), dim=1).T).amax(0), k)

        nbytes = q.numel() * 4 + p.numel() * p.element_size() + k * (4 + 8)
        flops = 2 * q.shape[0] * n * d + 2 * (q.shape[0] + n) * d
        row = {"shape": [q.shape[0], n, d], "k": k, "profiles": str(dt).split(".")[-1],
               "survivors_equal": same, "max_abs_err": err, "tol": SCORE_TOL,
               "ms": cuda_ms(lambda: topk_fused.identify_topk_cuda(q, p, k)),
               "plain_ms": cuda_ms(lambda: topk.identify_topk_plain(q, p, k)),
               "library_ms": cuda_ms(library),
               **bound(nbytes, flops, "tf32x3" if dt == torch.float32 else "tf32x2")}
        row = with_device_time(row, lambda: topk_fused.identify_topk_cuda(q, p, k),
                               "identify_topk_")
        emit({"phase": "kernel", "name": "identify_topk", "config": name,
              "library": "torch.topk((F.normalize(q) @ F.normalize(p).T).amax(0), k)", **row})
        rows[name] = row
    return summary("identify_topk", "identify_topk.cu", "sdtk_tpu/ops/research/topk_pallas.py:29",
                   rows[f"w32-n{IDENTIFY_N}-k192-float32"], "identify")


def phase_kernel_frames(device) -> dict:
    """K4: (M, 400) frames -> (M, 80) log-mel at the diarizer's frame count
    (128 one-second windows -> M = 12 544), bf16 and f32 compute; in bf16
    also at the identify chunk's frame count (32 x 298 = 9 536) and at
    M = 65 (one tile and one frame).  No serving path calls it."""
    import torch

    from sdtk_tpu_torch.ops import fbank, fbank_frames
    from sdtk_tpu_torch.ops.fbank import FrontendConfig

    fbank_frames.fbank_frames.launches = 0  # K4 has no path: its entry counts this phase
    configs = {"bf16-ln": FrontendConfig(), "f32-ln": FrontendConfig(compute_dtype="float32")}
    f32 = configs["f32-ln"]
    win = torch.from_numpy(fbank.melbank.window(400, f32.window)).to(device)
    mel = torch.from_numpy(fbank.melbank.mel_filterbank(
        f32.n_mels, f32.n_fft, f32.sample_rate, fmin=fbank_frames.JAX_MEL_FMIN)).to(device)
    rows = {}
    for name, (b, n), m in (("bf16-ln", (128, 16000), 12544), ("f32-ln", (128, 16000), 12544),
                            ("bf16-ln", (32, 48000), 9536), ("bf16-ln", (1, 16000), 65)):
        cfg = configs[name]
        x = torch.from_numpy(speechlike_batch(b, n, seed=b)[0]).to(device)
        frames = fbank.preemphasize(x, 0.97).unfold(1, 400, 160).reshape(-1, 400)[:m].contiguous()
        if frames.shape[0] != m:
            raise AssertionError(f"expected {m} frames, got {frames.shape[0]}")
        got = fbank_frames.fbank_frames_cuda(frames, cfg)
        want = fbank_frames.fbank_frames_plain(frames, cfg)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not bool(torch.isfinite(got).all()) or err > TOL[name]:
            raise AssertionError(f"fbank_frames {name} M={m}: kernel vs plain max|d| {err}")

        def kernel(frames=frames, cfg=cfg):
            return fbank_frames.fbank_frames_cuda(frames, cfg)

        def library(frames=frames):
            spec = torch.fft.rfft(frames * win, n=f32.n_fft)
            return torch.log((spec.real ** 2 + spec.imag ** 2) @ mel + f32.log_floor)

        n_freqs = cfg.n_fft // 2 + 1
        item = 2 if cfg.compute_dtype == "bfloat16" else 4
        nbytes = m * 400 * 4 + m * cfg.n_mels * 4 + (2 * 400 * n_freqs + n_freqs * cfg.n_mels) * item
        flops = 2 * m * 400 * n_freqs * 2 + 2 * m * n_freqs * cfg.n_mels
        row = {"shape": [m, 400], "max_abs_err": err, "tol": TOL[name], "ms": cuda_ms(kernel),
               "plain_ms": cuda_ms(lambda: fbank_frames.fbank_frames_plain(frames, cfg)),
               "library_ms": cuda_ms(library), **bound(nbytes, flops, cfg.compute_dtype)}
        rows[name, m] = with_device_time(row, kernel, "log_mel_")
        emit({"phase": "kernel", "name": "fbank_frames", "config": name,
              "library": "torch.fft.rfft + mel matmul (f32)", **rows[name, m]})
    fbank_frames.fbank_frames(frames, FrontendConfig())  # the wrapper, as a caller would
    torch.cuda.synchronize()
    entry = summary("fbank_frames", "fbank_frames.cu", "sdtk_tpu/ops/research/fbank_frames.py:24",
                    rows["bf16-ln", 12544], None)
    entry["launches"] = fbank_frames.fbank_frames.launches
    return entry


def reset_launches() -> dict:
    """Every kernel wrapper, by kernel name, with its count set to 0."""
    from sdtk_tpu_torch.ops import cosine, fbank_frames, fbank_wave, topk_fused

    wrappers = {"log_mel_wave": fbank_wave.log_mel_wave, "cosine": cosine.cosine,
                "identify_topk": topk_fused.identify_topk_fused,
                "fbank_frames": fbank_frames.fbank_frames}
    for fn in wrappers.values():
        fn.launches = 0
    return wrappers


def read_launches(wrappers: dict) -> dict:
    return {name: fn.launches for name, fn in wrappers.items()}


def phase_identify(work: Path, device: str, phase: str = "identify",
                   n_rows: int = IDENTIFY_N) -> dict:
    """The profile side on the card, through the entry points a user calls
    (``pipeline.identify``), with the bundled c512 checkpoint of the tower
    in use and its calibration, at ``n_rows`` profile rows of the tower's
    width.  Each query runs on the fused route (``SDTK_IDENTIFY_TOPK_N`` at
    ``n_rows``) and on the dense route (above it).  Returns the launch
    counts of the path."""
    import numpy as np
    import torch

    from sdtk_tpu_torch.backends.base import get_backend
    from sdtk_tpu_torch.data.synth import synth_utterance
    from sdtk_tpu_torch.ops.cosine import score_rows
    from sdtk_tpu_torch.ops.topk import identify_topk
    from sdtk_tpu_torch.pipeline import identify as ident
    from sdtk_tpu_torch.store import profiles as P
    from sdtk_tpu_torch.utils.audio import save_wav

    os.environ["SPEAKERS_EMBEDDINGS_DIR"] = str(work / f"{phase}-store")
    voices = {f"voice-{v}": v for v in (3, 8, 13)}
    wavs = {}
    for sid, v in voices.items():
        save_wav(work / f"{sid}-enroll.wav", synth_utterance(v, 1, 12.0))
        save_wav(work / f"{sid}-query.wav", synth_utterance(v, 99, 45.0))  # held out
        wavs[sid] = (work / f"{sid}-enroll.wav", work / f"{sid}-query.wav")
    backend = get_backend("gpu", device=device)
    dim = backend.embedding_dim

    # voice-3 gets two more embeddings (halves of its enrollment WAV): E = 3
    # embeddings of one speaker, so the fused route keeps k = 64 * 3 rows
    extra = {"voice-3": [[(0.0, 6.0)], [(6.0, 12.0)]]}
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    n_distract = n_rows - len(voices) - sum(map(len, extra.values()))
    distractors = rng.standard_normal((n_distract, dim)).astype(np.float32)
    distractors /= np.linalg.norm(distractors, axis=1, keepdims=True)
    for j, vec in enumerate(distractors):
        profile = P.create_speaker_profile(f"distractor-{j:05d}", f"Distractor {j}")
        P.add_embedding(profile, backend.name, P.create_embedding_record(
            "synthetic", "0" * 32, [], backend.model_version, vector=vec))
        P.save_speaker(profile)
    store_s = time.perf_counter() - t0

    wrappers = reset_launches()
    torch.cuda.synchronize()
    enroll_s = {}
    for sid, (enroll_wav, _) in wavs.items():
        t0 = time.perf_counter()
        ident.enroll(sid, enroll_wav, create_missing=True, name=sid, device=device)
        enroll_s[sid] = time.perf_counter() - t0
        for segs in extra.get(sid, []):
            ident.enroll(sid, enroll_wav, segments=segs, device=device)
    routes, identify_s, by_route = {}, {}, {}
    for route, fused_n in (("fused", n_rows), ("dense", 10 * n_rows)):
        os.environ["SDTK_IDENTIFY_TOPK_N"] = str(fused_n)
        before = read_launches(wrappers)
        routes[route], identify_s[route] = {}, {}
        for sid, (_, query) in wavs.items():
            t0 = time.perf_counter()
            routes[route][sid] = ident.identify(query, device=device)
            identify_s[route][sid] = time.perf_counter() - t0
        by_route[route] = {k: v - before[k] for k, v in read_launches(wrappers).items()}
    os.environ.pop("SDTK_IDENTIFY_TOPK_N", None)  # verify takes the route N gives it
    verify = {sid: ident.verify(sid, query, device=device) for sid, (_, query) in wavs.items()}
    torch.cuda.synchronize()
    launches = read_launches(wrappers)

    # where one (warm) identify call spends its time, piece by piece
    sid, (_, query) = next(iter(wavs.items()))
    t = [time.perf_counter()]
    pm = P.ProfileMatrix.build(backend.name, speakers=P.list_all_speakers())
    t.append(time.perf_counter())
    q = backend.embed_windows(backend._load(query, None))
    t.append(time.perf_counter())
    k = 64 * (1 + len(extra["voice-3"]))  # as identify_speaker sizes k
    top_s, top_i = identify_topk(q, pm.matrix, k=k, device=backend.device)
    t.append(time.perf_counter())
    raw = score_rows(q, pm.matrix, device=backend.device)
    t.append(time.perf_counter())
    breakdown = dict(zip(("store_load", "embed", "score_fused", "score_dense"),
                         np.diff(t).tolist()))
    # raw best-window cosines of the k survivors, fused route vs dense route
    raw_err = float(np.abs(top_s - raw.max(axis=0)[top_i]).max())

    top = {r: {s: [(row["speaker_id"], row["score"]) for row in res[:3]]
               for s, res in rr.items()} for r, rr in routes.items()}
    emit({"phase": phase, "tower": backend.model_version, "profiles": len(pm), "dim": dim,
          "query_windows": int(q.shape[0]), "k": k,
          "store_write_seconds": store_s, "enroll_seconds": enroll_s,
          "identify_seconds": identify_s, "breakdown_seconds": breakdown,
          "top3": top, "raw_fused_vs_dense_max_abs_err": raw_err, "verify": verify,
          "launches": launches, "launches_by_route": by_route})
    for sid in wavs:
        fused, dense = top["fused"][sid][:1] or [(None, None)], top["dense"][sid][:1] or [(None, None)]
        (f_id, f_score), (d_id, d_score) = fused[0], dense[0]
        if f_id != sid or d_id != sid:
            raise AssertionError(f"{sid} not ranked first: fused {f_id}, dense {d_id}")
        if abs(f_score - d_score) > SCORE_TOL:
            raise AssertionError(f"{sid}: fused {f_score} vs dense {d_score}")
        if not verify[sid]["match"]:
            raise AssertionError(f"verify did not match {sid}: {verify[sid]}")
    if raw_err > SCORE_TOL:
        raise AssertionError(f"raw survivor scores: fused vs dense max|d| {raw_err}")
    per_spk = max(sum(r["speaker_id"] == sid for r in pm.rows) for sid in wavs)
    if len(pm) != n_rows or q.shape[0] < 29 or 64 * per_spk != k or q.shape[1] != dim:
        raise AssertionError(f"identify ran at N={len(pm)}, W={q.shape[0]}, "
                             f"{per_spk} embeddings of one speaker")
    if (by_route["fused"]["identify_topk"] <= 0 or by_route["dense"]["cosine"] <= 0
            or launches["log_mel_wave"] <= 0):
        raise AssertionError(f"a kernel of the identify path was not launched: {by_route}")
    return launches


def phase_cli_detection(work: Path, device: str) -> None:
    """``cli.detection`` on a small store: add, enroll, identify --format
    json and verify, each rc 0 with the speaker found."""
    from sdtk_tpu_torch.cli import detection

    os.environ["SPEAKERS_EMBEDDINGS_DIR"] = str(work / "cli-store")

    def run(*argv) -> tuple[int, str]:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = detection.main(["-q", *argv])
        return rc, out.getvalue()

    rcs = {}
    for sid in ("voice-3", "voice-8"):
        rcs[f"add {sid}"] = run("add", sid, "--name", sid.title())[0]
        rcs[f"enroll {sid}"] = run("enroll", sid, str(work / f"{sid}-enroll.wav"),
                                   "--device", device)[0]
    rcs["identify"], out = run("identify", str(work / "voice-8-query.wav"), "--format", "json",
                               "--device", device)
    rows = json.loads(out) if rcs["identify"] == 0 else []
    rcs["verify"], verdict = run("verify", "voice-8", str(work / "voice-8-query.wav"),
                                 "--device", device)
    first = rows[0]["speaker_id"] if rows else None
    emit({"phase": "cli-detection", "rcs": rcs, "identify_first": first,
          "verify": verdict.strip()})
    if any(rcs.values()) or first != "voice-8":
        raise AssertionError(f"detection CLI: rcs {rcs}, first {first}")


def phase_tower(engine, wav, phase: str = "tower", win: int = 16000) -> None:
    """The engine's tower on the card in its serving dtype against the same
    weights in f32 on the CPU (plain log-mel), 8 windows of ``win``
    samples, one of them ragged: per-window cosine."""
    from dataclasses import replace

    import numpy as np
    import torch

    from sdtk_tpu_torch.models.ecapa import l2_normalize
    from sdtk_tpu_torch.ops import fbank

    windows = np.stack([wav[i * 6000 : i * 6000 + win] for i in range(8)]).astype(np.float32)
    lengths = np.full(8, win, np.int64)
    lengths[-1] = 5000  # one ragged row
    gpu = engine.embed(windows, lengths).float().cpu().numpy()
    cpu_model = type(engine.model)(replace(engine.model.cfg, dtype="float32"))
    cpu_model.load_state_dict({k: v.cpu() for k, v in engine.model.state_dict().items()})
    with torch.inference_mode():
        feats, mask = fbank.log_mel(torch.from_numpy(windows),
                                    replace(engine.cfg, compute_dtype="float32"),
                                    lengths=torch.from_numpy(lengths))
        cpu = l2_normalize(cpu_model.eval()(feats, mask)).numpy()
    cos = (gpu * cpu).sum(axis=1)
    emit({"phase": phase, "tower": type(engine.model).__name__, "dtype": engine.model.cfg.dtype,
          "params": engine.params_source, "windows": 8, "window_samples": win,
          "dim": int(gpu.shape[1]), "min_cosine": float(cos.min()), "bar": TOWER_COS_BAR,
          "finite": bool(np.isfinite(gpu).all())})
    if not np.isfinite(gpu).all() or cos.min() < TOWER_COS_BAR:
        raise AssertionError(f"{phase}: tower on the card disagrees with the CPU: cos {cos.min()}")


def phase_spectral() -> None:
    """The spectral device path (the diarizer's route from 1024 windows
    on) on the card, dense eigh and subspace iteration, against the
    NumPy host path on the same embeddings: labels up to permutation."""
    import numpy as np
    import torch

    from sdtk_tpu_torch.cluster import spectral

    rng = np.random.default_rng(0)
    n, k = 1536, 4
    truth = np.repeat(np.arange(k), n // k)
    emb = rng.standard_normal((k, 192))[truth] + 0.9 * rng.standard_normal((n, 192))
    emb = (emb / np.linalg.norm(emb, axis=1, keepdims=True)).astype(np.float32)
    host, k_host = spectral._spectral_cluster_numpy(emb, None, 8, 0.95, merge_rel=0.75)
    for subspace in (False, True):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        labels, k_dev = spectral.spectral_cluster(emb, force_device=True, use_subspace=subspace,
                                                  merge_rel=0.75, device="cuda")
        seconds = time.perf_counter() - t0
        pairs = set(zip(labels.tolist(), host.tolist()))
        agree = k_dev == k_host == k and len(pairs) == k
        emit({"phase": "spectral", "windows": n, "subspace": subspace, "k": k_dev,
              "k_host": k_host, "labels_agree": agree, "seconds": seconds})
        if not agree:
            raise AssertionError("spectral device path disagrees with the host path")


@contextlib.contextmanager
def tower(name: str):
    """Run the block with ``$SDTK_BACKEND_TOWER`` set to ``name``; the
    registry's cached ``gpu`` backend is dropped on the way in and out, so
    the backend is built anew with that tower."""
    from sdtk_tpu_torch.backends.base import register_backend

    target = "sdtk_tpu_torch.backends.gpu:GpuBackend"
    os.environ["SDTK_BACKEND_TOWER"] = name
    register_backend("gpu", target)
    try:
        yield
    finally:
        os.environ.pop("SDTK_BACKEND_TOWER", None)
        register_backend("gpu", target)


def phase_streaming(wav, ref, device: str) -> dict:
    """``OnlineDiarizer`` on the card with the default tower: the meeting
    fed in 0.5 s chunks as it would arrive, each chunk's latency on the
    host clock (a feed ends on the device-to-host copy of its embeddings),
    the real-time factor, live and ``finalize()`` DER at collar 0.75.
    Returns the launch counts of the path."""
    import numpy as np
    import torch

    from sdtk_tpu_torch.cluster.der import diarization_error_rate
    from sdtk_tpu_torch.pipeline.streaming import OnlineDiarizer, StreamingConfig
    from sdtk_tpu_torch.tools.measure import device_ms_by_kernel, host_ms

    chunk = 8000
    wrappers = reset_launches()
    torch.cuda.synchronize()
    t_start = time.perf_counter()
    d = OnlineDiarizer(cfg=StreamingConfig(), device=device)
    latency_ms, events = [], 0
    for i in range(0, len(wav), chunk):
        t0 = time.perf_counter()
        events += len(d.feed(wav[i : i + chunk]))
        latency_ms.append((time.perf_counter() - t0) * 1e3)
    live = d.segments()
    t0 = time.perf_counter()
    fin = d.finalize()
    finalize_s = time.perf_counter() - t0
    total_s = time.perf_counter() - t_start
    launches = read_launches(wrappers)
    audio_s = len(wav) / 16000
    der_live = diarization_error_rate(ref, live, collar=0.75)["der"]
    der_fin = diarization_error_rate(ref, fin["segments"], collar=0.75)["der"]
    one_row = [wav[:24000]]  # what a feed that completes one window embeds
    embed_host = host_ms(lambda: d.backend.embed_batch(one_row), reps=20)
    embed_dev = device_ms_by_kernel(lambda: d.backend.embed_batch(one_row), reps=5)
    emit({"phase": "streaming", "tower": d.backend.model_version, "audio_seconds": audio_s,
          "chunk_seconds": chunk / 16000, "chunks": len(latency_ms), "windows": events,
          "chunk_latency_ms": {"p50": float(np.percentile(latency_ms, 50)),
                               "p95": float(np.percentile(latency_ms, 95)),
                               "max": max(latency_ms)},
          "finalize_seconds": finalize_s, "rtf": total_s / audio_s,
          "embed_one_window": {"host_ms": embed_host, "device_ms": sum(embed_dev.values()),
                               "kernels": len(embed_dev)},
          "new_speaker_threshold": d.new_speaker_threshold, "n_speakers": fin["n_speakers"],
          "der_live_c075": der_live, "der_final_c075": der_fin, "der_bar": DER_BAR,
          "launches": launches})
    if launches["log_mel_wave"] <= 0:
        raise AssertionError("kernel log_mel_wave was not launched on the streaming path")
    if fin["n_speakers"] != 3 or not der_fin <= DER_BAR:
        raise AssertionError(f"streaming: {fin['n_speakers']} speakers, final DER {der_fin}")
    return launches


def phase_embed_cluster(engine) -> dict:
    """What ``bench.py`` times, on the card: K1 -> the ECAPA tower (bundled
    weights, bf16) -> L2 -> ``cluster_stage(max_speakers=8,
    use_subspace=True)`` on a (1024, 48 000) batch of 3 s windows, 20 steps
    each chained on the one before (the next input depends on the
    last output, so no step can be skipped or reordered), by CUDA events;
    embed alone the same way.  Returns the launch counts of the path."""
    import numpy as np
    import torch

    from sdtk_tpu_torch.cluster.spectral import bench_cluster_fn
    from sdtk_tpu_torch.tools.measure import device_ms_by_kernel

    b, n, steps = 1024, 48000, 20
    x0 = torch.from_numpy(speechlike_batch(b, n, seed=7)[0]).to(engine.device)
    lengths = torch.full((b,), n, device=engine.device)
    cluster = bench_cluster_fn(max_speakers=8, use_subspace=True)

    def embed(x):
        return engine.embed(x, lengths)

    def embed_cluster(x):
        return cluster(engine.embed(x, lengths))

    @torch.inference_mode()
    def chained(fn) -> float:
        fn(x0)  # warm
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        x = x0
        start.record()
        for _ in range(steps):
            out = fn(x)
            x = x0 + out.reshape(-1)[0].float() * 1e-30
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / 1e3

    wrappers = reset_launches()
    embed_s = chained(embed)
    full_s = chained(embed_cluster)
    launches = read_launches(wrappers)
    with torch.inference_mode():
        labels = embed_cluster(x0)
        emb = embed(x0)
        by_kernel = {"embed": device_ms_by_kernel(lambda: embed(x0), reps=3),
                     "cluster": device_ms_by_kernel(lambda: cluster(emb), reps=3)}
    torch.cuda.synchronize()
    top = {stage: {"device_ms": sum(ms.values()), "kernels": len(ms),
                   "top": sorted(ms.items(), key=lambda kv: -kv[1])[:6]}
           for stage, ms in by_kernel.items()}
    audio_s = b * n / 16000 * steps
    sizes = np.bincount(labels.cpu().numpy(), minlength=8)
    cfg = engine.model.cfg
    emit({"phase": "embed-cluster", "batch": [b, n], "steps": steps,
          "tower": f"{type(engine.model).__name__} c{cfg.channels} {cfg.dtype}",
          "params": engine.params_source, "eigensolver": "subspace",
          "embed_seconds": embed_s, "embed_cluster_seconds": full_s,
          "embed_audio_s_per_s": audio_s / embed_s,
          "embed_cluster_audio_s_per_s": audio_s / full_s,
          "cluster_share": (full_s - embed_s) / full_s, "device_ms_by_stage": top,
          "cluster_sizes": sizes.tolist(),
          "labels_device": str(labels.device), "launches": launches})
    if labels.device.type != engine.device.type or labels.shape != (b,) or sizes.sum() != b:
        raise AssertionError(f"embed-cluster: labels {labels.shape} on {labels.device}")
    return launches


def main() -> int:
    if not (ROOT / "sdtk_tpu_torch").is_dir():
        print("chip_smoke.py must run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("CUDA is not available: the smoke test needs a GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 products in full f32
    device = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout
    smi_line = smi.strip().splitlines()[0]
    emit({"phase": "env", "nvidia_smi": smi_line, "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "python": sys.version.split()[0]})

    from sdtk_tpu_torch.utils import build

    t0 = time.perf_counter()
    logs = build.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "kernels": sorted(logs),
          "ptxas": {k: [ln.strip() for ln in v.splitlines() if "Used" in ln or "spill" in ln]
                    for k, v in logs.items()},
          "tensor_core_instructions": mma_counts()})

    kernel_rows = [phase_kernel(device), phase_kernel_cosine(device),
                   phase_kernel_topk(device), phase_kernel_frames(device)]

    import numpy as np

    from sdtk_tpu_torch.cluster.der import diarization_error_rate
    from sdtk_tpu_torch.data.synth import build_meeting
    from sdtk_tpu_torch.pipeline.diarize import DiarizeConfig, Diarizer

    wav, ref = build_meeting(0, 3, 20, 3.0)
    diarizer = Diarizer(cfg=DiarizeConfig(), device="cuda")
    phase_tower(diarizer.backend.engine, wav)  # also loads the weights before the timed run

    wrappers = reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = diarizer.diarize_waveform(wav)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches(wrappers)
    der = diarization_error_rate(ref, result["segments"], collar=0.75)
    audio_s = len(wav) / 16000
    emit({"phase": "main", "audio_seconds": audio_s, "windows": len(result["window_labels"]),
          "n_speakers": result["n_speakers"], "der_c075": der["der"], "der_bar": DER_BAR,
          "miss": der["miss"], "false_alarm": der["false_alarm"], "confusion": der["confusion"],
          "wall_seconds": wall, "audio_s_per_s": audio_s / wall, "stage_seconds": result["timings"],
          "launches": launches, "params": diarizer.backend.engine.params_source})
    if launches["log_mel_wave"] <= 0:
        raise AssertionError("kernel log_mel_wave was not launched on the diarize path")
    if result["n_speakers"] != 3:
        raise AssertionError(f"expected 3 speakers, got {result['n_speakers']}")
    if not der["der"] <= DER_BAR:
        raise AssertionError(f"DER {der['der']} > {DER_BAR}")

    t0 = time.perf_counter()
    warm = diarizer.diarize_waveform(wav)  # a second, warm run: first-call costs excluded
    warm_wall = time.perf_counter() - t0
    emit({"phase": "main-warm", "wall_seconds": warm_wall, "audio_s_per_s": audio_s / warm_wall,
          "stage_seconds": warm["timings"],
          "same_labels": warm["window_labels"] == result["window_labels"]})

    eng = diarizer.backend.engine
    chunk = np.stack([wav[i * 6000 : i * 6000 + 16000] for i in range(128)])
    lens = np.full(128, 16000, np.int32)
    embed_ms = cuda_ms(lambda: eng.embed(chunk, lens), reps=10, warmup=2)
    emit({"phase": "embed", "windows": 128, "window_seconds": 1.0, "ms_per_chunk": embed_ms,
          "embed_audio_s_per_s": 128.0 / (embed_ms / 1e3)})

    phase_spectral()

    from sdtk_tpu_torch.cli import diarize as cli
    from sdtk_tpu_torch.utils.audio import save_wav

    out_dir = ROOT / "sdtk_tpu_torch" / "_build" / "smoke"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    save_wav(out_dir / "meeting.wav", wav)
    rc = cli.main([str(out_dir / "meeting.wav"), "--format", "rttm", "-q",
                   "-o", str(out_dir / "meeting.rttm")])
    n_lines = len((out_dir / "meeting.rttm").read_text().splitlines())
    emit({"phase": "cli", "rc": rc, "rttm_lines": n_lines})
    if rc != 0 or n_lines == 0:
        raise AssertionError("diarize CLI produced no RTTM")

    path_launches = {"diarize": launches, "identify": phase_identify(out_dir, "cuda")}
    phase_cli_detection(out_dir, "cuda")
    path_launches["streaming"] = phase_streaming(wav, ref, "cuda")

    from sdtk_tpu_torch.backends.base import get_backend

    with tower("xvector"):
        phase_tower(get_backend("gpu", device="cuda").engine, wav, "tower-xvector", win=48000)
        path_launches["identify-xvector"] = phase_identify(out_dir, "cuda", "identify-xvector",
                                                           XVECTOR_IDENTIFY_N)
    path_launches["embed-cluster"] = phase_embed_cluster(diarizer.backend.engine)

    for row in kernel_rows:
        if row["path"] is not None:
            row["launches"] = path_launches[row["path"]][row["name"]]
        row["launches_by_path"] = {p: counts[row["name"]] for p, counts in path_launches.items()}
    emit({"kernels": kernel_rows})
    print(smi_line, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
