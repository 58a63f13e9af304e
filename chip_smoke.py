#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``sdtk_tpu_torch``) on one GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It imports nothing of JAX or of ``sdtk_tpu``.  Phases, one JSON line each;
any failure raises and exits non-zero:

1. env     — card, power limit, torch and CUDA versions;
2. build   — every kernel under ``sdtk_tpu_torch/csrc`` built with nvcc
             (one process per source, started together), timed; then the
             host library (``csrc/host``, ``g++``), timed;
3. kernel  — each kernel against its plain PyTorch version on the card at
             the main path's shape, with stated tolerances; kernel, plain
             and library times (CUDA events around the wrapper, median of
             30 launches after warm-up, L2 warm), the kernel's device time
             alone (``torch.profiler``) and the bound from this run's inputs;
             the tower epilogue (port only) also against the eager chain it
             replaces; its launches are checked on each path it serves
             (and on none of the training paths) after the last phase;
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
15. assign — ``cli.assign`` (speaker-assign-gpu) on AssemblyAI and
             Speechmatics transcripts of the phase-5 meeting, labels
             shuffled, against the identify store plus voices 0-2 (N =
             8 195, D = 192), fused and dense route: every label to its true
             voice with an ``embedding_match`` signal, the log-mel kernel and
             the route's scoring kernel launched; ``show`` and ``apply``; wall
             seconds per call and its split; both scoring kernels against
             their plain versions at each label's window count;
16. process — ``cli.process`` (speaker-process-gpu) ``process DIR --backend
             local --parallel 2`` on three meetings, the kernels built anew
             under the worker threads: every item completed, every entry
             assigned, ``transcribe_local`` and ``speaker_assign`` in every
             recording's steps, the log-mel kernel launched; seconds per
             recording, audio-s per s, labels mapped to enrolled voices;
17. train-step — one training step of ECAPA c512 (bf16, warm-started from
             the fam5tel file, a seeded AAM head over 5 families x 64
             speakers) on one synthesized batch of 32 crops of 1.5 s, on the
             card and on the CPU from the same state: loss within 5 %
             relative, all gradients together at cosine >= 0.999, each
             tensor's within twice bf16's rounding (the CPU's bf16 gradient
             against its f32 one), every updated tensor at cosine >= 0.999;
             then 20 steps on that batch (the loss must fall), step time by
             CUDA events and by the profiler, peak memory; the step with the
             producer idle and with a thread synthesizing batches beside it;
             and the device-only rate at batch 256;
18. train — ``training.train`` with the fam5tel recipe (aug and noise at
             0.5), warm-started from the bundled file: 8 steps with a
             checkpoint every 4, then 2 more in a second call that restores
             step 8; K1 launched once a step (10), per-step host synthesis,
             queue wait, device step time, checkpoint seconds, and the
             device's idle share of the first call's loop by its own
             profile (``torch.profiler`` over the whole call); the
             saved file loads in ``GpuBackend`` and separates 8 unseen family
             voices (genuine-pair mean cosine above the impostor mean);
19. train-xvector — 2 steps of the full-width x-vector from scratch; the
             file loads through ``SDTK_BACKEND_TOWER=xvector``;
20. longform — ``cli.diarize --longform`` on a synthesized 3-speaker
             meeting of about an hour inside a one-rank NCCL group (the
             ``SDTK_*`` variables): 3 speakers, confusion and DER at
             collar 0.75 at or below fixed bars, K1 launched once; wall
             seconds, audio-s per s, stage seconds, peak memory, the
             device's idle share by the profiler; then the 61.3 s meeting
             of phase 5 (3 speakers, DER_BAR), the hour with the energy
             gate off (3 speakers, DER_BAR), and K1's launch on the
             path's own input against its plain version;
21. train-ddp — ``training.train(mesh_spec="data=1")`` in a one-rank NCCL
             group against the same 2 steps without a group: the losses
             bit for bit, the parameters within bf16's rounding, K1 once a
             step;
22. heldout-eer — ``python -m sdtk_tpu_torch.evals.eer`` with the bundled
             fam5tel (bf16), clean and telephone tiers at the JAX defaults
             (16 held-out speakers x 6 trials of 3 s): EER (bars 0.03 and
             0.05), its threshold, FAR / FRR at 0.354, the scored EER; K1
             launched, and held at the path's launch (16 rows of 3 s);
23. calibrate — ``evals.calibrate`` on a copy of fam5tel with the bundled
             sidecar's arguments: the fitted thresholds and merge bar within
             0.02 and the calibration EER within 0.01 of the bundled
             sidecar, read back by a ``GpuBackend`` over the copy; then with
             a 192-row cohort (``.cohort.npy`` written and read), and K3 at
             the cohort product's shape (96 x 192 x 192);
24. heldout-der — ``evals.der --heldout`` at its defaults (3 meetings, 3
             speakers, the count estimated): DER at collars 0.75 (bar 0.10)
             and 0.25;
25. decode — the main phase's meeting as FLAC and MPEG Layer II (and as a
             Layer III ``.mp3`` and an ``.m4a`` where the host has the
             codecs) through ``cli.diarize``: the FLAC's labels equal the
             WAV's, the MP2 (and MP3, M4A) give 3 speakers at DER_BAR, K1
             launched on each; ``load_audio_batch`` equals ``load_audio``;
26. train-vad-step — one step of the VAD trainer (v4 at full width, one
             batch of 64 windows of 1.5 s from ``make_batch``, one seeded
             ``VadNet``) on the card (K1, bf16 features) and on the CPU:
             loss within 1e-3 relative, each gradient and each updated
             tensor at cosine >= 0.999; 20 steps on that batch (the loss
             must fall, K1 once a step), step time by CUDA events and by
             the profiler, peak memory; K1 held at (64, 24 000);
27. train-vad — ``python -m sdtk_tpu_torch.evals.train_vad`` at the JAX
             defaults (400 steps of 64, v4) through ``main`` under the
             profiler: exit 0 (held-out window accuracy >= 0.9), K1 400
             times, the file read by ``VadScorer`` and by the trained gate
             on the meeting beside the bundled one; synthesis and step
             seconds, the device's idle share;
28. shell — catalog, report, review, samples, segments and llm through
             ``python -m sdtk_tpu_torch <tool>`` over the process phase's
             store: a jq query of its 3 recordings, report counts equal to
             the store's, an approved review segment written as a sample
             that identify on the card names (K1 and K2 launched); then
             ``detection`` validate (no issues), export in both formats
             (every profile), tag, update, check-validity and backends
             (``fake``, ``gpu`` and ``speechmatics`` listed);
29. tower-conformer — ``GpuBackend(model="conformer")`` at full width (dim
             256) from a seeded flax-msgpack file: 8 windows of 3 s on the
             card (bf16) against f32 on the CPU by cosine, mask invariance
             on the card in f32, ms per 128-window chunk, and
             ``cli.diarize`` under ``SDTK_BACKEND_TOWER=conformer`` (exit 0,
             K1 launched; untrained weights, so no DER bar);
30. train-conformer — the trainer's recipe with ``model_name="conformer"``:
             one step on the card against the CPU (loss and all gradients at
             train-step's bars), 10 steps on one batch (step ms by CUDA
             events and by the profiler, peak memory), then 2 steps of
             ``training.train`` (K1 twice) whose file loads through
             ``SDTK_BACKEND_TOWER=conformer``;
31. conformer-sp — ``ops.ringattn.conformer_sp_embed`` in a one-rank NCCL
             group on K1's features of the phase-5 meeting against the dense
             module on the card, both f32, at rtol = atol = 2e-4; wall ms and
             peak memory of each; K1 held at the path's (1, N) shape;
32. train-tp — the trainer's model axis: one step of ECAPA c512 (bf16,
             fam5tel, 320 classes, the recipe's batch of 32 x 1.5 s) at
             ``data=1,model=2`` on two ranks sharing the card (a gloo group
             over CUDA tensors) against the step without a group: loss within
             1 %, every gradient and updated tensor at cosine >= 0.999, each
             rank's parameter elements equal to the sharding rules' count,
             the sharded eval forward of 8 windows of 3 s at cosine >= 0.9999,
             K1 once in each rank's step; step ms and peak memory per rank;
33. native — the host library (``csrc/host``, ``g++``) loaded; the meeting
             as 16-bit WAV at 44.1 and 48 kHz and as 24-bit stereo at
             22.05 kHz, read by the C++ reader (max|d| against SciPy's path,
             no bar) and diarized through ``cli.diarize`` (3 speakers,
             DER_BAR, K1 launched); ``load_audio_batch`` equal to
             ``load_audio``, bit for bit; BLAKE3 of a file of the hour's size
             natively and in NumPy (one digest, seconds of each);
34. profile — ``SDTK_PROFILE=1``: a child process's warm diarize reports
             the five ``diarize.*`` stages; one diarize inside
             ``profiling.trace(dir)`` writes a Chrome trace with K1's kernel
             among its CUDA events;
35. evals  — ``evals.identify --backend gpu`` (4 speakers; each case's
             identified speakers equal to the CPU's, K1 launched),
             ``evals.streaming --der --heldout`` (exit 0, DER recorded) and
             ``evals.warmup`` (exit 0, every library under ``_build``);
36. speechbrain — a seeded spkrec-ecapa-voxceleb checkpoint directory at the
             published width (ECAPA c1024, MFA 3072) converted by
             ``python -m sdtk_tpu_torch.tools.convert_ecapa --verify`` on
             the meeting (f32 tower on the card vs the f64 reference,
             cosine >= 0.9999); K1 at SpeechBrain's frontend (n_fft 400,
             Hamming, centered, dB) vs plain at (128, 16 000) and
             (32, 48 000); with ``SDTK_MODEL_PATH`` on the file: the tower
             vs f32 on the CPU, ms per 128 x 1 s chunk beside the c512's,
             peak memory, share of the bf16 peak, ``cli.diarize`` (rc 0, K1
             launched) and identify at N = 2 048 on both routes (scores
             within 1e-5, K2 and K3 launched);
37. mfu    — ``python -m sdtk_tpu_torch.evals.mfu_probe`` (frontend, tower,
             full at batch 1024 x 3 s, 10 chained steps): every share of
             the bf16 peak in (0, 1], K1 launched;
38. scaling — ``evals.benchmark_scaling`` on one rank in an NCCL group (a
             spawned process) at full width (ECAPA c512, 1024 x 3 s, 3
             chained steps after a warm-up): audio-s per s, peak memory,
             K1 once a step;
39. topk-scale — ``evals.benchmark_topk`` at its defaults (W 64, D 192,
             k 64, bf16 profiles, N = 100 000 and 1 000 000): its hard gate
             against the library decomposition passed, K2 launched and held
             against its plain version at both N (survivors equal, 1e-5);
40. frontend — ``evals.benchmark_frontend`` at (1024, 48 000): plain,
             K4 on the framed copy and K1, their spot checks within 0.05;
             K4's first path (launched at least once), and K4 held against
             its plain version at that path's M = 305 152 with its times;
41. decode-sweep — ``evals.benchmark_decode`` (16 WAVs of 30 s at
             44.1 kHz): the C++ loader at 1, 2, 4 and every core against
             the NumPy path; no kernel;

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
every path driven, ``launches_by_path``, ``train`` among them; K4's row
is its ``frontend`` path's shape), the card's
name and power limit as ``nvidia-smi`` prints them, and ``{"ok": true, "device": {...}}`` last.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Kernel vs plain, same inputs and compute dtype.  Both sum exact products
# in f32 but in another order, so power values differ by a few f32 ulps;
# where that flips a bf16 rounding of a power bin (one bf16 ulp = 0.4 %),
# a narrow low mel band (1-2 bins) moves by up to ~4e-3 in ln.  The bars
# leave 10x room; dB is 10/ln(10) times the ln scale.
TOL = {"bf16-ln": 0.05, "bf16-db-fmin0": 0.25, "f32-ln": 2e-3, "bf16-speechbrain": 0.25}
# Cosine and identify top-k: f32-accurate products on both sides (3xTF32 in
# the kernels, f32 in the plain versions), summed in another order, a few
# f32 ulps of a cosine.
SCORE_TOL = 1e-5
D = 192  # ECAPA embedding width
IDENTIFY_N = 8192  # profile rows of the identify phase: the fused route's threshold
XVECTOR_IDENTIFY_N = 2048  # the x-vector identify phase's rows (full width, 512)
DER_BAR = 0.05
# The hour's bars are fixed, not taken from the labels under test.  A wrong
# clustering moves confusion.  The energy gate (the JAX package's rule: a
# window's mean log-mel above the loudest window's less 40 dB) drops quiet
# speech of this synthetic family, a miss of 0.058 on the hour, so the CLI's
# DER has that miss's room above DER_BAR; with the gate off the same hour
# is held to DER_BAR.
LONGFORM_CONFUSION_BAR = 0.01
LONGFORM_DER_BAR = 0.07
LONGFORM_SAMPLES = 57_600_000  # an hour at 16 kHz: the long-form frontend's row on one card
LONGFORM_TURNS = 1200  # build_meeting turns of ~3 s: about an hour
TOWER_COS_BAR = 0.995  # bf16 on the card vs f32 on the CPU, per window
GPU_BACKEND = "sdtk_tpu_torch.backends.gpu:GpuBackend"  # the registry's "gpu"


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps: int = 30, warmup: int = 5) -> float:
    """Median device time of ``fn`` over ``reps`` launches (CUDA events,
    ``tools/measure.py:event_ms``)."""
    from sdtk_tpu_torch.tools.measure import event_ms

    return event_ms(fn, reps, warmup)


def trace_device_us(prof, kernel: str = "") -> float:
    """Device microseconds in a ``torch.profiler`` trace, of the kernels
    whose name contains ``kernel`` ("" for every kernel and copy)."""
    return sum(float(getattr(e, "self_device_time_total", 0.0)
                     or getattr(e, "self_cuda_time_total", 0.0))
               for e in prof.key_averages()
               if kernel in e.key and str(e.device_type).endswith("CUDA"))


def device_ms(fn, kernel: str, reps: int = 20):
    """Mean device time of the CUDA kernel whose name contains ``kernel``
    over ``reps`` calls of ``fn`` (``torch.profiler``): the kernel alone,
    without the wrapper's host work.  A trace that shows no device time, or
    that dropped launches (``tools/measure.py:whole``), is taken once more,
    up to three traces; "not measured" where none shows a whole one."""
    from sdtk_tpu_torch.tools.measure import traced_kernels, whole

    for _ in range(3):
        rows = [r for r in traced_kernels(fn, reps) if kernel in r[0]]
        total_us = sum(us for _, us, _ in rows)
        if total_us > 0 and whole(rows, reps):
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
    """The least time the card could take (``tools/measure.py:bound``)."""
    from sdtk_tpu_torch.tools.measure import bound as card_bound

    return card_bound(nbytes, flops, dtype)


def summary(name: str, source: str, replaces: str, row: dict, path: str | None) -> dict:
    """One entry of the ``kernels`` line from a kernel-phase row."""
    keys = ("max_abs_err", "ms", "device_ms", "bound_share_of_device_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    extra = ("library_device_ms", "host_ms", "library_host_ms")  # where the phase took them
    return {"name": name, "route": "cuda", "source": f"sdtk_tpu_torch/csrc/{source}",
            "replaces": replaces, "path": path, "shape": row["shape"],
            **{k: row[k] for k in keys}, **{k: row[k] for k in extra if k in row}}


def long_speechlike(n: int, seed: int):
    """(1, n) synthetic speech of any length: one minute of voices, tiled at
    a random gain a minute (an hour of single utterances would take minutes
    to synthesize), and the full length."""
    import numpy as np

    minute, _ = speechlike_batch(1, 960_000, seed)
    reps = -(-n // minute.shape[1])
    gains = np.random.default_rng(seed).uniform(0.5, 1.5, size=(reps, 1)).astype(np.float32)
    x = (minute.reshape(1, -1) * gains).reshape(1, -1)[:, :n]
    return np.ascontiguousarray(x, np.float32), np.array([n], np.int64)


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


def k1_timing(x, cfg, coeff: float) -> tuple[float, dict]:
    """K1's raw output on (B, N) ``x`` at preemphasis ``coeff`` against its
    plain version: max|Δ|, and the kernel's, the plain version's and the
    library's times beside the bound.  For a centered ``cfg`` the kernel
    takes what the wrapper gives it: ``x`` preemphasized, zero-padded by
    win/2 on each side, and coefficient 0."""
    from dataclasses import replace

    import torch

    from sdtk_tpu_torch.ops import fbank, fbank_wave

    if cfg.center:
        x, coeff = fbank.pad_centered(fbank.preemphasize(x, coeff), cfg), 0.0
    raw_err = float((fbank_wave.log_mel_wave_cuda(x, cfg, coeff)
                     - fbank_wave.log_mel_wave_plain(x, cfg, coeff)).abs().max())
    f32 = replace(cfg, compute_dtype="float32")
    win = torch.from_numpy(fbank.melbank.window(f32.win_length, f32.window)).to(x.device)
    mel = torch.from_numpy(fbank.melbank.mel_filterbank(
        f32.n_mels, f32.n_fft, f32.sample_rate, fmin=f32.mel_fmin)).to(x.device)

    def kernel():
        return fbank_wave.log_mel_wave_cuda(x, cfg, coeff)

    # yardstick: one PyTorch FFT pipeline for the same function (f32)
    def library():
        frames = fbank.preemphasize(x, coeff).unfold(1, f32.win_length, f32.hop_length)
        spec = torch.fft.rfft(frames * win, n=f32.n_fft)
        return fbank.log_of_mel((spec.real ** 2 + spec.imag ** 2) @ mel, f32)

    b, n = x.shape
    t = fbank.melbank.num_frames(n, cfg.win_length, cfg.hop_length)
    n_freqs = cfg.n_fft // 2 + 1
    item = 2 if cfg.compute_dtype == "bfloat16" else 4
    nbytes = (x.numel() * 4 + b * t * cfg.n_mels * 4
              + (2 * cfg.win_length * n_freqs + n_freqs * cfg.n_mels) * item)
    flops = 2 * b * t * cfg.win_length * n_freqs * 2 + 2 * b * t * n_freqs * cfg.n_mels
    row = {"frames": t, "ms": cuda_ms(kernel),
           "plain_ms": cuda_ms(lambda: fbank_wave.log_mel_wave_plain(x, cfg, coeff)),
           "library_ms": cuda_ms(library), **bound(nbytes, flops, cfg.compute_dtype)}
    return raw_err, with_device_time(row, kernel, "log_mel_")


def k1_case(name: str, cfg, x_np, len_np, device, config: str | None = None) -> dict:
    """K1 on (B, N) ``x_np`` with ``len_np`` valid samples a row against its
    plain version (at ``TOL[name]``), with its times; emits the row."""
    import torch

    from sdtk_tpu_torch.ops import fbank, fbank_wave

    b, n = x_np.shape
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
    raw_err, timing = k1_timing(x, cfg, cfg.preemphasis)
    row = {"shape": [b, n], "max_abs_err": err, "raw_max_abs_err": raw_err, "tol": TOL[name],
           **timing}
    emit({"phase": "kernel", "name": "log_mel_wave", "config": config or name,
          "library": "torch.fft.rfft + mel matmul (f32)", **row})
    return row


def phase_kernel(device) -> dict:
    """K1: (B, N) waveform -> (B, T, 80) log-mel at the diarizer's chunk
    (128 one-second windows), bf16 in both log scales and f32; in bf16 also
    at the identify path's chunk (32 three-second windows), at a small
    ragged shape (3 x 4000: 23 frames a row, less than one tile), at the
    streaming path's chunk (16 windows of 1.5 s), at the embed + cluster
    batch (1024 three-second windows, 196 MB of f32 input), at the
    trainer's batches (32 crops of 1.5 s; 256 in train-step's rate) and at
    one row of an hour (57 600 000 samples, 360 000 frames).  Phase
    ``longform`` holds the long-form path's own launch (its input, its
    coefficient 0 and its length) against the plain version."""
    from sdtk_tpu_torch.ops.fbank import FrontendConfig

    configs = {
        "bf16-ln": FrontendConfig(),
        "bf16-db-fmin0": FrontendConfig(log_scale="db", mel_fmin=0.0),
        "f32-ln": FrontendConfig(compute_dtype="float32"),
    }
    cases = [(name, (128, 16000)) for name in configs]
    cases += [("bf16-ln", (32, 48000)), ("bf16-db-fmin0", (32, 48000)), ("bf16-ln", (3, 4000)),
              ("bf16-ln", (16, 24000)), ("bf16-ln", (1024, 48000)),
              ("bf16-ln", (32, 24000)), ("bf16-ln", (256, 24000)),
              ("bf16-ln", (1, LONGFORM_SAMPLES))]
    rows = {}
    for name, (b, n) in cases:
        x_np, len_np = speechlike_batch(b, n, seed=b) if b > 1 else long_speechlike(n, seed=1)
        rows[name, b, n] = k1_case(name, configs[name], x_np, len_np, device)
    return summary("log_mel_wave", "log_mel_wave.cu", "sdtk_tpu/ops/research/fbank_wave.py:148",
                   rows["bf16-ln", 128, 16000], "diarize")


def _gauss(shape, seed: int, device, dtype=None):
    import numpy as np
    import torch

    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32))
    return x.to(device=device, dtype=dtype or torch.float32)


def cosine_case(q, p, config: str | None = None) -> dict:
    """K3 on (Q, D) ``q`` and (N, D) ``p`` on the card against its plain
    version (at SCORE_TOL), with its times, the library call's and the
    bound; emits the row."""
    import torch
    import torch.nn.functional as F

    from sdtk_tpu_torch.ops import cosine
    from sdtk_tpu_torch.tools.measure import device_ms_by_kernel, host_ms

    (q_n, d), p_n = q.shape, p.shape[0]
    got = cosine.cosine_cuda(q, p)
    want = cosine.cosine_plain(q, p)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not bool(torch.isfinite(got).all()) or err > SCORE_TOL:
        raise AssertionError(f"cosine ({q_n}, {p_n}, {d}): kernel vs plain max|d| {err}")

    def kernel():
        return cosine.cosine_cuda(q, p)

    def library():
        return F.normalize(q, dim=1) @ F.normalize(p, dim=1).T

    row = {"shape": [q_n, p_n, d], "max_abs_err": err, "tol": SCORE_TOL,
           "ms": cuda_ms(kernel), "plain_ms": cuda_ms(lambda: cosine.cosine_plain(q, p)),
           "library_ms": cuda_ms(library),
           "library_device_ms": sum(device_ms_by_kernel(library).values()),
           "host_ms": host_ms(kernel), "library_host_ms": host_ms(library),
           **bound(4 * (q_n * d + p_n * d + q_n * p_n), 2 * q_n * p_n * d, "tf32x3")}
    row = with_device_time(row, kernel, "cosine_kernel")
    emit({"phase": "kernel", "name": "cosine", **({"config": config} if config else {}),
          "library": "F.normalize(q) @ F.normalize(p).T", **row})
    return row


def phase_kernel_cosine(device) -> dict:
    """K3: (Q, D) x (N, D) cosine, at the dense identify route's shape of
    the identify phase (29 windows x 8 192 profiles), at (32, 4096) and a
    ragged (29, 4093), for a 5-minute query (199 windows) and at the
    x-vector width (D = 512).  The bound counts f32-accurate products at the
    card's fastest route for them, 3xTF32; beside the kernel's times, the
    library call's device time (all its kernels) and the host time of both
    calls."""
    rows = {}
    for q_n, p_n, d in ((29, IDENTIFY_N, D), (32, 4096, D), (29, 4093, D), (199, IDENTIFY_N, D),
                        (29, IDENTIFY_N, 512)):
        q, p = _gauss((q_n, d), q_n, device), _gauss((p_n, d), p_n + d, device)
        rows[(q_n, p_n, d)] = cosine_case(q, p)
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


def k4_case(frames, name: str, config: str, reps: int = 30) -> dict:
    """K4 on (M, 400) ``frames`` against its plain version at ``TOL[name]``
    (``name`` a config of ``TOL``), with the kernel's, the plain version's
    and the library's times (``reps`` launches each) beside the bound;
    emits the row."""
    import torch

    from sdtk_tpu_torch.ops import fbank, fbank_frames
    from sdtk_tpu_torch.ops.fbank import FrontendConfig

    cfg = FrontendConfig(compute_dtype="float32" if name.startswith("f32") else "bfloat16")
    f32 = FrontendConfig(compute_dtype="float32")
    win = torch.from_numpy(fbank.melbank.window(400, f32.window)).to(frames.device)
    mel = torch.from_numpy(fbank.melbank.mel_filterbank(
        f32.n_mels, f32.n_fft, f32.sample_rate, fmin=fbank_frames.JAX_MEL_FMIN)).to(frames.device)
    m = frames.shape[0]
    got = fbank_frames.fbank_frames_cuda(frames, cfg)
    want = fbank_frames.fbank_frames_plain(frames, cfg)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    finite = bool(torch.isfinite(got).all())
    del got, want
    if not finite or err > TOL[name]:
        raise AssertionError(f"fbank_frames {name} M={m}: kernel vs plain max|d| {err}")

    def kernel():
        return fbank_frames.fbank_frames_cuda(frames, cfg)

    def library():
        spec = torch.fft.rfft(frames * win, n=f32.n_fft)
        return torch.log((spec.real ** 2 + spec.imag ** 2) @ mel + f32.log_floor)

    n_freqs = cfg.n_fft // 2 + 1
    item = 2 if cfg.compute_dtype == "bfloat16" else 4
    nbytes = m * 400 * 4 + m * cfg.n_mels * 4 + (2 * 400 * n_freqs + n_freqs * cfg.n_mels) * item
    flops = 2 * m * 400 * n_freqs * 2 + 2 * m * n_freqs * cfg.n_mels
    row = {"shape": [m, 400], "max_abs_err": err, "tol": TOL[name],
           "ms": cuda_ms(kernel, reps=reps),
           "plain_ms": cuda_ms(lambda: fbank_frames.fbank_frames_plain(frames, cfg), reps=reps),
           "library_ms": cuda_ms(library, reps=reps), **bound(nbytes, flops, cfg.compute_dtype)}
    row = with_device_time(row, kernel, "log_mel_")
    emit({"phase": "kernel", "name": "fbank_frames", "config": config,
          "library": "torch.fft.rfft + mel matmul (f32)", **row})
    return row


def phase_kernel_frames(device) -> None:
    """K4: (M, 400) frames -> (M, 80) log-mel at the diarizer's frame count
    (128 one-second windows -> M = 12 544), bf16 and f32 compute; in bf16
    also at the identify chunk's frame count (32 x 298 = 9 536) and at
    M = 65 (one tile and one frame).  Its path is ``evals.benchmark_frontend``
    (phase ``frontend``, which holds it at that path's M = 305 152)."""
    import torch

    from sdtk_tpu_torch.ops import fbank

    for name, (b, n), m in (("bf16-ln", (128, 16000), 12544), ("f32-ln", (128, 16000), 12544),
                            ("bf16-ln", (32, 48000), 9536), ("bf16-ln", (1, 16000), 65)):
        x = torch.from_numpy(speechlike_batch(b, n, seed=b)[0]).to(device)
        frames = fbank.preemphasize(x, 0.97).unfold(1, 400, 160).reshape(-1, 400)[:m].contiguous()
        if frames.shape[0] != m:
            raise AssertionError(f"expected {m} frames, got {frames.shape[0]}")
        k4_case(frames, name, name)


def epilogue_case(device, b: int, c: int, t: int, res2: bool = False) -> dict:
    """The tower epilogue on a (B, C, T) bf16 convolution output with
    BatchNorm and a ragged mask (a quarter of the rows short, the last with
    no valid frame) against its plain version, to the bit; with ``res2`` as
    a Res2 split: its output into a channel slice of a buffer 8 splits
    wide, and the next split's sum.  Times beside the bound (bytes: bf16
    in and out, with ``res2`` the sum's input and output too, the mask's
    B T bytes and the constants) and beside the eager chain it replaces
    (relu, cast, ``F.batch_norm``, cast, the mask's cast and multiply; with
    ``res2`` the add); emits the row."""
    import torch
    import torch.nn.functional as F

    from sdtk_tpu_torch.ops import tower_epilogue as te

    g = torch.Generator().manual_seed(c + t)
    y = (3 * torch.randn(b, c, t, generator=g)).to(torch.bfloat16).to(device)
    lengths = torch.where(torch.rand(b, generator=g) < 0.25,
                          torch.randint(1, t + 1, (b,), generator=g), t)
    lengths[-1] = 0
    mask = (torch.arange(t)[None, :] < lengths[:, None]).to(device)
    stats = (2 * torch.randn(c, generator=g), 3 * torch.rand(c, generator=g) + 1e-3,
             torch.randn(c, generator=g), torch.randn(c, generator=g))
    mean, var, gamma, beta = (v.to(device) for v in stats)
    scale, shift = te.bn_affine(mean, var, gamma, beta, 1e-5)
    buf = torch.randn((b, 8 * c, t), generator=g).to(torch.bfloat16).to(device) if res2 else None
    slices = dict(out=buf[:, c : 2 * c], add=buf[:, 2 * c : 3 * c]) if res2 else {}

    def kernel():
        return te.tower_epilogue_cuda(y, mask, scale, shift, **slices)

    def plain():
        return te.tower_epilogue_plain(y, mask, scale, shift, **slices)

    def library():
        e = F.batch_norm(torch.relu(y).float(), mean, var, gamma, beta, False, 0.0, 1e-5)
        e = e.to(torch.bfloat16) * mask[:, None, :].float().to(torch.bfloat16)
        return (e, slices["add"] + e) if res2 else e

    got = [o.clone() for o in ((kernel(),) if not res2 else kernel())]
    want = [o.clone() for o in ((plain(),) if not res2 else plain())]
    eager = (library(),) if not res2 else library()
    torch.cuda.synchronize()
    if not all(torch.equal(a, w) for a, w in zip(got, want)):
        raise AssertionError(f"tower_epilogue {(b, c, t)} res2={res2}: kernel != plain")
    if got[0].masked_select(~mask[:, None, :]).any():
        raise AssertionError(f"tower_epilogue {(b, c, t)}: a padded frame is not 0")

    def beyond_ulp(a, w):  # share of elements more than 1 bf16 ulp apart
        a, w = a.float(), w.float()
        top = torch.maximum(a.abs(), w.abs()).clamp_min(1e-30)
        return float(((a - w).abs() > torch.exp2(torch.floor(torch.log2(top)) - 7)).float().mean())

    ulp_off = max(beyond_ulp(a, w) for a, w in zip(got, eager))
    n = b * c * t
    nbytes = 2 * n * (4 if res2 else 2) + b * t + 8 * c
    row = {"shape": [b, c, t], "res2": res2, "max_abs_err": 0.0,
           "eager_share_beyond_1ulp": ulp_off, "ms": cuda_ms(kernel), "plain_ms": cuda_ms(plain),
           "library_ms": cuda_ms(library), **bound(nbytes, 0.0, "bfloat16")}
    row = with_device_time(row, kernel, "tower_epilogue")
    emit({"phase": "kernel", "name": "tower_epilogue",
          "library": "the eager chain: relu, cast, F.batch_norm (f32), cast, mask", **row})
    return row


def phase_kernel_epilogue(device) -> dict:
    """The tower epilogue at the c512 batch cell's TDNN output (1024, 512,
    298), a diarizer chunk's (128, 512, 98), a c512 Res2 split (1024, 64,
    298) and the c1024 TDNN output (1024, 1024, 301).  Its launches are
    each path's own (``check_epilogue_paths``)."""
    rows = {shape: epilogue_case(device, *shape) for shape in
            ((1024, 512, 298), (128, 512, 98), (1024, 64, 298, True), (1024, 1024, 301))}
    return summary("tower_epilogue", "tower_epilogue.cu", "none (port only, no JAX counterpart)",
                   rows[(1024, 512, 298)], "diarize")


# Paths that serve an ECAPA or x-vector tower in eval mode on the card, so
# take the fused epilogue; and the training paths, which keep the eager one.
EPILOGUE_PATHS = ("diarize", "identify", "identify-xvector", "embed-cluster", "longform",
                  "heldout-der", "profile", "speechbrain", "mfu", "scaling")
EAGER_PATHS = ("train", "train-xvector", "train-ddp", "train-vad-step", "train-vad",
               "train-conformer", "train-tp")


def check_epilogue_paths(path_launches: dict) -> None:
    """The tower epilogue launched on every serving path of
    ``EPILOGUE_PATHS`` and on no training path."""
    counts = {p: path_launches[p]["tower_epilogue"] for p in EPILOGUE_PATHS + EAGER_PATHS}
    emit({"phase": "kernel", "name": "tower_epilogue", "launches_by_path": counts})
    missing = [p for p in EPILOGUE_PATHS if counts[p] <= 0]
    trained = [p for p in EAGER_PATHS if counts[p] != 0]
    if missing or trained:
        raise AssertionError(f"tower_epilogue: not launched on {missing}, launched on the "
                             f"training paths {trained}: {counts}")


def reset_launches() -> dict:
    """Every kernel wrapper, by kernel name, with its count set to 0."""
    from sdtk_tpu_torch.tools.measure import kernel_wrappers

    wrappers = kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    return wrappers


def read_launches(wrappers: dict) -> dict:
    return {name: fn.launches for name, fn in wrappers.items()}


def write_profiles(vectors, backend, threads: int = 16) -> None:
    """One store profile ``distractor-<j>`` per row of ``vectors``, each
    with that row as its one embedding under ``backend``, written by
    ``threads`` threads (the files are written one at a time through
    ``store.profiles``, so the store's bytes do not depend on the threads;
    the time is the file system's more than the host's)."""
    from concurrent.futures import ThreadPoolExecutor

    from sdtk_tpu_torch.store import profiles as P

    def write(j: int) -> None:
        profile = P.create_speaker_profile(f"distractor-{j:05d}", f"Distractor {j}")
        P.add_embedding(profile, backend.name, P.create_embedding_record(
            "synthetic", "0" * 32, [], backend.model_version, vector=vectors[j]))
        P.save_speaker(profile)

    with ThreadPoolExecutor(threads) as pool:
        list(pool.map(write, range(len(vectors))))


def phase_identify(work: Path, device: str, phase: str = "identify",
                   n_rows: int = IDENTIFY_N, named: bool = True,
                   query_s: float = 45.0) -> dict:
    """The profile side on the card, through the entry points a user calls
    (``pipeline.identify``), with the bundled c512 checkpoint of the tower
    in use and its calibration, at ``n_rows`` profile rows of the tower's
    width.  Each query runs on the fused route (``SDTK_IDENTIFY_TOPK_N`` at
    ``n_rows``) and on the dense route (above it).  ``named``: each voice
    must come first and verify; without it (untrained weights) the two
    routes must still agree, and verify is not called.  Queries are
    ``query_s`` seconds long.  Returns the launch counts of the path."""
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
        save_wav(work / f"{sid}-query.wav", synth_utterance(v, 99, query_s))  # held out
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
    write_profiles(distractors, backend)
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
    verify = {sid: ident.verify(sid, query, device=device)
              for sid, (_, query) in wavs.items() if named}
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
        if f_id != d_id or (named and f_id != sid):
            raise AssertionError(f"{sid} first: fused {f_id}, dense {d_id}")
        if f_id is not None and abs(f_score - d_score) > SCORE_TOL:
            raise AssertionError(f"{sid}: fused {f_score} vs dense {d_score}")
        if named and not verify[sid]["match"]:
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

    os.environ["SDTK_BACKEND_TOWER"] = name
    register_backend("gpu", GPU_BACKEND)
    try:
        yield
    finally:
        os.environ.pop("SDTK_BACKEND_TOWER", None)
        register_backend("gpu", GPU_BACKEND)


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
    embed alone the same way, with its peak memory.  Returns the launch
    counts of the path."""
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
    torch.cuda.reset_peak_memory_stats(engine.device)
    embed_s = chained(embed)
    embed_peak = torch.cuda.max_memory_allocated(engine.device)
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
          "embed_peak_memory_bytes": embed_peak,
          "cluster_sizes": sizes.tolist(),
          "labels_device": str(labels.device), "launches": launches})
    if labels.device.type != engine.device.type or labels.shape != (b,) or sizes.sum() != b:
        raise AssertionError(f"embed-cluster: labels {labels.shape} on {labels.device}")
    return launches


def meeting_transcripts(ref, seed: int) -> tuple[dict, dict, dict]:
    """An AssemblyAI (ms) and a Speechmatics (s, one item per ~0.4 s word)
    transcript of a meeting's reference turns, each with its labels
    shuffled; and each format's label -> true voice id."""
    import numpy as np

    voices = sorted({spk for _, _, spk in ref})
    order = np.random.default_rng(seed).permutation(len(voices))
    aai = {spk: "ABCDEFGH"[i] for spk, i in zip(voices, order)}
    sm = {spk: f"S{i + 1}" for spk, i in zip(voices, order[::-1])}
    utterances, words = [], []
    for start, end, spk in ref:
        utterances.append({"speaker": aai[spk], "start": int(round(start * 1000)),
                           "end": int(round(end * 1000)), "text": "..."})
        n = max(1, int(round((end - start) / 0.4)))
        for k in range(n):
            words.append({"type": "word", "start_time": round(start + (end - start) * k / n, 3),
                          "end_time": round(start + (end - start) * (k + 1) / n, 3),
                          "speaker": sm[spk], "alternatives": [{"content": "w"}]})
    truth = {"assemblyai": {aai[spk]: f"voice-{spk[3:]}" for spk in voices},
             "speechmatics": {sm[spk]: f"voice-{spk[3:]}" for spk in voices}}
    return {"utterances": utterances}, {"results": words}, truth


def scoring_case(q, p_dev, k: int) -> dict:
    """(W, D) window embeddings ``q`` against the store matrix ``p_dev`` on
    the card: K2 on the windows bucketed as the dispatcher buckets them, at
    ``k``, and K3, each against its plain version."""
    import torch

    from sdtk_tpu_torch.ops import cosine, topk, topk_fused

    q_dev = torch.from_numpy(q).to(p_dev.device)
    qb = topk.bucket_windows(q_dev).contiguous()
    s_k, i_k = topk_fused.identify_topk_cuda(qb, p_dev, k)
    s_p, i_p = topk.identify_topk_plain(qb, p_dev, k)
    cos_err = float((cosine.cosine_cuda(q_dev, p_dev) - cosine.cosine_plain(q_dev, p_dev))
                    .abs().max())
    return {"W": int(q.shape[0]), "W_bucketed": int(qb.shape[0]), "k": k,
            "dense_route_on_card": q.size * p_dev.shape[0] >= cosine.NUMPY_MAX_WORK,
            "cosine_max_abs_err": cos_err, "topk_max_abs_err": float((s_k - s_p).abs().max()),
            "topk_survivors_equal": set(i_k.tolist()) == set(i_p.tolist())}


def check_scoring(where: str, c: dict) -> None:
    if not (c["cosine_max_abs_err"] <= SCORE_TOL and c["topk_max_abs_err"] <= SCORE_TOL
            and c["topk_survivors_equal"]):
        raise AssertionError(f"{where}: kernel vs plain {c}")


def phase_assign(work: Path, device: str) -> dict:
    """``speaker-assign-gpu`` on the card, through ``cli.assign.main``.  The
    store is the identify phase's (8 192 rows of the tower's width, D =
    192) with voices 0, 1 and 2 enrolled (``cli.detection``, trust high)
    from held-out 12 s utterances: N = 8 195.  The meeting
    ``build_meeting(0, 3, 20, 3.0)`` as a WAV, an AssemblyAI and a
    Speechmatics transcript of its turns with shuffled labels; each assigned
    on the fused route (``SDTK_IDENTIFY_TOPK_N`` at N) and on the dense
    route, then ``show --format json`` and ``apply`` on the first.  Below
    Q*N*D = 2^24 the dense route scores in NumPy (``ops.cosine.score_rows``,
    the JAX package's rule): at N = 1 024 no label (W <= 16) would reach
    the cosine kernel, at N = 8 195 the two 16-window labels do.  Then each
    label's windows against the two scoring kernels and their plain
    versions.  Returns the launch counts of the path."""
    import numpy as np
    import torch

    from sdtk_tpu_torch.backends.base import get_backend
    from sdtk_tpu_torch.cli import assign as cli_assign
    from sdtk_tpu_torch.cli import detection
    from sdtk_tpu_torch.data.synth import build_meeting, synth_utterance
    from sdtk_tpu_torch.ops.cosine import score_rows
    from sdtk_tpu_torch.ops.topk import identify_topk
    from sdtk_tpu_torch.store import profiles as P
    from sdtk_tpu_torch.transcripts import get_speaker_segments
    from sdtk_tpu_torch.utils.audio import save_wav

    store = work / "assign-store"
    shutil.rmtree(store, ignore_errors=True)
    t0 = time.perf_counter()
    # the identify store, written once, is this phase's from here on (no
    # later phase reads it under its old name): renamed, not copied
    os.replace(work / "identify-store", store)
    os.environ["SPEAKERS_EMBEDDINGS_DIR"] = str(store)
    for v in range(3):
        # utterance 99: held out from every meeting (their turns are 0-19, 1000+)
        save_wav(work / f"voice-{v}-enroll.wav", synth_utterance(v, 99, 12.0))
        enroll_wav = str(work / f"voice-{v}-enroll.wav")
        with contextlib.redirect_stdout(io.StringIO()):
            rcs = (detection.main(["-q", "add", f"voice-{v}", "--name", f"Voice {v}"]),
                   detection.main(["-q", "enroll", f"voice-{v}", enroll_wav,
                                   "--trust-level", "high", "--device", device]))
        if any(rcs):
            raise AssertionError(f"enrolling voice-{v}: rcs {rcs}")
    store_s = time.perf_counter() - t0
    wav, ref = build_meeting(0, 3, 20, 3.0)
    save_wav(work / "assign-meeting.wav", wav)
    aai, sm, truth = meeting_transcripts(ref, seed=8)
    # AssemblyAI last: its assignment file is the one left for show and apply
    transcripts = {"speechmatics": sm, "assemblyai": aai}
    for fmt, doc in transcripts.items():
        (work / f"assign-{fmt}.json").write_text(json.dumps(doc))
    backend = get_backend("gpu", device=device)
    pm = P.ProfileMatrix.build(backend.name, speakers=P.list_all_speakers())
    n = len(pm)

    def run(*argv) -> tuple[int, str]:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = cli_assign.main(list(argv))
        return rc, out.getvalue()

    wrappers = reset_launches()
    torch.cuda.synchronize()
    results, wall, by_route = {}, {}, {}
    for route, fused_n in (("fused", n), ("dense", 10 * n)):
        os.environ["SDTK_IDENTIFY_TOPK_N"] = str(fused_n)
        before = read_launches(wrappers)
        for fmt in transcripts:
            t0 = time.perf_counter()
            rc, out = run("assign", str(work / "assign-meeting.wav"), "-t",
                          str(work / f"assign-{fmt}.json"), "--format", "json", "--device", device)
            wall[route, fmt] = time.perf_counter() - t0
            if rc != 0:
                raise AssertionError(f"assign {route} {fmt}: rc {rc}")
            results[route, fmt] = json.loads(out)["mappings"]
        by_route[route] = {k: v - before[k] for k, v in read_launches(wrappers).items()}
    os.environ.pop("SDTK_IDENTIFY_TOPK_N", None)
    rc_show, shown = run("show", str(work / "assign-meeting.wav"), "--format", "json")
    rc_apply, applied = run("apply", str(work / "assign-meeting.wav"), "-t",
                            str(work / "assign-assemblyai.json"))
    torch.cuda.synchronize()
    launches = read_launches(wrappers)

    # where an assign call's time goes (warm): one store load (each label's
    # identify loads the store once), then per label its window embeddings
    # and the scoring on each route; then each label's windows against both
    # kernels and their plain versions
    t0 = time.perf_counter()
    P.ProfileMatrix.build(backend.name, speakers=P.list_all_speakers())
    split, checks = {"store_load_per_label": time.perf_counter() - t0}, {}
    p_dev = torch.from_numpy(pm.matrix).to(device)
    k = 64 * max(sum(r["speaker_id"] == sid for r in pm.rows)
                 for sid in {r["speaker_id"] for r in pm.rows})
    for label in truth["assemblyai"]:
        segs = [(s["start"], s["end"]) for s in get_speaker_segments(aai, label)]
        t = [time.perf_counter()]
        q = backend.embed_windows(backend._load(work / "assign-meeting.wav", segs))
        t.append(time.perf_counter())
        identify_topk(q, pm.matrix, k=k, device=backend.device)
        t.append(time.perf_counter())
        score_rows(q, pm.matrix, device=backend.device)
        t.append(time.perf_counter())
        split[label] = {"windows": int(q.shape[0]), **dict(zip(
            ("embed", "score_fused", "score_dense"), np.diff(t).tolist()))}
        checks[label] = scoring_case(q, p_dev, k)
    emit({"phase": "assign", "profiles": n, "dim": int(pm.matrix.shape[1]), "k": k,
          "store_enroll_seconds": store_s, "audio_seconds": len(wav) / 16000,
          "labels": {fmt: sorted(tr) for fmt, tr in truth.items()},
          "assign_seconds": {f"{r}/{f}": s for (r, f), s in wall.items()},
          "split_seconds_per_label": split,
          "scores": {f"{r}/{f}": {lab: [m["speaker_id"], m["score"]] for lab, m in mp.items()}
                     for (r, f), mp in results.items()},
          "kernel_vs_plain": checks, "tol": SCORE_TOL, "show_rc": rc_show,
          "apply_rc": rc_apply, "launches": launches, "launches_by_route": by_route})
    for (route, fmt), mappings in results.items():
        got = {lab: m["speaker_id"] for lab, m in mappings.items()}
        if got != truth[fmt]:
            raise AssertionError(f"assign {route} {fmt}: {got} != {truth[fmt]}")
        if not all(any(s["type"] == "embedding_match" for s in m["signals"])
                   for m in mappings.values()):
            raise AssertionError(f"assign {route} {fmt}: a label without an embedding_match")
    mapped = json.loads(applied) if rc_apply == 0 else {}
    names = {u["speaker"] for u in mapped.get("utterances", [])}
    if rc_show != 0 or json.loads(shown)["mappings"] != results["dense", "assemblyai"] \
            or names != {"Voice 0", "Voice 1", "Voice 2"}:
        raise AssertionError(f"show rc {rc_show}, apply rc {rc_apply}, names {names}")
    for label, c in checks.items():
        check_scoring(f"assign label {label}", c)
    if (launches["log_mel_wave"] <= 0 or by_route["fused"]["identify_topk"] <= 0
            or by_route["dense"]["cosine"] <= 0):
        raise AssertionError(f"a kernel of the assign path was not launched: {by_route}")
    return launches


def phase_process(work: Path, device: str) -> dict:
    """``speaker-process-gpu process DIR --backend local --parallel 2``
    through ``cli.process.main``: three meetings (``build_meeting(m, 3, 8,
    3.0)``, m = 1, 2, 3, voices 0-2) in a fresh directory, against the
    assign phase's store, with a context that expects the three voices.
    The kernels are built anew in a fresh directory by the two worker
    threads (as on a fresh checkout), so the first build happens under
    the threads.  Launch counters are bumped without a lock: under two
    threads a count may lose an update, so the phase reads them only as
    "launched or not" (> 0).  Returns the launch counts of the path."""
    import torch

    from sdtk_tpu_torch.cli import process as cli_process
    from sdtk_tpu_torch.data.synth import build_meeting
    from sdtk_tpu_torch.pipeline import process as proc
    from sdtk_tpu_torch.store import assignments, catalog
    from sdtk_tpu_torch.store.queue import ProcessingQueue
    from sdtk_tpu_torch.utils import build
    from sdtk_tpu_torch.utils.audio import save_wav

    src = work / "process-in"
    shutil.rmtree(src, ignore_errors=True)
    src.mkdir()
    audio_s = {}
    for m in (1, 2, 3):
        wav, _ = build_meeting(m, 3, 8, 3.0)
        save_wav(src / f"meeting-{m}.wav", wav)
        audio_s[f"meeting-{m}.wav"] = len(wav) / 16000
    catalog.create_context("standup", speakers=["voice-0", "voice-1", "voice-2"], force=True)
    fresh = work / "fresh-build"
    shutil.rmtree(fresh, ignore_errors=True)
    build_dir, loaded = build.BUILD_DIR, dict(build._loaded)
    build.BUILD_DIR = fresh
    build._loaded.clear()
    results, real = [], proc.process_single

    def recorded(*args, **kwargs):
        res = real(*args, **kwargs)
        results.append(res)
        return res

    proc.process_single = recorded
    wrappers = reset_launches()
    torch.cuda.synchronize()
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli_process.main(["-q", "process", str(src), "--backend", "local", "--parallel",
                                   "2", "--context", "standup", "--device", device])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        proc.process_single = real
        built = sorted(p.name for p in fresh.iterdir()) if fresh.exists() else []
        build.BUILD_DIR = build_dir
        build._loaded.clear()
        build._loaded.update(loaded)
    launches = read_launches(wrappers)
    from datetime import datetime

    items = ProcessingQueue().items()
    per_rec, mapped = {}, {}
    for item in items:
        name = Path(item["audio_path"]).name
        per_rec[name] = (datetime.fromisoformat(item["completed_at"])
                         - datetime.fromisoformat(item["started_at"])).total_seconds()
        a = assignments.load_assignments(item["b3sum"]) or {"mappings": {}}
        mapped[name] = {"labels": len(a["mappings"]),
                        "mapped_to_enrolled": sum(str(m.get("speaker_id")).startswith("voice-")
                                                  for m in a["mappings"].values()),
                        "ids": sorted(str(m.get("speaker_id")) for m in a["mappings"].values())}
    statuses = {Path(e["recording"]["path"]).name: catalog.compute_status(e)
                for e in catalog.list_entries() if Path(e["recording"]["path"]).parent == src}
    steps = {Path(r.audio_path).name: r.steps_completed for r in results}
    emit({"phase": "process", "rc": rc, "recordings": len(audio_s), "parallel": 2,
          "audio_seconds": sum(audio_s.values()), "wall_seconds": wall,
          "audio_s_per_s": sum(audio_s.values()) / wall, "seconds_per_recording": per_rec,
          "queue": {Path(i["audio_path"]).name: i["status"] for i in items},
          "catalog": statuses, "steps": steps, "labels_mapped": mapped,
          "built_under_threads": built, "launches": launches})
    if rc != 0 or sorted(i["status"] for i in items) != ["completed"] * 3:
        raise AssertionError(f"process: rc {rc}, queue {[i['status'] for i in items]}")
    if sorted(statuses.values()) != ["assigned"] * 3:
        raise AssertionError(f"process: catalog {statuses}")
    if len(steps) != 3 or not all({"transcribe_local", "speaker_assign"} <= set(s)
                                  for s in steps.values()):
        raise AssertionError(f"process: steps {steps}")
    if any(name.endswith(".tmp") for name in built) or not built:
        raise AssertionError(f"process: threaded build left {built}")
    if launches["log_mel_wave"] <= 0:
        raise AssertionError("kernel log_mel_wave was not launched on the process path")
    return launches


# Training (the trainer's recipe: ECAPA c512 bf16 warm-started from the bundled
# fam5tel file, 5 families x 64 speakers, 32 crops of 1.5 s from 3 s voices).
FAM5TEL = ROOT / "models" / "ecapatdnn-fam5tel.msgpack"
TRAIN_RECIPE = {"families": "0,1,2,3,4", "n_speakers": 64, "batch": 32, "seconds": 3.0,
                "crop_seconds": 1.5, "aug_prob": 0.5, "noise_prob": 0.5}
# The card's step against the CPU's from one state and batch, both bf16 (the
# trainer's dtype): cuDNN and oneDNN sum in other orders, so the loss may move
# by bf16 rounding of the embeddings (~0.4 % an element); 5 % leaves room.
TRAIN_LOSS_RTOL = 0.05
TRAIN_PARAM_COS = 0.999  # each updated tensor against the CPU's
# The gradients against the CPU's.  After AdamW's first step a parameter
# moves by about lr whatever its gradient, so the parameters' cosine would
# miss a wrong gradient; the gradients' would not.  All together: cosine
# >= 0.999.  Each tensor: its distance from the CPU's bf16 gradient at most
# twice bf16's own rounding there (the CPU's bf16 gradient's distance from
# its f32 one).  A tensor whose gradient is mostly rounding (the bundled
# checkpoint saturates attention's tanh, so softmax over time sees no
# change of att1 or att2) has no direction to agree on; this bar still
# holds it to rounding's size.
TRAIN_GRAD_COS = 0.999
TRAIN_GRAD_NOISE_FACTOR = 2.0
# Softmax over time is unchanged by a per-channel shift of its logits, so the
# gradient of attention's second bias is zero in exact arithmetic and rounding
# noise on either device; AdamW's normalized step moves it by up to lr (1e-3)
# with a sign neither determines.  It is held to that bound instead.
ZERO_GRAD_PARAM = "asp.att2.bias"


def phase_train_step(device):
    """One training step of the full-width ECAPA on the card against the
    same step on the CPU (K1's plain version, CPU convolutions) from one
    state (the fam5tel file plus a seeded AAM head over 320 classes) and
    one synthesized batch, both bf16, and the same step on the CPU in f32
    for the size of bf16's rounding in each gradient; then 20 steps on that batch on the card (the
    loss must fall), their device time by CUDA events and by the profiler,
    and the peak memory; then ``train()``'s step, 8 times with the producer
    idle and 8 times with a thread synthesizing batches beside it; then the
    device-only rate at batch 256 (the batch repeated 8 times).  Every step
    is ``training.featurize_step``, the one ``train()`` takes."""
    import threading

    import numpy as np
    import torch

    from sdtk_tpu_torch.data.batches import BatchSpec, make_batch
    from sdtk_tpu_torch.models.ecapa import EcapaConfig, EcapaTdnn
    from sdtk_tpu_torch.ops.fbank import FrontendConfig
    from sdtk_tpu_torch.parallel.train import TrainConfig, create_train_state
    from sdtk_tpu_torch.tools.measure import cos
    from sdtk_tpu_torch.training import featurize_step, warm_start

    fams = tuple(int(f) for f in TRAIN_RECIPE["families"].split(","))
    spec = BatchSpec(family_ids=fams, **{k: v for k, v in TRAIN_RECIPE.items() if k != "families"})
    t0 = time.perf_counter()
    wavs, cls = make_batch(np.random.default_rng(0), spec)
    synth_s = time.perf_counter() - t0
    cfg = TrainConfig(n_classes=spec.n_classes)
    fcfg = FrontendConfig()

    def fresh(dev, dtype="bfloat16"):
        state = create_train_state(EcapaTdnn(EcapaConfig(dtype=dtype)),
                                   torch.Generator().manual_seed(0), cfg, dev)
        warm_start(state, "ecapa", FAM5TEL)
        return state

    def step(state, dev, w=wavs, c=cls, fc=fcfg):
        return featurize_step(state, w, c, cfg, fc, dev)

    runs = []
    cpu_dev, f32 = torch.device("cpu"), FrontendConfig(compute_dtype="float32")
    for dev, dtype, fc in ((device, "bfloat16", fcfg), (cpu_dev, "bfloat16", fcfg),
                           (cpu_dev, "float32", f32)):
        state = fresh(dev, dtype)
        t0 = time.perf_counter()
        m = step(state, dev, fc=fc)
        loss = float(m["loss"])
        names = [n for n, _ in state.model.named_parameters()] + ["aam_weights"]
        params = [*state.model.parameters(), state.aam_weights]
        runs.append({"loss": loss, "seconds": time.perf_counter() - t0, "state": state,
                     "params": dict(zip(names, [p.detach().cpu() for p in params])),
                     "grads": dict(zip(names, [p.grad.detach().cpu() for p in params]))})
    gpu, cpu, ref = runs
    param_cos = {n: cos(gpu["params"][n], cpu["params"][n]) for n in gpu["params"]}
    worst = min((n for n in param_cos if n != ZERO_GRAD_PARAM), key=param_cos.get)
    # each tensor: the card's distance from the CPU's bf16 gradient over bf16's
    # own (the CPU's bf16 gradient's distance from its f32 one)
    dist = {n: float((gpu["grads"][n].double() - cpu["grads"][n].double()).norm())
            for n in names}
    noise = {n: float((cpu["grads"][n].double() - ref["grads"][n].double()).norm())
             for n in names}
    ratio = {n: dist[n] / noise[n] if noise[n] > 0 else (0.0 if dist[n] == 0 else math.inf)
             for n in names}
    worst_grad = max(ratio, key=ratio.get)
    rounding_bound = [n for n in names
                      if noise[n] >= float(ref["grads"][n].double().norm()) and noise[n] > 0]
    grad_cos_all = cos(torch.cat([g.flatten() for g in gpu["grads"].values()]),
                       torch.cat([g.flatten() for g in cpu["grads"].values()]))
    zero_grad_diff = float((gpu["params"][ZERO_GRAD_PARAM]
                            - cpu["params"][ZERO_GRAD_PARAM]).abs().max())
    loss_rel = abs(gpu["loss"] - cpu["loss"]) / abs(cpu["loss"])
    row = {"phase": "train-step", "classes": spec.n_classes, "batch": spec.batch,
           "crop_seconds": spec.crop_seconds, "synth_seconds": synth_s,
           "loss_cuda": gpu["loss"], "loss_cpu": cpu["loss"], "loss_rel_diff": loss_rel,
           "loss_bar": TRAIN_LOSS_RTOL, "min_param_cos": param_cos[worst], "min_param": worst,
           "param_cos_bar": TRAIN_PARAM_COS, "grad_cos_all": grad_cos_all,
           "grad_cos_bar": TRAIN_GRAD_COS, "worst_grad": worst_grad,
           "worst_grad_over_bf16_rounding": ratio[worst_grad],
           "worst_grad_cos": cos(gpu["grads"][worst_grad], cpu["grads"][worst_grad]),
           "grad_rounding_bar": TRAIN_GRAD_NOISE_FACTOR,
           "grads_mostly_rounding": rounding_bound,
           "zero_grads": [n for n in names if float(ref["grads"][n].abs().max()) == 0.0],
           "zero_grad_param": ZERO_GRAD_PARAM, "zero_grad_param_cos": param_cos[ZERO_GRAD_PARAM],
           "zero_grad_param_max_abs_diff": zero_grad_diff,
           "cpu_step_seconds": cpu["seconds"], "cpu_f32_step_seconds": ref["seconds"]}
    del runs, cpu, ref

    # 20 steps on the one batch, on the card
    state = gpu["state"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms = [], []
    for _ in range(20):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        m = step(state, device)
        b.record()
        losses.append(m["loss"])
        step_ms.append((a, b))
    torch.cuda.synchronize()
    losses = [float(x) for x in losses]
    step_ms = [a.elapsed_time(b) for a, b in step_ms]
    busy = device_ms(lambda: step(state, device), "", reps=3)  # "" matches every kernel
    t0 = time.perf_counter()
    step(state, device)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    median_ms = statistics.median(step_ms[5:])
    row.update({
        "losses_20": losses, "first5_mean": statistics.mean(losses[:5]),
        "last5_mean": statistics.mean(losses[-5:]),
        "step_ms_median": median_ms, "step_ms": step_ms,
        "step_device_busy_ms": busy, "step_host_ms_synced": host_ms,
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
        "audio_s_per_s_batch": spec.batch * spec.crop_seconds / (median_ms / 1e3)})

    # train()'s step (log_every 20: no synchronize inside the loop) with the
    # producer idle, then with a thread making batches beside it as train()'s
    # producer does: does the synthesis slow the step's launches?
    def steps8():
        marks, t0 = [], time.perf_counter()
        for _ in range(8):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            step(state, device)
            b.record()
            marks.append((a, b))
        host_ms = (time.perf_counter() - t0) * 1e3 / 8
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in marks], host_ms

    idle_spans, idle_host = steps8()
    stop = threading.Event()
    made = []

    def producer():
        r = np.random.default_rng(1)
        while not stop.is_set():
            made.append(make_batch(r, spec)[1].size)

    worker = threading.Thread(target=producer, daemon=True)
    worker.start()
    time.sleep(0.1)
    try:
        busy_spans, busy_host = steps8()
    finally:
        stop.set()
        worker.join()
    row.update({"producer_idle_step_ms": idle_spans, "producer_idle_host_ms_per_step": idle_host,
                "producer_busy_step_ms": busy_spans, "producer_busy_host_ms_per_step": busy_host,
                "producer_busy_batches_made": len(made),
                "producer_busy_slowdown": statistics.median(busy_spans)
                / statistics.median(idle_spans)})

    # device-only rate at batch 256: the batch repeated, labels with it
    w256, c256 = np.tile(wavs, (8, 1)), np.tile(cls, 8)
    ms256 = cuda_ms(lambda: step(state, device, w256, c256), reps=10, warmup=3)
    row.update({"step_ms_b256": ms256,
                "audio_s_per_s_b256": 256 * spec.crop_seconds / (ms256 / 1e3),
                "peak_memory_bytes_b256": torch.cuda.max_memory_allocated()})
    emit(row)
    if not loss_rel <= TRAIN_LOSS_RTOL:
        raise AssertionError(f"train-step: card loss {gpu['loss']} vs CPU {row['loss_cpu']}")
    if not grad_cos_all >= TRAIN_GRAD_COS:
        raise AssertionError(f"train-step: gradients at cosine {grad_cos_all} with the CPU's")
    if not ratio[worst_grad] <= TRAIN_GRAD_NOISE_FACTOR:
        raise AssertionError(f"train-step: {worst_grad}'s gradient {dist[worst_grad]} from the "
                             f"CPU's, bf16 rounding there {noise[worst_grad]}")
    if not param_cos[worst] >= TRAIN_PARAM_COS:
        raise AssertionError(f"train-step: {worst} at cosine {param_cos[worst]} with the CPU's")
    if not zero_grad_diff <= 2 * cfg.learning_rate * 1.001:
        raise AssertionError(f"train-step: {ZERO_GRAD_PARAM} moved {zero_grad_diff} apart")
    if not row["last5_mean"] < row["first5_mean"]:
        raise AssertionError(f"train-step: the loss did not fall on a fixed batch: {losses}")


def _train_report(phase: str, state, logs: list[str], wall: float, busy_ms) -> dict:
    """Per-step times of a ``train()`` call and the device's idle share of
    its loop: by the steps' CUDA-event spans (which hold the device's waits
    for the host's launches inside a step, so this share is a lower bound),
    and by the device time of the call's own profile (``busy_ms``, every
    kernel and copy of the whole call, warm start and save included, so
    this share is a lower bound too), over the loop's wall time with and
    without its checkpoint writes."""
    steps = state.timings["steps"]
    loop_s = state.timings["loop_s"]
    ckpt_s = state.timings["ckpt_s"]
    span_s = sum(t["step_ms"] for t in steps) / 1e3
    measured = isinstance(busy_ms, float)
    return {"phase": phase, "steps": len(steps), "wall_seconds": wall, "loop_seconds": loop_s,
            "ckpt_seconds": ckpt_s, "loop_seconds_without_ckpt": loop_s - ckpt_s,
            "synth_s": [t["synth_s"] for t in steps], "wait_s": [t["wait_s"] for t in steps],
            "step_ms": [t["step_ms"] for t in steps], "loss": [t["loss"] for t in steps],
            "device_idle_share_by_step_spans": 1.0 - span_s / loop_s,
            "device_busy_ms_profiled": busy_ms,
            "device_idle_share_by_profile": (1.0 - busy_ms / 1e3 / loop_s if measured
                                             else "not measured"),
            "device_idle_share_by_profile_without_ckpt": (
                1.0 - busy_ms / 1e3 / (loop_s - ckpt_s) if measured else "not measured"),
            "log": [m for m in logs if not m.startswith("step ")]}


def _profiled_device_ms(fn):
    """``fn()``'s result and the device time of every kernel and copy it
    ran (``torch.profiler``, host and device activities, as ``device_ms``
    traces), or "not measured" where the trace shows none."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    total_us = trace_device_us(prof)
    return out, (total_us / 1e3 if total_us > 0 else "not measured")


def phase_train(work: Path) -> dict:
    """``training.train`` on the card with the fam5tel recipe, warm-started
    from the bundled file, 8 steps with a checkpoint every 4 (under the
    profiler, for the device's busy time), then a second call of 2 steps on
    the same checkpoint directory (crash resume from step 8).  Both log
    every 20 steps, the trainer's default.  K1 must launch once a step; the
    saved file must load in ``GpuBackend`` and separate 8 unseen family
    voices (genuine-pair mean cosine above the impostor mean).  Returns the
    path's launch counts."""
    import numpy as np
    import torch

    from sdtk_tpu_torch import training
    from sdtk_tpu_torch.backends.gpu import GpuBackend
    from sdtk_tpu_torch.data.synth_families import family_utterance
    from sdtk_tpu_torch.utils.checkpoint import read_msgpack

    tree = read_msgpack(FAM5TEL)
    n_leaves = sum(1 for col in ("params", "batch_stats") for _ in _leaf_iter(tree[col]))
    ck = work / "train-ckpt"
    shutil.rmtree(ck, ignore_errors=True)
    kw = {**TRAIN_RECIPE, "model_name": "ecapa", "resume_path": FAM5TEL, "ckpt_dir": ck,
          "ckpt_every": 4, "device": "cuda"}
    wrappers = reset_launches()
    rows, outs = [], []
    for steps, name in ((8, "train"), (2, "train-resume")):
        logs: list[str] = []

        def call(steps=steps, name=name, logs=logs):
            return training.train(steps=steps, out_path=work / f"{name}.msgpack",
                                  log=logs.append, **kw)

        t0 = time.perf_counter()
        if name == "train":
            (state, out), busy_ms = _profiled_device_ms(call)
        else:
            (state, out), busy_ms = call(), "not measured"
        torch.cuda.synchronize()
        rows.append(_train_report(name, state, logs, time.perf_counter() - t0, busy_ms))
        outs.append(out)
    launches = read_launches(wrappers)

    be = GpuBackend(model="ecapa", params_path=outs[-1], device="cuda")
    voices = [(i % 5, 500_000 + i) for i in range(8)]
    emb = np.stack([be.embed_waveform(family_utterance(f, s, u, 3.0))
                    for f, s in voices for u in (1, 2)])
    emb = emb / np.linalg.norm(emb, axis=1, keepdims=True)
    sims = emb @ emb.T
    spk = np.repeat(np.arange(8), 2)
    upper = np.triu(np.ones_like(sims, dtype=bool), 1)
    genuine = float(sims[upper & (spk[:, None] == spk[None, :])].mean())
    impostor = float(sims[upper & (spk[:, None] != spk[None, :])].mean())
    for row in rows:
        emit(row)
    emit({"phase": "train-check", "launches": launches, "steps_taken": 10,
          "expected_resume_leaves": n_leaves, "params_source": be.engine.params_source,
          "embedding_dim": int(emb.shape[1]), "genuine_mean_cos": genuine,
          "impostor_mean_cos": impostor})
    resumed = f"({n_leaves} leaves, 0 skipped)"
    if not all(any(m.startswith("resumed backbone") and resumed in m for m in r["log"])
               for r in rows):
        raise AssertionError(f"train: resume did not merge {resumed}: {rows[0]['log']}")
    if not any("restored full train state" in m and "(step 8)" in m for m in rows[1]["log"]):
        raise AssertionError(f"train: the second call did not restore step 8: {rows[1]['log']}")
    if launches["log_mel_wave"] != 10 or any(v for k, v in launches.items() if k != "log_mel_wave"):
        raise AssertionError(f"train: launches {launches}, expected log_mel_wave 10 and no other")
    if be.engine.params_source != str(outs[-1]) or not np.isfinite(emb).all() \
            or emb.shape[1] != 192:
        raise AssertionError("train: the saved file did not load into GpuBackend")
    if not genuine > impostor:
        raise AssertionError(f"train: genuine {genuine} <= impostor {impostor}")
    return launches


def _leaf_iter(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaf_iter(v)
        else:
            yield v


def phase_train_xvector(work: Path) -> dict:
    """Two steps of the full-width x-vector from scratch (the recipe's
    batch); the file it writes loads through ``SDTK_BACKEND_TOWER=xvector``
    with ``SDTK_MODEL_PATH`` and embeds to finite 512-d vectors.  Returns
    the path's launch counts."""
    import numpy as np
    import torch

    from sdtk_tpu_torch import training
    from sdtk_tpu_torch.backends.base import get_backend
    from sdtk_tpu_torch.data.synth_families import family_utterance

    wrappers = reset_launches()
    logs: list[str] = []
    t0 = time.perf_counter()
    state, out = training.train(steps=2, model_name="xvector",
                                out_path=work / "train-xvector.msgpack", log=logs.append,
                                device="cuda", **TRAIN_RECIPE)
    torch.cuda.synchronize()
    row = _train_report("train-xvector", state, logs, time.perf_counter() - t0, "not measured")
    launches = read_launches(wrappers)
    os.environ["SDTK_MODEL_PATH"] = str(out)
    try:
        with tower("xvector"):
            be = get_backend("gpu", device="cuda")
            emb = be.embed_waveform(family_utterance(1, 3, 5, 3.0))
            source = be.engine.params_source
    finally:
        os.environ.pop("SDTK_MODEL_PATH", None)
    emit({**row, "launches": launches, "params_source": source, "embedding_dim": int(emb.shape[0])})
    if source != str(out) or emb.shape != (512,) or not np.isfinite(emb).all():
        raise AssertionError(f"train-xvector: {source} gave {emb.shape}")
    if launches["log_mel_wave"] != 2:
        raise AssertionError(f"train-xvector: launches {launches}")
    return launches


@contextlib.contextmanager
def one_rank_group_env():
    """``SDTK_*`` variables that describe a process group of one rank on
    this machine, as a user's launcher sets them; removed afterwards."""
    from sdtk_tpu_torch.tools.measure import free_port

    keys = ("SDTK_COORDINATOR", "SDTK_NUM_PROCESSES", "SDTK_PROCESS_ID")
    os.environ.update({"SDTK_COORDINATOR": f"127.0.0.1:{free_port()}",
                       "SDTK_NUM_PROCESSES": "1", "SDTK_PROCESS_ID": "0"})
    try:
        yield
    finally:
        for k in keys:
            os.environ.pop(k, None)


def phase_longform(work: Path, ref_61) -> dict:
    """Long-form diarization of a synthesized same-family 3-speaker meeting
    of about an hour (``build_meeting(7, 3, 1200, 3.0)``) through the CLI a
    user calls, ``cli.diarize --longform --eval-rttm ... --collar 0.75``
    (the CLI's 1.0 s / 0.375 s windows and energy gate), inside a process
    group of one rank on NCCL that the ``SDTK_*`` variables describe, so the
    collectives run on the card.  The first call runs under the profiler
    (launch counts, peak memory, the device's busy time); a second, warm
    call is timed alone; a third diarizes the main phase's 61.3 s meeting.
    The hour is diarized once more with the energy gate off (the CLI's
    windows, ``LongformDiarizer`` called directly).  Then K1's launch on the path's own input (the hour padded for one rank,
    the halo chunk preemphasized, coefficient 0) is held against its plain
    version.  Fails unless both meetings give 3 speakers, the hour's
    confusion and DER are at or below LONGFORM_CONFUSION_BAR and
    LONGFORM_DER_BAR, the 61.3 s meeting's DER and the ungated hour's at or
    below DER_BAR, K1 launched once and agrees with its plain version, the tower
    epilogue launched and no other kernel.  Returns the hour
    call's launch counts."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from sdtk_tpu_torch.cli import diarize as cli
    from sdtk_tpu_torch.cluster.der import diarization_error_rate, load_rttm
    from sdtk_tpu_torch.ops.fbank_wave import raw_log_mel_wave
    from sdtk_tpu_torch.ops.longform import halo_chunk, pad_for_sharding
    from sdtk_tpu_torch.pipeline import longform
    from sdtk_tpu_torch.pipeline.diarize import to_rttm
    from sdtk_tpu_torch.tools.make_meeting import write_meeting

    t0 = time.perf_counter()
    wav_path, rttm_path, audio_s = write_meeting(work / "hour", 7, 3, LONGFORM_TURNS, 3.0, "hour")
    synth_s = time.perf_counter() - t0
    (work / "meeting.rttm").write_text(to_rttm({"segments": ref_61}, recording_id="rec"))

    results, inputs = [], []
    real = longform.LongformDiarizer.diarize_waveform

    def recorded(self, wav):
        out = real(self, wav)
        results.append(out)
        inputs.append((self._engine.cfg, wav))
        return out

    def call(wav, rttm, out_json, rec):
        with one_rank_group_env():
            t0 = time.perf_counter()
            rc = cli.main([str(wav), "--longform", "--eval-rttm", str(rttm), "--collar", "0.75",
                           "--recording-id", rec, "--format", "json", "-q", "-o", str(out_json)])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"longform: the CLI returned {rc} on {wav}")
        return json.loads(Path(out_json).read_text()), wall

    longform.LongformDiarizer.diarize_waveform = recorded
    try:
        wrappers = reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            out1, wall1 = call(wav_path, rttm_path, work / "hour" / "out1.json", "hour")
        launches = read_launches(wrappers)
        peak = torch.cuda.max_memory_allocated()
        busy_us = trace_device_us(prof)
        out2, wall2 = call(wav_path, rttm_path, work / "hour" / "out2.json", "hour")
        out3, _ = call(work / "meeting.wav", work / "meeting.rttm", work / "meeting-long.json",
                       "rec")
    finally:
        longform.LongformDiarizer.diarize_waveform = real
    first, warm, short = results

    # the hour with the energy gate off: the gate's miss apart from the rest
    fcfg, hour = inputs[0]
    ungated = longform.LongformDiarizer(cfg=longform.LongformConfig(
        window_seconds=1.0, hop_seconds=0.375, vad_threshold_db=-math.inf))  # the CLI's windows
    ungated_out = ungated.diarize_waveform(hour)
    ungated_der = diarization_error_rate(load_rttm(rttm_path)["hour"], ungated_out["segments"],
                                         collar=0.75)

    # K1 as sharded_log_mel launches it on the hour, against its plain version
    tol = TOL["bf16-ln" if fcfg.compute_dtype == "bfloat16" else "f32-ln"]
    x = torch.from_numpy(pad_for_sharding(np.asarray(hour, np.float32), 1, fcfg)).cuda()
    pre = halo_chunk(x, fcfg)[None]
    k1_out = raw_log_mel_wave(pre, fcfg, 0.0)
    k1_finite = bool(torch.isfinite(k1_out).all())
    k1_err, k1_timing_row = k1_timing(pre, fcfg, 0.0)
    k1_row = {"shape": list(pre.shape), "max_abs_err": k1_err, "tol": tol, **k1_timing_row}
    emit({"phase": "kernel", "name": "log_mel_wave", "config": "long-form path, coefficient 0",
          "library": "torch.fft.rfft + mel matmul (f32)", **k1_row})
    del x, pre, k1_out

    busy_ms = busy_us / 1e3 if busy_us > 0 else "not measured"
    in_call = sum(first["timings"].values())
    row = {"phase": "longform", "audio_seconds": audio_s, "synth_seconds": synth_s,
           "windows": len(first["window_labels"]), "windows_kept": first["windows_kept"],
           "mesh_devices": first["mesh_devices"], "embed_chunk": longform.EMBED_CHUNK,
           "n_speakers": out1["n_speakers"], "der_c075": out1["der"]["der"],
           "miss": out1["der"]["miss"], "false_alarm": out1["der"]["false_alarm"],
           "confusion": out1["der"]["confusion"], "der_bar": LONGFORM_DER_BAR,
           "confusion_bar": LONGFORM_CONFUSION_BAR,
           "ungated": {"n_speakers": ungated_out["n_speakers"],
                       **{k: ungated_der[k] for k in ("der", "miss", "false_alarm", "confusion")}},
           "wall_seconds_profiled": wall1, "wall_seconds": wall2,
           "audio_s_per_s": audio_s / wall2, "stage_seconds_profiled": first["timings"],
           "stage_seconds": warm["timings"],
           "audio_s_per_s_in_diarize_waveform": audio_s / sum(warm["timings"].values()),
           "launches": launches, "peak_memory_bytes": peak, "device_busy_ms_profiled": busy_ms,
           "device_idle_share_of_call": (1.0 - busy_ms / 1e3 / wall1
                                         if isinstance(busy_ms, float) else "not measured"),
           "device_idle_share_of_diarize_waveform": (1.0 - busy_ms / 1e3 / in_call
                                                     if isinstance(busy_ms, float)
                                                     else "not measured"),
           "same_labels_warm": warm["window_labels"] == first["window_labels"],
           "meeting_61s": {"n_speakers": out3["n_speakers"], "der_c075": out3["der"]["der"],
                           "der_bar": DER_BAR, "windows": len(short["window_labels"]),
                           "stage_seconds": short["timings"]}}
    emit(row)
    if launches["log_mel_wave"] != 1 or launches["tower_epilogue"] <= 0 or any(
            v for k, v in launches.items() if k not in ("log_mel_wave", "tower_epilogue")):
        raise AssertionError(f"longform: launches {launches}, expected log_mel_wave 1, the "
                             f"tower epilogue and no other")
    if first["mesh_devices"] != 1:
        raise AssertionError(f"longform: {first['mesh_devices']} ranks, expected a group of 1")
    if out1["n_speakers"] != 3 or out3["n_speakers"] != 3:
        raise AssertionError(f"longform: {out1['n_speakers']} and {out3['n_speakers']} speakers, "
                             "expected 3 and 3")
    if not out1["der"]["confusion"] <= LONGFORM_CONFUSION_BAR:
        raise AssertionError(f"longform: confusion {out1['der']['confusion']} > "
                             f"{LONGFORM_CONFUSION_BAR}")
    if not out1["der"]["der"] <= LONGFORM_DER_BAR:
        raise AssertionError(f"longform: DER {out1['der']['der']} > {LONGFORM_DER_BAR}")
    if not out3["der"]["der"] <= DER_BAR:
        raise AssertionError(f"longform: 61.3 s meeting DER {out3['der']['der']} > {DER_BAR}")
    if ungated_out["n_speakers"] != 3 or not ungated_der["der"] <= DER_BAR:
        raise AssertionError(f"longform: the hour with the gate off: {ungated_out['n_speakers']} "
                             f"speakers, DER {ungated_der['der']} > {DER_BAR}")
    if not k1_finite or not k1_err <= tol:
        raise AssertionError(f"longform: K1 on the path's input {tuple(k1_row['shape'])}, "
                             f"finite {k1_finite}, max|d| {k1_err} > {tol}")
    return launches


def phase_train_ddp(work: Path) -> dict:
    """``training.train(mesh_spec="data=1")`` inside a process group of one
    rank on NCCL (the gradient all-reduce and the global loss run on the
    card), 2 steps of the fam5tel recipe, against the same call without a
    group, both with cuDNN's deterministic algorithms so the two runs can
    be compared at all: the losses equal bit for bit, every parameter
    within bf16's rounding of its value (2⁻⁸ relative), K1 launched once a
    step.  Returns the group run's launch counts."""
    import torch

    from sdtk_tpu_torch import training
    from sdtk_tpu_torch.parallel import multihost
    from sdtk_tpu_torch.tools.measure import free_port

    kw = {**TRAIN_RECIPE, "model_name": "ecapa", "resume_path": FAM5TEL, "device": "cuda",
          "steps": 2, "seed": 3, "log_every": 1}
    flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        multihost.initialize(f"127.0.0.1:{free_port()}", 1, 0, device="cuda")
        try:
            wrappers = reset_launches()
            t0 = time.perf_counter()
            grouped, _ = training.train(mesh_spec="data=1", out_path=work / "ddp.msgpack",
                                        log=lambda m: None, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = read_launches(wrappers)
        finally:
            multihost.shutdown()
        plain, _ = training.train(out_path=work / "plain.msgpack", log=lambda m: None, **kw)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags
    loss_g = [t["loss"] for t in grouped.timings["steps"]]
    loss_p = [t["loss"] for t in plain.timings["steps"]]
    worst, worst_ratio, max_abs = "", 0.0, 0.0
    pg = dict(grouped.model.named_parameters())
    for name, p in plain.model.named_parameters():
        d = (pg[name].detach() - p.detach()).abs()
        ratio = float((d / torch.clamp(p.detach().abs() * 2.0 ** -8, min=1e-30)).max())
        max_abs = max(max_abs, float(d.max()))
        if ratio >= worst_ratio:
            worst, worst_ratio = name, ratio
    row = {"phase": "train-ddp", "steps": 2, "losses_group": loss_g, "losses_no_group": loss_p,
           "params_max_abs_diff": max_abs, "worst_param": worst,
           "worst_param_diff_over_bf16_rounding": worst_ratio, "wall_seconds_group": wall,
           "step_ms_group": [t["step_ms"] for t in grouped.timings["steps"]],
           "step_ms_no_group": [t["step_ms"] for t in plain.timings["steps"]],
           "launches": launches}
    emit(row)
    if loss_g != loss_p:
        raise AssertionError(f"train-ddp: losses {loss_g} in the group, {loss_p} without")
    if not worst_ratio <= 1.0:
        raise AssertionError(f"train-ddp: {worst} {worst_ratio}x bf16's rounding apart")
    if launches["log_mel_wave"] != 2 or any(v for k, v in launches.items() if k != "log_mel_wave"):
        raise AssertionError(f"train-ddp: launches {launches}, expected log_mel_wave 2 and no other")
    return launches


# Held-out verification EER of the bundled fam5tel in bf16 at the JAX
# defaults (16 speakers x 6 trials, 3 s): 96 genuine trials, steps of ~1 %.
# The JAX package's published EER is 1.0 % on both tiers.
EER_BARS = {"clean": 0.03, "telephone": 0.05}
# The port's fitter against the bundled sidecar's own numbers: the
# augmentation's draws are NumPy's in both packages, so only the tower's
# arithmetic differs.
CALIB_BAR = {"eer_threshold": 0.02, "raw_eer_threshold": 0.02, "suggested_merge_tau": 0.02,
             "calibration_eer": 0.01}
CALIB_ARGS = ["--speakers", "24", "--families", "0,1,2,3,4", "--base-id", "500000",
              "--augment-prob", "0.5"]
HELDOUT_DER_BAR = 0.10  # collar 0.75; a broken clustering reads > 0.3


def run_json(module, argv: list[str]) -> dict:
    """``module.main(argv)``, as ``python -m`` runs it; its JSON line."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = module.main(argv)
    if rc != 0:
        raise AssertionError(f"{module.__name__} {argv}: exit code {rc}")
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def phase_heldout_eer(device) -> dict:
    """``python -m sdtk_tpu_torch.evals.eer`` on the card with the bundled
    fam5tel (bf16), clean and telephone tiers at the JAX defaults: EER and
    its threshold, FAR / FRR at 0.354, the EER of the scored space, the
    launches.  Fails above EER_BARS or if K1 was not launched; then K1 at
    the path's own launch (``embed_rows``' calls of 16 rows of 3 s)
    against its plain version.  Returns the launch counts."""
    import numpy as np

    from sdtk_tpu_torch.backends.base import get_backend, register_backend
    from sdtk_tpu_torch.data.synth_heldout import apply_tier, heldout_utterance
    from sdtk_tpu_torch.evals import eer

    register_backend("gpu", GPU_BACKEND)  # a backend over the bundled checkpoint
    start = time.perf_counter()
    wrappers = reset_launches()
    rows = {}
    for tier in EER_BARS:
        t0 = time.perf_counter()
        out = run_json(eer, ["--backend", "gpu", "--device", "cuda", "--tier", tier])
        rows[tier] = {k: out.get(k) for k in ("eer", "eer_threshold", "far_at_reference",
                                              "frr_at_reference", "scored_eer",
                                              "calibrated_far_at_reference",
                                              "calibrated_frr_at_reference", "genuine_mean",
                                              "impostor_mean", "genuine_trials",
                                              "impostor_trials")}
        rows[tier]["seconds"] = time.perf_counter() - t0
    launches = read_launches(wrappers)
    emit({"phase": "heldout-eer", "checkpoint": FAM5TEL.name, "tiers": rows, "bars": EER_BARS,
          "seconds": time.perf_counter() - start, "launches": launches})
    for tier, bar in EER_BARS.items():
        if not rows[tier]["eer"] <= bar:
            raise AssertionError(f"heldout-eer: {tier} EER {rows[tier]['eer']} > {bar}")
    if launches["log_mel_wave"] <= 0:
        raise AssertionError("heldout-eer: log_mel_wave was not launched")
    cfg = get_backend("gpu", device="cuda").engine.cfg
    x = np.stack([apply_tier(heldout_utterance(s, 1, 3.0), "telephone", seed=1000 * s + 1)
                  for s in range(16)])
    k1_case("bf16-ln", cfg, x, np.full(16, x.shape[1], np.int64), device,
            config="heldout-eer path, 16 held-out rows of 3 s")
    return launches


def phase_calibrate(work: Path, device) -> dict:
    """``python -m sdtk_tpu_torch.evals.calibrate`` on a copy of fam5tel with
    the bundled sidecar's own arguments, ``--out`` beside the copy: the
    fitted fields within CALIB_BAR of ``models/ecapatdnn-fam5tel.calib.json``;
    a ``GpuBackend`` over the copy reads the sidecar (merge bar, calibrated
    scores).  Then the same with ``--cohort-size 192`` on a second copy: the
    ``.cohort.npy`` is written and read (16 speakers, so 96 trials), and K3
    is held against its plain version at the cohort product's shape (96 x
    192 cohort rows).
    Returns the launch counts of both runs."""
    import numpy as np
    import torch

    from sdtk_tpu_torch.backends.base import register_backend
    from sdtk_tpu_torch.backends.gpu import GpuBackend
    from sdtk_tpu_torch.evals import calibrate

    d = work / "calib"
    d.mkdir(parents=True, exist_ok=True)
    bundled = json.loads(FAM5TEL.with_suffix(".calib.json").read_text())
    fits, seconds = {}, {}
    wrappers = reset_launches()
    try:
        # the cohort run at 16 speakers: 96 trials against 192 cohort rows
        for name, extra in (("fam5tel", ["--cohort-size", "0"]),
                            ("fam5tel-cohort", ["--cohort-size", "192", "--speakers", "16"])):
            ckpt = d / f"{name}.msgpack"
            shutil.copy(FAM5TEL, ckpt)
            os.environ["SDTK_MODEL_PATH"] = str(ckpt)
            register_backend("gpu", GPU_BACKEND)
            t0 = time.perf_counter()
            fits[name] = run_json(calibrate, ["--backend", "gpu", "--device", "cuda", *CALIB_ARGS,
                                              *extra, "--out", str(ckpt.with_suffix(".calib.json"))])
            seconds[name] = time.perf_counter() - t0
    finally:
        os.environ.pop("SDTK_MODEL_PATH", None)
        register_backend("gpu", GPU_BACKEND)
    launches = read_launches(wrappers)
    fit = fits["fam5tel"]
    diffs = {k: abs(fit[k] - bundled[k]) for k in CALIB_BAR}

    reader = GpuBackend(params_path=d / "fam5tel.msgpack", device="cuda")
    at_t = float(reader.calibrate_score(np.array([fit["eer_threshold"]], np.float32))[0])
    with_cohort = GpuBackend(params_path=d / "fam5tel-cohort.msgpack", device="cuda")
    cohort = with_cohort.cohort
    emit({"phase": "calibrate", "fit": {k: fit[k] for k in (*CALIB_BAR, "gain", "raw_eer")},
          "bundled": {k: bundled[k] for k in CALIB_BAR}, "abs_diff": diffs, "bars": CALIB_BAR,
          "cohort_fit": {k: fits["fam5tel-cohort"][k] for k in ("score_space", "eer_threshold",
                                                                "calibration_eer", "gain")},
          "read_back": {"merge_tau": reader.cluster_merge_tau,
                        "calibrated_at_eer_threshold": at_t,
                        "cohort_shape": None if cohort is None else list(cohort.shape)},
          "seconds": seconds, "launches": launches})
    for k, bar in CALIB_BAR.items():
        if not diffs[k] <= bar:
            raise AssertionError(f"calibrate: {k} {fit[k]} is {diffs[k]} from the bundled "
                                 f"{bundled[k]} (bar {bar})")
    if reader.cluster_merge_tau != fit["suggested_merge_tau"] or not abs(at_t - 0.354) <= 1e-4:
        raise AssertionError(f"calibrate: the backend read merge bar {reader.cluster_merge_tau} "
                             f"and {at_t} at the EER threshold")
    if cohort is None or cohort.shape != (192, D) or fits["fam5tel-cohort"]["cohort_size"] != 192:
        raise AssertionError("calibrate: the 192-row cohort was not written and read back")
    if launches["log_mel_wave"] <= 0:
        raise AssertionError("calibrate: log_mel_wave was not launched")
    p = torch.from_numpy(np.ascontiguousarray(cohort, np.float32)).to(device)
    cosine_case(torch.roll(p, 1, dims=0)[:96].contiguous(), p,
                config="calibrate cohort product, 96 x 192 cohort rows")
    return launches


def phase_heldout_der() -> dict:
    """``python -m sdtk_tpu_torch.evals.der --heldout`` on the card at its
    defaults (3 meetings of 3 held-out speakers, the count estimated, clean
    tier): DER at collars 0.75 and 0.25, the launches; fails above
    HELDOUT_DER_BAR at 0.75.  Returns the launch counts."""
    from sdtk_tpu_torch.evals import der

    wrappers = reset_launches()
    t0 = time.perf_counter()
    out = run_json(der, ["--backend", "gpu", "--device", "cuda", "--heldout"])
    wall = time.perf_counter() - t0
    launches = read_launches(wrappers)
    emit({"phase": "heldout-der", "meetings": out["meetings"], "tier": out["tier"],
          "der_c075": out["by_collar"]["0.75"], "der_c025": out["by_collar"]["0.25"],
          "bar": HELDOUT_DER_BAR, "audio_seconds": out["audio_seconds"],
          "audio_s_per_s": out["audio_s_per_s"], "seconds": wall, "launches": launches})
    if not out["by_collar"]["0.75"]["mean_der"] <= HELDOUT_DER_BAR:
        raise AssertionError(f"heldout-der: DER {out['by_collar']['0.75']['mean_der']} > "
                             f"{HELDOUT_DER_BAR}")
    if launches["log_mel_wave"] <= 0:
        raise AssertionError("heldout-der: log_mel_wave was not launched")
    return launches


@contextlib.contextmanager
def recorded_diarize():
    """A context in which every ``Diarizer.diarize_waveform`` result is
    appended to the list it yields."""
    from sdtk_tpu_torch.pipeline import diarize as pdiarize

    results, real = [], pdiarize.Diarizer.diarize_waveform

    def recorded(self, wav):
        out = real(self, wav)
        results.append(out)
        return out

    pdiarize.Diarizer.diarize_waveform = recorded
    try:
        yield results
    finally:
        pdiarize.Diarizer.diarize_waveform = real


def phase_decode(work: Path, ref) -> dict:
    """The main phase's meeting, as the ``cli`` phase wrote it (16-bit WAV),
    saved as FLAC (``flacio.encode``) and as MPEG Layer II
    (``encode_layer2``), each through ``cli.diarize`` on the card: the FLAC's
    samples are the WAV's, so its window labels must equal the WAV's; the
    MP2 must give 3 speakers and DER <= DER_BAR; K1 launched on each.
    Where the host has libmp3lame with libmpg123, and the AV libraries with
    an AAC encoder, one Layer III ``.mp3`` and one ``.m4a`` more, each held
    as the MP2 is; otherwise the row says it is not available, and why.
    ``load_audio_batch`` over the WAV, FLAC and MP2 must equal
    ``load_audio`` of each.  Returns the launch counts of every call."""
    from sdtk_tpu_torch.cli import diarize as cli
    from sdtk_tpu_torch.cluster.der import diarization_error_rate
    from sdtk_tpu_torch.utils import audio, avio, flacio, mpegaudio, syscodec

    start = time.perf_counter()
    d = work / "decode"
    d.mkdir(parents=True, exist_ok=True)
    x16 = audio.load_audio(work / "meeting.wav")[0]
    files = {"wav": work / "meeting.wav", "flac": d / "meeting.flac", "mp2": d / "meeting.mp2"}
    t0 = time.perf_counter()
    files["flac"].write_bytes(flacio.encode(x16, 16000, 16))
    encode_s = {"flac": time.perf_counter() - t0}
    t0 = time.perf_counter()
    files["mp2"].write_bytes(mpegaudio.encode_layer2(x16, 16000, 128))
    encode_s["mp2"] = time.perf_counter() - t0
    missing = {}
    if syscodec.lame_available() and syscodec.mpg123_available():
        files["mp3"] = d / "meeting.mp3"
        audio.save_mp3(files["mp3"], x16)
    else:
        missing["mp3"] = "libmp3lame or libmpg123 not found"
    if avio.available() and avio.can_encode(".m4a"):
        files["m4a"] = d / "meeting.m4a"
        avio.encode_file(str(files["m4a"]), x16, 16000)
    else:
        missing["m4a"] = avio.disabled_reason() or "no AAC encoder in the AV libraries"

    rows, total = {}, {}
    with recorded_diarize() as results:
        for kind, path in files.items():
            wrappers = reset_launches()
            t0 = time.perf_counter()
            rc = cli.main([str(path), "--format", "json", "-q", "-o", str(d / f"{kind}.json")])
            wall = time.perf_counter() - t0
            launches = read_launches(wrappers)
            if rc != 0:
                raise AssertionError(f"decode: the CLI returned {rc} on {path.name}")
            res = results[-1]
            der = diarization_error_rate(ref, res["segments"], collar=0.75)
            rows[kind] = {"bytes": path.stat().st_size, "n_speakers": res["n_speakers"],
                          "der_c075": der["der"], "seconds": wall, "launches": launches,
                          "labels": res["window_labels"]}
            total = {k: total.get(k, 0) + v for k, v in launches.items()}
    t0 = time.perf_counter()
    batch = audio.load_audio_batch([files[k] for k in ("wav", "flac", "mp2")])
    batch_s = time.perf_counter() - t0
    batch_same = all(b.shape == w.shape and bool((b == w).all())
                     for b, w in zip(batch, (audio.load_audio(files[k])[0]
                                             for k in ("wav", "flac", "mp2"))))
    flac_same = rows["flac"]["labels"] == rows["wav"]["labels"]
    emit({"phase": "decode", "audio_seconds": len(x16) / 16000, "encode_seconds": encode_s,
          "formats": {k: {kk: v for kk, v in r.items() if kk != "labels"}
                      for k, r in rows.items()},
          "available": {k: {"available": False, "reason": v} for k, v in missing.items()},
          "flac_labels_equal_wav": flac_same, "load_audio_batch_equal": batch_same,
          "load_audio_batch_seconds": batch_s, "der_bar": DER_BAR,
          "seconds": time.perf_counter() - start})
    if not flac_same:
        raise AssertionError("decode: the FLAC's window labels differ from the WAV's")
    for kind in files:
        if kind in ("wav", "flac"):
            continue
        if rows[kind]["n_speakers"] != 3 or not rows[kind]["der_c075"] <= DER_BAR:
            raise AssertionError(f"decode: {kind} gave {rows[kind]['n_speakers']} speakers, "
                                 f"DER {rows[kind]['der_c075']} (bar {DER_BAR})")
    for kind, row in rows.items():
        if row["launches"]["log_mel_wave"] <= 0:
            raise AssertionError(f"decode: log_mel_wave was not launched on the {kind}")
    if not batch_same:
        raise AssertionError("decode: load_audio_batch differs from load_audio")
    return total


# The VAD trainer (evals/train_vad.py's recipe: v4 at full width, batches of
# 64 windows of 1.5 s, Adam at 1e-3, positives weighted 2.0).  The card's step
# against the CPU's from one state and batch: the features differ only by
# K1's bf16 rounding (<= 0.007 ln), and the step runs in full f32 on both
# (``train_vad.full_f32``).
VAD_BATCH = 64
VAD_LOSS_RTOL = 1e-3
VAD_GRAD_COS = 0.999  # each gradient tensor against the CPU's
VAD_PARAM_COS = 0.999  # each updated tensor against the CPU's


def phase_train_vad_step(device) -> dict:
    """One step of the VAD trainer at full width (v4, 82 input channels,
    32 channels) on one batch of ``make_batch(default_rng(0), 64, 148)``
    from one seeded ``VadNet`` state, on the card (K1, bf16 features) and
    on the CPU (K1's plain version): loss within VAD_LOSS_RTOL relative,
    every gradient tensor at cosine >= VAD_GRAD_COS, every updated tensor
    at cosine >= VAD_PARAM_COS.  Then 20 steps on that batch on the card
    (the loss must fall; K1 once a step), the step's time by CUDA events
    and by the profiler, its host time, the peak memory; then K1 at the
    path's (64, 24 000) against its plain version.  Returns the path's
    launch counts (the card's first step and the 20) and the step's device
    time by the profiler."""
    import copy

    import numpy as np
    import torch

    from sdtk_tpu_torch.evals import train_vad as tv
    from sdtk_tpu_torch.models.vad import VadNet
    from sdtk_tpu_torch.ops.fbank import FrontendConfig
    from sdtk_tpu_torch.tools.measure import cos

    fcfg = FrontendConfig()
    t0 = time.perf_counter()
    wavs, labels = tv.make_batch(np.random.default_rng(0), VAD_BATCH, fcfg.num_frames(tv.N))
    synth_s = time.perf_counter() - t0
    init = VadNet(tv.vad_config("v4", fcfg.n_mels))
    init.reset_parameters(torch.Generator().manual_seed(0))

    def step(net, opt, dev):
        return tv.vad_step(net, opt, wavs, labels, fcfg, 2.0, dev)

    runs = {}
    wrappers = reset_launches()
    for name, dev in (("cuda", device), ("cpu", torch.device("cpu"))):
        net = copy.deepcopy(init).to(dev)
        opt = tv.make_optimizer(net, 1e-3)
        t0 = time.perf_counter()
        loss = float(step(net, opt, dev))
        runs[name] = {"loss": loss, "seconds": time.perf_counter() - t0, "net": net, "opt": opt,
                      "grads": {n: p.grad.detach().cpu() for n, p in net.named_parameters()},
                      "params": {n: p.detach().cpu() for n, p in net.named_parameters()}}
    first_launches = read_launches(wrappers)
    gpu, cpu = runs["cuda"], runs["cpu"]
    grad_cos = {n: cos(gpu["grads"][n], cpu["grads"][n]) for n in gpu["grads"]}
    param_cos = {n: cos(gpu["params"][n], cpu["params"][n]) for n in gpu["params"]}
    loss_rel = abs(gpu["loss"] - cpu["loss"]) / abs(cpu["loss"])
    worst_g, worst_p = min(grad_cos, key=grad_cos.get), min(param_cos, key=param_cos.get)

    net, opt = gpu["net"], gpu["opt"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, marks = [], []
    for _ in range(20):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        losses.append(step(net, opt, device))
        b.record()
        marks.append((a, b))
    torch.cuda.synchronize()
    launches = read_launches(wrappers)
    losses = [float(x) for x in losses]
    step_ms = [a.elapsed_time(b) for a, b in marks]
    busy = device_ms(lambda: step(net, opt, device), "", reps=5)  # "" matches every kernel
    t0 = time.perf_counter()
    step(net, opt, device)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    row = {"phase": "train-vad-step", "arch": "v4", "batch": VAD_BATCH,
           "params": sum(p.numel() for p in init.parameters()), "synth_seconds": synth_s,
           "loss_cuda": gpu["loss"], "loss_cpu": cpu["loss"], "loss_rel_diff": loss_rel,
           "loss_bar": VAD_LOSS_RTOL, "grad_cos": grad_cos, "min_grad_cos": grad_cos[worst_g],
           "min_grad": worst_g, "grad_cos_bar": VAD_GRAD_COS, "param_cos": param_cos,
           "min_param_cos": param_cos[worst_p], "min_param": worst_p,
           "param_cos_bar": VAD_PARAM_COS, "cpu_step_seconds": cpu["seconds"],
           "first_cuda_step_seconds": gpu["seconds"], "losses_20": losses,
           "first5_mean": statistics.mean(losses[:5]), "last5_mean": statistics.mean(losses[-5:]),
           "step_ms": step_ms, "step_ms_median": statistics.median(step_ms[5:]),
           "step_device_busy_ms": busy, "step_host_ms_synced": host_ms,
           "peak_memory_bytes": torch.cuda.max_memory_allocated(),
           "tf32": "off inside the step (train_vad.full_f32)",
           "first_step_launches": first_launches, "launches": launches}
    emit(row)
    if not loss_rel <= VAD_LOSS_RTOL:
        raise AssertionError(f"train-vad-step: card loss {gpu['loss']} vs CPU {cpu['loss']}")
    if not grad_cos[worst_g] >= VAD_GRAD_COS:
        raise AssertionError(f"train-vad-step: {worst_g}'s gradient at cosine {grad_cos[worst_g]}")
    if not param_cos[worst_p] >= VAD_PARAM_COS:
        raise AssertionError(f"train-vad-step: {worst_p} at cosine {param_cos[worst_p]}")
    if not row["last5_mean"] < row["first5_mean"]:
        raise AssertionError(f"train-vad-step: the loss did not fall on a fixed batch: {losses}")
    if first_launches["log_mel_wave"] != 1 or launches["log_mel_wave"] != 21 \
            or any(v for k, v in launches.items() if k != "log_mel_wave"):
        raise AssertionError(f"train-vad-step: launches {first_launches}, then {launches}; "
                             "expected log_mel_wave once a step and no other kernel")
    k1_case("bf16-ln", fcfg, wavs, np.full(VAD_BATCH, tv.N, np.int64), device,
            config="train-vad-step path, 64 windows of 1.5 s")
    return launches, busy


VAD_SMOKE_STEPS = 100  # the recipe's 400 cut: its host synthesis is 125-155 s on the H100's host


def phase_train_vad(work: Path, wav, step_device_ms) -> dict:
    """``python -m sdtk_tpu_torch.evals.train_vad`` on the card at the JAX
    defaults (batch 64, v4) but VAD_SMOKE_STEPS steps, through ``main``
    under the profiler, ``--out`` in the smoke directory: the loss falls
    (the first logged step's against the final), K1 once a step, the file
    read by the port's ``VadScorer`` and by ``pipeline.vad.trained_vad_mask``
    on the 61.3 s meeting.  Printed without a bar: the exit code and the
    held-out window accuracy (the script's own bar, 0.9, is the full
    recipe's), the share of the meeting's windows that the trained
    gate and the bundled ``models/vad.msgpack`` keep alike, synthesis and
    step seconds, and the device's idle share of the loop by the profile
    and by ``step_device_ms`` (train-vad-step's step on the device) times
    the steps.  Returns the path's launch counts."""
    import numpy as np

    from sdtk_tpu_torch.evals import train_vad as tv
    from sdtk_tpu_torch.models.vad import VadScorer, default_checkpoint
    from sdtk_tpu_torch.pipeline.diarize import DiarizeConfig
    from sdtk_tpu_torch.pipeline.vad import trained_vad_mask

    out = work / "vad-trained.msgpack"
    out.unlink(missing_ok=True)
    timings: dict = {}
    buf, logs = io.StringIO(), io.StringIO()

    steps = VAD_SMOKE_STEPS

    def call():
        with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(logs):
            return tv.main(["--device", "cuda", "--out", str(out), "--steps", str(steps)],
                           timings=timings)

    wrappers = reset_launches()
    t0 = time.perf_counter()
    rc, busy_ms = _profiled_device_ms(call)
    wall = time.perf_counter() - t0
    launches = read_launches(wrappers)
    result = json.loads(buf.getvalue().strip().splitlines()[-1])
    scorer = VadScorer(out)
    dcfg = DiarizeConfig()
    masks = {}
    for name, path in (("trained", out), ("bundled", default_checkpoint())):
        starts, keep = trained_vad_mask(wav, 16000, dcfg.window_seconds, dcfg.hop_seconds,
                                        params_path=str(path))
        masks[name] = keep
    alike = float(np.mean(masks["trained"] == masks["bundled"]))
    log = [ln for ln in logs.getvalue().splitlines() if ln.startswith("step ")]
    first_loss = float(log[0].rsplit(" ", 1)[1]) if log else float("nan")
    loop_s = timings["loop_s"]
    by_steps = step_device_ms * steps if isinstance(step_device_ms, float) else "not measured"
    row = {"phase": "train-vad", "steps": steps, "steps_cut_from": 400, "rc": rc,
           "result": result, "first_logged_loss": first_loss, "wall_seconds": wall,
           "synth_seconds": timings["synth_s"], "step_seconds": timings["step_s"],
           "loop_seconds": loop_s, "synth_s_per_batch": timings["synth_s"] / steps,
           "device_busy_ms_profiled": busy_ms, "device_busy_ms_by_step_device_time": by_steps,
           "profiled_over_step_device_time": (busy_ms / by_steps if isinstance(busy_ms, float)
                                              and isinstance(by_steps, float) else "not measured"),
           "device_idle_share_of_loop": {
               k: 1.0 - v / 1e3 / loop_s if isinstance(v, float) else "not measured"
               for k, v in (("by_profile", busy_ms), ("by_step_device_time", by_steps))},
           "log": log,
           "scorer": {"deep": scorer.cfg.deep, "extra_feats": scorer.cfg.extra_feats},
           "meeting_windows": int(len(starts)),
           "kept_share": {k: float(v.mean()) for k, v in masks.items()},
           "windows_alike_with_bundled": alike, "launches": launches}
    emit(row)
    if not result["final_loss"] < first_loss:
        raise AssertionError(f"train-vad: the loss did not fall: {log}, "
                             f"final {result['final_loss']}")
    if launches["log_mel_wave"] != steps or any(v for k, v in launches.items()
                                               if k != "log_mel_wave"):
        raise AssertionError(f"train-vad: launches {launches}, expected log_mel_wave {steps}")
    if not (scorer.cfg.deep and scorer.cfg.extra_feats) or result["out"] != str(out):
        raise AssertionError("train-vad: the written file is not the v4 graph")
    if not len(masks["trained"]) == len(masks["bundled"]) > 0:
        raise AssertionError("train-vad: the trained gate scored no window of the meeting")
    return launches


def phase_shell(work: Path, device: str) -> dict:
    """The host shell over the process phase's store (its 3 meetings; the
    assign store's 8 195 profiles), each command through ``python -m
    sdtk_tpu_torch <tool>`` (``__main__.main``, in this process): ``catalog``
    list / status / show / list-contexts, and a ``query`` whose filter
    selects the entries under the process directory, which must print
    those 3 and no other; ``report`` status, speakers, coverage and
    confidence as JSON, their counts equal to what the store holds;
    ``review review <b3sum> --simple`` approving the first segment and
    quitting: one new sample under that speaker, listed by ``samples
    list``, reviewed in its metadata, an MP3 that decodes; ``detection
    identify`` of that MP3 on the card naming the approved speaker first
    (K1 launched, K2 on the fused route); ``samples extract`` of that
    speaker's turns and ``segments`` on the meeting's transcript; ``llm
    analyze`` and ``detect-names`` with the offline pattern provider.  Then
    identify's K1 input and its K2 scoring (the sample's windows against
    the store) against their plain versions.  Returns the path's launch
    counts."""
    from collections import Counter

    import numpy as np
    import torch

    from sdtk_tpu_torch import __main__ as umbrella
    from sdtk_tpu_torch import config
    from sdtk_tpu_torch.pipeline import report as R
    from sdtk_tpu_torch.pipeline import review as RV
    from sdtk_tpu_torch.pipeline.identify import _backend as identify_backend
    from sdtk_tpu_torch.store import assignments, catalog
    from sdtk_tpu_torch.store import profiles as P
    from sdtk_tpu_torch.utils.audio import load_audio
    from sdtk_tpu_torch.utils.ioutil import load_yaml

    src = work / "process-in"
    for var, name in (("SPEAKER_REVIEW_SESSION_DIR", "review-session"),
                      ("SPEAKER_LLM_CACHE_DIR", "llm-cache")):
        shutil.rmtree(work / name, ignore_errors=True)
        os.environ[var] = str(work / name)
    seconds: dict = {}

    def run(*argv: str, stdin: str = "") -> str:
        out, err = io.StringIO(), io.StringIO()
        real, sys.stdin = sys.stdin, io.StringIO(stdin)
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
                rc = umbrella.main(list(argv))
        finally:
            sys.stdin = real
        seconds[argv[0] if argv[0] == "segments" else " ".join(argv[:2])] = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"shell: {' '.join(argv)} returned {rc}: {err.getvalue()[-2000:]}")
        return out.getvalue()

    wrappers = reset_launches()
    start = time.perf_counter()
    listed = json.loads(run("catalog", "list", "--format", "json"))
    ours = {r["b3sum"]: r for r in listed if Path(r["path"]).parent == src}
    by_name = {Path(r["path"]).name: b3 for b3, r in ours.items()}
    b3 = by_name.get("meeting-1.wav", "")
    status = run("catalog", "status", b3).strip()
    shown = json.loads(run("catalog", "show", b3, "--format", "json"))
    shown_text = run("catalog", "show", b3)
    contexts = run("catalog", "list-contexts")
    prefix = json.dumps(str(src) + "/")
    queried = run("catalog", "query",
                  f".[] | select(.recording.path | startswith({prefix})) | .recording.b3sum")
    queried = sorted(json.loads(line) for line in queried.splitlines())

    reports = {name: json.loads(run("report", name, "--format", "json"))
               for name in ("status", "speakers", "coverage", "confidence")}
    entries = catalog.list_entries()
    n_profiles = len(list(config.db_dir().glob("*.json")))
    low = reports["confidence"]
    # recordings whose assignment file holds a mapping below the threshold
    below = sum(any(R.CONFIDENCE_MAP.get(m.get("confidence", "low"), 0) < low["threshold"]
                    for m in (load_yaml(f).get("mappings") or {}).values())
                for f in config.assignments_dir().glob("*.yaml"))
    counts = {"recordings": (reports["status"]["recordings"]["total"], len(entries)),
              "speakers": (reports["status"]["speakers"]["total"], n_profiles),
              "speakers_report": (reports["speakers"]["total"], n_profiles),
              "speakers_listed": (len(reports["speakers"]["speakers"]), n_profiles),
              "coverage": (sum(c["total"] for c in reports["coverage"].values()), len(entries)),
              "confidence": (low["count"], below)}

    samples_root = config.samples_dir()
    before = set(samples_root.rglob("*.meta.yaml"))
    review_out = run("review", "review", b3, "--simple", stdin="a\nq\n")
    session = RV.load_session()
    seg = session.segments[0]
    spk = seg.speaker_id
    new = sorted(set(samples_root.rglob("*.meta.yaml")) - before)
    meta = load_yaml(new[0]) if len(new) == 1 else {}
    mp3 = new[0].with_name(new[0].name.replace(".meta.yaml", ".mp3")) if new else None
    sample_list = json.loads(run("samples", "list", str(spk), "--format", "json"))
    x, sr = load_audio(mp3) if mp3 else (np.zeros(0, np.float32), 0)

    at = read_launches(wrappers)
    ident = json.loads(run("detection", "identify", str(mp3), "--device", device,
                           "--format", "json"))
    ident_launches = {k: v - at[k] for k, v in read_launches(wrappers).items()}

    transcript = shown["transcriptions"][0]["path"]
    mapping = assignments.load_assignments(b3)["mappings"]
    label = next(lab for lab, m in mapping.items() if m.get("speaker_id") == spk)
    extracted = run("samples", "extract", str(spk), shown["recording"]["path"],
                    "--transcript", transcript, "-l", label, "--max-segments", "2")
    speakers = run("segments", transcript).split()
    csv = run("segments", transcript, label, "--format", "csv")
    analysis = json.loads(run("llm", "analyze", transcript, "--provider", "pattern"))
    names = json.loads(run("llm", "detect-names", transcript, "--provider", "pattern"))
    # the detection tool's profile commands over the same store
    validated = run("detection", "validate").strip()
    exported = json.loads(run("detection", "export"))
    exported_sm = json.loads(run("detection", "export", "--format", "speechmatics"))
    tags = run("detection", "tag", str(spk), "--add", "smoke").strip()
    run("detection", "update", str(spk), "--description", "approved in review",
        "--metadata", "source=chip_smoke")
    updated = json.loads(run("detection", "show", str(spk)))
    validity = run("detection", "check-validity", str(spk), "-v", "--device", device)
    listed_backends = run("detection", "backends").split()
    launches = read_launches(wrappers)

    # identify's kernels against their plain versions at its own shapes: K1
    # on the first batch identify built from the sample (max_windows rows,
    # the pad rows of length 0), K2 on the sample's windows against the
    # store matrix identify scored, at its k
    backend = identify_backend(None, device)
    eng = backend.engine
    wav = backend._load(mp3, None)
    all_w, all_l = eng._window_all(np.asarray(wav, np.float32))
    n_win = min(eng.max_windows, len(all_w))
    x_k1 = np.zeros((eng.max_windows, all_w.shape[1]), np.float32)
    len_k1 = np.zeros(eng.max_windows, np.int64)
    x_k1[:n_win], len_k1[:n_win] = all_w[:n_win], all_l[:n_win]
    k1_row = k1_case("bf16-ln", eng.cfg, x_k1, len_k1, device,
                     config="shell path, identify of the approved sample")
    pm = P.ProfileMatrix.build(backend.name, speakers=[
        s for s in P.list_all_speakers() if s.get("embeddings", {}).get(backend.name)])
    k = min(64 * max(Counter(r["speaker_id"] for r in pm.rows).values()), len(pm))
    scoring = scoring_case(np.asarray(backend.embed_windows(wav), np.float32),
                           torch.from_numpy(pm.matrix).to(device), k)
    row = {"phase": "shell", "recordings_in_dir": sorted(by_name), "status": status,
           "show_text_lines": len(shown_text.splitlines()),
           "contexts": contexts.strip().splitlines(),
           "query_b3sums": len(queried), "counts": counts, "profiles": n_profiles,
           "review": {"recording": b3, "segments": len(session.segments),
                      "first": {"label": seg.speaker_label, "speaker_id": spk,
                                "start": seg.start, "end": seg.end, "decision": seg.decision},
                      "new_samples": [str(p.relative_to(samples_root)) for p in new],
                      "review_status": meta.get("review", {}).get("status"),
                      "mp3_bytes": mp3.stat().st_size if mp3 else 0,
                      "mp3_seconds": len(x) / sr if sr else 0.0,
                      "listed": len(sample_list), "lines": len(review_out.splitlines())},
           "identify": {"top": [(r["speaker_id"], r["score"]) for r in ident[:3]],
                        "launches": ident_launches, "profiles_rows": len(pm),
                        "k1_shape": k1_row["shape"], "k1_max_abs_err": k1_row["max_abs_err"],
                        "kernel_vs_plain": scoring, "tol": SCORE_TOL},
           "extract": extracted.strip(), "segments_speakers": speakers,
           "segments_csv_rows": len(csv.splitlines()) - 1,
           "llm": {"detections": len(analysis.get("detections", [])), "names": names},
           "detection": {"validate": validated, "export_speakers": len(exported["speakers"]),
                         "export_speechmatics_speakers": len(exported_sm["speakers"]),
                         "tags": tags, "description": updated.get("description"),
                         "check_validity": validity.strip().splitlines()[-3:],
                         "backends": listed_backends},
           "seconds": seconds,
           "wall_seconds": time.perf_counter() - start, "launches": launches}
    emit(row)
    if sorted(by_name) != ["meeting-1.wav", "meeting-2.wav", "meeting-3.wav"]:
        raise AssertionError(f"shell: catalog list shows {sorted(by_name)} in {src}")
    if queried != sorted(ours) or status not in catalog.STATUS_VALUES:
        raise AssertionError(f"shell: query gave {queried}, the directory holds {sorted(ours)}")
    for key, (got, want) in counts.items():
        if got != want:
            raise AssertionError(f"shell: report {key} {got}, the store holds {want}")
    if not (len(new) == 1 and new[0].parent.name == spk and seg.decision == "approved"
            and meta.get("review", {}).get("status") == "reviewed"):
        raise AssertionError(f"shell: review wrote {new} for {spk}")
    if not any(m.get("sample_id") == meta["sample_id"] for m in sample_list):
        raise AssertionError("shell: samples list does not show the approved sample")
    if not (len(x) > 0 and sr == 16000 and np.isfinite(x).all()):
        raise AssertionError(f"shell: the sample's MP3 does not decode ({len(x)} samples, {sr})")
    if not ident or ident[0]["speaker_id"] != spk:
        raise AssertionError(f"shell: identify named {row['identify']['top']}, approved {spk}")
    if ident_launches["log_mel_wave"] <= 0 or ident_launches["identify_topk"] <= 0:
        raise AssertionError(f"shell: identify launched {ident_launches}; expected K1 and K2")
    check_scoring("shell identify", scoring)
    if "Extracted" not in extracted or label not in speakers or len(csv.splitlines()) < 2:
        raise AssertionError(f"shell: extract {extracted!r}, segments {speakers}")
    if validated != "All files valid.":
        raise AssertionError(f"shell: detection validate found issues: {validated[:2000]}")
    if not (len(exported["speakers"]) == len(exported_sm["speakers"]) == n_profiles
            and exported["context"] == "default"):
        raise AssertionError(f"shell: export listed {len(exported['speakers'])} and "
                             f"{len(exported_sm['speakers'])} of {n_profiles} speakers")
    if "smoke" not in tags.split(",") or updated.get("description") != "approved in review" \
            or updated.get("metadata", {}).get("source") != "chip_smoke":
        raise AssertionError(f"shell: tag gave {tags!r}, update gave {updated.get('metadata')}")
    if "Checked" not in validity or "INVALIDATED" in validity:
        raise AssertionError(f"shell: check-validity printed {validity!r}")
    if not {"fake", "gpu", "speechmatics"} <= set(listed_backends):
        raise AssertionError(f"shell: backends listed {listed_backends}")
    return launches


CONFORMER_SEED = 13  # the seeded full-width Conformer of the three Conformer phases
# The Conformer's sequence-parallel forward against its dense module, both
# f32 on the card: tests/test_parallel.py's bar.
SP_TOL = 2e-4
MASK_INVARIANCE_TOL = 1e-4  # tests/test_models.py's bar, f32


def seeded_conformer(dtype: str = "float32"):
    """The full-width Conformer (dim 256, 6 blocks) with seeded random
    weights and seeded, non-identity BatchNorm statistics, on the CPU."""
    import torch

    from sdtk_tpu_torch.models.conformer import Conformer, ConformerConfig

    model = Conformer(ConformerConfig(dtype=dtype))
    gen = torch.Generator().manual_seed(CONFORMER_SEED)
    model.reset_parameters(gen)
    with torch.no_grad():
        for i in range(model.cfg.n_blocks):
            bn = getattr(model, f"block{i}").conv.BatchNorm_0
            bn.running_mean.copy_(0.1 * torch.randn(bn.running_mean.shape, generator=gen))
            bn.running_var.copy_(0.5 + torch.rand(bn.running_var.shape, generator=gen))
    return model.eval()


def phase_tower_conformer(work: Path, wav) -> dict:
    """The Conformer tower served by ``GpuBackend(model="conformer")`` at
    full width from a seeded flax-msgpack file (no Conformer file is
    bundled): 8 windows of 3 s on the card (bf16) against the same weights
    in f32 on the CPU, per window at ``TOWER_COS_BAR``; mask invariance on
    the card in f32 (24 frames of garbage behind a masked tail move the
    embedding by at most ``MASK_INVARIANCE_TOL``); ms per chunk of 128
    windows of 1 s; then ``cli.diarize`` on the meeting under
    ``SDTK_BACKEND_TOWER=conformer`` exits 0 with K1 launched (untrained
    weights: no DER bar).  Returns the CLI path's launch counts."""
    import numpy as np
    import torch

    from sdtk_tpu_torch.backends.base import get_backend
    from sdtk_tpu_torch.cli import diarize as cli
    from sdtk_tpu_torch.utils.checkpoint import conformer_jax_tree, write_msgpack

    path = work / "conformer-seeded.msgpack"
    write_msgpack(path, conformer_jax_tree(seeded_conformer().state_dict()))
    os.environ["SDTK_MODEL_PATH"] = str(path)
    try:
        with tower("conformer"):
            eng = get_backend("gpu", device="cuda").engine
            phase_tower(eng, wav, "tower-conformer", win=48000)

            f32 = seeded_conformer().to("cuda")
            rng = np.random.default_rng(3)
            feats = torch.from_numpy(rng.standard_normal((1, 300, 80)).astype(np.float32))
            garbage = torch.from_numpy(50 * rng.standard_normal((1, 24, 80)).astype(np.float32))
            mask = torch.arange(324)[None] < 300
            with torch.inference_mode():
                ref = f32(feats.cuda())
                padded = f32(torch.cat([feats, garbage], dim=1).cuda(), mask.cuda())
            invariance = float((padded - ref).abs().max())

            chunk = np.stack([wav[i * 6000 : i * 6000 + 16000] for i in range(128)])
            lens = np.full(128, 16000, np.int32)
            chunk_ms = cuda_ms(lambda: eng.embed(chunk, lens), reps=10, warmup=2)
            chunk3 = np.stack([wav[i * 6000 : i * 6000 + 48000] for i in range(128)])
            chunk3_ms = cuda_ms(lambda: eng.embed(chunk3, lens * 3), reps=10, warmup=2)

            wrappers = reset_launches()
            t0 = time.perf_counter()
            rc = cli.main([str(work / "meeting.wav"), "--format", "rttm", "-q",
                           "-o", str(work / "meeting-conformer.rttm")])
            torch.cuda.synchronize()
            cli_s = time.perf_counter() - t0
            launches = read_launches(wrappers)
            source = eng.params_source
    finally:
        os.environ.pop("SDTK_MODEL_PATH", None)
    n_lines = len((work / "meeting-conformer.rttm").read_text().splitlines()) if rc == 0 else 0
    emit({"phase": "tower-conformer-path", "params": source,
          "mask_invariance_max_abs": invariance, "mask_invariance_bar": MASK_INVARIANCE_TOL,
          "ms_per_chunk_128x1s": chunk_ms, "embed_audio_s_per_s_1s": 128.0 / (chunk_ms / 1e3),
          "ms_per_chunk_128x3s": chunk3_ms,
          "embed_audio_s_per_s_3s": 3 * 128.0 / (chunk3_ms / 1e3),
          "cli_rc": rc, "cli_rttm_lines": n_lines, "cli_seconds": cli_s, "launches": launches})
    if source != str(path):
        raise AssertionError(f"tower-conformer: served {source}, not {path}")
    if not invariance <= MASK_INVARIANCE_TOL:
        raise AssertionError(f"tower-conformer: padding moved the embedding by {invariance}")
    if rc != 0 or n_lines == 0 or launches["log_mel_wave"] <= 0:
        raise AssertionError(f"tower-conformer: diarize rc {rc}, {n_lines} lines, {launches}")
    return launches


def phase_train_conformer(work: Path, device) -> dict:
    """The trainer's recipe with the full-width Conformer: one step on the
    card against the CPU from one seeded state and one synthesized batch,
    both bf16 (loss within ``TRAIN_LOSS_RTOL`` relative, all gradients
    together at cosine >= ``TRAIN_GRAD_COS``); 10 steps on that batch on
    the card (step ms by CUDA events and by the profiler, peak memory);
    then 2 steps of ``training.train(model_name="conformer")`` (K1 once a
    step), whose file loads through ``SDTK_BACKEND_TOWER=conformer``.
    Returns the ``train()`` call's launch counts."""
    import numpy as np
    import torch

    from sdtk_tpu_torch import training
    from sdtk_tpu_torch.backends.base import get_backend
    from sdtk_tpu_torch.data.batches import BatchSpec, make_batch
    from sdtk_tpu_torch.data.synth_families import family_utterance
    from sdtk_tpu_torch.ops.fbank import FrontendConfig
    from sdtk_tpu_torch.parallel.train import TrainConfig, create_train_state
    from sdtk_tpu_torch.tools.measure import cos
    from sdtk_tpu_torch.training import build_model, featurize_step

    fams = tuple(int(f) for f in TRAIN_RECIPE["families"].split(","))
    spec = BatchSpec(family_ids=fams, **{k: v for k, v in TRAIN_RECIPE.items() if k != "families"})
    wavs, cls = make_batch(np.random.default_rng(0), spec)
    cfg = TrainConfig(n_classes=spec.n_classes)
    fcfg = FrontendConfig()

    def step(state, dev):
        return featurize_step(state, wavs, cls, cfg, fcfg, dev)

    runs = []
    for dev in (device, torch.device("cpu")):
        state = create_train_state(build_model("conformer", 512, 8),
                                   torch.Generator().manual_seed(0), cfg, dev)
        m = step(state, dev)
        params = [*state.model.parameters(), state.aam_weights]
        runs.append({"loss": float(m["loss"]), "state": state,
                     "grads": [p.grad.detach().cpu() for p in params]})
    gpu, cpu = runs
    cpu_loss = cpu["loss"]
    loss_rel = abs(gpu["loss"] - cpu_loss) / abs(cpu_loss)
    grad_cos = cos(torch.cat([g.flatten() for g in gpu["grads"]]),
                   torch.cat([g.flatten() for g in cpu["grads"]]))
    state = gpu["state"]
    del runs, cpu
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    marks, losses = [], []
    for _ in range(10):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        losses.append(step(state, device)["loss"])
        b.record()
        marks.append((a, b))
    torch.cuda.synchronize()
    step_ms = [a.elapsed_time(b) for a, b in marks]
    peak = torch.cuda.max_memory_allocated()
    busy = device_ms(lambda: step(state, device), "", reps=3)

    wrappers = reset_launches()
    logs: list[str] = []
    t0 = time.perf_counter()
    tstate, out = training.train(steps=2, model_name="conformer",
                                 out_path=work / "train-conformer.msgpack", log=logs.append,
                                 device="cuda", **TRAIN_RECIPE)
    torch.cuda.synchronize()
    report = _train_report("train-conformer", tstate, logs, time.perf_counter() - t0,
                           "not measured")
    launches = read_launches(wrappers)
    os.environ["SDTK_MODEL_PATH"] = str(out)
    try:
        with tower("conformer"):
            be = get_backend("gpu", device="cuda")
            emb = be.embed_waveform(family_utterance(1, 3, 5, 3.0))
            source = be.engine.params_source
    finally:
        os.environ.pop("SDTK_MODEL_PATH", None)
    emit({**report, "batch": spec.batch, "crop_seconds": spec.crop_seconds,
          "loss_cuda": gpu["loss"], "loss_cpu": cpu_loss,
          "loss_rel_diff": loss_rel, "loss_bar": TRAIN_LOSS_RTOL, "grad_cos_all": grad_cos,
          "grad_cos_bar": TRAIN_GRAD_COS, "losses_10": [float(x) for x in losses],
          "step_ms_events": step_ms, "step_ms_median": statistics.median(step_ms[3:]),
          "step_device_busy_ms": busy, "peak_memory_bytes": peak,
          "launches": launches, "params_source": source, "embedding_dim": int(emb.shape[0])})
    if not loss_rel <= TRAIN_LOSS_RTOL:
        raise AssertionError(f"train-conformer: card loss {gpu['loss']}, {loss_rel} from the CPU")
    if not grad_cos >= TRAIN_GRAD_COS:
        raise AssertionError(f"train-conformer: gradients at cosine {grad_cos} with the CPU's")
    if launches["log_mel_wave"] != 2:
        raise AssertionError(f"train-conformer: launches {launches}, expected log_mel_wave 2")
    if source != str(out) or emb.shape != (192,) or not np.isfinite(emb).all():
        raise AssertionError(f"train-conformer: {source} gave {emb.shape}")
    return launches


# The model axis on the one card: two ranks at data=1,model=2 in a gloo
# group over CUDA tensors (NCCL takes one rank a device; gloo runs the
# all-gathers and all-reduces this phase needs on CUDA tensors, f32 and bf16).
# The sharded step against the one-card step, both bf16 with cuDNN's
# deterministic algorithms: split convolutions round each block of a
# layer's input gradient to bf16 before the model ranks sum them, so the
# loss is held to 1 %, all gradients together and every updated tensor to
# cosine 0.999, the eval forward to 0.9999 a window.  A gradient that
# bf16's own rounding dominates (attention's, saturated by the bundled
# file; some res2 biases) has no direction to agree on: each gradient is
# held to cosine 0.999 or to twice bf16's rounding there, as train-step
# holds the card against the CPU.
TP_MESH = "data=1,model=2"
TP_LOSS_RTOL = 0.01
TP_COS = 0.999
TP_EVAL_COS = 0.9999


def phase_train_tp(work: Path, device) -> dict:
    """``sdtk_tpu_torch.tools.bench_ranks``'s model-axis check at
    ``TP_MESH``: ECAPA c512 from the fam5tel file (bf16, a seeded AAM head
    over 320 classes) on one batch of the train recipe, one step split over
    two ranks against the same step on the card without a group: loss
    within ``TP_LOSS_RTOL``, all gradients together at cosine >= ``TP_COS``,
    each at ``TP_COS`` or within ``TRAIN_GRAD_NOISE_FACTOR`` times bf16's
    rounding (the one-card bf16 gradient's distance from its f32 one), every
    updated tensor at cosine >= ``TP_COS`` but attention's second bias (its
    gradient is rounding noise, ``ZERO_GRAD_PARAM``), held to AdamW's ±lr; each rank's
    parameter elements equal to the rules' count from the whole tower's
    shapes; the sharded eval forward of 8 windows of 3 s at cosine >=
    ``TP_EVAL_COS`` per window; K1 once in each rank's step and no other
    kernel.  Step ms by CUDA events and peak memory, per rank.  Returns
    rank 0's launch counts."""
    import torch

    from sdtk_tpu_torch.tools import bench_ranks

    flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        t = [time.perf_counter()]
        inputs = bench_ranks.tp_inputs(work, device)
        t.append(time.perf_counter())

        def one_card():
            out = bench_ranks.tp_reference(inputs, device)
            t.append(time.perf_counter())
            return out

        ref, ranks = bench_ranks.run_tp(inputs, work, TP_MESH, 2, "gloo", one_card)
        t.append(time.perf_counter())
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags
    row = bench_ranks.tp_compare(ref, ranks)
    grad_cos, param_cos = row.pop("grad_cos"), row.pop("param_cos")
    rounding = row.pop("grad_over_bf16_rounding")
    zero_diff = float((ranks[0]["params"][ZERO_GRAD_PARAM]
                       - ref["params"][ZERO_GRAD_PARAM]).abs().max())
    by_rounding = {n: [grad_cos[n], rounding[n]] for n in grad_cos if grad_cos[n] < TP_COS}
    low_grads = {n: v for n, v in by_rounding.items() if v[1] > TRAIN_GRAD_NOISE_FACTOR}
    low_params = {n: c for n, c in param_cos.items() if c < TP_COS and n != ZERO_GRAD_PARAM}
    emit({"phase": "train-tp", "mesh": TP_MESH, "world": 2, "backend": "gloo (CUDA tensors)",
          "wall_seconds": t[-1] - t[0], "inputs_seconds": t[1] - t[0],
          "one_card_seconds": t[2] - t[1], "ranks_after_seconds": t[3] - t[2], **row,
          "grads_by_rounding": by_rounding, "zero_grad_param": ZERO_GRAD_PARAM,
          "zero_grad_param_max_abs_diff": zero_diff, "loss_bar": TP_LOSS_RTOL, "cos_bar": TP_COS,
          "grad_rounding_bar": TRAIN_GRAD_NOISE_FACTOR, "eval_cos_bar": TP_EVAL_COS})
    if not row["loss_rel_diff"] <= TP_LOSS_RTOL:
        raise AssertionError(f"train-tp: loss {row['loss']} against {row['loss_one_card']}")
    if not row["grad_cos_all"] >= TP_COS or low_grads or low_params:
        raise AssertionError(f"train-tp: gradients at cosine {row['grad_cos_all']}, "
                             f"{low_grads} beyond bf16's rounding, parameters {low_params}")
    if not zero_diff <= 2 * 1e-3 * 1.01:
        raise AssertionError(f"train-tp: {ZERO_GRAD_PARAM} moved {zero_diff} apart")
    if row["param_elements"] != row["param_elements_by_rules"]:
        raise AssertionError(f"train-tp: parameter elements {row['param_elements']}, the rules "
                             f"give {row['param_elements_by_rules']}")
    if not row["min_eval_cos"] >= TP_EVAL_COS:
        raise AssertionError(f"train-tp: sharded eval forward at cosine {row['eval_cos']}")
    for launches in row["launches"]:
        if launches["log_mel_wave"] != 1 or any(v for k, v in launches.items()
                                                if k != "log_mel_wave"):
            raise AssertionError(f"train-tp: launches {row['launches']}, expected K1 once")
    return row["launches"][0]


def phase_conformer_sp(wav, device) -> dict:
    """``conformer_sp_embed`` in a process group of one rank on NCCL (the
    ``SDTK_*`` variables) on K1's features of the 61.3 s meeting, with the
    seeded full-width Conformer in f32, against the dense module on the
    card (f32) at rtol = atol = ``SP_TOL``: wall ms (a warm-up call, then a
    timed one) and peak memory of each; K1 held at the path's (1, N)
    shape.  Returns the path's launch counts (K1 and the forward)."""
    import numpy as np
    import torch

    from sdtk_tpu_torch.ops.fbank import FrontendConfig
    from sdtk_tpu_torch.ops.fbank_wave import log_mel_wave
    from sdtk_tpu_torch.ops.ringattn import conformer_sp_embed, time_shard
    from sdtk_tpu_torch.parallel import multihost

    model = seeded_conformer().to(device)
    x_np = np.asarray(wav, np.float32)[None]
    with one_rank_group_env():
        info = multihost.initialize(device="cuda")
        try:
            wrappers = reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            feats, mask = log_mel_wave(torch.from_numpy(x_np).to(device), FrontendConfig())
            f_loc, m_loc = time_shard(feats[0]), time_shard(mask[0])
            emb = conformer_sp_embed(model, f_loc, m_loc)
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            launches = read_launches(wrappers)
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            emb = conformer_sp_embed(model, f_loc, m_loc)
            torch.cuda.synchronize()
            sp_ms = (time.perf_counter() - t0) * 1e3
            sp_peak = torch.cuda.max_memory_allocated()
        finally:
            multihost.shutdown()
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        dense = model(feats, mask)[0]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dense = model(feats, mask)[0]
        torch.cuda.synchronize()
    dense_ms = (time.perf_counter() - t0) * 1e3
    dense_peak = torch.cuda.max_memory_allocated()
    err = float((emb - dense).abs().max())
    close = bool(torch.allclose(emb, dense, rtol=SP_TOL, atol=SP_TOL))
    k1_row = k1_case("bf16-ln", FrontendConfig(), x_np, np.array([x_np.shape[1]], np.int64),
                     device, config="conformer-sp path")
    emit({"phase": "conformer-sp", "group": info, "frames": int(feats.shape[1]),
          "audio_seconds": x_np.shape[1] / 16000, "first_call_seconds": first_s,
          "sp_wall_ms": sp_ms, "sp_peak_memory_bytes": sp_peak, "dense_wall_ms": dense_ms,
          "dense_peak_memory_bytes": dense_peak, "max_abs_diff": err, "tol": SP_TOL,
          "finite": bool(torch.isfinite(emb).all()), "k1_shape": k1_row["shape"],
          "k1_max_abs_err": k1_row["max_abs_err"], "launches": launches})
    if not close or not torch.isfinite(emb).all():
        raise AssertionError(f"conformer-sp: sequence-parallel vs dense max|d| {err}")
    if launches["log_mel_wave"] != 1:
        raise AssertionError(f"conformer-sp: launches {launches}, expected log_mel_wave 1")
    return launches


# The host library (csrc/host: the WAV reader and resampler, the threaded
# loader, BLAKE3) on the card's machine.  The hour as 16-bit mono WAV is
# 57 600 000 samples of 2 bytes: the size of the file hashed.
HOUR_WAV_BYTES = 2 * LONGFORM_SAMPLES + 44
NATIVE_RATES = {"wav44k": (44100, 1, 16), "wav48k": (48000, 1, 16), "wav22k-24bit-stereo":
                (22050, 2, 24)}


def write_pcm_wav(path: Path, x, sr: int, bits: int) -> None:
    """(frames, channels) float in [-1, 1] as 16- or 24-bit PCM WAV."""
    import struct

    import numpy as np

    ch = x.shape[1]
    v = np.round(np.clip(x, -1.0, 1.0) * ((1 << (bits - 1)) - 1)).astype("<i4")
    payload = (v.astype("<i2").tobytes() if bits == 16
               else v.reshape(-1, 1).view(np.uint8).reshape(-1, 4)[:, :3].tobytes())
    block = ch * bits // 8
    body = (b"WAVE" + b"fmt " + struct.pack("<IHHIIHH", 16, 1, ch, sr, sr * block, block, bits)
            + b"data" + struct.pack("<I", len(payload)) + payload)
    path.write_bytes(b"RIFF" + struct.pack("<I", len(body)) + body)


def phase_native(work: Path, wav, ref, device: str) -> dict:
    """The host library built by ``g++`` from ``csrc/host`` and loaded; the
    phase-5 meeting written as 16-bit WAV at 44.1 and 48 kHz and as 24-bit
    stereo at 22.05 kHz, each read by the C++ reader (``_load_audio_native``
    returns samples; max|d| against the SciPy path printed, no bar: the two
    are different filters) and diarized through ``cli.diarize``: 3 speakers,
    DER <= DER_BAR, K1 launched; ``load_audio_batch`` of the three equal to
    ``load_audio`` of each, bit for bit; BLAKE3 of a file of the hour's
    size natively and in NumPy, the same digest, seconds of each.  Returns
    the launch counts of the three diarize calls."""
    import numpy as np
    from scipy.signal import resample_poly

    from sdtk_tpu_torch.cli import diarize as cli
    from sdtk_tpu_torch.cluster.der import diarization_error_rate
    from sdtk_tpu_torch.utils import audio, build, hashing, nativelib

    start = time.perf_counter()
    d = work / "native"
    d.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    lib = nativelib.get_lib()
    load_s = time.perf_counter() - t0
    if lib is None:
        raise AssertionError("native: the host library did not load")
    files = {}
    for kind, (sr, ch, bits) in NATIVE_RATES.items():
        g = math.gcd(sr, 16000)
        x = resample_poly(wav.astype(np.float64), sr // g, 16000 // g)
        cols = np.stack([x, 0.8 * x], axis=1) if ch == 2 else x[:, None]
        files[kind] = d / f"meeting-{kind}.wav"
        write_pcm_wav(files[kind], cols, sr, bits)

    rows, total = {}, {}
    with recorded_diarize() as results:
        for kind, path in files.items():
            t0 = time.perf_counter()
            native = audio._load_audio_native(path, 16000)
            native_s = time.perf_counter() - t0
            if native is None:
                raise AssertionError(f"native: the C++ reader returned nothing for {path.name}")
            t0 = time.perf_counter()
            x, sr = audio._decode_wav(path)
            python = audio.resample(x.mean(axis=1), sr, 16000)
            python_s = time.perf_counter() - t0
            wrappers = reset_launches()
            t0 = time.perf_counter()
            rc = cli.main([str(path), "--format", "json", "-q", "--device", device,
                           "-o", str(d / f"{kind}.json")])
            wall = time.perf_counter() - t0
            launches = read_launches(wrappers)
            if rc != 0:
                raise AssertionError(f"native: the CLI returned {rc} on {path.name}")
            der = diarization_error_rate(ref, results[-1]["segments"], collar=0.75)
            n = min(len(native[0]), len(python))
            rows[kind] = {"rate": sr, "bytes": path.stat().st_size, "samples": len(native[0]),
                          "python_samples": len(python),
                          "max_abs_diff_vs_scipy": float(np.abs(native[0][:n] - python[:n]).max()),
                          "native_decode_seconds": native_s, "python_decode_seconds": python_s,
                          "n_speakers": results[-1]["n_speakers"], "der_c075": der["der"],
                          "seconds": wall, "launches": launches}
            total = {k: total.get(k, 0) + v for k, v in launches.items()}
    paths = list(files.values())
    t0 = time.perf_counter()
    batch = audio.load_audio_batch(paths)
    batch_s = time.perf_counter() - t0
    batch_same = all(b.shape == w.shape and bool((b == w).all())
                     for b, w in zip(batch, (audio.load_audio(p)[0] for p in paths)))

    blob = d / "hour-sized.bin"
    blob.write_bytes(np.random.default_rng(15).integers(0, 256, HOUR_WAV_BYTES, np.uint8).tobytes())
    data = blob.read_bytes()
    t0 = time.perf_counter()
    native_digest = hashing.compute_b3sum_full(blob)
    native_hash_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    numpy_digest = hashing.blake3_numpy(data).hex()
    numpy_hash_s = time.perf_counter() - t0
    emit({"phase": "native", "host_library": build.host_library_path().name,
          "library_load_seconds": load_s, "files": rows, "load_audio_batch_equal": batch_same,
          "load_audio_batch_seconds": batch_s, "der_bar": DER_BAR,
          "blake3": {"bytes": len(data), "native_seconds": native_hash_s,
                     "numpy_seconds": numpy_hash_s, "same_digest": native_digest == numpy_digest},
          "seconds": time.perf_counter() - start})
    blob.unlink()
    for kind, row in rows.items():
        if row["n_speakers"] != 3 or not row["der_c075"] <= DER_BAR:
            raise AssertionError(f"native: {kind} gave {row['n_speakers']} speakers, "
                                 f"DER {row['der_c075']} (bar {DER_BAR})")
        if row["launches"]["log_mel_wave"] <= 0:
            raise AssertionError(f"native: log_mel_wave was not launched on the {kind}")
    if not batch_same:
        raise AssertionError("native: load_audio_batch differs from load_audio")
    if native_digest != numpy_digest:
        raise AssertionError(f"native: BLAKE3 {native_digest} natively, {numpy_digest} in NumPy")
    return total


# A child process that diarizes the meeting twice with SDTK_PROFILE=1 and
# profiles only the second (warm) call; the report goes to its stderr at exit.
PROFILE_CHILD = r"""
import json, sys, time
import torch
from sdtk_tpu_torch.pipeline.diarize import Diarizer
from sdtk_tpu_torch.utils import profiling
from sdtk_tpu_torch.utils.audio import load_audio
wav = load_audio(sys.argv[1])[0]
d = Diarizer(device=sys.argv[2])
d.diarize_waveform(wav)
profiling.reset()
t0 = time.perf_counter()
r = d.diarize_waveform(wav)
if d.device.type == "cuda":
    torch.cuda.synchronize()
print(json.dumps({"n_speakers": r["n_speakers"], "wall_seconds": time.perf_counter() - t0}))
"""
DIARIZE_STAGES = ("diarize.vad", "diarize.denoise", "diarize.embed", "diarize.cluster",
                  "diarize.resegment")


def phase_profile(work: Path, diarizer, wav, device: str) -> dict:
    """``SDTK_PROFILE=1``: one warm diarize of the meeting in a child
    process, whose stderr report must list the five ``diarize.*`` stages
    once each; then one diarize inside ``profiling.trace(dir)`` here: the
    trace file written, and K1's kernel (``log_mel_*``, the waveform
    source) among its CUDA kernel events.  Returns the traced call's launch
    counts."""
    from sdtk_tpu_torch.utils import profiling

    start = time.perf_counter()
    d = work / "profile"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    env = {**os.environ, "SDTK_PROFILE": "1", "PYTHONPATH": str(ROOT)}
    env.pop("SDTK_TRACE_DIR", None)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", PROFILE_CHILD, str(work / "meeting.wav"), device],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    child_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"profile: the child exited {proc.returncode}:\n{proc.stderr[-3000:]}")
    child = json.loads(proc.stdout.strip().splitlines()[-1])
    report = proc.stderr[proc.stderr.find("── sdtk profile ──"):].splitlines()[1:]
    stages = {}
    for line in report:
        parts = line.split()
        if len(parts) >= 3 and parts[1].endswith("s") and parts[2].startswith("("):
            stages[parts[0]] = {"seconds": float(parts[1][:-1]),
                                "count": int(parts[2].strip("(x,"))}

    wrappers = reset_launches()
    t0 = time.perf_counter()
    with profiling.trace(str(d / "trace")):
        diarizer.diarize_waveform(wav)
    trace_s = time.perf_counter() - t0
    launches = read_launches(wrappers)
    files = sorted((d / "trace").glob("*.pt.trace.json"))
    events = json.loads(files[0].read_text())["traceEvents"] if files else []
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    k1 = sorted({n for n in kernels if "log_mel_" in n and "FrameRows" not in n})
    emit({"phase": "profile", "child_seconds": child_s, "child": child, "stages": stages,
          "report": report, "trace_file": files[0].name if files else None,
          "trace_bytes": files[0].stat().st_size if files else 0, "trace_seconds": trace_s,
          "trace_kernel_events": len(kernels), "k1_events": sum(n in k1 for n in kernels),
          "k1_names": k1[:3], "launches": launches, "seconds": time.perf_counter() - start})
    missing = [s for s in DIARIZE_STAGES if stages.get(s, {}).get("count") != 1]
    if missing:
        raise AssertionError(f"profile: stages {missing} not reported once: {report}")
    if not files or not k1:
        raise AssertionError(f"profile: no trace, or no K1 kernel among its {len(kernels)} "
                             f"kernel events")
    if launches["log_mel_wave"] <= 0:
        raise AssertionError("profile: log_mel_wave was not launched in the traced call")
    return launches


def phase_evals(work: Path, device: str) -> dict:
    """The eval scripts on the card: ``evals.identify --backend gpu`` at 4
    speakers, case by case the identified speakers equal to the same cases
    run on the CPU (K1 launched on the card; 4 profiles are scored on the
    host, below the cosine kernel's 2**24 products); ``evals.streaming
    --der --heldout`` (exit 0, its DER recorded, K1 launched);
    ``evals.warmup`` in a child process (exit 0, every kernel's library and
    the host library under ``_build`` afterwards).  Seconds of each.
    Returns the launch counts of identify and streaming."""
    from sdtk_tpu_torch.evals import identify, streaming
    from sdtk_tpu_torch.utils import build

    start = time.perf_counter()
    d = work / "evals"
    d.mkdir(parents=True, exist_ok=True)
    seconds, cases = {}, {}
    wrappers = reset_launches()
    for dev in (device, "cpu"):
        t0 = time.perf_counter()
        out = run_json(identify, ["--backend", "gpu", "--speakers", "4", "--device", dev,
                                  "--cases", str(d / f"cases-{dev}.json")])
        seconds[f"identify_{dev}"] = time.perf_counter() - t0
        cases[dev] = json.loads((d / f"cases-{dev}.json").read_text())
        if dev == device:
            id_launches, id_out = read_launches(wrappers), out
    differ = [(a["case"], a["identified"], b["identified"])
              for a, b in zip(cases[device], cases["cpu"])
              if a["case"] != b["case"] or set(a["identified"]) != set(b["identified"])]
    low = min((s for c in cases[device] for s in c["scores"][: len(c["expected"])]), default=0.0)

    wrappers = reset_launches()
    t0 = time.perf_counter()
    st = run_json(streaming, ["--backend", "gpu", "--device", device, "--der", "--heldout"])
    seconds["streaming_der"] = time.perf_counter() - t0
    st_launches = read_launches(wrappers)

    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "sdtk_tpu_torch.evals.warmup",
                           "--device", device], cwd=ROOT,
                          env={**os.environ, "PYTHONPATH": str(ROOT)}, capture_output=True,
                          text=True, timeout=600)
    seconds["warmup"] = time.perf_counter() - t0
    warm = [json.loads(ln) for ln in proc.stdout.splitlines() if ln.startswith("{")]
    libs = {n: build.library_path(n).exists() for n in build.kernel_names() if device == "cuda"}
    libs["host"] = build.host_library_path().exists()
    emit({"phase": "evals", "identify": id_out, "identify_cases": len(cases[device]),
          "identify_cases_differing": differ, "identify_lowest_expected_score": low,
          "identify_launches": id_launches, "streaming": st, "streaming_launches": st_launches,
          "warmup_rc": proc.returncode, "warmup": warm, "libraries_present": libs,
          "seconds": seconds, "wall_seconds": time.perf_counter() - start})
    if differ or len(cases[device]) != len(cases["cpu"]):
        raise AssertionError(f"evals: identify on the card differs from the CPU: {differ}")
    if id_launches["log_mel_wave"] <= 0:
        raise AssertionError(f"evals: identify launched {id_launches}, expected K1")
    if st_launches["log_mel_wave"] <= 0:
        raise AssertionError("evals: streaming did not launch log_mel_wave")
    if proc.returncode != 0:
        raise AssertionError(f"evals: warmup exited {proc.returncode}:\n{proc.stderr[-3000:]}")
    if not all(libs.values()):
        raise AssertionError(f"evals: libraries missing under _build after warmup: {libs}")
    return {k: id_launches[k] + st_launches[k] for k in id_launches}


SB_SEED = 16  # the seeded SpeechBrain checkpoint of phase speechbrain
# spkrec-ecapa-voxceleb: (channels, Res2 scale, SE bottleneck, attention, MFA, emb, n_mels)
SB_SHAPE = (1024, 8, 128, 128, 3072, 192, 80)
SB_DILATIONS = (2, 3, 4)
SB_VERIFY_COS = 0.9999  # the converter's --verify: f32 tower on the card vs f64 reference
SB_IDENTIFY_N = 2048
# 72 s queries: 47 windows of 3 s, so the dense route's 47 x 2 048 x 192
# products pass the 2**24 below which identify scores on the host
SB_QUERY_S = 72.0
SB_HYPERPARAMS = """\
# ############################################################################
# Model: ECAPA big for Speaker verification (spkrec-ecapa-voxceleb layout)
# ############################################################################

n_mels: 80

pretrained_path: speechbrain/spkrec-ecapa-voxceleb

compute_features: !new:speechbrain.lobes.features.Fbank
    n_mels: !ref <n_mels>

mean_var_norm: !new:speechbrain.processing.features.InputNormalization
    norm_type: sentence
    std_norm: False

embedding_model: !new:speechbrain.lobes.models.ECAPA_TDNN.ECAPA_TDNN
    input_size: !ref <n_mels>
    channels: [1024, 1024, 1024, 1024, 3072]
    kernel_sizes: [5, 3, 3, 3, 1]
    dilations: [1, 2, 3, 4, 1]
    attention_channels: 128
    lin_neurons: 192

mean_var_norm_emb: !new:speechbrain.processing.features.InputNormalization
    norm_type: global
    std_norm: False
"""


def speechbrain_state_dict(seed: int) -> dict:
    """A SpeechBrain ECAPA state dict at the published shapes (20.8 M
    parameters), its weights drawn with std 1/sqrt(fan_in), the scale of
    trained weights, and BatchNorm statistics near the identity.
    ``tests/test_convert.py``'s 0.2·randn grows activations by
    ~0.2·sqrt(fan_in) a layer, ~6x at C = 1024 and more through the
    3 072-wide layers: the bf16 tower would part from f32 for that alone,
    and the comparison would measure nothing."""
    import torch

    c, scale, se, attn, mfa, emb, n_mels = SB_SHAPE
    g = torch.Generator().manual_seed(seed)

    def conv(prefix, o, i, k):
        return {f"{prefix}.weight": torch.randn(o, i, k, generator=g) / math.sqrt(i * k),
                f"{prefix}.bias": 0.05 * torch.randn(o, generator=g)}

    def bn(prefix, n):
        return {f"{prefix}.weight": 1.0 + 0.1 * torch.randn(n, generator=g),
                f"{prefix}.bias": 0.1 * torch.randn(n, generator=g),
                f"{prefix}.running_mean": 0.1 * torch.randn(n, generator=g),
                f"{prefix}.running_var": 1.0 + 0.1 * torch.rand(n, generator=g),
                f"{prefix}.num_batches_tracked": torch.tensor(100_000)}

    sd = conv("blocks.0.conv.conv", c, n_mels, 5) | bn("blocks.0.norm.norm", c)
    width = c // scale
    for i in range(1, len(SB_DILATIONS) + 1):
        p = f"blocks.{i}"
        sd |= conv(f"{p}.tdnn1.conv.conv", c, c, 1) | bn(f"{p}.tdnn1.norm.norm", c)
        for j in range(scale - 1):
            sd |= conv(f"{p}.res2net_block.blocks.{j}.conv.conv", width, width, 3)
            sd |= bn(f"{p}.res2net_block.blocks.{j}.norm.norm", width)
        sd |= conv(f"{p}.tdnn2.conv.conv", c, c, 1) | bn(f"{p}.tdnn2.norm.norm", c)
        sd |= conv(f"{p}.se_block.conv1.conv", se, c, 1)
        sd |= conv(f"{p}.se_block.conv2.conv", c, se, 1)
    sd |= conv("mfa.conv.conv", mfa, len(SB_DILATIONS) * c, 1) | bn("mfa.norm.norm", mfa)
    sd |= conv("asp.tdnn.conv.conv", attn, 3 * mfa, 1) | bn("asp.tdnn.norm.norm", attn)
    sd |= conv("asp.conv.conv", mfa, attn, 1) | bn("asp_bn.norm", 2 * mfa)
    return sd | conv("fc.conv", emb, 2 * mfa, 1)


def phase_speechbrain(work: Path, wav, c512_engine) -> dict:
    """The SpeechBrain ECAPA path at the published width: a seeded
    checkpoint directory in the spkrec-ecapa-voxceleb layout (sentence input
    norm, embedding-norm stats, classifier files to ignore) converted by
    ``python -m sdtk_tpu_torch.tools.convert_ecapa --verify`` in a child
    process on the meeting WAV (the f32 tower on the card against the f64
    reference, cosine >= SB_VERIFY_COS); K1 at SpeechBrain's frontend (n_fft
    400, Hamming, centered, dB, 0 Hz) against its plain version at
    (128, 16 000) and (32, 48 000); then, with ``SDTK_MODEL_PATH`` on the
    converted file: the engine's sidecar read (tower and frontend), the
    tower against f32 on the CPU (``phase_tower``), ms per 128 x 1 s chunk
    by events beside the c512 engine's on the same device-resident input,
    peak memory, the share of the bf16 peak by the probe's FLOP count,
    ``cli.diarize`` on the meeting (rc 0, an RTTM, K1 launched; random
    weights, so no DER bar) and identify at N = 2 048 on both routes
    (raw scores within SCORE_TOL, K2 and K3 launched).  Returns the launch
    counts of the diarize and identify calls."""
    import numpy as np
    import torch

    from sdtk_tpu_torch.backends.base import get_backend
    from sdtk_tpu_torch.cli import diarize as cli
    from sdtk_tpu_torch.evals.mfu_probe import PEAK_FLOPS, ecapa_flops_per_window
    from sdtk_tpu_torch.ops.fbank import FrontendConfig
    from sdtk_tpu_torch.tools.measure import event_ms

    start = time.perf_counter()
    d = work / "spkrec-ecapa-voxceleb"
    d.mkdir(parents=True, exist_ok=True)
    (d / "hyperparams.yaml").write_text(SB_HYPERPARAMS)
    torch.save(speechbrain_state_dict(SB_SEED), d / "embedding_model.ckpt")
    g = torch.Generator().manual_seed(SB_SEED + 1)
    torch.save({"count": 1000, "glob_mean": 0.1 * torch.randn(SB_SHAPE[5], generator=g)},
               d / "mean_var_norm_emb.ckpt")
    torch.save({"weight": torch.zeros(4, SB_SHAPE[5])}, d / "classifier.ckpt")
    (d / "label_encoder.txt").write_text("'spk1' => 0\n")
    out = work / "ecapatdnn-speechbrain.msgpack"
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "sdtk_tpu_torch.tools.convert_ecapa", str(d),
                           "-o", str(out), "--verify", str(work / "meeting.wav")], cwd=ROOT,
                          env={**os.environ, "PYTHONPATH": str(ROOT)}, capture_output=True,
                          text=True, timeout=600)
    convert_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"convert_ecapa exited {proc.returncode}:\n{proc.stderr[-3000:]}")
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    sidecar = json.loads(out.with_suffix(".config.json").read_text())

    cfg = FrontendConfig(**sidecar["frontend"])
    k1 = {f"{b}x{n}": k1_case("bf16-speechbrain", cfg, *speechlike_batch(b, n, seed=b + 16),
                              "cuda")
          for b, n in ((128, 16000), (32, 48000))}

    os.environ["SDTK_MODEL_PATH"] = str(out)
    try:
        with tower("ecapa"):
            eng = get_backend("gpu", device="cuda").engine
            phase_tower(eng, wav, "tower-speechbrain")
            chunk = torch.from_numpy(
                np.stack([wav[i * 6000 : i * 6000 + 16000] for i in range(128)])).cuda()
            lens = torch.full((128,), 16000, device="cuda")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            chunk_ms = event_ms(lambda: eng.embed(chunk, lens), reps=10, warmup=2)
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            c512_ms = event_ms(lambda: c512_engine.embed(chunk, lens), reps=10, warmup=2)
            flops = 128 * ecapa_flops_per_window(eng.model.cfg, cfg.num_frames(16000))

            wrappers = reset_launches()
            t0 = time.perf_counter()
            rc = cli.main([str(work / "meeting.wav"), "--format", "rttm", "-q",
                           "-o", str(work / "meeting-speechbrain.rttm")])
            diarize_s = time.perf_counter() - t0
            cli_launches = read_launches(wrappers)
            rttm = (work / "meeting-speechbrain.rttm").read_text().splitlines()
            id_launches = phase_identify(d, "cuda", "identify-speechbrain", SB_IDENTIFY_N,
                                         named=False, query_s=SB_QUERY_S)
    finally:
        os.environ.pop("SDTK_MODEL_PATH", None)
    mcfg = eng.model.cfg
    emit({"phase": "speechbrain", "source_params": report["source_params"],
          "model": report["model"], "frontend": sidecar["frontend"],
          "directory_extras": report.get("directory_extras"), "verify": report["verify"],
          "verify_bar": SB_VERIFY_COS, "convert_seconds": convert_s,
          "k1": {k: {key: v[key] for key in ("max_abs_err", "ms", "device_ms", "plain_ms",
                                             "library_ms", "bound_ms", "bound_by")}
                 for k, v in k1.items()},
          "engine": {"params": eng.params_source, "channels": mcfg.channels,
                     "mfa_channels": mcfg.mfa_channels, "mfa_bn": mcfg.mfa_bn,
                     "asp_tdnn": mcfg.asp_tdnn, "window": eng.cfg.window, "n_fft": eng.cfg.n_fft},
          "chunk": [128, 16000], "frames": cfg.num_frames(16000), "ms_per_chunk": chunk_ms,
          "c512_ms_per_chunk": c512_ms, "peak_memory_gb": peak_gb, "tower_flops": flops,
          "tower_bound_ms": flops / PEAK_FLOPS * 1e3, "mfu": flops / (chunk_ms / 1e3) / PEAK_FLOPS,
          "diarize_rc": rc, "diarize_seconds": diarize_s, "rttm_lines": len(rttm),
          "rttm_speakers": len({ln.split()[7] for ln in rttm}), "diarize_launches": cli_launches,
          "wall_seconds": time.perf_counter() - start})
    if report["verify"]["cosine_similarity"] < SB_VERIFY_COS or report["verify"]["device"] != "cuda":
        raise AssertionError(f"speechbrain: --verify {report['verify']}")
    if (eng.cfg.window, eng.cfg.n_fft, mcfg.channels, mcfg.mfa_channels) != ("hamming", 400,
                                                                             1024, 3072):
        raise AssertionError(f"speechbrain: the engine did not take the sidecar: {eng.cfg} {mcfg}")
    if rc != 0 or not rttm or cli_launches["log_mel_wave"] <= 0:
        raise AssertionError(f"speechbrain: diarize rc {rc}, {len(rttm)} RTTM lines, "
                             f"launches {cli_launches}")
    return {k: cli_launches[k] + id_launches[k] for k in cli_launches}


MFU_ARGS = ["--stages", "frontend,tower,full", "--batches", "1024", "--iters", "10"]


def phase_mfu() -> dict:
    """``python -m sdtk_tpu_torch.evals.mfu_probe`` in a child process, cut
    from the JAX script's batches 512, 1024 and 2048 to 1024 (the time
    limit): each stage's ms, audio-s per s and share of the bf16 peak, which
    must lie in (0, 1].  Returns the child's launch counts."""
    start = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "sdtk_tpu_torch.evals.mfu_probe", *MFU_ARGS],
                          cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT)},
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"mfu_probe exited {proc.returncode}:\n{proc.stderr[-3000:]}")
    last = json.loads(proc.stdout.strip().splitlines()[-1])
    emit({"phase": "mfu", "args": MFU_ARGS, "rows": last["rows"], "device": last["device"],
          "peak_flops": last["peak_flops"], "launches": last["launches"],
          "wall_seconds": time.perf_counter() - start})
    bad = [r for r in last["rows"] if not (isinstance(r["mfu"], float) and 0 < r["mfu"] <= 1)]
    if bad or len(last["rows"]) != 3:
        raise AssertionError(f"mfu: rows out of (0, 1]: {bad or last['rows']}")
    if last["launches"]["log_mel_wave"] <= 0:
        raise AssertionError("mfu: the probe did not launch log_mel_wave")
    return last["launches"]


SCALING_ARGS = {"per_device_batch": 1024, "seconds": 3.0, "iters": 3, "channels": 512}
TOPK_SCALE_N = (100_000, 1_000_000)  # the JAX script's catalog sizes, W 64, D 192, k 64
FRONTEND_ARGS = ["--batch", "1024", "--seconds", "3", "--iters", "20"]
DECODE_ARGS = ["--files", "16", "--seconds", "30", "--thread-sweep"]


def run_main(main_fn, argv: list[str]) -> tuple[int, dict]:
    """``main_fn(argv)`` in this process: its exit code and the JSON object
    of its last line of output."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main_fn(argv)
    return rc, json.loads(out.getvalue().strip().splitlines()[-1])


def phase_scaling() -> dict:
    """``evals.benchmark_scaling`` on one rank in an NCCL group (a spawned
    process on this card) at full width: ECAPA c512 (seeded), 1024 rows of
    3 s a step, 3 steps chained, after one warm-up step.  The rank sets
    every launch count to 0 after its warm-up and reads them after its
    timed steps: K1 once a step.  Returns the rank's launch counts."""
    from sdtk_tpu_torch.evals import benchmark_scaling as bs

    t0 = time.perf_counter()
    summary = bs.measure([1], device="cuda", emit=lambda line: None, **SCALING_ARGS)
    row, rank = summary["summary"][0], summary["ranks"]["1"][0]
    emit({"phase": "scaling", **SCALING_ARGS, **row, "rank": rank,
          "wall_seconds": time.perf_counter() - t0})
    if not row["throughput_audio_s_per_s"] > 0:
        raise AssertionError(f"scaling: throughput {row}")
    if rank["launches"]["log_mel_wave"] != SCALING_ARGS["iters"]:
        raise AssertionError(f"scaling: K1 launched {rank['launches']} in "
                             f"{SCALING_ARGS['iters']} steps")
    return rank["launches"]


def phase_topk_scale(device) -> dict:
    """``evals.benchmark_topk`` at its defaults through its ``main``: K2 on
    bf16 profiles at N = 100 000 and 1 000 000 (W 64, D 192, k 64) against
    the library decomposition, its hard gate (survivor sets equal, scores
    within 5e-2) passed; then K2 held against its plain version on the
    same inputs at both N (survivors equal, scores within SCORE_TOL).
    Returns the launch counts of the ``main`` call."""
    import numpy as np
    import torch

    from sdtk_tpu_torch.evals import benchmark_topk as bt
    from sdtk_tpu_torch.ops import topk, topk_fused

    t0 = time.perf_counter()
    wrappers = reset_launches()
    rc, line = run_main(bt.main, ["--device", "cuda"])
    launches = read_launches(wrappers)
    rng = np.random.default_rng(0)  # the script's inputs: queries, then each N's rows
    q = torch.from_numpy(rng.standard_normal((64, D)).astype(np.float32)).to(device)
    held = {}
    for n in TOPK_SCALE_N:
        p, _ = bt.profiles(rng, n, D, device)
        s, i = topk_fused.identify_topk_cuda(q, p, 64)
        ws, wi = topk.identify_topk_plain(q, p, 64)
        torch.cuda.synchronize()
        held[str(n)] = {"survivors_equal": set(i.tolist()) == set(wi.tolist()),
                        "max_abs_err": float((s - ws).abs().max()), "tol": SCORE_TOL}
        del p
    emit({"phase": "topk-scale", **line, "rc": rc, "kernel_vs_plain": held,
          "launches": launches, "wall_seconds": time.perf_counter() - t0})
    if rc != 0 or not line["parity_ok"] or set(line["sizes"]) != {str(n) for n in TOPK_SCALE_N}:
        raise AssertionError(f"topk-scale: the gate failed (rc {rc}): {line['sizes']}")
    bad = {n: h for n, h in held.items() if not (h["survivors_equal"]
                                                 and h["max_abs_err"] <= SCORE_TOL)}
    if bad:
        raise AssertionError(f"topk-scale: K2 vs plain {bad}")
    if launches["identify_topk"] <= 0:
        raise AssertionError(f"topk-scale: K2 was not launched: {launches}")
    return launches


def phase_frontend(device) -> tuple[dict, dict]:
    """``evals.benchmark_frontend`` at (1024, 48 000) through its ``main``:
    the plain log-mel, K4 on the (305 152, 400) frames ``unfold`` writes
    out, and K1, 20 chained calls each, both spot checks within 0.05; K4
    launched at least once.  Then K4 against its plain version on that
    path's frames (M = 305 152) at ``TOL["bf16-ln"]``, with its times and
    bound.  Returns the launch counts of the ``main`` call and K4's row."""
    import numpy as np
    import torch

    from sdtk_tpu_torch.evals import benchmark_frontend as bf
    from sdtk_tpu_torch.ops import fbank
    from sdtk_tpu_torch.ops.fbank import FrontendConfig

    t0 = time.perf_counter()
    wrappers = reset_launches()
    rc, line = run_main(bf.main, [*FRONTEND_ARGS, "--device", "cuda"])
    launches = read_launches(wrappers)
    emit({"phase": "frontend", **line, "rc": rc, "launches": launches,
          "wall_seconds": time.perf_counter() - t0})
    if rc != 0 or launches["fbank_frames"] < 1 or launches["log_mel_wave"] < 1:
        raise AssertionError(f"frontend: rc {rc}, launches {launches}, {line}")

    cfg = FrontendConfig()
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((1024, 48000)).astype(
        np.float32)).to(device)  # the script's batch
    frames = fbank.preemphasize(x, cfg.preemphasis).unfold(
        1, cfg.win_length, cfg.hop_length).reshape(-1, cfg.win_length)
    del x
    if frames.shape[0] != 1024 * 298:
        raise AssertionError(f"frontend: {frames.shape[0]} frames, expected 305 152")
    row = k4_case(frames, "bf16-ln", "frontend path", reps=10)
    return launches, row


def phase_decode_sweep() -> dict:
    """``evals.benchmark_decode`` through its ``main``: 16 WAVs of 30 s at
    44.1 kHz decoded and resampled to 16 kHz by the C++ loader with one
    thread a core and at 1, 2, 4 and every core, and by the NumPy path;
    the per-core rate and the core scaling that the scaling roofline
    takes.  No kernel runs.  Returns the launch counts (all 0)."""
    from sdtk_tpu_torch.evals import benchmark_decode as bd

    t0 = time.perf_counter()
    wrappers = reset_launches()
    rc, line = run_main(bd.main, [*DECODE_ARGS, "--device", "cuda"])
    launches = read_launches(wrappers)
    emit({"phase": "decode-sweep", **line, "rc": rc, "cores": os.cpu_count(),
          "launches": launches, "wall_seconds": time.perf_counter() - t0})
    if rc != 0 or not line.get("per_core_audio_s_per_s", 0) > 0 or not (
            line.get("core_scaling_efficiency", 0) > 0):
        raise AssertionError(f"decode-sweep: rc {rc}, {line}")
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
    kernels_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host_library = build.build_host()
    emit({"phase": "build", "seconds": kernels_s, "kernels": sorted(logs),
          "host_library": host_library.name, "host_library_seconds": time.perf_counter() - t0,
          "ptxas": {k: [ln.strip() for ln in v.splitlines() if "Used" in ln or "spill" in ln]
                    for k, v in logs.items()},
          "tensor_core_instructions": mma_counts()})

    kernel_rows = [phase_kernel(device), phase_kernel_cosine(device), phase_kernel_topk(device),
                   phase_kernel_epilogue(device)]
    phase_kernel_frames(device)  # K4's row in the kernels line is its path's (phase frontend)

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
    path_launches["assign"] = phase_assign(out_dir, "cuda")
    path_launches["process"] = phase_process(out_dir, "cuda")
    phase_train_step(device)
    path_launches["train"] = phase_train(out_dir)
    path_launches["train-xvector"] = phase_train_xvector(out_dir)
    path_launches["longform"] = phase_longform(out_dir, ref)
    path_launches["train-ddp"] = phase_train_ddp(out_dir)
    path_launches["heldout-eer"] = phase_heldout_eer(device)
    path_launches["calibrate"] = phase_calibrate(out_dir, device)
    path_launches["heldout-der"] = phase_heldout_der()
    path_launches["decode"] = phase_decode(out_dir, ref)
    path_launches["train-vad-step"], vad_step_device_ms = phase_train_vad_step(device)
    path_launches["train-vad"] = phase_train_vad(out_dir, wav, vad_step_device_ms)
    path_launches["shell"] = phase_shell(out_dir, "cuda")
    path_launches["tower-conformer"] = phase_tower_conformer(out_dir, wav)
    path_launches["train-conformer"] = phase_train_conformer(out_dir, device)
    path_launches["conformer-sp"] = phase_conformer_sp(wav, device)
    path_launches["train-tp"] = phase_train_tp(out_dir, device)
    path_launches["native"] = phase_native(out_dir, wav, ref, "cuda")
    path_launches["profile"] = phase_profile(out_dir, diarizer, wav, "cuda")
    path_launches["evals"] = phase_evals(out_dir, "cuda")
    path_launches["speechbrain"] = phase_speechbrain(out_dir, wav, diarizer.backend.engine)
    path_launches["mfu"] = phase_mfu()
    path_launches["scaling"] = phase_scaling()
    path_launches["topk-scale"] = phase_topk_scale(device)
    path_launches["frontend"], k4_path_row = phase_frontend(device)
    kernel_rows.append(summary("fbank_frames", "fbank_frames.cu",
                               "sdtk_tpu/ops/research/fbank_frames.py:24", k4_path_row, "frontend"))
    path_launches["decode-sweep"] = phase_decode_sweep()

    for row in kernel_rows:
        if row["path"] is not None:
            row["launches"] = path_launches[row["path"]][row["name"]]
        row["launches_by_path"] = {p: counts[row["name"]] for p, counts in path_launches.items()}
    check_epilogue_paths(path_launches)
    emit({"kernels": kernel_rows})
    print(smi_line, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
