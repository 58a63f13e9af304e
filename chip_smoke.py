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
             and library times (CUDA events, median of 30 launches after
             warm-up, L2 warm) and the bound from this run's inputs;
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

then the ``kernels`` line, the card's name and power limit as
``nvidia-smi`` prints them, and ``{"ok": true, "device": {...}}`` last.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM data-sheet peaks (dense): bf16 tensor cores, f32 CUDA cores, HBM3.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12

# Kernel vs plain, same inputs and compute dtype.  Both sum exact products
# in f32 but in another order, so power values differ by a few f32 ulps;
# where that flips a bf16 rounding of a power bin (one bf16 ulp = 0.4 %),
# a narrow low mel band (1-2 bins) moves by up to ~4e-3 in ln.  The bars
# leave 10x room; dB is 10/ln(10) times the ln scale.
TOL = {"bf16-ln": 0.05, "bf16-db-fmin0": 0.25, "f32-ln": 2e-3}
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


def speechlike_batch(b: int, n: int, seed: int):
    """(b, n) synthetic voices with ragged lengths (tails zeroed, as the
    diarizer pads), plus the lengths."""
    import numpy as np

    from sdtk_tpu_torch.data.synth import synth_utterance

    rng = np.random.default_rng(seed)
    x = np.stack([synth_utterance(i % 16, 100 + i, n / 16000) for i in range(b)])
    lengths = np.where(rng.uniform(size=b) < 0.25, rng.integers(400, n, size=b), n)
    x[np.arange(n)[None, :] >= lengths[:, None]] = 0.0
    return x.astype(np.float32), lengths.astype(np.int64)


def phase_kernel(device) -> dict:
    import numpy as np
    import torch

    from sdtk_tpu_torch.ops import fbank, fbank_wave
    from sdtk_tpu_torch.ops.fbank import FrontendConfig

    x_np, len_np = speechlike_batch(128, 16000, seed=0)
    x = torch.from_numpy(x_np).to(device)
    lengths = torch.from_numpy(len_np).to(device)
    configs = {
        "bf16-ln": FrontendConfig(),
        "bf16-db-fmin0": FrontendConfig(log_scale="db", mel_fmin=0.0),
        "f32-ln": FrontendConfig(compute_dtype="float32"),
    }
    rows = {}
    for name, cfg in configs.items():
        got, gmask = fbank_wave.log_mel_wave(x, cfg, lengths=lengths)
        want, wmask = fbank.log_mel(x, cfg, lengths=lengths)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{name}: kernel output not finite")
        if not torch.equal(gmask, wmask):
            raise AssertionError(f"{name}: frame masks differ")
        err = float((got - want).abs().max())
        if err > TOL[name]:
            raise AssertionError(f"{name}: kernel vs plain max|d| {err} > {TOL[name]}")
        raw_err = float((fbank_wave.log_mel_wave_cuda(x, cfg, cfg.preemphasis)
                         - fbank_wave.log_mel_wave_plain(x, cfg, cfg.preemphasis)).abs().max())
        coeff = cfg.preemphasis
        ms = cuda_ms(lambda: fbank_wave.log_mel_wave_cuda(x, cfg, coeff))
        plain_ms = cuda_ms(lambda: fbank_wave.log_mel_wave_plain(x, cfg, coeff))
        b, n = x.shape
        t = got.shape[1]
        n_freqs = cfg.n_fft // 2 + 1
        item = 2 if cfg.compute_dtype == "bfloat16" else 4
        nbytes = (x.numel() * 4 + b * t * cfg.n_mels * 4
                  + (2 * cfg.win_length * n_freqs + n_freqs * cfg.n_mels) * item)
        flops = 2 * b * t * cfg.win_length * n_freqs * 2 + 2 * b * t * n_freqs * cfg.n_mels
        t_bytes = nbytes / PEAK_BYTES * 1e3
        t_ops = flops / PEAK_FLOPS[cfg.compute_dtype] * 1e3
        rows[name] = {
            "max_abs_err": err, "raw_max_abs_err": raw_err, "tol": TOL[name],
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes > t_ops else "operations",
            "bytes": nbytes, "flops": flops,
        }
        emit({"phase": "kernel", "name": "log_mel_wave", "config": name,
              "shape": [b, n], "frames": t, **rows[name]})

    # yardstick: one PyTorch FFT pipeline for the same function (f32)
    cfg = configs["f32-ln"]
    win = torch.from_numpy(fbank.melbank.window(cfg.win_length, cfg.window)).to(device)
    mel = torch.from_numpy(fbank.melbank.mel_filterbank(
        cfg.n_mels, cfg.n_fft, cfg.sample_rate, fmin=cfg.mel_fmin)).to(device)

    def library():
        frames = fbank.preemphasize(x, cfg.preemphasis).unfold(1, cfg.win_length, cfg.hop_length)
        spec = torch.fft.rfft(frames * win, n=cfg.n_fft)
        return torch.log((spec.real ** 2 + spec.imag ** 2) @ mel + cfg.log_floor)

    lib_err = float((library() - fbank_wave.log_mel_wave_plain(x, cfg, cfg.preemphasis))
                    .abs().max())
    library_ms = cuda_ms(library)
    emit({"phase": "kernel", "name": "log_mel_wave", "library": "torch.fft.rfft + mel matmul",
          "library_ms": library_ms, "library_vs_plain_f32_max_abs_err": lib_err})
    row = rows["bf16-ln"]
    return {"name": "log_mel_wave", "route": "cuda",
            "source": "sdtk_tpu_torch/csrc/log_mel_wave.cu",
            "replaces": "sdtk_tpu/ops/research/fbank_wave.py:148",
            "max_abs_err": row["max_abs_err"], "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"], "library_ms": library_ms}


def phase_tower(engine, wav) -> None:
    from dataclasses import replace

    import numpy as np
    import torch

    from sdtk_tpu_torch.models.ecapa import EcapaTdnn, l2_normalize
    from sdtk_tpu_torch.ops import fbank

    win = 16000
    windows = np.stack([wav[i * 6000 : i * 6000 + win] for i in range(8)]).astype(np.float32)
    lengths = np.full(8, win, np.int64)
    lengths[-1] = 5000  # one ragged row
    gpu = engine.embed(windows, lengths).float().cpu().numpy()
    cpu_model = EcapaTdnn(replace(engine.model.cfg, dtype="float32"))
    cpu_model.load_state_dict({k: v.cpu() for k, v in engine.model.state_dict().items()})
    with torch.inference_mode():
        feats, mask = fbank.log_mel(torch.from_numpy(windows),
                                    replace(engine.cfg, compute_dtype="float32"),
                                    lengths=torch.from_numpy(lengths))
        cpu = l2_normalize(cpu_model.eval()(feats, mask)).numpy()
    cos = (gpu * cpu).sum(axis=1)
    emit({"phase": "tower", "windows": 8, "min_cosine": float(cos.min()),
          "bar": TOWER_COS_BAR, "finite": bool(np.isfinite(gpu).all())})
    if not np.isfinite(gpu).all() or cos.min() < TOWER_COS_BAR:
        raise AssertionError(f"tower on the card disagrees with the CPU: cos {cos.min()}")


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
                    for k, v in logs.items()}})

    kernel_rows = [phase_kernel(device)]

    import numpy as np

    from sdtk_tpu_torch.cluster.der import diarization_error_rate
    from sdtk_tpu_torch.data.synth import build_meeting
    from sdtk_tpu_torch.ops import fbank_wave
    from sdtk_tpu_torch.pipeline.diarize import DiarizeConfig, Diarizer

    wav, ref = build_meeting(0, 3, 20, 3.0)
    diarizer = Diarizer(cfg=DiarizeConfig(), device="cuda")
    phase_tower(diarizer.backend.engine, wav)  # also loads the weights before the timed run

    counters = {"log_mel_wave": fbank_wave.log_mel_wave}
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = diarizer.diarize_waveform(wav)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    der = diarization_error_rate(ref, result["segments"], collar=0.75)
    audio_s = len(wav) / 16000
    emit({"phase": "main", "audio_seconds": audio_s, "windows": len(result["window_labels"]),
          "n_speakers": result["n_speakers"], "der_c075": der["der"], "der_bar": DER_BAR,
          "miss": der["miss"], "false_alarm": der["false_alarm"], "confusion": der["confusion"],
          "wall_seconds": wall, "audio_s_per_s": audio_s / wall, "stage_seconds": result["timings"],
          "launches": launches, "params": diarizer.backend.engine.params_source})
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")
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
    out_dir.mkdir(parents=True, exist_ok=True)
    save_wav(out_dir / "meeting.wav", wav)
    rc = cli.main([str(out_dir / "meeting.wav"), "--format", "rttm", "-q",
                   "-o", str(out_dir / "meeting.rttm")])
    n_lines = len((out_dir / "meeting.rttm").read_text().splitlines())
    emit({"phase": "cli", "rc": rc, "rttm_lines": n_lines})
    if rc != 0 or n_lines == 0:
        raise AssertionError("diarize CLI produced no RTTM")

    for row in kernel_rows:
        row["launches"] = launches[row["name"]]
    emit({"kernels": kernel_rows})
    print(smi_line, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
