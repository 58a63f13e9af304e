"""Host audio-decode throughput: the threaded C++ loader against the NumPy
path.

The counterpart of ``evals/benchmark_decode.py``, with its flags and its
JSON line.  ``--files`` WAVs of ``--seconds`` each (16-bit mono at
``--source-sr``, a tone and noise per file, written as the JAX script
writes them) are decoded and resampled to 16 kHz, the worst case of the
serving input: by ``utils/audio.py:load_audio_batch`` on the port's host
library (``csrc/host/audioio.cc``, the JAX package's ``native/`` sources,
built by ``utils/build.py:build_host``) with one thread a core, and with
``--thread-sweep`` at 1, 2, 4 and every core; then serially in NumPy and
SciPy (``_decode_wav``, mono mixdown, ``resample``).

``per_core_audio_s_per_s`` (one thread) and ``core_scaling_efficiency``
(all cores against one) are the host-decode terms of
``evals/benchmark_scaling.py:roofline``.  No kernel runs, and nothing
touches a card: ``--device`` names the device whose host is measured, and
on a machine without CUDA the default ``cuda`` raises, as every entry
point of the port does.

    python -m sdtk_tpu_torch.evals.benchmark_decode [--files 64] [--seconds 30]
        [--source-sr 44100] [--thread-sweep] [--device cuda]

Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
import wave
from pathlib import Path

import numpy as np


def make_wavs(tmp: Path, n: int, seconds: float, sr: int) -> list[Path]:
    """``n`` 16-bit mono WAVs of ``seconds`` at ``sr``: a tone of 200 + 10·i
    Hz at 0.3 and normal noise at 0.01 (``default_rng(0)``), the JAX
    script's files byte for byte."""
    rng = np.random.default_rng(0)
    paths = []
    t = np.arange(int(seconds * sr)) / sr
    for i in range(n):
        x = 0.3 * np.sin(2 * np.pi * (200 + 10 * i) * t)
        x += 0.01 * rng.standard_normal(len(t))
        pcm = (np.clip(x, -1, 1) * 32767).astype("<i2")
        p = tmp / f"bench{i:03d}.wav"
        with wave.open(str(p), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(sr)
            w.writeframes(pcm.tobytes())
        paths.append(p)
    return paths


def numpy_serial(paths: list[Path], target_sr: int = 16000) -> list[np.ndarray]:
    """Each file through the NumPy / SciPy path, one after another."""
    from ..utils import audio

    out = []
    for p in paths:
        x, sr = audio._decode_wav(p)
        x = x.mean(axis=1)
        if sr != target_sr:
            x = audio.resample(x, sr, target_sr)
        out.append(x)
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="sdtk_tpu_torch.evals.benchmark_decode")
    ap.add_argument("--files", type=int, default=64)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--source-sr", type=int, default=44100)
    ap.add_argument("--thread-sweep", action="store_true",
                    help="throughput at 1, 2, 4 and every core: the measured core scaling of "
                         "benchmark_scaling's roofline")
    ap.add_argument("--device", default="cuda",
                    help="the device whose host is measured (default cuda)")
    args = ap.parse_args(argv)

    from ..utils import audio
    from ..utils.device import resolve_device
    from ..utils.nativelib import get_lib

    resolve_device(args.device)
    with tempfile.TemporaryDirectory() as td:
        paths = make_wavs(Path(td), args.files, args.seconds, args.source_sr)
        audio_s = args.files * args.seconds

        results = {}
        if get_lib() is not None:
            t0 = time.perf_counter()
            batch = audio.load_audio_batch(paths, target_sr=16000)
            dt = time.perf_counter() - t0
            assert len(batch) == args.files
            results["native_threaded"] = audio_s / dt

            if args.thread_sweep:
                sweep = {}
                n_cores = os.cpu_count() or 1
                threads = sorted({1, 2, 4, n_cores} & set(range(1, n_cores + 1)))
                for nt in threads:
                    t0 = time.perf_counter()
                    audio.load_audio_batch(paths, target_sr=16000, n_threads=nt)
                    sweep[str(nt)] = audio_s / (time.perf_counter() - t0)
                results["thread_sweep_audio_s_per_s"] = sweep
                base = sweep.get("1")
                if base and len(threads) > 1:
                    top = threads[-1]
                    results["core_scaling_efficiency"] = sweep[str(top)] / (top * base)
                    results["per_core_audio_s_per_s"] = base

        t0 = time.perf_counter()
        numpy_serial(paths)
        results["numpy_serial"] = audio_s / (time.perf_counter() - t0)

    out = {"metric": "wav decode+resample throughput", "unit": "audio_s_per_s", **results}
    if "native_threaded" in results:
        out["native_speedup"] = results["native_threaded"] / results["numpy_serial"]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
