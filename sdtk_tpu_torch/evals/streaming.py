"""Streaming diarization: latency and real-time factor, or DER.

The counterpart of ``evals/benchmark_streaming.py``.  By default it feeds
a synthetic three-voice conversation to the port's ``OnlineDiarizer`` in
real-time-sized chunks and reports the real-time factor (processing time
/ audio time; below 1.0 is faster than real time) and the chunk latency
percentiles.  With ``--der`` it scores the online path, live (greedy
assignment) and after ``finalize()`` (recluster), against the offline
``Diarizer`` on synthetic meetings (``--heldout``: the held-out voice
family, ``--tier``), at collars 0.75 and 0.25.  Everything runs on
``--device`` (default cuda), K1 featurizing each window.

Usage: python -m sdtk_tpu_torch.evals.streaming [--backend fake|gpu] [--seconds 60]
       [--chunk-seconds 0.5] [--der [--heldout] [--tier clean] [--meetings 3]
       [--speakers 3] [--window 1.0] [--hop 0.375] [--vad energy]] [--device cuda]
Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def conversation(seconds: float, sr: int = 16000) -> np.ndarray:
    """Three harmonic voices in 4 s turns over a little noise."""
    rng = np.random.default_rng(0)
    freqs = [220, 520, 330]
    out = []
    t_turn = 4.0
    n_turns = int(seconds / t_turn)
    for i in range(n_turns):
        f = freqs[i % len(freqs)]
        t = np.arange(int(t_turn * sr)) / sr
        x = sum((0.5 / (k + 1)) * np.sin(2 * np.pi * f * (k + 1) * t)
                for k in range(4))
        out.append((0.4 * x / np.max(np.abs(x))).astype(np.float32))
    wav = np.concatenate(out)
    return wav + 0.005 * rng.standard_normal(len(wav)).astype(np.float32)


def der_mode(args) -> int:
    """DER of the live and finalized online output and of the offline
    Diarizer on the same meetings: live − final is the price of causality,
    final − offline the price of the streaming window."""
    from ..cluster.der import diarization_error_rate
    from ..pipeline.diarize import DiarizeConfig, Diarizer
    from ..pipeline.streaming import OnlineDiarizer, StreamingConfig
    from .der import build_meeting

    sr = 16000
    chunk = int(args.chunk_seconds * sr)
    collars = (0.75, 0.25)
    rows = {"live": [], "final": [], "offline": []}
    offline = Diarizer(args.backend, DiarizeConfig(vad=args.vad), device=args.device)
    for m in range(args.meetings):
        wav, ref = build_meeting(m, args.speakers, 10, 3.0, heldout=args.heldout, tier=args.tier)
        d = OnlineDiarizer(args.backend, StreamingConfig(
            window_seconds=args.window, hop_seconds=args.hop, vad=args.vad), device=args.device)
        for i in range(0, len(wav), chunk):
            d.feed(wav[i : i + chunk])
        live = d.segments()
        fin = d.finalize(recluster=True)["segments"]
        off = offline.diarize_waveform(wav)["segments"]
        for name, hyp in (("live", live), ("final", fin), ("offline", off)):
            rows[name].append({c: diarization_error_rate(ref, hyp, collar=c)["der"]
                               for c in collars})
    out = {
        "benchmark": "streaming-der",
        "backend": args.backend,
        "generator": "heldout" if args.heldout else "train-family",
        "tier": args.tier if args.heldout else "clean",
        "meetings": args.meetings,
        "speakers": args.speakers,
        "window": args.window,
        "hop": args.hop,
        "vad": args.vad,
    }
    for name, per in rows.items():
        for c in collars:
            out[f"{name}_mean_der_c{int(c * 100)}"] = round(float(np.mean([r[c] for r in per])), 4)
    for c in collars:
        tag = f"c{int(c * 100)}"
        out[f"causality_cost_{tag}"] = round(
            out[f"live_mean_der_{tag}"] - out[f"final_mean_der_{tag}"], 4)
        out[f"streaming_gap_{tag}"] = round(
            out[f"final_mean_der_{tag}"] - out[f"offline_mean_der_{tag}"], 4)
    print(json.dumps(out))
    return 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="sdtk_tpu_torch.evals.streaming")
    ap.add_argument("--backend", default="fake")
    ap.add_argument("--seconds", type=float, default=60.0)
    ap.add_argument("--chunk-seconds", type=float, default=0.5)
    ap.add_argument("--der", action="store_true",
                    help="score DER of the online path (live + finalized) "
                         "vs the offline pipeline on synthetic meetings")
    ap.add_argument("--heldout", action="store_true")
    ap.add_argument("--tier", default="clean",
                    choices=["clean", "noise", "reverb", "telephone", "music"])
    ap.add_argument("--meetings", type=int, default=3)
    ap.add_argument("--speakers", type=int, default=3)
    ap.add_argument("--window", type=float, default=1.0)
    ap.add_argument("--hop", type=float, default=0.375)
    ap.add_argument("--vad", default="energy", choices=["energy", "trained", "auto"],
                    help="streaming gate (trained stays opt-in in serving; the "
                         "benchmark measures both)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)

    if args.der:
        return der_mode(args)

    from ..pipeline.streaming import OnlineDiarizer, StreamingConfig

    sr = 16000
    wav = conversation(args.seconds, sr)
    chunk = int(args.chunk_seconds * sr)

    d = OnlineDiarizer(args.backend, StreamingConfig(), device=args.device)
    # first-call costs (the tower's weights, cuDNN's plans) on a throwaway stream
    warm = OnlineDiarizer(args.backend, StreamingConfig(), device=args.device)
    warm.feed(wav[: chunk * 4])
    warm.finalize()

    lat = []
    t_all = time.perf_counter()
    for i in range(0, len(wav), chunk):
        t0 = time.perf_counter()
        d.feed(wav[i : i + chunk])
        lat.append(time.perf_counter() - t0)
    result = d.finalize()
    total = time.perf_counter() - t_all

    lat_ms = np.array(lat) * 1000.0
    print(json.dumps({
        "metric": "streaming diarization real-time factor",
        "backend": args.backend,
        "audio_seconds": args.seconds,
        "rtf": round(total / args.seconds, 4),
        "chunk_latency_ms": {
            "p50": round(float(np.percentile(lat_ms, 50)), 2),
            "p95": round(float(np.percentile(lat_ms, 95)), 2),
            "max": round(float(lat_ms.max()), 2),
        },
        "n_speakers": result.get("n_speakers"),
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
