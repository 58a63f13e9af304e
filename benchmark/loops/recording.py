"""Recordings diarized one at a time: a speaker-process worker's closed loop.

Each recording is a seeded meeting of ``speakers`` voices taking turns of
``turn_s`` seconds, assembled from a per-speaker pool of utterances at random
offsets and gains.  It is cut at every hop into windows
(``DiarizeConfig(window_seconds, hop_seconds)``), embedded by
``Diarizer._embed_windows`` (``EmbedEngine.embed`` in the diarizer's own
chunks, padded as it pads) and clustered by ``spectral_cluster`` with the
speaker count estimated.  A recording's latency runs from handing in its
samples to its labels on the host (a ``request`` span); assembling the next
recording is outside it.

Metrics: ``recording_p95_ms`` over every recording of the window, and
``recording_audio_s_per_s``, the recordings' seconds of audio completed over
the whole window (the next recording's assembly included); a traced run's
device shares are over its requests' time.
"""

from __future__ import annotations

import numpy as np
import torch

from benchlib import harness, synth, weights, yardstick
from benchlib.check import cos_gap, label_mismatch
from benchlib.harness import SR, Outcome, Run, span
from reference import cluster as ref_cluster


def run(r: Run) -> Outcome:
    from sdtk_tpu_torch.cluster import spectral
    from sdtk_tpu_torch.pipeline import diarize

    cfg, tr, dev = r.config, r.traffic, r.device
    harness.set_model_path(weights.weights_file(cfg, r.root, dev))
    diarizer = diarize.Diarizer("gpu", diarize.DiarizeConfig(
        window_seconds=tr["window_s"], hop_seconds=tr["hop_s"]), device=str(dev))
    engine = diarizer.backend.engine
    bad = harness.config_mismatch(cfg, engine)
    if bad:
        raise SystemExit(f"the program does not run the configuration as stated: {bad}")
    pool, _ = synth.voice_pool(r.seed, tr["speakers"], tr["per_speaker"], tr["utterance_s"])
    win = int(tr["window_s"] * SR)
    hop = int(tr["hop_s"] * SR)
    n = int(tr["recording_s"] * SR)
    starts = np.arange(1 + (n - win) // hop) * hop
    starts_s = starts / SR
    k = tr["max_speakers"]

    buffer = np.empty(n, np.float32)  # the window's recordings reuse one buffer

    def recording(index: int, out=None) -> np.ndarray:
        return synth.meeting(pool, tr["speakers"], tr["recording_s"], tr["turn_s"], tr["gain"],
                             r.seed, index, out)

    def embed(wav):
        return diarizer._embed_windows(wav, starts_s)

    def cluster(emb):
        return spectral.spectral_cluster(emb, max_speakers=k, device=str(dev))

    if r.mode == "control":
        control = harness.reference(r, "fp8")

        def embed(wav):  # noqa: F811 - the control in the program's place
            return control.embed(torch.from_numpy(windows(wav, starts, win)),
                                 np.full(len(starts), win))

        def cluster(emb):  # noqa: F811
            return ref_cluster.cluster_count(emb, k, tf32=True)

    def serve(wav):
        with span("request"):
            with span("embed"):
                emb = embed(wav)
            t = harness.now()
            with span("cluster"):
                labels, count = cluster(emb)
        return emb, labels, count, harness.now() - t

    for w in range(tr["warmup_recordings"]):
        serve(recording(-1 - w))
    harness.sync(dev)
    setup_s = harness.now() - r.t_start

    kept, latency, cluster_s, held = [], [], [], {}

    def advance():
        wav = recording(len(kept), buffer)
        t = harness.now()
        emb, labels, count, c_s = serve(wav)
        latency.append(harness.now() - t)
        cluster_s.append(c_s)
        kept.append((emb, np.asarray(labels), int(count)))

    t0 = harness.now()
    if r.trace:
        with harness.traced(dev, held):
            for _ in range(tr["trace_recordings"]):
                advance()
    while harness.now() - t0 < r.seconds:
        advance()
    harness.sync(dev)
    window_s = harness.now() - t0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del diarizer, engine, embed, cluster, serve
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    ref = harness.reference(r)
    sample = synth.rng_for(r.seed, 4).choice(len(kept), size=min(tr["check_recordings"],
                                                                 len(kept)), replace=False)
    numbers = {"emb_cos_gap": 0.0, "count_diff": 0, "label_mismatch": 0}
    for j in sorted(sample.tolist()):
        emb, labels, count = kept[j]
        want = ref.embed(torch.from_numpy(windows(recording(j), starts, win)),
                         np.full(len(starts), win))
        ref_labels, ref_count = ref_cluster.cluster_count(emb, k)
        numbers["emb_cos_gap"] = max(numbers["emb_cos_gap"], cos_gap(emb, want))
        numbers["count_diff"] = max(numbers["count_diff"], abs(count - ref_count))
        numbers["label_mismatch"] = max(numbers["label_mismatch"],
                                        label_mismatch(labels, ref_labels))

    lat = np.asarray(latency)
    traced = tr["trace_recordings"] if r.trace else 0
    chunk = diarize.DiarizeConfig().embed_chunk  # the program's chunk: K1's launch shape
    chunks = -(-len(starts) // chunk)
    return Outcome(
        setup_s=setup_s, attempted=len(kept), failed=0,
        end_to_end={"recording_p95_ms": float(np.percentile(lat, 95)) * 1e3,
                    "recording_audio_s_per_s": len(kept) * tr["recording_s"] / window_s,
                    "setup_s": setup_s},
        memory_peak_bytes=peak, numbers=numbers, trace=held.get("trace"),
        work={"steps": traced, "cluster_s": cluster_s, "config": cfg,
              "k1_launches": [(chunk, win)] * chunks * traced,
              "windows": len(starts) * traced,
              "n_frames": yardstick.kernel_frames(win, cfg["frontend"])})


def windows(wav: np.ndarray, starts: np.ndarray, win: int) -> np.ndarray:
    """(len(starts), win) float32 windows of ``wav`` (zero past its end)."""
    out = np.zeros((len(starts), win), np.float32)
    for i, a in enumerate(starts):
        seg = wav[a : a + win]
        out[i, : len(seg)] = seg
    return out
