"""Batch embed + cluster on a raw-waveform tower: the corpus user's loop for a
model that reads samples (WavLM + ECAPA, ``models/wavlm.py``).

Each step takes ``batch`` distinct clips of ``window_s`` seconds, cut from a
seeded pool of voices at random offsets and gains, a share of them ragged
(zeroed after a random valid length), as the batch loop draws them
(``loops/batch.py:Feed``), and runs ``EmbedEngine.embed`` on the program's
waveform route (``GpuBackend(model="wavlm_ecapa")``: no log-mel kernel) then
``cluster_stage`` on the embeddings, each step's clips indexed through the
last step's labels.  A tree without the model fails at once: the backend
refuses the name before any weight is drawn.

``correct``: ``emb_cos_gap`` of the timed path's own embeddings against the
plain float32 reference (``reference/wavlm_ecapa.py``, each clip over its
own valid samples, in blocks of 16 clips of one length on the card), and
``label_mismatch_share`` of the clustering against the plain clustering of
the program's embeddings.

Metrics: ``audio_s_per_s`` (clip seconds over the window), and from a traced
run the per-layer readers' work counts.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from benchlib import harness, manifest, synth, wavlm_weights
from benchlib.check import cos_gap, label_mismatch
from benchlib.harness import Outcome, Run, span
from reference import cluster as ref_cluster
from reference import flaxio
from reference.precision import PRECISIONS
from reference.wavlm_ecapa import WavLMEcapa as PlainModel


class Reference:
    """The plain model, float32 or (for the control) fp8; embeds clips by
    blocks of equal valid length."""

    def __init__(self, cfg: dict, path, device, precision: str = "float32", block: int = 16):
        self.model = PlainModel(flaxio.read(path), cfg["model"], device, PRECISIONS[precision])
        self.block = block

    def embed(self, x: torch.Tensor, lengths) -> np.ndarray:
        """(B, L) clips and (B,) valid lengths → (B, D) float32 unit rows."""
        lengths = np.asarray(torch.as_tensor(lengths).cpu()).astype(np.int64)
        out = None
        for length in np.unique(lengths):
            rows = np.flatnonzero(lengths == length)
            for i in range(0, len(rows), self.block):
                idx = torch.as_tensor(rows[i : i + self.block], device=x.device)
                e = self.model(x.index_select(0, idx)[:, : int(length)]).cpu().numpy()
                if out is None:
                    out = np.zeros((len(lengths), e.shape[1]), np.float32)
                out[rows[i : i + self.block]] = e
        return out


def config_mismatch(cfg: dict, engine) -> list[str]:
    """Where the program's model departs from the configuration's."""
    have = dataclasses.asdict(engine.model.cfg)
    norm = (lambda v: list(v) if isinstance(v, (list, tuple)) else v)
    return [k for k, v in cfg["model"].items() if norm(have.get(k)) != norm(v)]


def run(r: Run) -> Outcome:
    from sdtk_tpu_torch.backends import gpu
    from sdtk_tpu_torch.cluster import spectral

    cfg, tr, dev = r.config, r.traffic, r.device
    backend = gpu.GpuBackend(model="wavlm_ecapa", device=str(dev))
    path = wavlm_weights.weights_file(cfg, r.root, dev)
    harness.set_model_path(path)
    engine = backend.engine
    bad = config_mismatch(cfg, engine)
    if bad or engine.params_source != str(path):
        raise SystemExit(f"the program does not run the configuration as stated: {bad}")
    pool_np, _ = synth.voice_pool(r.seed, tr["speakers"], tr["per_speaker"], tr["utterance_s"])
    feed = manifest.module("loops", "batch").Feed(torch.from_numpy(pool_np).to(dev), tr, r.seed)
    k = tr["max_speakers"]
    embed = engine.embed

    def cluster(emb):
        return spectral.cluster_stage(emb, max_speakers=k, use_subspace=tr["use_subspace"])

    if r.mode == "control":
        control = Reference(cfg, path, dev, "fp8")

        def embed(x, lengths):  # noqa: F811 - the control in the program's place
            return torch.from_numpy(control.embed(x, lengths)).to(dev)

        def cluster(emb):  # noqa: F811
            return torch.from_numpy(ref_cluster.cluster_fixed(emb.cpu().numpy(), k,
                                                              tf32=True)).to(dev)

    def step(i: int, dep):
        x, lengths = feed.inputs(i, dep)
        with span("embed"):
            emb = embed(x, lengths)
        with span("cluster"):
            labels = cluster(emb)
        return emb, labels

    for w in range(tr["warmup_steps"]):
        step(-1 - w, None)
    harness.sync(dev)
    setup_s = harness.now() - r.t_start

    sample = set(synth.rng_for(r.seed, 3).integers(1, 24, size=tr["check_steps"] - 1).tolist())
    kept, held = {}, {}
    i, dep = 0, None

    def advance():
        nonlocal i, dep
        emb, labels = step(i, dep)
        dep = labels[:1]
        if i in sample:
            kept[i] = (emb, labels)
        i += 1
        return emb, labels

    t0 = harness.now()
    if r.trace:
        with harness.traced(dev, held):
            for _ in range(tr["trace_steps"]):
                last = advance()
    while harness.now() - t0 < r.seconds:
        last = advance()
    kept[i - 1] = last
    harness.sync(dev)
    window_s = harness.now() - t0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    kept = {j: (e.float().cpu().numpy(), lab.cpu().numpy()) for j, (e, lab) in kept.items()}
    del embed, cluster, step, advance, last, engine, backend
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    ref = Reference(cfg, path, dev)
    gaps, mismatches = [], []
    for j, (emb, labels) in sorted(kept.items()):
        x, lengths = feed.inputs(j)
        gaps.append(cos_gap(emb, ref.embed(x, lengths)))
        mismatches.append(label_mismatch(labels, ref_cluster.cluster_fixed(emb, k)))
    numbers = {"emb_cos_gap": max(gaps), "label_mismatch_share": max(mismatches) / tr["batch"]}

    audio_s = i * tr["batch"] * tr["window_s"]
    return Outcome(
        setup_s=setup_s, attempted=i, failed=0,
        end_to_end={"audio_s_per_s": audio_s / window_s, "setup_s": setup_s},
        memory_peak_bytes=peak, numbers=numbers, trace=held.get("trace"),
        work={"steps": tr["trace_steps"], "clips": tr["batch"] * tr["trace_steps"],
              "samples": feed.L, "config": cfg})
