"""Batch embed + cluster: the corpus user's loop.

Each step takes ``batch`` distinct clips of ``window_s`` seconds, cut from a
seeded pool of voices at random offsets and gains, a share of them ragged
(zeroed after a random valid length, as the diarizer pads), and runs
``EmbedEngine.embed`` (K1 → tower → L2) then ``cluster_stage`` on the
embeddings.  Step i + 1's clips are indexed through step i's labels (times
zero), so no step can start before the one before has ended, and nothing in
the window synchronizes but the program itself.  Every clip is drawn on the
device from (seed, step), so the check draws a step's clips again, and the
embeddings stay on the device: the copies to and from the card that a caller
with host arrays pays (``embed_rows``) are not in this loop.

Metrics: ``audio_s_per_s`` (clip seconds over the window), and from a traced
run the per-layer readers' work counts.
"""

from __future__ import annotations

import torch

from benchlib import harness, synth, weights, yardstick
from benchlib.check import cos_gap, label_mismatch
from benchlib.harness import SR, Outcome, Run, span
from reference import cluster as ref_cluster


class Feed:
    """The clips of step ``step``, drawn on the pool's device."""

    def __init__(self, pool: torch.Tensor, tr: dict, seed: int):
        self.pool = pool
        self.tr, self.seed = tr, seed
        self.n_utt, self.ulen = pool.shape
        self.L = int(tr["window_s"] * SR)
        self.view = pool.reshape(-1).unfold(0, self.L, 1)
        self.g = torch.Generator(device=pool.device)
        self.ar = torch.arange(self.L, device=pool.device)
        lo, step = tr["ragged_s"][0], tr["ragged_s"][1]
        self.ragged = torch.tensor([int(round((lo + step * j) * SR))
                                    for j in range(int(round((tr["window_s"] - lo) / step)))],
                                   device=pool.device)

    def inputs(self, step: int, dep: torch.Tensor | None = None):
        tr, dev, g, b = self.tr, self.pool.device, self.g, self.tr["batch"]
        g.manual_seed(harness.step_seed(self.seed, step))
        utt = torch.randint(0, self.n_utt, (b,), generator=g, device=dev)
        off = torch.randint(0, self.ulen - self.L + 1, (b,), generator=g, device=dev)
        lo, hi = tr["gain"]
        gain = lo + (hi - lo) * torch.rand(b, generator=g, device=dev)
        short = torch.rand(b, generator=g, device=dev) < tr["ragged_share"]
        pick = torch.randint(0, len(self.ragged), (b,), generator=g, device=dev)
        length = torch.where(short, self.ragged[pick], self.L)
        start = utt * self.ulen + off
        if dep is not None:
            start = start + dep * 0
        x = self.view[start] * gain[:, None]
        return x * (self.ar[None, :] < length[:, None]), length


def run(r: Run) -> Outcome:
    from sdtk_tpu_torch.backends import gpu
    from sdtk_tpu_torch.cluster import spectral

    cfg, tr, dev = r.config, r.traffic, r.device
    harness.set_model_path(weights.weights_file(cfg, r.root, dev))
    engine = gpu.GpuBackend(model="ecapa", channels=cfg["model"]["channels"],
                            device=str(dev)).engine
    bad = harness.config_mismatch(cfg, engine)
    if bad:
        raise SystemExit(f"the program does not run the configuration as stated: {bad}")
    pool_np, _ = synth.voice_pool(r.seed, tr["speakers"], tr["per_speaker"], tr["utterance_s"])
    feed = Feed(torch.from_numpy(pool_np).to(dev), tr, r.seed)
    k = tr["max_speakers"]
    embed = engine.embed

    def cluster(emb):
        return spectral.cluster_stage(emb, max_speakers=k, use_subspace=tr["use_subspace"])

    if r.mode == "control":
        control = harness.reference(r, "fp8")

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
    del embed, cluster, step, advance, last
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    ref = harness.reference(r)
    gaps, mismatches = [], []
    for j, (emb, labels) in sorted(kept.items()):
        x, lengths = feed.inputs(j)
        gaps.append(cos_gap(emb, ref.embed(x, lengths)))
        mismatches.append(label_mismatch(labels, ref_cluster.cluster_fixed(emb, k)))
    numbers = {"emb_cos_gap": max(gaps), "label_mismatch": max(mismatches),
               "label_mismatch_share": max(mismatches) / tr["batch"]}

    audio_s = i * tr["batch"] * tr["window_s"]
    return Outcome(
        setup_s=setup_s, attempted=i, failed=0,
        end_to_end={"audio_s_per_s": audio_s / window_s, "setup_s": setup_s},
        memory_peak_bytes=peak, numbers=numbers, trace=held.get("trace"),
        work={"steps": tr["trace_steps"], "k1_launches": [(tr["batch"], feed.L)] * tr["trace_steps"],
              "windows": tr["batch"] * tr["trace_steps"],
              "n_frames": yardstick.kernel_frames(feed.L, cfg["frontend"]),
              "config": cfg})

