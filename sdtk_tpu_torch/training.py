"""Embedder trainer: AAM-softmax on the synthetic voice corpus.

The counterpart of ``sdtk_tpu/training.py``.  Run:
``python -m sdtk_tpu_torch.training --steps 300 --speakers 64`` (or
``python -m sdtk_tpu_torch train ...``); ``--device cpu`` runs on the
CPU with the frontend kernel's plain version.

``--mesh data=N`` trains data-parallel over a process group of N ranks,
one device each (``parallel/multihost.py``; e.g. ``torchrun
--nproc-per-node N -m sdtk_tpu_torch.training --mesh data=N``).  Every
rank draws the same global batch from the seeded producer, as the JAX
trainer draws it, and takes its own rows; the step is the global
batch's (``parallel/train.py``).  Rank 0 alone writes checkpoints and
the inference file; every rank restores them.  ``model=N`` is not
ported.

A producer thread synthesizes batches on the host (``data/batches.py``:
family voices, random crops and gains, augmentation, noise, beds) from
one seeded ``np.random.Generator`` in the JAX trainer's order, so one
seed gives both packages the same batches.  The main loop featurizes
them on the device with the waveform→log-mel kernel
(``ops/fbank_wave.py``, K1) and takes one AdamW step of the tower and the
AAM head (``parallel/train.py``).  The run saves a flax-msgpack
inference file (params + batch_stats) that the JAX ``TpuBackend`` and the
port's ``GpuBackend`` both load, warm-starts from one (``--resume``), and
takes full-state crash-resume checkpoints (``--ckpt-dir``).
"""

from __future__ import annotations

import argparse
import queue
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

from . import config
from .data.batches import BatchSpec, make_batch
from .models.conformer import Conformer, ConformerConfig
from .models.ecapa import EcapaConfig, EcapaTdnn
from .models.xvector import XVector, XVectorConfig
from .ops.fbank import FrontendConfig
from .ops.fbank_wave import log_mel_wave
from .parallel import multihost
from .parallel.checkpoint import latest_checkpoint, restore_train_state, save_train_state
from .parallel.mesh import parse_mesh_spec
from .parallel.train import (TrainConfig, TrainState, create_train_state, sync_batchnorm,
                             train_step)
from .utils.checkpoint import (conformer_jax_tree, conformer_state_dict, ecapa_jax_tree,
                               ecapa_state_dict, read_msgpack, write_msgpack, xvector_jax_tree,
                               xvector_state_dict)

# tower name → (state dict → flax variables, flax variables → state dict)
CONVERTERS = {"ecapa": (ecapa_jax_tree, ecapa_state_dict),
              "xvector": (xvector_jax_tree, xvector_state_dict),
              "conformer": (conformer_jax_tree, conformer_state_dict)}


def build_model(model_name: str, channels: int, scale: int) -> torch.nn.Module:
    if model_name == "ecapa":
        return EcapaTdnn(EcapaConfig(channels=channels, scale=scale))
    if model_name == "xvector":
        return XVector(XVectorConfig(channels=channels))
    if model_name == "conformer":
        return Conformer(ConformerConfig(dim=min(channels, 256)))
    raise ValueError(f"unknown model '{model_name}'")


def warm_start(state: TrainState, model_name: str, path: str | Path) -> tuple[int, int]:
    """Merge every ``params`` and ``batch_stats`` leaf of a saved inference
    file whose flax path and shape match into ``state``'s tower (the AAM
    head and the optimizer stay fresh).  Returns (merged, skipped) leaf
    counts, counted as the JAX trainer counts them."""
    to_tree, to_state_dict = CONVERTERS[model_name]
    loaded = read_msgpack(path)
    template = to_tree(state.model.state_dict())
    merged, skipped = [0], [0]

    def merge(tmpl, src):
        if isinstance(tmpl, dict):
            return {k: merge(v, (src or {}).get(k)) for k, v in tmpl.items()}
        if src is not None and getattr(src, "shape", None) == tmpl.shape:
            merged[0] += 1
            return np.asarray(src, tmpl.dtype)
        skipped[0] += 1
        return tmpl

    tree = {col: merge(template[col], loaded.get(col)) for col in ("params", "batch_stats")}
    state.model.load_state_dict(to_state_dict(tree))
    return merged[0], skipped[0]


def featurize_step(state: TrainState, wavs: np.ndarray, cls: np.ndarray, tcfg: TrainConfig,
                   fcfg: FrontendConfig, device: torch.device) -> dict[str, torch.Tensor]:
    """One training step from host waveforms: K1 featurizes ``wavs`` on
    ``device`` (the frontend has no parameters, so no gradient flows into
    it), then one AdamW step on ``cls``'s labels.  The loop of ``train``.
    In a process group, ``wavs`` and ``cls`` are the global batch and this
    rank steps on its own rows of it."""
    rank, world = multihost.rank_and_world()
    rows = slice(rank * len(cls) // world, (rank + 1) * len(cls) // world)
    with torch.no_grad():
        feats, mask = log_mel_wave(torch.from_numpy(wavs[rows]).to(device), fcfg)
    return train_step(state, feats, mask, torch.from_numpy(cls[rows]).to(device), tcfg)


def data_parallel_ranks(mesh_spec: str, batch: int) -> int:
    """The ranks a ``--mesh`` spec trains over: ``data`` (the process
    group's size when the spec leaves it out), which must be the group's
    size and divide the batch.  ``model`` > 1 raises."""
    sizes = parse_mesh_spec(mesh_spec)
    if sizes.get("model", 1) > 1:
        raise NotImplementedError(
            f"mesh '{mesh_spec}': model-axis sharding is not ported yet (ROADMAP Queue 1 "
            "item 4.2); data-parallel meshes (data=N over a process group of N ranks) are")
    world = multihost.rank_and_world()[1]
    data = sizes.get("data") or world
    if data != world:
        raise RuntimeError(f"mesh '{mesh_spec}' needs a process group of {data} ranks; this "
                           f"process has {world} (parallel/multihost.py:initialize)")
    if batch % data:
        raise ValueError(f"batch {batch} does not split over {data} ranks")
    return data


class _StepClock:
    """Per-step device time: CUDA events around the step on a GPU (read
    after the loop, so timing adds no synchronization), the host clock on
    the CPU (where the step is synchronous)."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks: list = []

    def start(self):
        self.marks.append([self._now(), None])

    def stop(self):
        self.marks[-1][1] = self._now()

    def _now(self):
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def ms(self) -> list[float]:
        if self.cuda:
            torch.cuda.synchronize()
            return [a.elapsed_time(b) for a, b in self.marks]
        return [(b - a) * 1e3 for a, b in self.marks]


def train(
    steps: int = 300,
    n_speakers: int = 64,
    families: str = "0",
    batch: int = 32,
    seconds: float = 3.0,
    crop_seconds: float = 1.5,
    channels: int = 512,
    scale: int = 8,
    model_name: str = "ecapa",
    lr: float = 1e-3,
    mesh_spec: str = "",
    seed: int = 0,
    out_path: str | Path | None = None,
    resume_path: str | Path | None = None,
    ckpt_dir: str | Path | None = None,
    ckpt_every: int = 200,
    log_every: int = 20,
    noise_prob: float = 0.0,
    noise_snr_db: tuple[float, float] = (5.0, 25.0),
    aug_prob: float = 0.0,
    bed_prob: float = 0.0,
    bed_snr_db: tuple[float, float] = (3.0, 20.0),
    log=print,
    device: str | torch.device | None = None,
):
    """Train ``steps`` steps; returns (state, out_path).  ``crop_seconds``
    < ``seconds`` trains on random crops with random gain, the diarizer's
    window distribution.  ``state.timings`` holds the loop's wall seconds
    (``loop_s``), the part of them spent writing checkpoints (``ckpt_s``),
    and each step's loss, accuracy, host synthesis seconds,
    queue wait, and device milliseconds (featurize + forward + backward +
    AdamW; ``steps``)."""
    dev = multihost.rank_device(device)
    world = data_parallel_ranks(mesh_spec, batch)
    lead = multihost.rank_and_world()[0] == 0  # writes files and logs
    if not lead:
        log = lambda msg: None  # noqa: E731
    model = build_model(model_name, channels, scale)
    if world > 1:
        sync_batchnorm(model)
    spec = BatchSpec(
        family_ids=tuple(int(x) for x in str(families).split(",") if x != ""),
        n_speakers=n_speakers, batch=batch, seconds=seconds, crop_seconds=crop_seconds,
        aug_prob=aug_prob, noise_prob=noise_prob, noise_snr_db=tuple(noise_snr_db),
        bed_prob=bed_prob, bed_snr_db=tuple(bed_snr_db))
    tcfg = TrainConfig(n_classes=spec.n_classes, emb_dim=model.cfg.emb_dim, learning_rate=lr)
    state = create_train_state(model, torch.Generator().manual_seed(seed), tcfg, dev)
    if resume_path:
        merged, skipped = warm_start(state, model_name, resume_path)
        log(f"resumed backbone from {resume_path} ({merged} leaves, {skipped} skipped)")
    if ckpt_dir:
        latest = latest_checkpoint(ckpt_dir)
        if latest is not None:
            restore_train_state(latest, state)
            log(f"restored full train state from {latest} (step {state.step})")
    fcfg = FrontendConfig()
    rng = np.random.default_rng(seed)

    # Host synthesis costs far more than the device step, so one worker
    # thread keeps a small queue of ready batches while the device trains.
    # Only the worker touches `rng`, in order, so the batch sequence is the
    # serial loop's.  It never touches the device.
    prefetch: queue.Queue = queue.Queue(maxsize=4)
    stop_flag = threading.Event()

    def _producer():
        # a synthesis failure is relayed through the queue and re-raised by
        # the consumer, which would otherwise block on get() forever
        try:
            for _ in range(steps):
                if stop_flag.is_set():
                    return
                t0 = time.perf_counter()
                wavs, cls = make_batch(rng, spec)
                prefetch.put((wavs, cls, time.perf_counter() - t0))
        except BaseException as exc:  # noqa: BLE001 — relayed, not swallowed
            prefetch.put(exc)

    producer = threading.Thread(target=_producer, daemon=True)
    producer.start()

    clock = _StepClock(dev)
    host: list[tuple[float, float]] = []
    metrics: list[dict] = []
    ckpt_s = 0.0
    t_loop = time.perf_counter()
    try:
        for step in range(steps):
            t0 = time.perf_counter()
            item = prefetch.get()
            wait_s = time.perf_counter() - t0
            if isinstance(item, BaseException):
                raise item
            wavs, cls, synth_s = item
            host.append((synth_s, wait_s))
            clock.start()
            out = featurize_step(state, wavs, cls, tcfg, fcfg, dev)
            clock.stop()
            metrics.append(out)
            if step % log_every == 0 or step == steps - 1:
                log(f"step {step:4d}  loss {float(out['loss']):7.4f}  "
                    f"acc {float(out['acc']):5.3f}  ({(time.perf_counter() - t_loop):6.1f}s)")
            if lead and ckpt_dir and ckpt_every and (step + 1) % ckpt_every == 0:
                t0 = time.perf_counter()
                p = save_train_state(ckpt_dir, state, step=state.step)
                ckpt_s += time.perf_counter() - t0
                log(f"checkpoint -> {p}")
        step_ms = clock.ms()  # synchronizes: the loop's wall time includes the device's
        loop_s = time.perf_counter() - t_loop
    finally:
        stop_flag.set()
        while not prefetch.empty():  # unblock a producer stuck on put()
            prefetch.get_nowait()
    state.timings = {"loop_s": loop_s, "ckpt_s": ckpt_s, "steps": [
        {"loss": float(m["loss"]), "acc": float(m["acc"]), "synth_s": s, "wait_s": w,
         "step_ms": ms}
        for m, (s, w), ms in zip(metrics, host, step_ms)]}

    # the inference variables (params + batch_stats), for either package's backend
    to_tree = CONVERTERS[model_name][0]
    out_path = (Path(out_path) if out_path
                else config.model_dir() / f"{type(model).__name__.lower()}.msgpack")
    if lead:
        write_msgpack(out_path, to_tree(state.model.state_dict()))
        log(f"saved params -> {out_path}")
    if multihost.in_group():
        torch.distributed.barrier()  # the file exists when any rank returns
    return state, out_path


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="sdtk-train-gpu", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--speakers", type=int, default=64,
                   help="Speakers PER FAMILY (classes = speakers × families)")
    p.add_argument("--families", default="0",
                   help="Comma list of synthetic family ids to train across "
                        "(data/synth_families.py; 0 = the data/synth.py corpus)")
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--crop-seconds", type=float, default=1.5)
    p.add_argument("--channels", type=int, default=512)
    p.add_argument("--scale", type=int, default=8, help="ECAPA Res2Net scale")
    p.add_argument("--model", default="ecapa", choices=["ecapa", "xvector", "conformer"])
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--mesh", default="",
                   help="Mesh spec as in the JAX trainer: data=N over a process group of N "
                        "ranks (parallel/multihost.py); model=N is not ported")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out")
    p.add_argument("--resume", help="Warm-start from a saved .msgpack checkpoint")
    p.add_argument("--ckpt-dir", help="Periodic full-state checkpoints (crash resume)")
    p.add_argument("--ckpt-every", type=int, default=200)
    p.add_argument("--noise-prob", type=float, default=0.0,
                   help="Per-example probability of additive-noise augmentation")
    p.add_argument("--noise-snr", type=float, nargs=2, default=(5.0, 25.0),
                   metavar=("LO", "HI"), help="SNR range in dB for noise aug")
    p.add_argument("--bed-prob", type=float, default=0.0,
                   help="Per-example probability of a structured non-speech "
                        "bed (music/hum/keyboard/pink) mixed at --bed-snr")
    p.add_argument("--bed-snr", type=float, nargs=2, default=(3.0, 20.0))
    p.add_argument("--aug-prob", type=float, default=0.0,
                   help="Per-example probability for each channel/prosody "
                        "augmentation (speed, reverb, tilt, band-limit, codec)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' runs the plain versions)")
    args = p.parse_args(argv)
    multihost.initialize(device=args.device)
    try:
        train(
            steps=args.steps,
            n_speakers=args.speakers,
            families=args.families,
            batch=args.batch,
            seconds=args.seconds,
            crop_seconds=args.crop_seconds,
            channels=args.channels,
            scale=args.scale,
            model_name=args.model,
            lr=args.lr,
            mesh_spec=args.mesh,
            seed=args.seed,
            out_path=args.out,
            resume_path=args.resume,
            ckpt_dir=args.ckpt_dir,
            ckpt_every=args.ckpt_every,
            noise_prob=args.noise_prob,
            bed_prob=args.bed_prob,
            bed_snr_db=tuple(args.bed_snr),
            noise_snr_db=tuple(args.noise_snr),
            aug_prob=args.aug_prob,
            log=lambda msg: print(msg, file=sys.stderr),
            device=args.device,
        )
    finally:
        multihost.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
