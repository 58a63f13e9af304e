"""Long-form diarization and data-parallel training, or the
sequence-parallel Conformer, on 1 and N ranks.

    python -m sdtk_tpu_torch.tools.bench_ranks [--ranks 4] [--turns 1200]
        [--train-steps 3] [--device cuda] [--out DIR] [--mode longform]
    python -m sdtk_tpu_torch.tools.bench_ranks --mode conformer-sp
        [--ranks 4] [--turns 200] [--device cuda] [--out DIR]

Writes a synthetic same-family meeting (``tools/make_meeting.py``, id 7,
3 speakers, ``--turns`` turns of ~3 s: 1 200 make about an hour), then
for one rank and for ``--ranks`` ranks starts that many processes on this
machine in a process group (``parallel/multihost.py``: NCCL, one card a
rank; gloo with ``--device cpu``), and on every rank:

- diarizes the meeting with ``LongformDiarizer`` at the CLI's 1.0 s /
  0.375 s windows and energy gate: a warm-up call, then a timed one
  (host clock from a barrier to the synchronized end): wall seconds,
  stage seconds, rank 0's peak device memory;
- trains ``--train-steps`` steps of the fam5tel recipe (ECAPA c512 bf16
  warm-started from the bundled file, 5 families × 64 speakers, a global
  batch of 32 crops of 1.5 s, augmentation and noise at 0.5) with
  ``mesh_spec="data=<ranks>"``: each step's global loss and device ms.

Prints one JSON line: both sizes' numbers, the speaker count and DER at
collar 0.75 of each, how many windows the N-rank run labels otherwise
than the one-rank run (under the label map that matches them best), the
largest relative difference between the two runs' losses, and the card's
name and power limit.

``--mode conformer-sp`` instead embeds the whole meeting with the
full-width Conformer (dim 256, seeded random weights, f32) through
``ops/ringattn.py:conformer_sp_embed``: every rank featurizes the meeting
with the log-mel kernel, pads the frames (masked) to a multiple of the
ranks, takes its time block, and runs a warm-up call and a timed one
(host clock from a barrier to the synchronized end).  The line holds each
size's wall ms, frames and rank 0's peak device memory, and the largest
difference between the two sizes' embeddings (bar 2e-4, the
sequence-parallel test's).
"""

from __future__ import annotations

import argparse
import json
import shutil
import socket
import subprocess
import time
from pathlib import Path

RECIPE = {"families": "0,1,2,3,4", "n_speakers": 64, "batch": 32, "seconds": 3.0,
          "crop_seconds": 1.5, "aug_prob": 0.5, "noise_prob": 0.5, "model_name": "ecapa"}


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _rank(rank: int, world: int, port: int, job: dict) -> None:
    import torch
    import torch.distributed as dist

    from .. import config, training
    from ..parallel import multihost
    from ..pipeline.longform import LongformConfig, LongformDiarizer
    from ..utils.audio import load_audio

    device = job["device"]
    multihost.initialize(f"127.0.0.1:{port}", world, rank, device=device)
    try:
        dev = multihost.rank_device(device)
        cuda = dev.type == "cuda"
        wav, _ = load_audio(job["wav"])
        d = LongformDiarizer(LongformConfig(window_seconds=1.0, hop_seconds=0.375), device=device)
        d.diarize_waveform(wav)  # warm-up: weights on the card, cuDNN plans, the kernel build
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        dist.barrier()
        t0 = time.perf_counter()
        res = d.diarize_waveform(wav)
        wall = time.perf_counter() - t0
        out = {"world": world, "wall_seconds": wall, "stage_seconds": res["timings"],
               "n_speakers": res["n_speakers"], "windows": len(res["window_labels"]),
               "windows_kept": res["windows_kept"], "window_labels": res["window_labels"],
               "segments": res["segments"], "mesh_devices": res["mesh_devices"],
               "peak_memory_bytes": torch.cuda.max_memory_allocated(dev) if cuda else None}
        if job["train_steps"]:
            state, _ = training.train(
                steps=job["train_steps"], mesh_spec=f"data={world}",
                resume_path=config.repo_models_dir() / "ecapatdnn-fam5tel.msgpack",
                out_path=Path(job["out"]) / f"train-{world}.msgpack", log=lambda m: None,
                device=device, seed=0, **RECIPE)
            out["train_loss"] = [s["loss"] for s in state.timings["steps"]]
            out["train_step_ms"] = [s["step_ms"] for s in state.timings["steps"]]
        if rank == 0:
            Path(job["out"], f"ranks-{world}.json").write_text(json.dumps(out))
    finally:
        multihost.shutdown()


def _sp_rank(rank: int, world: int, port: int, job: dict) -> None:
    import numpy as np
    import torch
    import torch.distributed as dist

    from ..models.conformer import Conformer, ConformerConfig
    from ..ops.fbank import FrontendConfig
    from ..ops.fbank_wave import log_mel_wave
    from ..ops.ringattn import conformer_sp_embed, time_shard
    from ..parallel import multihost
    from ..utils.audio import load_audio

    device = job["device"]
    multihost.initialize(f"127.0.0.1:{port}", world, rank, device=device)
    try:
        dev = multihost.rank_device(device)
        cuda = dev.type == "cuda"
        wav, _ = load_audio(job["wav"])
        feats, mask = log_mel_wave(torch.from_numpy(wav)[None].to(dev), FrontendConfig())
        pad = -feats.shape[1] % job["multiple"]
        feats = torch.nn.functional.pad(feats[0], (0, 0, 0, pad))
        mask = torch.nn.functional.pad(mask[0], (0, pad))
        model = Conformer(ConformerConfig(dtype="float32"))
        model.reset_parameters(torch.Generator().manual_seed(0))
        model.to(dev).eval()
        f_loc, m_loc = time_shard(feats), time_shard(mask)
        conformer_sp_embed(model, f_loc, m_loc)  # warm-up
        if cuda:
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        dist.barrier()
        t0 = time.perf_counter()
        emb = conformer_sp_embed(model, f_loc, m_loc)
        if cuda:
            torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        if rank == 0:
            out = {"world": world, "wall_ms": wall * 1e3, "frames": int(feats.shape[0]),
                   "frames_per_rank": int(f_loc.shape[0]), "valid_frames": int(mask.sum()),
                   "peak_memory_bytes": torch.cuda.max_memory_allocated(dev) if cuda else None,
                   "embedding": np.asarray(emb.cpu(), np.float64).tolist()}
            Path(job["out"], f"sp-{world}.json").write_text(json.dumps(out))
    finally:
        multihost.shutdown()


def _windows_differing(a: list[int], b: list[int]) -> int:
    """Windows whose label in ``b`` is not the one that ``a``'s label maps to
    most often (−1, a gated window, maps to itself); 0 for the same
    partition up to a permutation."""
    from collections import Counter

    pairs = Counter(zip(a, b))
    best: dict[int, tuple[int, int]] = {}
    for (x, y), n in pairs.items():
        if x not in best or n > best[x][1]:
            best[x] = (y, n)
    taken = Counter(y for y, _ in best.values())
    if len(a) != len(b) or any(n > 1 for n in taken.values()):
        return max(len(a), len(b))  # not one-to-one: count every window
    return sum(n for (x, y), n in pairs.items() if best[x][0] != y)


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="sdtk_tpu_torch.tools.bench_ranks", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--ranks", type=int, default=4)
    p.add_argument("--turns", type=int, default=1200)
    p.add_argument("--train-steps", type=int, default=3)
    p.add_argument("--device", default="cuda", help="cuda (NCCL, one card a rank) or cpu (gloo)")
    p.add_argument("--out", default="sdtk_tpu_torch/_build/bench_ranks")
    p.add_argument("--mode", choices=["longform", "conformer-sp"], default="longform")
    args = p.parse_args(argv)

    import torch
    import torch.multiprocessing as mp

    from ..cluster.der import diarization_error_rate, load_rttm
    from .make_meeting import write_meeting

    if args.device == "cuda" and torch.cuda.device_count() < args.ranks:
        raise SystemExit(f"needs {args.ranks} CUDA devices, found {torch.cuda.device_count()}")
    out = Path(args.out)
    shutil.rmtree(out, ignore_errors=True)
    wav, rttm, audio_s = write_meeting(out, 7, 3, args.turns, 3.0, "meeting")
    ref = load_rttm(rttm)["meeting"]
    job = {"wav": str(wav), "out": str(out), "device": args.device,
           "train_steps": args.train_steps, "multiple": args.ranks}
    if args.mode == "conformer-sp":
        return _conformer_sp(job, args.ranks, audio_s)
    runs = {}
    for world in sorted({1, args.ranks}):
        mp.spawn(_rank, args=(world, _free_port(), job), nprocs=world, join=True)
        run = json.loads((out / f"ranks-{world}.json").read_text())
        run["der_c075"] = diarization_error_rate(ref, [tuple(s) for s in run.pop("segments")],
                                                 collar=0.75)["der"]
        run["audio_s_per_s"] = audio_s / run["wall_seconds"]
        runs[world] = run
    one, many = runs[1], runs[args.ranks]
    summary = {"audio_seconds": audio_s, "device": args.device,
               "windows_labelled_otherwise": _windows_differing(one["window_labels"],
                                                                many["window_labels"])}
    if args.train_steps:
        summary["train_loss_max_rel_diff"] = max(
            abs(a - b) / abs(b) for a, b in zip(many["train_loss"], one["train_loss"]))
    for run in runs.values():
        run.pop("window_labels")
    summary["runs"] = runs
    _print(summary)
    return 0


def _print(summary: dict) -> None:
    if summary["device"] == "cuda":
        summary["nvidia_smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    print(json.dumps(summary))


def _conformer_sp(job: dict, ranks: int, audio_s: float) -> int:
    import numpy as np
    import torch.multiprocessing as mp

    runs = {}
    for world in sorted({1, ranks}):
        mp.spawn(_sp_rank, args=(world, _free_port(), job), nprocs=world, join=True)
        runs[world] = json.loads((Path(job["out"]) / f"sp-{world}.json").read_text())
    emb = {w: np.asarray(r.pop("embedding")) for w, r in runs.items()}
    diff = float(np.abs(emb[ranks] - emb[1]).max())
    _print({"mode": "conformer-sp", "audio_seconds": audio_s, "device": job["device"],
            "embedding_max_abs_diff": diff, "bar": 2e-4, "agree": diff <= 2e-4,
            "runs": runs})
    return 0 if diff <= 2e-4 else 1


if __name__ == "__main__":
    raise SystemExit(main())
