"""Long-form diarization and data-parallel training, the
sequence-parallel Conformer, or the trainer's model axis, on 1 and N
ranks.

    python -m sdtk_tpu_torch.tools.bench_ranks [--ranks 4] [--turns 1200]
        [--train-steps 3] [--device cuda] [--out DIR] [--mode longform]
    python -m sdtk_tpu_torch.tools.bench_ranks --mode conformer-sp
        [--ranks 4] [--turns 200] [--device cuda] [--out DIR]
    python -m sdtk_tpu_torch.tools.bench_ranks --mode tp [--ranks 4] [--out DIR]

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

``--mode tp`` runs one step of ECAPA c512 (bf16, warm-started from the
bundled fam5tel file, a seeded AAM head over 320 classes) on one batch of
the train recipe (32 crops of 1.5 s), with cuDNN's deterministic
algorithms, on one card without a group and on ``--ranks`` ranks (NCCL,
one card a rank) at ``data=2,model=2`` and ``data=1,model=4`` (of 4 ranks;
``TP_MESHES``): the loss, the cosine of every
gradient and every updated tensor with the one-card step's, each rank's
parameter elements against the sharding rules' count, the sharded eval
forward of 8 windows of 3 s against the dense one (cosine per window),
each rank's K1 launches in the step, the step's ms by CUDA events (the
median of 3 steps after the checked one) and each rank's peak memory.
The one-card and gathered tensors are compared on the host.  ``chip_smoke.py``'s
``train-tp`` phase runs the same check at ``data=1,model=2`` as two ranks
on one card in a gloo group (:func:`run_tp`).
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import time
from pathlib import Path

from .measure import cos, free_port, kernel_wrappers

RECIPE = {"families": "0,1,2,3,4", "n_speakers": 64, "batch": 32, "seconds": 3.0,
          "crop_seconds": 1.5, "aug_prob": 0.5, "noise_prob": 0.5, "model_name": "ecapa"}
TP_TIMED_STEPS = 3
TP_MESHES = ("data=2,model=2", "data=1,model=4")
TP_EVAL_WINDOWS = 8


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


# -- the model axis ------------------------------------------------------------

def _tp_state(device, dtype: str = "bfloat16"):
    """ECAPA c512 from the bundled fam5tel file with a seeded AAM head over
    the recipe's 320 classes, whole, on ``device``."""
    import torch

    from .. import config
    from ..models.ecapa import EcapaConfig, EcapaTdnn
    from ..parallel.train import TrainConfig, create_train_state
    from ..training import warm_start

    cfg = TrainConfig(n_classes=RECIPE["n_speakers"] * len(RECIPE["families"].split(",")))
    state = create_train_state(EcapaTdnn(EcapaConfig(dtype=dtype)),
                               torch.Generator().manual_seed(0), cfg, device)
    warm_start(state, "ecapa", config.repo_models_dir() / "ecapatdnn-fam5tel.msgpack")
    return state, cfg


def tp_inputs(out: Path, device) -> Path:
    """The recipe's first batch (seed 0) and K1's features of 8 unseen
    family voices of 3 s, written to ``out/tp-inputs.npz``."""
    import numpy as np
    import torch

    from ..data.batches import BatchSpec, make_batch
    from ..data.synth_families import family_utterance
    from ..ops.fbank import FrontendConfig
    from ..ops.fbank_wave import log_mel_wave

    spec = BatchSpec(family_ids=tuple(int(f) for f in RECIPE["families"].split(",")),
                     **{k: v for k, v in RECIPE.items() if k not in ("families", "model_name")})
    wavs, cls = make_batch(np.random.default_rng(0), spec)
    voices = np.stack([family_utterance(i % 5, 100 + i, 7, 3.0)
                       for i in range(TP_EVAL_WINDOWS)]).astype(np.float32)
    feats, mask = log_mel_wave(torch.from_numpy(voices).to(device), FrontendConfig())
    path = out / "tp-inputs.npz"
    np.savez(path, wavs=wavs, cls=cls, eval_feats=feats.float().cpu().numpy(),
             eval_mask=mask.cpu().numpy())
    return path


def _tp_step(state, cfg, inputs, device, fcfg=None) -> dict:
    """The checked step: the loss, the launches in it and the peak
    memory."""
    import torch

    from ..ops.fbank import FrontendConfig
    from ..training import featurize_step

    wrappers = kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats(device)
    m = featurize_step(state, inputs["wavs"], inputs["cls"], cfg, fcfg or FrontendConfig(),
                       device)
    loss = float(m["loss"])
    launches = {k: fn.launches for k, fn in wrappers.items()}
    peak = torch.cuda.max_memory_allocated(device)
    return {"loss": loss, "launches": launches, "peak_memory_bytes": peak}


def _timed_steps(state, cfg, inputs, device) -> list[float]:
    import torch

    from ..ops.fbank import FrontendConfig
    from ..training import featurize_step

    marks = []
    for _ in range(TP_TIMED_STEPS):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        featurize_step(state, inputs["wavs"], inputs["cls"], cfg, FrontendConfig(), device)
        b.record()
        marks.append((a, b))
    torch.cuda.synchronize(device)
    return [a.elapsed_time(b) for a, b in marks]


def _whole(state, grads: bool) -> dict:
    """The gradient (``grads``) or the parameters after the step, by name,
    whole (gathered over the model ranks: every rank calls it), on the
    host in float32."""
    tensors = {n: p.grad if grads else p.detach() for n, p in state.model.named_parameters()}
    a = state.aam_weights
    tensors["aam_weights"] = a.grad if grads else a.detach()
    return {n: (state.shardings[n].gather(t) if n in state.shardings else t).float().cpu()
            for n, t in tensors.items()}


def tp_reference(inputs_path: Path, device) -> dict:
    """The one-card step (no group) and the dense eval forward; and the
    same step in float32 (K1 and the tower in f32, TF32 off), whose
    gradient measures bf16's own rounding in each tensor."""
    import numpy as np
    import torch

    from ..ops.fbank import FrontendConfig

    inputs = dict(np.load(inputs_path))
    state, cfg = _tp_state(device)
    with torch.no_grad():
        emb = state.model.eval()(torch.from_numpy(inputs["eval_feats"]).to(device),
                                 torch.from_numpy(inputs["eval_mask"]).to(device))
    out = _tp_step(state, cfg, inputs, device)
    out["grads"] = _whole(state, grads=True)
    out["params"] = _whole(state, grads=False)
    out["eval"] = emb.float().cpu()
    out["step_ms"] = _timed_steps(state, cfg, inputs, device)
    out["param_elements"] = sum(p.numel() for p in state.model.parameters())
    f32, _ = _tp_state(device, "float32")
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        _tp_step(f32, cfg, inputs, device, FrontendConfig(compute_dtype="float32"))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    out["grads_f32"] = _whole(f32, grads=True)
    return out


def _tp_rank(rank: int, world: int, address: str, job: dict) -> None:
    """One rank of the model-axis check: joins the group (NCCL, one card a
    rank; or gloo with every rank on card 0), splits the warm-started
    state over ``job["mesh"]``, runs the sharded eval forward of its data
    rows, then the checked step and the timed ones; rank 0 writes the
    gathered gradient and parameters too."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from ..parallel.mesh import make_mesh
    from ..parallel.sharding import batch_sharding, param_shardings
    from ..parallel.train import shard_state

    t0 = time.perf_counter()
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    device = torch.device("cuda", rank if job["backend"] == "nccl" else 0)
    torch.cuda.set_device(device)
    dist.init_process_group(job["backend"], init_method=f"tcp://{address}", world_size=world,
                            rank=rank)
    try:
        inputs = dict(np.load(job["inputs"]))
        state, cfg = _tp_state(device)
        mesh = make_mesh(job["mesh"])
        rules = param_shardings(state.model, mesh)  # from the whole tower's shapes
        expected = sum(torch.Size(rules[n].shard_shape(p.shape)).numel()
                       for n, p in state.model.named_parameters())
        shard_state(state, mesh)
        rows = batch_sharding(mesh)
        with torch.no_grad():
            emb = state.model.eval()(rows.shard(torch.from_numpy(inputs["eval_feats"])).to(device),
                                     rows.shard(torch.from_numpy(inputs["eval_mask"])).to(device))
        setup_s = time.perf_counter() - t0
        while not Path(job["go"]).exists():  # the parent's own work on the card is done
            time.sleep(0.02)
        dist.barrier()
        out = _tp_step(state, cfg, inputs, device)
        out.update({"rank": rank, "coords": mesh.coords, "eval": emb.float().cpu(),
                    "setup_seconds": setup_s,
                    "param_elements": sum(p.numel() for p in state.model.parameters()),
                    "param_elements_by_rules": expected,
                    "aam_rows": int(state.aam_weights.shape[0])})
        grads, params = _whole(state, grads=True), _whole(state, grads=False)
        if rank == 0:
            out.update({"grads": grads, "params": params})
        dist.barrier()
        out["step_ms"] = _timed_steps(state, cfg, inputs, device)
        torch.save(out, Path(job["out"]) / f"tp-{job['tag']}-{rank}.pt")
    finally:
        dist.destroy_process_group()


def run_tp(inputs_path: Path, out: Path, mesh: str, world: int, backend: str,
           meanwhile=None) -> tuple:
    """(``meanwhile()``'s result, every rank's result of :func:`_tp_rank` by
    rank) at ``mesh`` over ``world`` processes on ``backend``.  The parent
    runs ``meanwhile`` while the ranks start; they step only after it has
    returned, so the two never share the card's time."""
    import torch
    import torch.multiprocessing as mp

    tag = mesh.replace(",", "-").replace("=", "")
    go = out / f"tp-{tag}.go"
    go.unlink(missing_ok=True)
    job = {"inputs": str(inputs_path), "out": str(out), "mesh": mesh, "backend": backend,
           "tag": tag, "go": str(go)}
    ranks = mp.start_processes(_tp_rank, args=(world, f"127.0.0.1:{free_port()}", job),
                               nprocs=world, join=False, start_method="spawn")
    try:
        result = meanwhile() if meanwhile else None
    finally:
        go.touch()
        while not ranks.join():
            pass
    return result, [torch.load(out / f"tp-{tag}-{r}.pt", weights_only=False)
                    for r in range(world)]


def tp_compare(ref: dict, ranks: list[dict]) -> dict:
    """The sharded step against the one-card step: loss (relative), every
    gradient's and every updated tensor's cosine (and their minima, by
    name), all gradients' cosine together, and each gradient's distance
    from the one-card one over bf16's own rounding there (the one-card
    bf16 gradient's distance from its f32 one); each rank's parameter
    elements against the rules' count, the sharded eval forward's cosine
    per window with the dense one (rows by data index), launches, step ms
    and peak memory per rank."""
    import statistics

    import torch

    lead = ranks[0]
    grad_cos = {n: cos(lead["grads"][n], g) for n, g in ref["grads"].items()}
    param_cos = {n: cos(lead["params"][n], p) for n, p in ref["params"].items()}
    rounding = {}
    for n, g in ref["grads"].items():
        dist = float((lead["grads"][n].double() - g.double()).norm())
        noise = float((g.double() - ref["grads_f32"][n].double()).norm())
        rounding[n] = dist / noise if noise > 0 else (0.0 if dist == 0 else float("inf"))
    grad_cos_all = cos(torch.cat([g.flatten() for g in lead["grads"].values()]),
                       torch.cat([g.flatten() for g in ref["grads"].values()]))
    blocks = sorted((r["coords"]["data"], r["eval"]) for r in ranks if r["coords"]["model"] == 0)
    emb = torch.cat([e for _, e in blocks])
    eval_cos = [cos(a, b) for a, b in zip(emb, ref["eval"])]
    return {
        "loss": lead["loss"], "loss_one_card": ref["loss"],
        "loss_rel_diff": abs(lead["loss"] - ref["loss"]) / abs(ref["loss"]),
        "grad_cos": grad_cos, "min_grad_cos": min(grad_cos.values()),
        "min_grad": min(grad_cos, key=grad_cos.get), "grad_cos_all": grad_cos_all,
        "grad_over_bf16_rounding": rounding,
        "max_grad_over_bf16_rounding": max(rounding.values()),
        "setup_seconds": [r["setup_seconds"] for r in ranks],
        "param_cos": param_cos, "min_param_cos": min(param_cos.values()),
        "min_param": min(param_cos, key=param_cos.get),
        "eval_cos": eval_cos, "min_eval_cos": min(eval_cos),
        "param_elements": [r["param_elements"] for r in ranks],
        "param_elements_by_rules": [r["param_elements_by_rules"] for r in ranks],
        "param_elements_one_card": ref["param_elements"],
        "aam_rows": [r["aam_rows"] for r in ranks],
        "launches": [r["launches"] for r in ranks],
        "step_ms_median": [statistics.median(r["step_ms"]) for r in ranks],
        "step_ms": [r["step_ms"] for r in ranks],
        "step_ms_one_card": ref["step_ms"],
        "step_ms_one_card_median": statistics.median(ref["step_ms"]),
        "peak_memory_bytes": [r["peak_memory_bytes"] for r in ranks],
        "peak_memory_bytes_one_card": ref["peak_memory_bytes"],
    }


def _tp(args) -> int:
    import torch

    if args.device != "cuda":
        raise SystemExit("--mode tp measures on the cards: --device cuda")
    out = Path(args.out)
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    device = torch.device("cuda", 0)
    inputs = tp_inputs(out, device)
    ref, runs = None, {}
    for mesh in TP_MESHES:
        got, ranks = run_tp(inputs, out, mesh, args.ranks, "nccl",
                            None if ref else lambda: tp_reference(inputs, device))
        ref = ref or got
        row = tp_compare(ref, ranks)
        grad_cos, rounding = row.pop("grad_cos"), row.pop("grad_over_bf16_rounding")
        row.pop("param_cos")
        # the gradients below cosine 0.999, with their distance over bf16's rounding
        row["grads_below_0999"] = {n: [c, rounding[n]] for n, c in grad_cos.items() if c < 0.999}
        runs[mesh] = row
    _print({"mode": "tp", "device": "cuda", "ranks": args.ranks, "runs": runs})
    return 0


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
    p.add_argument("--mode", choices=["longform", "conformer-sp", "tp"], default="longform")
    args = p.parse_args(argv)
    if args.mode == "tp":
        return _tp(args)

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
        mp.spawn(_rank, args=(world, free_port(), job), nprocs=world, join=True)
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
        mp.spawn(_sp_rank, args=(world, free_port(), job), nprocs=world, join=True)
        runs[world] = json.loads((Path(job["out"]) / f"sp-{world}.json").read_text())
    emb = {w: np.asarray(r.pop("embedding")) for w, r in runs.items()}
    diff = float(np.abs(emb[ranks] - emb[1]).max())
    _print({"mode": "conformer-sp", "audio_seconds": audio_s, "device": job["device"],
            "embedding_max_abs_diff": diff, "bar": 2e-4, "agree": diff <= 2e-4,
            "runs": runs})
    return 0 if diff <= 2e-4 else 1


if __name__ == "__main__":
    raise SystemExit(main())
