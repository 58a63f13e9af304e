"""Rank functions of the port's multi-process CPU tests, and the runner that
starts them: ``world`` processes (``torch.multiprocessing``, spawn) in a
gloo group that meets through a ``file://`` store, so no port is opened.

Kept apart from the test files so that a spawned rank imports this module,
which imports the port and never JAX.  Each rank pickles what it returns
to ``out_dir/rank{r}.pkl``; :func:`run_ranks` returns the list by rank.
"""

from __future__ import annotations

import os
import pickle
import tempfile
from pathlib import Path

import torch
import torch.multiprocessing as mp


def _entry(rank: int, world: int, store: str, out_dir: str, fn_name: str, payload) -> None:
    torch.set_num_threads(2)
    from sdtk_tpu_torch.parallel import multihost

    multihost.initialize(f"file://{store}", world, rank, device="cpu")
    try:
        out = globals()[fn_name](rank, world, payload)
    finally:
        multihost.shutdown()
    with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)


def run_ranks(world: int, fn_name: str, payload) -> list:
    """Run ``fn_name(rank, world, payload)`` (a function of this module) on
    ``world`` gloo ranks; returns each rank's result, by rank."""
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_entry, args=(world, os.path.join(tmp, "store"), tmp, fn_name, payload),
                 nprocs=world, join=True)
        out = []
        for r in range(world):
            with open(Path(tmp) / f"rank{r}.pkl", "rb") as f:
                out.append(pickle.load(f))
        return out


# -- long-form ---------------------------------------------------------------

def longform_cases(rank: int, world: int, payload: dict) -> dict:
    """Every long-form case of ``payload`` at this world size:
    ``log_mel`` (the features every rank returns, per config), ``affinity``
    (the refined matrix) and ``diarize`` (one result per case, without its
    timings)."""
    from sdtk_tpu_torch.ops.fbank import FrontendConfig
    from sdtk_tpu_torch.ops.longform import (pad_for_sharding, sharded_affinity_rows,
                                             sharded_log_mel)
    from sdtk_tpu_torch.pipeline.longform import LongformConfig, LongformDiarizer

    out: dict = {"log_mel": {}, "diarize": {}}
    for name, (x, cfg_kw) in payload.get("log_mel", {}).items():
        cfg = FrontendConfig(**cfg_kw)
        xp = pad_for_sharding(x, world, cfg)
        n_local = len(xp) // world
        local = torch.from_numpy(xp[rank * n_local : (rank + 1) * n_local].copy())
        out["log_mel"][name] = sharded_log_mel(local, cfg).numpy()
    if "affinity" in payload:
        emb = torch.from_numpy(payload["affinity"])
        rows = emb.shape[0] // world
        out["affinity"] = sharded_affinity_rows(emb[rank * rows : (rank + 1) * rows]).numpy()
    starts = payload.get("starts", {})
    for name, (wav, cfg_kw, channels, params_path) in payload.get("diarize", {}).items():
        d = LongformDiarizer(LongformConfig(**cfg_kw), channels=channels,
                             params_path=params_path, device="cpu",
                             subspace_start=lambda n, m: starts[n, m])
        res = d.diarize_waveform(wav)
        res.pop("timings")
        out["diarize"][name] = res
    return out


def cli_rank(rank: int, world: int, payload: dict) -> int:
    """The diarize CLI as a user starts it on each rank: the group comes
    from ``SDTK_*`` variables (the runner's group is left first)."""
    from sdtk_tpu_torch.cli import diarize as cli
    from sdtk_tpu_torch.parallel import multihost

    multihost.shutdown()
    os.environ.update({"SDTK_COORDINATOR": f"file://{payload['store']}",
                       "SDTK_NUM_PROCESSES": str(world), "SDTK_PROCESS_ID": str(rank)})
    return cli.main(payload["argv"])


# -- data-parallel training -----------------------------------------------------

def train_step_rank(rank: int, world: int, payload: dict) -> list[dict]:
    """One data-parallel step of a small ECAPA from ``payload["init"]``
    (JAX's params, batch_stats, AAM weights) on each global batch of
    ``payload["batches"]``, this rank taking its rows: the global loss and
    accuracy, the state after the step and the gradient the step took."""
    import numpy as np

    from sdtk_tpu_torch.models.ecapa import EcapaConfig, EcapaTdnn
    from sdtk_tpu_torch.parallel.train import (TrainConfig, TrainState, make_optimizer,
                                               sync_batchnorm, train_step)
    from sdtk_tpu_torch.utils.checkpoint import ecapa_state_dict

    params, stats, aam = payload["init"]
    cfg = TrainConfig(n_classes=payload["n_classes"], emb_dim=payload["ecapa"]["emb_dim"])
    out = []
    for feats, mask, labels in payload["batches"]:
        model = EcapaTdnn(EcapaConfig(dtype="float32", **payload["ecapa"]))
        model.load_state_dict(ecapa_state_dict({"params": params, "batch_stats": stats}))
        sync_batchnorm(model)
        aam_w = torch.nn.Parameter(torch.from_numpy(np.array(aam, np.float32)))
        state = TrainState(model, aam_w, make_optimizer(model, aam_w, cfg))
        rows = slice(rank * len(labels) // world, (rank + 1) * len(labels) // world)
        m = train_step(state, torch.from_numpy(feats[rows]), torch.from_numpy(mask[rows]),
                       torch.from_numpy(labels[rows]), cfg)
        out.append({"loss": float(m["loss"]), "acc": float(m["acc"]),
                    "state": {k: v.detach().clone() for k, v in model.state_dict().items()},
                    "aam": aam_w.detach().numpy().copy(),
                    "grads": {n: p.grad.clone() for n, p in model.named_parameters()},
                    "aam_grad": aam_w.grad.numpy().copy()})
    return out


def train_rank(rank: int, world: int, payload: dict) -> dict:
    """``training.train`` with ``payload["kw"]`` on this rank: each step's
    loss and the final state."""
    from sdtk_tpu_torch import training

    logs: list[str] = []
    state, out = training.train(log=logs.append, **payload["kw"])
    return {"losses": [s["loss"] for s in state.timings["steps"]], "logs": logs,
            "state": {k: v.clone() for k, v in state.model.state_dict().items()},
            "out": str(out), "step": state.step}


# -- ring attention and the sequence-parallel Conformer ------------------------

def ring_cases(rank: int, world: int, payload: dict) -> dict:
    """``ring_shift`` both ways and ``all_reduce_max`` of [rank, −rank];
    this rank's block of ``ring_attention`` for each (q, k, v, mask,
    q_block) case; and ``conformer_sp_embed`` of each (state dict, config, feats,
    mask) case from this rank's time blocks (``time_shard``); a case whose
    length does not divide over the ranks returns the error's message."""
    from sdtk_tpu_torch.models.conformer import Conformer, ConformerConfig
    from sdtk_tpu_torch.ops import ringattn
    from sdtk_tpu_torch.ops.ringattn import conformer_sp_embed, ring_attention, time_shard
    from sdtk_tpu_torch.parallel.multihost import all_reduce_max, ring_shift

    x = torch.tensor([float(rank), -float(rank)])
    out: dict = {"ring": {}, "sp": {}, "shift": {
        "next": ring_shift(x, 1).tolist(), "prev": ring_shift(x, -1).tolist(),
        "max": all_reduce_max(x).tolist()}}
    for name, (q, k, v, mask, q_block) in payload.get("ring", {}).items():
        q, k, v, mask = (time_shard(torch.from_numpy(a)) for a in (q, k, v, mask))
        ringattn.Q_BLOCK = q_block  # this process's own copy of the module
        out["ring"][name] = ring_attention(q, k, v, mask).numpy()
    for name, (sd, cfg_kw, feats, mask) in payload.get("sp", {}).items():
        model = Conformer(ConformerConfig(**cfg_kw))
        model.load_state_dict(sd)
        try:
            f, m = time_shard(torch.from_numpy(feats)), time_shard(torch.from_numpy(mask))
        except ValueError as e:
            out["sp"][name] = str(e)
            continue
        ringattn.Q_BLOCK = 16  # blocks of queries inside each hop, a ragged last one
        out["sp"][name] = conformer_sp_embed(model.eval(), f, m).numpy()
    return out


# -- the model axis: sharded steps and the sharded forward ----------------------

def _tower(name: str, kw: dict):
    from sdtk_tpu_torch.models.conformer import Conformer, ConformerConfig
    from sdtk_tpu_torch.models.ecapa import EcapaConfig, EcapaTdnn
    from sdtk_tpu_torch.models.xvector import XVector, XVectorConfig

    build = {"ecapa": (EcapaTdnn, EcapaConfig), "xvector": (XVector, XVectorConfig),
             "conformer": (Conformer, ConformerConfig)}[name]
    return build[0](build[1](dtype="float32", **kw))


def train_tp_rank(rank: int, world: int, payload: dict) -> dict:
    """For each case of ``payload["cases"]`` (tower, its config, JAX's
    initial (params, batch_stats, AAM weights), global batches, steps):
    a fresh state from the initial one, split over ``payload["mesh"]``,
    then ``make_distributed_step`` on each batch, ``steps`` times: each
    step's global loss and accuracy, the whole gradient and the whole
    state after it (gathered over the model ranks), and this rank's
    parameter shapes; and, for ``payload["eval"]`` (tower, config, flax
    variables, feats, mask), the sharded eval forward of this rank's data
    rows."""
    import numpy as np

    from sdtk_tpu_torch.parallel.mesh import make_mesh
    from sdtk_tpu_torch.parallel.sharding import batch_sharding, shard_params
    from sdtk_tpu_torch.parallel.train import (TrainConfig, TrainState, full_state,
                                               make_distributed_step, make_optimizer,
                                               shard_state)
    from sdtk_tpu_torch.training import CONVERTERS

    mesh = make_mesh(payload["mesh"])
    out: dict = {"coords": mesh.coords, "cases": {}}
    for name, (tower, kw, (params, stats, aam), batches, steps) in payload["cases"].items():
        cfg = TrainConfig(n_classes=aam.shape[0], emb_dim=aam.shape[1])
        step = make_distributed_step(mesh, cfg)
        runs = []
        for feats, mask, labels in batches:
            model = _tower(tower, kw)
            model.load_state_dict(CONVERTERS[tower][1]({"params": params, "batch_stats": stats}))
            aam_w = torch.nn.Parameter(torch.from_numpy(np.array(aam, np.float32)))
            state = shard_state(TrainState(model, aam_w, make_optimizer(model, aam_w, cfg)), mesh)
            local = {k: tuple(v.shape) for k, v in model.state_dict().items()}
            local["aam_weights"] = tuple(aam_w.shape)
            run = []
            for _ in range(steps):
                m = step(state, torch.from_numpy(feats), torch.from_numpy(mask),
                         torch.from_numpy(labels))
                grads = {n: p.grad for n, p in model.named_parameters()}
                grads["aam_weights"] = aam_w.grad
                grads = {n: state.shardings[n].gather(g) if n in state.shardings else g.clone()
                         for n, g in grads.items()}
                whole = full_state(state)
                run.append({"loss": float(m["loss"]), "acc": float(m["acc"]), "grads": grads,
                            "state": {k: v.clone() for k, v in whole["model"].items()}, "aam": whole["aam_weights"].numpy().copy()})
            runs.append({"steps": run, "local_shapes": local})
        out["cases"][name] = runs
    if "eval" in payload:
        tower, kw, variables, feats, mask = payload["eval"]
        model = _tower(tower, kw)
        model.load_state_dict(CONVERTERS[tower][1](variables))
        rows = batch_sharding(mesh)
        with torch.no_grad():
            out["eval"] = shard_params(model, mesh).eval()(
                rows.shard(torch.from_numpy(feats)), rows.shard(torch.from_numpy(mask))).numpy()
    return out


def f32_towers() -> None:
    """Make ``training.train`` build its towers in float32 (the trainer's
    towers are bf16), in this process."""
    import dataclasses

    from sdtk_tpu_torch import training

    build = training.build_model

    def f32(name: str, channels: int, scale: int):
        model = build(name, channels, scale)
        return type(model)(dataclasses.replace(model.cfg, dtype="float32"))

    training.build_model = f32


def train_calls_rank(rank: int, world: int, payload: dict) -> list[dict]:
    """``training.train`` with each keyword set of ``payload["calls"]``, in
    order, in one group (each call makes its own mesh), with float32
    towers: each step's loss, the logs, the step count, the file and the
    last step's whole gradient (gathered over the model ranks)."""
    from sdtk_tpu_torch import training

    f32_towers()
    out = []
    for kw in payload["calls"]:
        logs: list[str] = []
        state, path = training.train(log=logs.append, **kw)
        sh = state.shardings
        grads = {n: sh[n].gather(p.grad) if n in sh else p.grad.clone()
                 for n, p in state.model.named_parameters()}
        out.append({"losses": [s["loss"] for s in state.timings["steps"]], "logs": logs,
                    "step": state.step, "out": str(path), "grads": grads})
    return out
