"""The trainer's model axis in the port (the sharding rules and split layers
of sdtk_tpu_torch/parallel/sharding.py and models/ecapa.py, ``shard_state``
and ``make_distributed_step`` in parallel/train.py,
``training.train(mesh_spec="data=D,model=M")``) on gloo ranks (CPU
processes, ``tests/torch_dist_workers.py``) against JAX's
``make_distributed_step`` on a mesh of the same shape and against the
port's one-device step, with ``tests/test_torch_train_step.py``'s small
f32 towers and its batch of 16 with padded frames (seed 0).  Tolerances are stated
in each test."""

from __future__ import annotations

import shutil
from functools import partial
from pathlib import Path

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_workers as workers
from sdtk_tpu.backends.tpu import TpuBackend
from sdtk_tpu.models.conformer import Conformer as JaxConformer
from sdtk_tpu.models.conformer import ConformerConfig as JaxConformerConfig
from sdtk_tpu.models.ecapa import EcapaConfig as JaxEcapaConfig
from sdtk_tpu.models.ecapa import EcapaTdnn as JaxEcapa
from sdtk_tpu.models.xvector import XVector as JaxXVector
from sdtk_tpu.models.xvector import XVectorConfig as JaxXVectorConfig
from sdtk_tpu.parallel import make_mesh
from sdtk_tpu.parallel import train as jax_train
from sdtk_tpu.parallel.sharding import batch_sharding as jax_batch_sharding
from sdtk_tpu.parallel.sharding import shard_params as jax_shard_params
from sdtk_tpu_torch import training
from sdtk_tpu_torch.parallel.train import TrainConfig, train_step
from sdtk_tpu_torch.utils.checkpoint import read_msgpack
from test_torch_train_step import (EXEMPT_BOUND, GRAD_ATOL, GRAD_RTOL, KINK_GRAD_RTOL, N_CLASSES,
                                   SMALL_CONFORMER, SMALL_ECAPA, SMALL_XVECTOR, ZERO_GRAD_LEAF,
                                   _batch, _jax_grads, _leaves, _port_state)

SEEDS = (0,)
STEPS = 2
MESHES = {"data=2,model=2": 4, "data=1,model=2": 2}
TOWERS = {
    "ecapa": (lambda: JaxEcapa(JaxEcapaConfig(dtype="float32", **SMALL_ECAPA)), SMALL_ECAPA),
    "xvector": (lambda: JaxXVector(JaxXVectorConfig(dtype="float32", **SMALL_XVECTOR)),
                SMALL_XVECTOR),
    "conformer": (lambda: JaxConformer(JaxConformerConfig(dtype="float32", **SMALL_CONFORMER)),
                  SMALL_CONFORMER),
}
# Parameters and statistics after a step: within 1e-5 of the leaf's largest
# element, that element counted as 1 at least (a zero-initialized bias holds
# values of about lr after a step), but the exempt elements (a gradient
# within its leaf's noise floor at this step or an earlier one), which Adam
# moves ±lr a step with a sign neither run determines: EXEMPT_BOUND a step.
PARAM_RTOL = 1e-5
TINY = {"n_speakers": 4, "families": "0,1", "batch": 8, "seconds": 1.0, "crop_seconds": 1.0,
        "channels": 32, "log_every": 1, "device": "cpu"}


def _to_tree(tower):
    return training.CONVERTERS[tower][0]


@pytest.fixture(scope="module")
def jax_init():
    """The batch (seed 0) and JAX's create_train_state(PRNGKey(0)) of
    each small tower: (model, state) and its numpy (params, batch_stats,
    AAM weights)."""
    batches = [_batch(seed) for seed in SEEDS]
    tcfg = jax_train.TrainConfig(n_classes=N_CLASSES, emb_dim=16)
    out = {}
    for tower, (make, _) in TOWERS.items():
        model = make()
        state0 = jax_train.create_train_state(model, jax.random.PRNGKey(0), tcfg,
                                              jnp.zeros((1, batches[0][0].shape[1], 80)))
        init = jax.device_get((state0.params, state0.batch_stats, state0.aam_weights))
        out[tower] = (model, state0, init)
    return batches, tcfg, out


def _cases(tower_steps: dict, batches, init) -> dict:
    return {t: (t, TOWERS[t][1], init[t][2], batches[:n_batches], steps)
            for t, (n_batches, steps) in tower_steps.items()}


# tower → (batches, steps) on each mesh
PLAN = {"data=2,model=2": {"ecapa": (len(SEEDS), STEPS)},
        "data=1,model=2": {"ecapa": (len(SEEDS), STEPS), "xvector": (1, 1), "conformer": (1, 1)}}


@pytest.fixture(scope="module")
def runs(jax_init):
    """For each mesh: JAX's steps (loss, acc, the gradient at the step's
    state, the state after) and its sharded eval forward, and every rank's
    port run (one spawn a mesh)."""
    batches, tcfg, init = jax_init
    grad = jax.jit(partial(_jax_grads, cfg=tcfg))  # on one device: one compile a tower
    out = {}
    for spec, n in MESHES.items():
        mesh = make_mesh(spec, jax.devices()[:n])
        step = jax_train.make_distributed_step(mesh, tcfg)
        jax_steps = {}
        for tower, (n_batches, steps) in PLAN[spec].items():
            model, state0, _ = init[tower]
            per_batch = []
            for batch in batches[:n_batches]:
                args = tuple(jnp.asarray(a) for a in batch)
                state = jax_train.shard_state(jax.tree_util.tree_map(jnp.copy, state0), mesh)
                run = []
                for _ in range(steps):
                    g = jax.device_get(grad(jax.device_get(state), *args))
                    state, m = step(state, *args)
                    run.append((float(m["loss"]), float(m["acc"]), g, jax.device_get(
                        (state.params, state.batch_stats, state.aam_weights))))
                per_batch.append(run)
            jax_steps[tower] = per_batch
        model, state0, _ = init["ecapa"]
        variables = {"params": state0.params, "batch_stats": state0.batch_stats}
        feats, mask, _ = batches[0]
        apply = jax.jit(model.apply)
        jax_eval = np.asarray(apply(jax_shard_params(variables, mesh),
                                    jax.device_put(feats, jax_batch_sharding(mesh)),
                                    jax.device_put(mask, jax_batch_sharding(mesh))))
        dense = {"params": jax.device_get(state0.params),
                 "batch_stats": jax.device_get(state0.batch_stats)}
        port = workers.run_ranks(n, "train_tp_rank", {
            "mesh": spec, "cases": _cases(PLAN[spec], batches, init),
            "eval": ("ecapa", SMALL_ECAPA, dense, feats, mask)})
        out[spec] = (jax_steps, jax_eval, port)
    return out


def _one_device(tower: str, batches, init, steps: int) -> list[list[dict]]:
    """The port's step without a group, ``steps`` times on each batch, with
    the ranks' 2 threads."""
    from torch_dist_workers import _tower

    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    cfg = TrainConfig(n_classes=N_CLASSES, emb_dim=16)
    out = []
    try:
        for feats, mask, labels in batches:
            state = _port_state(_tower(tower, TOWERS[tower][1]), init,
                                training.CONVERTERS[tower][1])
            run = []
            for _ in range(steps):
                m = train_step(state, torch.from_numpy(feats), torch.from_numpy(mask),
                               torch.from_numpy(labels), cfg)
                grads = {n: p.grad.clone() for n, p in state.model.named_parameters()}
                grads["aam_weights"] = state.aam_weights.grad.clone()
                run.append({"loss": float(m["loss"]), "acc": float(m["acc"]), "grads": grads,
                            "state": {k: v.clone() for k, v in state.model.state_dict().items()},
                            "aam": state.aam_weights.detach().numpy().copy()})
            out.append(run)
    finally:
        torch.set_num_threads(threads)
    return out


def _port_leaves(tower: str, run: dict) -> tuple[dict, dict, dict]:
    """A port step's (gradient, parameters, statistics) by flax path, the
    AAM head's as ``aam``."""
    to_tree = _to_tree(tower)
    grads = {k: v for k, v in run["grads"].items() if k != "aam_weights"}
    tree = to_tree(run["state"])
    return ({**_leaves(to_tree({**run["state"], **grads})["params"]),
             "aam": run["grads"]["aam_weights"].numpy()},
            {**_leaves(tree["params"]), "aam": run["aam"]}, _leaves(tree["batch_stats"]))


def _jax_leaves(step) -> tuple[dict, dict, dict]:
    _, _, g, (params, stats, aam) = step
    return ({**_leaves(g["params"]), "aam": np.asarray(g["aam"])},
            {**_leaves(params), "aam": np.asarray(aam)}, _leaves(stats))


def _hold(got: list, want: list, tower: str, where: str) -> None:
    """Holds a run of steps (the port's, sharded) to another (JAX's, or the
    port's on one device): each step's loss within 1e-5 relative and
    accuracy equal; every gradient element within its leaf's noise floor
    (``GRAD_RTOL`` of the leaf's largest |g|, at least ``GRAD_ATOL``) of the
    other run's gradient at its own state; parameters, AAM weights and
    statistics as ``PARAM_RTOL`` says, the exempt elements within
    ``EXEMPT_BOUND`` a step; attention's second bias exempt from the first
    step (its gradient is rounding noise)."""
    exempt: dict = {}
    for i, (g_run, w_run) in enumerate(zip(got, want)):
        at = f"{where} step {i + 1}"
        if isinstance(w_run, dict):
            w_loss, w_acc = w_run["loss"], w_run["acc"]
            wg, wp, ws = _port_leaves(tower, w_run)
        else:
            w_loss, w_acc = w_run[:2]
            wg, wp, ws = _jax_leaves(w_run)
        gg, gp, gs = _port_leaves(tower, g_run)
        np.testing.assert_allclose(g_run["loss"], w_loss, rtol=1e-5, err_msg=at)
        assert g_run["acc"] == w_acc, at
        assert gg.keys() == wg.keys() and gp.keys() == wp.keys() and gs.keys() == ws.keys()
        for k, w in wg.items():
            floor = max(GRAD_RTOL * float(np.abs(w).max()), GRAD_ATOL)
            assert np.abs(gg[k] - w).max() <= floor, f"{at} {k}: gradient"
            exempt[k] = exempt.get(k, False) | (np.abs(w) <= floor)
        for k, w in wp.items():
            d = np.abs(gp[k] - w)
            tol = PARAM_RTOL * max(float(np.abs(w).max()), 1.0)
            assert d[~exempt[k]].max(initial=0.0) <= tol, f"{at} {k}: |Δ| {d[~exempt[k]].max()}"
            assert d[exempt[k]].max(initial=0.0) <= EXEMPT_BOUND * (i + 1), f"{at} {k}: exempt"
        for k, w in ws.items():
            tol = PARAM_RTOL * max(float(np.abs(w).max()), 1.0)
            np.testing.assert_allclose(gs[k], w, rtol=0, atol=tol, err_msg=f"{at} {k}")
        if ZERO_GRAD_LEAF in exempt:
            assert exempt[ZERO_GRAD_LEAF].all(), at


@pytest.mark.parametrize("spec", list(MESHES))
def test_ecapa_steps_match_jax_mesh(spec, runs):
    """One and two steps of the small ECAPA at ``spec`` from JAX's initial
    state, on each global batch, against JAX's ``make_distributed_step`` on
    the same mesh, held as ``_hold`` says; every rank reports the same loss
    and whole state."""
    jax_steps, _, port = runs[spec]
    for b, seed in enumerate(SEEDS):
        first = port[0]["cases"]["ecapa"][b]["steps"]
        _hold(first, jax_steps["ecapa"][b], "ecapa", f"{spec} seed {seed}")
        for rank in port[1:]:
            other = rank["cases"]["ecapa"][b]["steps"]
            assert [s["loss"] for s in other] == [s["loss"] for s in first]
            for k, v in first[-1]["state"].items():
                assert torch.equal(other[-1]["state"][k], v), (rank["coords"], k)


@pytest.mark.parametrize("spec", list(MESHES))
def test_ecapa_steps_match_one_device(spec, runs, jax_init):
    """The same sharded steps against the port's step without a group on
    each whole batch, held as ``_hold`` says."""
    batches, _, init = jax_init
    _, _, port = runs[spec]
    one = _one_device("ecapa", batches, init["ecapa"][2], STEPS)
    for b, seed in enumerate(SEEDS):
        _hold(port[0]["cases"]["ecapa"][b]["steps"], one[b], "ecapa", f"{spec} seed {seed}")


@pytest.mark.parametrize("tower", ["xvector", "conformer"])
def test_other_towers_step_at_model_2(tower, runs, jax_init):
    """A step of the small x-vector (no leaf split: the model ranks
    replicate it) and of the small Conformer (``asp/att1``, ``asp/att2`` and
    ``embedding`` split) at ``data=1,model=2`` against JAX's distributed
    step on that mesh and against the port's one device, held as
    ``_hold`` says."""
    batches, _, init = jax_init
    jax_steps, _, port = runs["data=1,model=2"]
    got = port[0]["cases"][tower][0]["steps"]
    _hold(got, jax_steps[tower][0], tower, f"{tower} vs JAX")
    _hold(got, _one_device(tower, batches[:1], init[tower][2], 1)[0], tower, f"{tower} vs one")


@pytest.mark.parametrize("spec", list(MESHES))
def test_each_rank_holds_its_block(spec, runs):
    """Each rank stores the rules' block: at ``model=2`` the split ECAPA
    leaves at half their width, the AAM head at half its 64 classes; the
    x-vector whole; the Conformer's three split leaves at half."""
    _, _, port = runs[spec]
    for rank in port:
        shapes = rank["cases"]["ecapa"][0]["local_shapes"]
        assert shapes["block1.res2.conv3.weight"] == (4, 8, 3)
        assert shapes["block1.tdnn_in.conv.weight"] == (16, 32, 1)
        assert shapes["block1.se.fc1.weight"] == (8, 32)
        assert shapes["block1.se.fc2.weight"] == (32, 8)
        assert shapes["embedding.weight"] == (16, 96)
        assert shapes["block1.tdnn_in.conv.bias"] == (32,)
        assert shapes["aam_weights"] == (N_CLASSES // 2, 16)
        if "conformer" in rank["cases"]:
            c = rank["cases"]["conformer"][0]["local_shapes"]
            assert (c["asp.att1.weight"], c["asp.att2.weight"], c["embedding.weight"]) == (
                (8, 96, 1), (16, 16, 1), (16, 32))
            x = rank["cases"]["xvector"][0]["local_shapes"]
            assert x["segment6.weight"] == (16, 96) and x["tdnn1.conv.weight"] == (32, 80, 5)


@pytest.mark.parametrize("spec", list(MESHES))
def test_sharded_eval_forward(spec, runs, jax_init):
    """The split tower's eval forward of the batch (each data row's rows)
    against the dense forward and against JAX's ``shard_params`` +
    ``apply`` on the same mesh: atol 2e-4, rtol 1e-3
    (``tests/test_parallel.py:test_sharded_inference_matches_single_device``'s
    bar)."""
    from torch_dist_workers import _tower

    batches, _, init = jax_init
    _, jax_eval, port = runs[spec]
    feats, mask, _ = batches[0]
    rows = sorted((r["coords"]["data"], r["eval"]) for r in port if r["coords"]["model"] == 0)
    got = np.concatenate([e for _, e in rows])
    for r in port:  # the model ranks of a data row return the same rows
        assert np.array_equal(r["eval"], rows[r["coords"]["data"]][1])
    model = _port_state(_tower("ecapa", SMALL_ECAPA), init["ecapa"][2]).model.eval()
    with torch.no_grad():
        dense = model(torch.from_numpy(feats), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, dense, atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(got, jax_eval, atol=2e-4, rtol=1e-3)


@pytest.fixture()
def f32_train(monkeypatch):
    """``training.train`` with float32 towers in this process, as the ranks
    of ``train_runs`` build them (``torch_dist_workers.f32_towers``)."""
    monkeypatch.setattr(training, "build_model", training.build_model)
    workers.f32_towers()


@pytest.fixture(scope="module")
def train_runs(tmp_path_factory):
    """With float32 towers (the trainer builds bf16 ones, whose rounding
    differs once a layer is split), on 2 ranks, in one group: ``train()``
    at ``data=1,model=2``, one step; at
    ``data=2`` with a checkpoint at step 2; at ``data=1,model=2`` again on
    that checkpoint directory (a crash resume, one step); the x-vector at
    ``data=1,model=2`` and the Conformer at ``model=2``, one step each."""
    d = tmp_path_factory.mktemp("train_tp")
    kw = {**TINY, "steps": 2, "seed": 5}
    calls = [
        {**kw, "steps": 1, "mesh_spec": "data=1,model=2", "out_path": str(d / "tp.msgpack")},
        {**kw, "mesh_spec": "data=2", "out_path": str(d / "dp.msgpack"), "ckpt_dir": str(d / "ck"),
         "ckpt_every": 2},
        {**kw, "steps": 1, "mesh_spec": "data=1,model=2", "out_path": str(d / "resumed.msgpack"),
         "ckpt_dir": str(d / "ck"), "ckpt_every": 0},
        {**kw, "steps": 1, "model_name": "xvector", "mesh_spec": "data=1,model=2",
         "out_path": str(d / "xv.msgpack")},
        {**kw, "steps": 1, "model_name": "conformer", "mesh_spec": "model=2",
         "out_path": str(d / "cf.msgpack")},
    ]
    ranks = workers.run_ranks(2, "train_calls_rank", {"calls": calls})
    return d, kw, ranks


def test_train_on_model_axis_writes_the_whole_file(train_runs, tmp_path, f32_train,
                                                   monkeypatch):
    """``train(mesh_spec="data=1,model=2")``, one step: rank 0 alone logs and
    writes a file of the whole tower, which flax's ``msgpack_restore`` and
    JAX's ``TpuBackend`` read and flax's ``to_bytes`` writes back byte for
    byte; leaf for leaf it is the unsharded run's at the
    same seed, held as ``_hold`` holds a step: the loss within 1e-5
    relative, every gradient element within its leaf's noise floor,
    parameters and statistics within 1e-5 of the leaf's largest element
    (counted as 1 at least), the exempt elements within ``EXEMPT_BOUND``.
    At a ReLU kink (``tests/test_torch_train_step.py``: a Conv or Dense
    output within rounding of zero, here one below 1e-6 in the unsharded
    forward, can take either sign in a split layer), the gradient elements
    the floor misses join the exempt ones and what they miss by is held to
    ``KINK_GRAD_RTOL`` of their leaf's norm."""
    from sdtk_tpu_torch.models.ecapa import Conv, Dense

    d, kw, ranks = train_runs
    smallest: list[float] = []
    build = training.build_model

    def recording(*args):
        model = build(*args)
        for mod in model.modules():
            if isinstance(mod, (Conv, Dense)):
                mod.register_forward_hook(
                    lambda m, i, o: smallest.append(float(o.detach()[o != 0].abs().min())))
        return model

    monkeypatch.setattr(training, "build_model", recording)
    one, _ = training.train(out_path=tmp_path / "one.msgpack", log=lambda m: None,
                            **{**kw, "steps": 1})
    kink = min(smallest) < 1e-6
    a, b = ranks[0][0], ranks[1][0]
    assert a["losses"] == b["losses"]
    np.testing.assert_allclose(a["losses"], [s["loss"] for s in one.timings["steps"]], rtol=1e-5)
    assert any("saved params" in m for m in a["logs"]) and b["logs"] == []
    to_tree = _to_tree("ecapa")
    sd = one.model.state_dict()
    want_g = _leaves(to_tree({**sd, **{n: p.grad for n, p in one.model.named_parameters()}}))
    got_g = _leaves(to_tree({**sd, **a["grads"]}))
    exempt = {}
    for k, g in want_g.items():
        if not k.startswith("params/"):
            continue
        floor = max(GRAD_RTOL * float(np.abs(g).max()), GRAD_ATOL)
        miss = np.abs(got_g[k] - g) > floor
        if kink:
            rel = float(np.linalg.norm((got_g[k] - g)[miss]) / np.linalg.norm(g))
            assert rel <= KINK_GRAD_RTOL, (k, rel)
        else:
            assert not miss.any(), k
        exempt[k] = (np.abs(g) <= floor) | miss
    raw = (d / "tp.msgpack").read_bytes()
    restored = flax.serialization.msgpack_restore(raw)
    assert flax.serialization.to_bytes(restored) == raw  # the JAX trainer's writer's bytes
    got, want = _leaves(restored), _leaves(read_msgpack(tmp_path / "one.msgpack"))
    assert got.keys() == want.keys() and len(got) == 192
    for k, w in want.items():
        diff = np.abs(got[k] - w)
        ex = exempt.get(k, np.zeros(w.shape, bool))
        assert diff[~ex].max(initial=0.0) <= PARAM_RTOL * max(float(np.abs(w).max()), 1.0), k
        assert diff[ex].max(initial=0.0) <= EXEMPT_BOUND, k
    assert exempt[f"params/{ZERO_GRAD_LEAF}"].all()
    emb = TpuBackend(channels=32, params_path=d / "tp.msgpack").embed_waveform(
        np.sin(np.arange(16000) * 0.05).astype(np.float32))
    assert emb.shape == (192,) and np.isfinite(emb).all()


def test_crash_resume_crosses_mesh_shapes(train_runs, tmp_path, f32_train):
    """A ``data=2`` run's step-2 checkpoint (the whole state) restores at
    ``data=1,model=2``: the run logs the restore of step 2, ends at step 3,
    and its step's loss is that of the same continuation without a group
    within 1e-5 relative."""
    d, kw, ranks = train_runs
    resumed = ranks[0][2]
    assert any("restored full train state" in m and "(step 2)" in m for m in resumed["logs"])
    assert resumed["step"] == ranks[1][2]["step"] == 3
    ck = tmp_path / "ck"
    shutil.copytree(d / "ck", ck)
    one, _ = training.train(out_path=tmp_path / "r.msgpack", ckpt_dir=ck, ckpt_every=0,
                            log=lambda m: None, **{**kw, "steps": 1})
    assert one.step == 3
    np.testing.assert_allclose(resumed["losses"], [one.timings["steps"][0]["loss"]], rtol=1e-5)


@pytest.mark.parametrize("call,model_name", [(3, "xvector"), (4, "conformer")])
def test_train_other_towers_on_model_axis(train_runs, tmp_path, f32_train, call, model_name):
    """``train(model_name=...)`` with a model axis takes its step: the loss
    is the unsharded run's within 1e-5 relative, and the file is whole."""
    d, kw, ranks = train_runs
    got = ranks[0][call]
    one, out = training.train(out_path=tmp_path / "one.msgpack", log=lambda m: None,
                              **{**kw, "steps": 1, "model_name": model_name})
    np.testing.assert_allclose(got["losses"], [one.timings["steps"][0]["loss"]], rtol=1e-5)
    assert got["losses"] == ranks[1][call]["losses"]
    want = _leaves(read_msgpack(out))
    assert _leaves(read_msgpack(Path(got["out"]))).keys() == want.keys()
