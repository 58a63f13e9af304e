"""Data-parallel training in the port (sdtk_tpu_torch/parallel/train.py,
global BatchNorm statistics in models/ecapa.py, ``training.train`` with
``--mesh data=N``) on gloo ranks (CPU processes,
``tests/torch_dist_workers.py``): a 2-rank step on a global batch against
the one-device step on that batch and against JAX's
``make_distributed_step`` on a ``data=2`` mesh, with
``tests/test_torch_train_step.py``'s small ECAPA, batches, bars and
exemption rule.  Tolerances are stated in each test."""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_workers as workers
from sdtk_tpu.models.ecapa import EcapaConfig as JaxEcapaConfig
from sdtk_tpu.models.ecapa import EcapaTdnn as JaxEcapa
from sdtk_tpu.parallel import make_mesh
from sdtk_tpu.parallel import train as jax_train
from sdtk_tpu_torch import training
from sdtk_tpu_torch.models.ecapa import EcapaConfig, EcapaTdnn
from sdtk_tpu_torch.parallel.train import TrainConfig, train_step
from sdtk_tpu_torch.utils.checkpoint import ecapa_jax_tree, read_msgpack
from test_torch_train_step import (EXEMPT_BOUND, GRAD_ATOL, GRAD_RTOL, N_CLASSES, SMALL_ECAPA,
                                   ZERO_GRAD_LEAF, _batch, _check_step, _jax_grads, _leaves,
                                   _linear_outputs, _port_state, _sign_flips)

SEEDS = (0, 1, 2)
TINY = {"n_speakers": 4, "families": "0,1", "batch": 8, "seconds": 1.0, "crop_seconds": 1.0,
        "channels": 32, "log_every": 1, "device": "cpu"}


@pytest.fixture(scope="module")
def jax_init():
    """The batches (seeds 0-2, 16 rows with padded frames) and JAX's
    create_train_state(PRNGKey(0)) for the small f32 ECAPA."""
    batches = [_batch(seed) for seed in SEEDS]
    model = JaxEcapa(JaxEcapaConfig(dtype="float32", **SMALL_ECAPA))
    tcfg = jax_train.TrainConfig(n_classes=N_CLASSES, emb_dim=16)
    state0 = jax_train.create_train_state(model, jax.random.PRNGKey(0), tcfg,
                                          jnp.zeros((1, batches[0][0].shape[1], 80)))
    init = jax.device_get((state0.params, state0.batch_stats, state0.aam_weights))
    return batches, init, (model, tcfg, state0)


@pytest.fixture(scope="module")
def jax_steps(jax_init):
    """For each batch, from JAX's initial state: the gradient, the Conv and
    Dense outputs, and one ``make_distributed_step`` on a ``data=2`` mesh:
    (loss, acc, gradient, state after, outputs)."""
    batches, _, (model, tcfg, state0) = jax_init
    mesh = make_mesh("data=2", jax.devices()[:2])
    step = jax_train.make_distributed_step(mesh, tcfg)
    grad = jax.jit(partial(_jax_grads, cfg=tcfg))
    linear = jax.jit(partial(_linear_outputs, model))
    steps = []
    for batch in batches:
        args = tuple(jnp.asarray(a) for a in batch)
        g = jax.device_get(grad(state0, *args))
        pre = linear({"params": state0.params, "batch_stats": state0.batch_stats}, *args[:2])
        pre = {k.removesuffix("/__call__"): v[0] for k, v in _leaves(pre).items()}
        fresh = jax.tree_util.tree_map(jnp.copy, state0)  # the step donates its state
        state, m = step(jax_train.shard_state(fresh, mesh), *args)
        steps.append((float(m["loss"]), float(m["acc"]), g,
                      jax.device_get((state.params, state.batch_stats, state.aam_weights)), pre))
    return steps


_RUNS: dict = {}


@pytest.fixture(scope="module")
def rank_runs(jax_init):
    """world → every rank's step on each batch (one group per world size)."""
    batches, init, _ = jax_init
    payload = {"init": init, "batches": batches, "n_classes": N_CLASSES, "ecapa": SMALL_ECAPA}

    def get(world):
        if world not in _RUNS:
            _RUNS[world] = workers.run_ranks(world, "train_step_rank", payload)
        return _RUNS[world]

    yield get
    _RUNS.clear()


def _one_device_steps(batches, init) -> list:
    """The port's step without a group, on each whole batch, with the ranks'
    2 threads (the CPU kernels' sums can take another order at another
    thread count)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        return _steps(batches, init)
    finally:
        torch.set_num_threads(threads)


def _steps(batches, init) -> list:
    cfg = TrainConfig(n_classes=N_CLASSES, emb_dim=16)
    out = []
    for feats, mask, labels in batches:
        state = _port_state(EcapaTdnn(EcapaConfig(dtype="float32", **SMALL_ECAPA)), init)
        m = train_step(state, torch.from_numpy(feats), torch.from_numpy(mask),
                       torch.from_numpy(labels), cfg)
        out.append({"loss": float(m["loss"]), "acc": float(m["acc"]),
                    "state": state.model.state_dict(),
                    "aam": state.aam_weights.detach().numpy(),
                    "grads": {n: p.grad for n, p in state.model.named_parameters()},
                    "aam_grad": state.aam_weights.grad.numpy()})
    return out


def _grad_leaves(run: dict) -> dict:
    """A step's gradient by flax path, the AAM head's as ``aam``."""
    tree = ecapa_jax_tree({**run["state"], **run["grads"]})["params"]
    return {**_leaves(tree), "aam": run["aam_grad"]}


def test_ranks_hold_equal_parameters(rank_runs):
    """After the step both ranks hold the same parameters, statistics and
    AAM weights, bit for bit, and report the same global loss."""
    a, b = rank_runs(2)
    for x, y in zip(a, b):
        assert x["loss"] == y["loss"] and x["acc"] == y["acc"]
        assert all(torch.equal(x["state"][k], y["state"][k]) for k in x["state"])
        assert np.array_equal(x["aam"], y["aam"])


def test_group_of_one_is_the_one_device_step(rank_runs, jax_init):
    """A gloo group of one rank (the collectives run) gives the step without
    a group bit for bit: loss, accuracy, parameters, statistics."""
    batches, init, _ = jax_init
    (got,) = rank_runs(1)
    for x, y in zip(got, _one_device_steps(batches, init)):
        assert x["loss"] == y["loss"] and x["acc"] == y["acc"]
        assert all(torch.equal(x["state"][k], y["state"][k]) for k in y["state"])
        assert np.array_equal(x["aam"], y["aam"])


def test_two_rank_step_equals_one_device_step(rank_runs, jax_init):
    """2 ranks of 8 rows against one device with the 16: loss within 1e-6
    relative, accuracy equal; each gradient element within its leaf's noise
    floor (1e-4 of the leaf's largest |g|, at least 2e-6); parameters, AAM
    weights and BatchNorm statistics within 1e-6, except elements whose
    gradient is within that floor (Adam's first step moves them ±lr by the
    sign of rounding noise), held to 2·lr·1.01."""
    batches, init, _ = jax_init
    two = rank_runs(2)[0]
    for seed, x, y in zip(SEEDS, two, _one_device_steps(batches, init)):
        np.testing.assert_allclose(x["loss"], y["loss"], rtol=1e-6, err_msg=f"seed {seed}")
        assert x["acc"] == y["acc"]
        got_g, want_g = _grad_leaves(x), _grad_leaves(y)
        got_p = {**_leaves(ecapa_jax_tree(x["state"])["params"]), "aam": x["aam"]}
        want_p = {**_leaves(ecapa_jax_tree(y["state"])["params"]), "aam": y["aam"]}
        for k, wg in want_g.items():
            floor = max(GRAD_RTOL * float(np.abs(wg).max()), GRAD_ATOL)
            assert np.abs(got_g[k] - wg).max() <= floor, (seed, k)
            exempt = np.abs(wg) <= floor
            d = np.abs(got_p[k] - want_p[k])
            assert d[~exempt].max(initial=0.0) <= 1e-6, (seed, k, d[~exempt].max())
            assert d[exempt].max(initial=0.0) <= EXEMPT_BOUND, (seed, k)
        assert got_g[ZERO_GRAD_LEAF].shape == want_g[ZERO_GRAD_LEAF].shape
        g_stats = _leaves(ecapa_jax_tree(x["state"])["batch_stats"])
        w_stats = _leaves(ecapa_jax_tree(y["state"])["batch_stats"])
        for k in w_stats:
            np.testing.assert_allclose(g_stats[k], w_stats[k], rtol=0, atol=1e-6,
                                       err_msg=f"seed {seed} {k}")


def test_two_rank_step_matches_jax_data_mesh(rank_runs, jax_init, jax_steps):
    """The 2-rank step against JAX's ``make_distributed_step`` on a
    ``data=2`` mesh from the same state and global batch, held as
    ``tests/test_torch_train_step.py`` holds one step: loss within 1e-5
    relative, accuracy equal, every gradient element within its leaf's
    noise floor of JAX's, parameters, AAM weights and statistics within
    2e-5 but the exempt elements, within 2·lr·1.01; a step at a ReLU kink
    (a Conv or Dense output of another sign than JAX's) as ``_check_step``
    says."""
    batches, init, _ = jax_init
    two = rank_runs(2)[0]
    for seed, (feats, mask, _), x, want in zip(SEEDS, batches, two, jax_steps):
        want_loss, want_acc, want_grads, want_state, want_pre = want
        state = _port_state(EcapaTdnn(EcapaConfig(dtype="float32", **SMALL_ECAPA)), init)
        kink = _sign_flips(state.model, feats, mask, want_pre) > 0
        np.testing.assert_allclose(x["loss"], want_loss, rtol=1e-5, err_msg=f"seed {seed}")
        assert x["acc"] == want_acc
        state.model.load_state_dict(x["state"])
        for name, p in state.model.named_parameters():
            p.grad = x["grads"][name]
        with torch.no_grad():
            state.aam_weights.copy_(torch.from_numpy(x["aam"]))
        state.aam_weights.grad = torch.from_numpy(x["aam_grad"])
        exempt: dict = {}
        _check_step(state, want_state, want_grads, exempt, atol=2e-5, where=f"seed {seed}",
                    kink=kink)
        assert exempt[ZERO_GRAD_LEAF].all()


def test_train_on_two_ranks(tmp_path):
    """``training.train(mesh_spec="data=2")`` on 2 ranks against the same
    call on one device: each rank draws the global batch of 8 and steps on
    its 4 rows.  The first step's loss within 1e-6 relative, the second's
    within 1e-3 (after Adam's first step, elements whose gradient is
    rounding noise sit ±lr apart); the ranks end with equal parameters;
    rank 0 alone logs and writes the file, which both packages' readers
    load."""
    kw = {**TINY, "steps": 2, "seed": 5}
    ranks = workers.run_ranks(2, "train_rank", {"kw": {**kw, "mesh_spec": "data=2",
                                                       "out_path": str(tmp_path / "dp.msgpack")}})
    one, _ = training.train(out_path=tmp_path / "one.msgpack", log=lambda m: None, **kw)
    want = [s["loss"] for s in one.timings["steps"]]
    a, b = ranks
    assert a["losses"] == b["losses"]
    np.testing.assert_allclose(a["losses"][0], want[0], rtol=1e-6)
    np.testing.assert_allclose(a["losses"][1], want[1], rtol=1e-3)
    assert all(torch.equal(a["state"][k], b["state"][k]) for k in a["state"])
    assert a["step"] == b["step"] == 2
    assert any("saved params" in m for m in a["logs"]) and b["logs"] == []
    tree = read_msgpack(tmp_path / "dp.msgpack")
    assert set(tree) == {"params", "batch_stats"}


def test_train_conformer_on_two_ranks(tmp_path):
    """The Conformer (dim 32) trained with ``mesh_spec="data=2"`` on 2 ranks
    against one device: the conv module's BatchNorm takes the global
    batch's statistics (``sync_batchnorm``), so the first step's loss is
    within 1e-6 relative of one device's and the running statistics after
    it within 1e-6; the ranks end with equal parameters."""
    kw = {**TINY, "steps": 1, "seed": 3, "model_name": "conformer"}
    ranks = workers.run_ranks(2, "train_rank", {"kw": {**kw, "mesh_spec": "data=2",
                                                       "out_path": str(tmp_path / "dp.msgpack")}})
    one, _ = training.train(out_path=tmp_path / "one.msgpack", log=lambda m: None, **kw)
    a, b = ranks
    assert a["losses"] == b["losses"]
    np.testing.assert_allclose(a["losses"][0], one.timings["steps"][0]["loss"], rtol=1e-6)
    assert all(torch.equal(a["state"][k], b["state"][k]) for k in a["state"])
    for k, v in one.model.state_dict().items():
        if "running_" in k:
            np.testing.assert_allclose(a["state"][k].numpy(), v.numpy(), rtol=0, atol=1e-6,
                                       err_msg=k)


@pytest.mark.parametrize("mesh", ["model=2", "data=1,model=2"])
def test_model_axis_still_raises(mesh, tmp_path):
    """A model axis of 2 in a process without a group of 2 ranks raises
    before anything runs (``tests/test_torch_train_tp.py`` trains on 2)."""
    with pytest.raises(RuntimeError, match="process group of 2 ranks"):
        training.train(steps=1, mesh_spec=mesh, out_path=tmp_path / "x.msgpack", **TINY)
