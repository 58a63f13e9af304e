"""The port's training step (sdtk_tpu_torch/parallel/train.py, train-mode
BatchNorm in models/ecapa.py) against the JAX package's
(sdtk_tpu/parallel/train.py, flax's ``nn.BatchNorm``, ``optax.adamw``):
the AAM-softmax loss and its gradient, BatchNorm's batch statistics and
running update, AdamW, and whole steps of a small ECAPA and x-vector
carried across from JAX's ``create_train_state``.  Tolerances are stated
in each test."""

from __future__ import annotations

import copy
from functools import partial

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sdtk_tpu.models.conformer import Conformer as JaxConformer
from sdtk_tpu.models.conformer import ConformerConfig as JaxConformerConfig
from sdtk_tpu.models.ecapa import EcapaConfig as JaxEcapaConfig
from sdtk_tpu.models.ecapa import EcapaTdnn as JaxEcapa
from sdtk_tpu.models.xvector import XVector as JaxXVector
from sdtk_tpu.models.xvector import XVectorConfig as JaxXVectorConfig
from sdtk_tpu.parallel import train as jax_train
from sdtk_tpu_torch.models.conformer import Conformer, ConformerConfig
from sdtk_tpu_torch.models.ecapa import BatchNorm, EcapaConfig, EcapaTdnn
from sdtk_tpu_torch.models.xvector import XVector, XVectorConfig
from sdtk_tpu_torch.parallel.train import (AdamW, TrainConfig, TrainState, aam_softmax_loss,
                                           make_optimizer, train_step)
from sdtk_tpu_torch.utils.checkpoint import (conformer_jax_tree, conformer_state_dict,
                                             ecapa_jax_tree, ecapa_state_dict)

SMALL_ECAPA = {"channels": 32, "scale": 4, "mfa_channels": 96, "attention_channels": 16,
               "se_bottleneck": 16, "emb_dim": 16}
SMALL_XVECTOR = {"channels": 32, "pre_pool_channels": 48, "emb_dim": 16}
SMALL_CONFORMER = {"dim": 32, "n_blocks": 2, "n_heads": 4, "conv_kernel": 7, "emb_dim": 16,
                   "attention_channels": 16}
N_CLASSES = 64
# Softmax over time is unchanged by a per-channel shift of its logits, so
# the gradient of attention's second bias is zero in exact arithmetic and
# rounding noise in either package; Adam's normalized step then moves it by
# up to ±lr with a sign neither package determines.
ZERO_GRAD_LEAF = "asp/att2/bias"


def _aam_inputs():
    """Rows chosen to reach every branch of the loss: the label's cosine
    exactly 1 and exactly -1 (sin clamped at 1e-6, no gradient through it),
    0.999 and -0.999 (sin small, gradient amplified), exactly 0 (the
    margin's ``cos > 0`` guard), and generic rows of either sign."""
    rng = np.random.default_rng(0)
    d, c = 8, 5
    w = rng.standard_normal((c, d)).astype(np.float32)
    w[0] = 0.0
    w[0, 0] = 2.0  # unit direction e0, exactly representable after normalizing
    w[1] = 0.0
    w[1, 1] = 0.5  # e1
    e = rng.standard_normal((8, d)).astype(np.float32)
    labels = np.array([0, 0, 2, 1, 3, 4, 2, 0])
    e[0] = 0.0
    e[0, 0] = 3.0  # cos(e, w0) = 1 exactly
    e[1] = 0.0
    e[1, 0] = -1.5  # cos = -1 exactly
    e[2] = w[2] / np.linalg.norm(w[2]) + 0.045 * e[2] / np.linalg.norm(e[2])  # cos ≈ 0.999
    e[3] = 0.0
    e[3, 0] = 1.0  # cos(e, w1) = 0 exactly
    e[4] = -w[3] / np.linalg.norm(w[3]) + 0.045 * e[4] / np.linalg.norm(e[4])  # cos ≈ -0.999
    e[5] = -w[4] + 0.3 * e[5]  # generic, negative
    return e, w, labels


def test_aam_softmax_loss_and_gradient_match_jax():
    """Loss, accuracy and both gradients: max|Δ| ≤ 1e-6 (+1e-6 relative)."""
    e, w, labels = _aam_inputs()

    def jax_loss(e_, w_):
        return jax_train.aam_softmax_loss(e_, w_, jnp.asarray(labels), 0.2, 30.0)

    (want_loss, want_acc), (want_ge, want_gw) = jax.value_and_grad(
        jax_loss, argnums=(0, 1), has_aux=True)(jnp.asarray(e), jnp.asarray(w))
    et = torch.tensor(e, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    loss, acc = aam_softmax_loss(et, wt, torch.from_numpy(labels), 0.2, 30.0)
    loss.backward()
    cos = (torch.nn.functional.normalize(et, dim=-1) @ torch.nn.functional.normalize(wt, dim=-1).T)
    picked = cos[torch.arange(8), torch.from_numpy(labels)].detach().numpy()
    assert picked[0] == 1.0 and picked[1] == -1.0 and picked[3] == 0.0
    assert 0.998 < picked[2] < 1.0 and -1.0 < picked[4] < -0.998 and picked[5] < 0
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-6, atol=1e-6)
    assert float(acc) == float(want_acc)
    np.testing.assert_allclose(et.grad.numpy(), np.asarray(want_ge), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(want_gw), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shape", [(4, 30, 12), (6, 20)], ids=["frames", "pooled"])
def test_batchnorm_train_mode_matches_flax(shape):
    """One train-mode call from non-trivial running statistics: output,
    updated running mean and var (momentum 0.99, biased var), and the input
    and parameter gradients equal flax's within 1e-6."""
    rng = np.random.default_rng(1)
    c = shape[-1]
    x = (rng.standard_normal(shape) * 2.0 + 0.7).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rng.standard_normal(c).astype(np.float32)
    r_mean = rng.standard_normal(c).astype(np.float32)
    r_var = rng.uniform(0.5, 2.0, c).astype(np.float32)
    probe = rng.standard_normal(shape).astype(np.float32)

    bn = fnn.BatchNorm(use_running_average=False, dtype=jnp.float32)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": r_mean, "var": r_var}}

    def f(params, xx):
        y, upd = bn.apply({"params": params, "batch_stats": variables["batch_stats"]}, xx,
                          mutable=["batch_stats"])
        return (y * probe).sum(), (y, upd["batch_stats"])

    (_, (want_y, want_stats)), (want_gp, want_gx) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(variables["params"], jnp.asarray(x))

    mod = BatchNorm(c)
    with torch.no_grad():
        mod.weight.copy_(torch.from_numpy(scale))
        mod.bias.copy_(torch.from_numpy(bias))
        mod.running_mean.copy_(torch.from_numpy(r_mean))
        mod.running_var.copy_(torch.from_numpy(r_var))
    xt = torch.tensor(np.moveaxis(x, -1, 1).copy(), requires_grad=True)  # channels first
    y = mod.train()(xt)
    (y * torch.from_numpy(np.moveaxis(probe, -1, 1).copy())).sum().backward()
    tol = {"rtol": 1e-6, "atol": 1e-6}
    np.testing.assert_allclose(np.moveaxis(y.detach().numpy(), 1, -1), want_y, **tol)
    np.testing.assert_allclose(mod.running_mean.numpy(), want_stats["mean"], **tol)
    np.testing.assert_allclose(mod.running_var.numpy(), want_stats["var"], **tol)
    np.testing.assert_allclose(np.moveaxis(xt.grad.numpy(), 1, -1), want_gx, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(mod.weight.grad.numpy(), want_gp["scale"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(mod.bias.grad.numpy(), want_gp["bias"], rtol=1e-5, atol=1e-5)


def test_adamw_matches_optax():
    """The port's AdamW (betas 0.9/0.999, eps 1e-8, weight decay 2e-5 on
    every tensor) against ``optax.adamw(1e-3, weight_decay=2e-5)`` over 5
    steps of random gradients: |Δ| ≤ 1e-7 + 1e-7·|p| (XLA may fuse a
    multiply-add that torch rounds twice; one f32 ulp is 1.19e-7 at
    |p| = 1).  ``torch.optim.AdamW`` misses this by 4.8e-7: its decay
    factor 1 − lr·wd rounds to 1.0 in float32."""
    rng = np.random.default_rng(2)
    shapes = {"a": (7, 5), "b": (3,), "c": (2, 3, 4)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32) * 10.0 ** rng.uniform(-4, 1)
              for k, s in shapes.items()} for _ in range(5)]
    tx = optax.adamw(1e-3, weight_decay=2e-5)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    opt_state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = AdamW(list(tp.values()), lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=2e-5)
    for g in grads:
        updates, opt_state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        for k in shapes:
            np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                       rtol=1e-7, atol=1e-7)


def _batch(seed: int, b: int = 16, t: int = 60):
    """Features and a mask with padded frames in half the rows, and labels
    over the JAX trainer's default 64 classes."""
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((b, t, 80)).astype(np.float32)
    lengths = rng.integers(30, t + 1, b)
    lengths[::2] = t
    mask = np.arange(t)[None, :] < lengths[:, None]
    feats = feats * mask[..., None]
    return feats, mask, rng.integers(0, N_CLASSES, b)


def _jax_grads(state, feats, mask, labels, cfg):
    """The gradient JAX's ``train_step`` takes: its ``loss_fn``, as written
    there."""
    def loss_fn(trainable):
        emb, _ = state.apply_fn({"params": trainable["params"], "batch_stats": state.batch_stats},
                                feats, mask=mask, train=True, mutable=["batch_stats"])
        return jax_train.aam_softmax_loss(emb, trainable["aam"], labels, cfg.margin, cfg.scale)[0]

    return jax.grad(loss_fn)({"params": state.params, "aam": state.aam_weights})


def _jax_runs(jax_model, n_steps: int, batches, linear_outputs: bool = True):
    """JAX's create_train_state(PRNGKey(0)), then n_steps jitted train steps
    from it on each of ``batches``: the initial state and, for each batch,
    (loss, acc, gradient, state after, Conv and Dense outputs, or None
    without ``linear_outputs``) for each step."""
    tcfg = jax_train.TrainConfig(n_classes=N_CLASSES, emb_dim=16)
    state0 = jax_train.create_train_state(jax_model, jax.random.PRNGKey(0), tcfg,
                                          jnp.zeros((1, batches[0][0].shape[1], 80)))
    step = jax.jit(partial(jax_train.train_step, cfg=tcfg))
    grad = jax.jit(partial(_jax_grads, cfg=tcfg))
    linear = jax.jit(partial(_linear_outputs, jax_model))
    init = jax.device_get((state0.params, state0.batch_stats, state0.aam_weights))
    runs = []
    for batch in batches:
        args = tuple(jnp.asarray(a) for a in batch)
        state, out = state0, []
        for _ in range(n_steps):
            g = jax.device_get(grad(state, *args))
            pre = None
            if linear_outputs:
                pre = linear({"params": state.params, "batch_stats": state.batch_stats},
                             args[0], args[1])
                pre = {k.removesuffix("/__call__"): v[0] for k, v in _leaves(pre).items()}
            state, m = step(state, *args)
            out.append((float(m["loss"]), float(m["acc"]), g,
                        jax.device_get((state.params, state.batch_stats, state.aam_weights)), pre))
        runs.append(out)
    return init, runs


def _port_state(model, init, to_state_dict=ecapa_state_dict) -> TrainState:
    params, stats, aam = init
    model.load_state_dict(to_state_dict({"params": params, "batch_stats": stats}))
    aam_w = torch.nn.Parameter(torch.from_numpy(np.array(aam, np.float32)))
    cfg = TrainConfig(n_classes=N_CLASSES, emb_dim=16)
    return TrainState(model, aam_w, make_optimizer(model, aam_w, cfg))


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, np.float32)
    return out


# A gradient element within the rounding noise of the two packages' sums
# has a sign neither determines, and Adam's normalized first steps turn it
# into ±lr; the noise stays in both packages' moments after that step.  The
# floor of that noise, per leaf: 1e-4 of the leaf's largest |g|, and 2e-6
# where a whole leaf's gradient is noise (attention's second bias: softmax
# over time ignores a per-channel shift).  Each step holds every element of
# the port's gradient within this floor of JAX's, so the floor is checked,
# not assumed: above it the two signs agree, and no element's gradient,
# exempt or not, can be wrong by more than the floor.
GRAD_RTOL = 1e-4
GRAD_ATOL = 2e-6
# A ReLU input within rounding of zero can take one side in each package
# (a kink): the frame's term drops out of one package's gradient for
# everything upstream of it.  At such a step the elements the floor misses
# join the exempt ones, and what they miss by is held to 2 % of their
# leaf's norm instead.
KINK_GRAD_RTOL = 2e-2
# Two Adam updates of opposite sign: |m̂/√v̂| ≤ 1.0036 at steps 1-3 for
# β = (0.9, 0.999) (Cauchy-Schwarz over the step weights), plus the decay.
EXEMPT_BOUND = 2 * 1e-3 * 1.01


def _linear_outputs(jax_model, variables, feats, mask):
    """Every Conv and Dense output of JAX's train-mode forward, by flax
    path."""
    _, upd = jax_model.apply(
        variables, feats, mask=mask, train=True, mutable=["batch_stats", "intermediates"],
        capture_intermediates=lambda mdl, _: isinstance(mdl, (fnn.Conv, fnn.Dense)))
    return upd["intermediates"]


def _sign_flips(model, feats, mask, want: dict) -> int:
    """How many Conv and Dense outputs of the port's train-mode forward have
    another sign than JAX's (``want``: flax path → output), ReLU inputs
    among them.  Runs on a copy, so the running statistics stay as they
    are."""
    copied = copy.deepcopy(model).train()
    got = {}
    for name, mod in copied.named_modules():
        if type(mod).__name__ in ("Conv", "Dense"):
            mod.register_forward_hook(
                lambda m, i, out, key=name.replace(".", "/"): got.__setitem__(key, out))
    with torch.no_grad():
        copied(torch.from_numpy(feats), torch.from_numpy(mask))
    assert got.keys() == want.keys()
    flips = 0
    for key, out in got.items():
        out = out.numpy()
        out = np.moveaxis(out, 1, -1) if out.ndim == 3 else out  # JAX: channels last
        flips += int((np.sign(out) != np.sign(want[key])).sum())
    return flips


def _check_step(state: TrainState, want, want_grads, exempt: dict, atol: float,
                where: str, kink: bool = False,
                convert=(ecapa_jax_tree, ecapa_state_dict)) -> None:
    """Holds the port's step to JAX's, from the same parameters and
    statistics: every gradient element within its leaf's noise floor of
    JAX's; every parameter and AAM element within ``atol``, but those whose
    JAX gradient was below the floor at this step or an earlier one
    (``exempt``, updated here), which are held to ``EXEMPT_BOUND``;
    batch_stats within ``atol``.  At a ``kink`` step (``_sign_flips``) the
    elements whose gradient misses the floor are exempt too, and what they
    miss by is held to ``KINK_GRAD_RTOL`` of their leaf's norm.  Then loads
    JAX's parameters, AAM weights and statistics, so that the next step
    starts from the same state (the port's optimizer moments carry over).
    ``convert`` is the tower's (state dict → flax tree, flax tree → state
    dict) pair."""
    to_tree, to_state_dict = convert
    model = state.model
    sd = model.state_dict()
    tree = to_tree(sd)
    grads = {n: p.grad for n, p in model.named_parameters()}
    got_g = {**_leaves(to_tree({**sd, **grads})["params"]),
             "aam": state.aam_weights.grad.numpy()}
    want_g = {**_leaves(want_grads["params"]), "aam": np.asarray(want_grads["aam"])}
    params, stats, aam = want
    want_p = {**_leaves(params), "aam": np.asarray(aam)}
    got_p = {**_leaves(tree["params"]), "aam": state.aam_weights.detach().numpy()}
    assert got_g.keys() == want_g.keys() == got_p.keys() == want_p.keys()
    for k, wg in want_g.items():
        floor = max(GRAD_RTOL * float(np.abs(wg).max()), GRAD_ATOL)
        dg = np.abs(got_g[k] - wg)
        ex = exempt.get(k, False) | (np.abs(wg) <= floor)
        if kink:
            miss = dg > floor
            rel = float(np.linalg.norm(dg[miss]) / np.linalg.norm(wg))
            assert rel <= KINK_GRAD_RTOL, f"{where} {k}: gradient |Δ| {rel} of its norm"
            ex = ex | miss
        else:
            assert dg.max() <= floor, f"{where} {k}: gradient |Δ| {dg.max()} > {floor}"
        exempt[k] = ex
        d = np.abs(got_p[k] - want_p[k])
        assert d[~ex].max(initial=0.0) <= atol, f"{where} {k}: |Δ| {d[~ex].max()}"
        assert d[ex].max(initial=0.0) <= EXEMPT_BOUND, f"{where} {k}: exempt |Δ| {d.max()}"
    g_stats, w_stats = _leaves(tree["batch_stats"]), _leaves(stats)
    assert g_stats.keys() == w_stats.keys()
    for k in w_stats:
        np.testing.assert_allclose(g_stats[k], w_stats[k], rtol=0, atol=atol,
                                   err_msg=f"{where} batch_stats/{k}")
    model.load_state_dict(to_state_dict({"params": params, "batch_stats": stats}))
    with torch.no_grad():
        state.aam_weights.copy_(torch.from_numpy(np.array(aam, np.float32)))


ECAPA_SEEDS = tuple(range(10))


@pytest.fixture(scope="module")
def ecapa_f32_runs():
    batches = [_batch(seed) for seed in ECAPA_SEEDS]
    jax_model = JaxEcapa(JaxEcapaConfig(dtype="float32", **SMALL_ECAPA))
    return batches, _jax_runs(jax_model, 3, batches)


@pytest.mark.parametrize("n_steps", [1, 3])
def test_small_ecapa_steps_match_jax_f32(ecapa_f32_runs, n_steps):
    """A small ECAPA (channels 32, scale 4, MFA 96, attention 16, SE 16,
    emb 16, f32) from JAX's create_train_state(PRNGKey(0)), carried across,
    then n_steps steps on each of ten batches of 16 with padded frames
    (seeds 0-9), each step from JAX's parameters and statistics: each
    step's loss within 1e-5 relative, accuracy equal, gradient within the
    noise floor above, and params, AAM weights and batch_stats within 2e-5,
    the exempt elements within ``EXEMPT_BOUND``; at most one step in ten at
    a ReLU kink, held as ``_check_step`` says.

    Left to run free, the two trajectories part: Adam moves an element
    whose gradient is noise 2·lr apart, and later steps' gradients need not
    ignore it.  Even from one state, a ReLU input within rounding of zero
    can take one side in each package, so the gradient of everything
    upstream of its frame differs (seeds 4 and 9 at step 3 flip a sign;
    seed 4's moves a block-1 bias 2.5e-5 apart)."""
    batches, (init, jax_runs) = ecapa_f32_runs
    cfg = TrainConfig(n_classes=N_CLASSES, emb_dim=16)
    kinks = 0
    for seed, (feats, mask, labels), jax_steps in zip(ECAPA_SEEDS, batches, jax_runs):
        state = _port_state(EcapaTdnn(EcapaConfig(dtype="float32", **SMALL_ECAPA)), init)
        exempt: dict = {}
        for i in range(n_steps):
            want_loss, want_acc, want_grads, want_state, want_pre = jax_steps[i]
            kink = _sign_flips(state.model, feats, mask, want_pre) > 0
            kinks += kink
            m = train_step(state, torch.from_numpy(feats), torch.from_numpy(mask),
                           torch.from_numpy(labels), cfg)
            where = f"seed {seed} step {i + 1}"
            np.testing.assert_allclose(float(m["loss"]), want_loss, rtol=1e-5, err_msg=where)
            assert float(m["acc"]) == want_acc, where
            _check_step(state, want_state, want_grads, exempt, atol=2e-5, where=where, kink=kink)
            assert exempt[ZERO_GRAD_LEAF].all(), where
        assert state.step == n_steps
    assert kinks <= len(ECAPA_SEEDS) * n_steps // 10, f"{kinks} steps at a ReLU kink"
    # attention's second bias does not reach the output: moving it by the
    # bound leaves the embeddings unchanged
    state.model.eval()
    x, mk = torch.from_numpy(feats), torch.from_numpy(mask)
    with torch.no_grad():
        before = state.model(x, mk)
        bias = state.model.asp.att2.bias
        signs = torch.randn(bias.shape, generator=torch.Generator().manual_seed(0)).sign()
        bias.add_(EXEMPT_BOUND * signs)
        np.testing.assert_allclose(state.model(x, mk).numpy(), before.numpy(), rtol=0, atol=1e-5)


def test_small_ecapa_steps_bf16():
    """The same model with bf16 convolutions on both sides (f32 params,
    BatchNorm and statistics): the loss of each of 2 steps within 2e-2
    relative (measured 5.4e-4 and 2.3e-3).  bf16 rounding puts many more
    gradients within noise of zero than f32 does, and Adam gives those a
    sign of their own in each package: by a third step the losses run
    0.1-2.3 % apart (seeds 3 and 4)."""
    feats, mask, labels = _batch(4)
    init, (jax_steps,) = _jax_runs(JaxEcapa(JaxEcapaConfig(dtype="bfloat16", **SMALL_ECAPA)),
                                   2, [(feats, mask, labels)])
    state = _port_state(EcapaTdnn(EcapaConfig(dtype="bfloat16", **SMALL_ECAPA)), init)
    cfg = TrainConfig(n_classes=N_CLASSES, emb_dim=16)
    for want_loss, *_ in jax_steps:
        m = train_step(state, torch.from_numpy(feats), torch.from_numpy(mask),
                       torch.from_numpy(labels), cfg)
        np.testing.assert_allclose(float(m["loss"]), want_loss, rtol=2e-2)


def test_small_xvector_step_matches_jax():
    """One step of a small x-vector (channels 32, 48 before pooling, emb 16,
    f32) from JAX's init, on three batches (seeds 5-7): loss within 1e-5
    relative, accuracy equal, and the gradient, params, AAM weights and
    batch_stats held as the ECAPA steps are, at 2e-5."""
    batches = [_batch(seed) for seed in (5, 6, 7)]
    init, jax_runs = _jax_runs(JaxXVector(JaxXVectorConfig(dtype="float32", **SMALL_XVECTOR)),
                               1, batches)
    cfg = TrainConfig(n_classes=N_CLASSES, emb_dim=16)
    for seed, (feats, mask, labels), ((want_loss, want_acc, want_grads, want_state, want_pre),) \
            in zip((5, 6, 7), batches, jax_runs):
        state = _port_state(XVector(XVectorConfig(dtype="float32", **SMALL_XVECTOR)), init)
        kink = _sign_flips(state.model, feats, mask, want_pre) > 0
        m = train_step(state, torch.from_numpy(feats), torch.from_numpy(mask),
                       torch.from_numpy(labels), cfg)
        np.testing.assert_allclose(float(m["loss"]), want_loss, rtol=1e-5)
        assert float(m["acc"]) == want_acc
        _check_step(state, want_state, want_grads, {}, atol=2e-5, where=f"seed {seed}",
                    kink=kink)


@pytest.fixture(scope="module")
def conformer_f32_runs():
    batches = [_batch(seed) for seed in (0, 1, 2)]
    jax_model = JaxConformer(JaxConformerConfig(dtype="float32", **SMALL_CONFORMER))
    return batches, _jax_runs(jax_model, 3, batches, linear_outputs=False)


@pytest.mark.parametrize("n_steps", [1, 3])
def test_small_conformer_steps_match_jax_f32(conformer_f32_runs, n_steps):
    """A small Conformer (dim 32, 2 blocks, 4 heads, kernel 7, emb 16, f32)
    from JAX's create_train_state(PRNGKey(0)), carried across by
    ``conformer_state_dict``, then n_steps steps on each of three batches of
    16 with padded frames (seeds 0-2), each step from JAX's parameters and
    statistics, held as the ECAPA steps are: loss within 1e-5 relative,
    accuracy equal, every gradient element within its leaf's noise floor,
    params, AAM weights and batch_stats within 2e-5, exempt elements within
    ``EXEMPT_BOUND``.  The tower has no ReLU, so no step sits at a kink.
    Besides attention-pooling's second bias, the key projection's bias has
    a gradient of rounding noise only (softmax over keys ignores a shift
    shared by every key): both are exempt at the first step."""
    batches, (init, jax_runs) = conformer_f32_runs
    cfg = TrainConfig(n_classes=N_CLASSES, emb_dim=16)
    convert = (conformer_jax_tree, conformer_state_dict)
    for seed, (feats, mask, labels), jax_steps in zip((0, 1, 2), batches, jax_runs):
        state = _port_state(Conformer(ConformerConfig(dtype="float32", **SMALL_CONFORMER)),
                            init, conformer_state_dict)
        exempt: dict = {}
        for i in range(n_steps):
            want_loss, want_acc, want_grads, want_state, _ = jax_steps[i]
            m = train_step(state, torch.from_numpy(feats), torch.from_numpy(mask),
                           torch.from_numpy(labels), cfg)
            where = f"seed {seed} step {i + 1}"
            np.testing.assert_allclose(float(m["loss"]), want_loss, rtol=1e-5, err_msg=where)
            assert float(m["acc"]) == want_acc, where
            _check_step(state, want_state, want_grads, exempt, atol=2e-5, where=where,
                        convert=convert)
            assert exempt[ZERO_GRAD_LEAF].all(), where
            for b in range(2):
                assert exempt[f"block{b}/mhsa/MultiHeadDotProductAttention_0/key/bias"].all()
        assert state.step == n_steps
