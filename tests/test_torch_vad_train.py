"""The port's VAD trainer (sdtk_tpu_torch/evals/train_vad.py, VadNet in
sdtk_tpu_torch/models/vad.py, the VAD converters in utils/checkpoint.py)
against the JAX script (evals/train_vad.py, imported by path) and the
flax ``VadNet``: the batches bit for bit, the forward pass from JAX's
init, whole Adam steps on the same batches from the same parameters, and
the written file byte for byte.  Tolerances are stated in each test."""

from __future__ import annotations

import contextlib
import hashlib
import importlib.util
import io
import json
from pathlib import Path

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sdtk_tpu.models import vad as jax_vad
from sdtk_tpu.ops import fbank as jax_fbank
from sdtk_tpu_torch.evals import train_vad
from sdtk_tpu_torch.models.vad import VadConfig, VadNet, VadScorer, save_params
from sdtk_tpu_torch.ops import fbank_wave
from sdtk_tpu_torch.ops.fbank import FrontendConfig
from sdtk_tpu_torch.utils.checkpoint import vad_jax_tree, vad_state_dict

REPO = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location("jax_train_vad", REPO / "evals" / "train_vad.py")
jax_script = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jax_script)

N_FRAMES = FrontendConfig().num_frames(train_vad.N)  # 148


def test_constants_match_the_jax_script():
    assert (train_vad.SR, train_vad.WIN_S, train_vad.N, train_vad.BED_SNR_LO) == (
        jax_script.SR, jax_script.WIN_S, jax_script.N, jax_script.BED_SNR_LO)
    assert N_FRAMES == 148


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_windows_bit_equal(seed):
    """speech_window, nonspeech_window and composite_window: the same
    samples, labels and generator state after each draw (exact)."""
    for fn in ("speech_window", "nonspeech_window"):
        a, b = np.random.default_rng(seed), np.random.default_rng(seed)
        for _ in range(3):
            np.testing.assert_array_equal(getattr(train_vad, fn)(a), getattr(jax_script, fn)(b))
        assert a.bit_generator.state == b.bit_generator.state
    a, b = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(3):
        (wa, la), (wb, lb) = (train_vad.composite_window(a, N_FRAMES),
                              jax_script.composite_window(b, N_FRAMES))
        np.testing.assert_array_equal(wa, wb)
        np.testing.assert_array_equal(la, lb)
        assert wa.dtype == wb.dtype and la.dtype == lb.dtype


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_make_batch_bit_equal(seed):
    """make_batch at batch 8, twice from one generator: exact."""
    a, b = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(2):
        (wa, la), (wb, lb) = train_vad.make_batch(a, 8, N_FRAMES), jax_script.make_batch(b, 8, N_FRAMES)
        assert wa.shape == (8, train_vad.N) and la.shape == (8, N_FRAMES)
        np.testing.assert_array_equal(wa, wb)
        np.testing.assert_array_equal(la, lb)


def _jax_init(cfg_kw: dict, seed: int, t: int = 148):
    jcfg = jax_vad.VadConfig(**cfg_kw)
    model = jax_vad.VadNet(jcfg)
    params = model.init(jax.random.PRNGKey(seed), jnp.zeros((2, t, jcfg.n_mels)))
    return model, params


def _port(cfg_kw: dict, params) -> VadNet:
    net = VadNet(VadConfig(**cfg_kw))
    net.load_state_dict(vad_state_dict(jax.tree.map(np.asarray, params)))
    return net


@pytest.mark.parametrize("arch", ["v3", "v4"])
def test_vadnet_matches_flax(arch):
    """n_mels 24, channels 8, JAX's init carried across: logits within
    1e-5 of flax's ``apply``; the port's own init has the tree's names and
    shapes."""
    kw = {"n_mels": 24, "channels": 8, "deep": arch == "v4", "extra_feats": arch == "v4"}
    model, params = _jax_init(kw, seed=3, t=40)
    x = np.random.default_rng(5).standard_normal((3, 40, 24)).astype(np.float32)
    want = np.asarray(model.apply(params, jnp.asarray(x)))
    net = _port(kw, params)
    got = net(torch.from_numpy(x)).detach().numpy()
    assert got.shape == (3, 40)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    own = VadNet(VadConfig(**kw))
    own.reset_parameters(torch.Generator().manual_seed(0))
    shapes = jax.tree.map(lambda a: a.shape, vad_jax_tree(own.state_dict()))
    assert shapes == jax.tree.map(lambda a: a.shape, jax.tree.map(np.asarray, params))


def _jax_step(model, fcfg, tx, pos_weight: float):
    """The JAX script's jitted step (evals/train_vad.py:155-174)."""

    @jax.jit
    def step(params, opt_state, wavs, labels):
        feats, mask = jax_fbank.log_mel(wavs, fcfg)

        def loss_fn(p):
            logits = model.apply(p, feats)
            per = optax.sigmoid_binary_cross_entropy(logits, labels)
            w = 1.0 + (pos_weight - 1.0) * labels
            return (per * w * mask).sum() / jnp.maximum((w * mask).sum(), 1.0)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss, grads

    return step


def _jax_update(model, tx, pos_weight: float):
    """The JAX script's step after its frontend: the same loss, gradients
    and optax update, on features given to it."""

    @jax.jit
    def update(params, opt_state, feats, mask, labels):
        def loss_fn(p):
            logits = model.apply(p, feats)
            per = optax.sigmoid_binary_cross_entropy(logits, labels)
            w = 1.0 + (pos_weight - 1.0) * labels
            return (per * w * mask).sum() / jnp.maximum((w * mask).sum(), 1.0)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss, grads

    return update


def _seat(net: VadNet, opt, params, opt_state) -> None:
    """Load JAX's parameters and Adam state (count, mu, nu) into the port's
    net and optimizer."""
    adam = opt_state[0]
    state = {n: jax.tree.map(np.asarray, t) for n, t in
             (("p", params), ("mu", {"params": adam.mu["params"]}),
              ("nu", {"params": adam.nu["params"]}))}
    sd = {n: vad_state_dict(t) for n, t in state.items()}
    with torch.no_grad():
        for name, p in net.named_parameters():
            p.copy_(sd["p"][name])
            if p in opt.state or int(adam.count) > 0:
                opt.state[p]["exp_avg"] = sd["mu"][name].clone()
                opt.state[p]["exp_avg_sq"] = sd["nu"][name].clone()
    opt.param_groups[0]["step"] = int(adam.count)


def _run_both(dtype: str, steps: int, seed: int = 0, batch: int = 4, reseat: bool = False,
              jax_feats: bool = False):
    """``steps`` steps of the full-width v4 net in both packages from JAX's
    init, on the same batches.  The port takes ``vad_step`` (K1's plain
    version featurizes), or with ``jax_feats`` ``vad_update`` on the
    features JAX's step makes inside (``fbank.log_mel``).  With ``reseat``
    each port step starts from JAX's state before it (parameters and Adam
    moments), so each step is held alone.  Returns (JAX losses, port
    losses, [(JAX params, JAX grads, port params, port grads) after each
    step], flax trees)."""
    kw = {"n_mels": 80, "deep": True, "extra_feats": True}
    model, params = _jax_init(kw, seed)
    net = _port(kw, params)
    jfcfg = jax_fbank.FrontendConfig(compute_dtype=dtype)
    fcfg = FrontendConfig(compute_dtype=dtype)
    tx = optax.adam(1e-3)
    opt_state = tx.init(params)
    opt = train_vad.make_optimizer(net, 1e-3)
    step = _jax_step(model, jfcfg, tx, 2.0)
    rng = np.random.default_rng(seed)
    jl, tl, after = [], [], []
    cpu = torch.device("cpu")
    for _ in range(steps):
        wavs, labels = train_vad.make_batch(rng, batch, N_FRAMES)
        if reseat:
            _seat(net, opt, params, opt_state)
        params, opt_state, loss, grads = step(params, opt_state, jnp.asarray(wavs),
                                              jnp.asarray(labels))
        jl.append(float(loss))
        if jax_feats:
            feats, mask = jax_fbank.log_mel(jnp.asarray(wavs), jfcfg)
            loss = train_vad.vad_update(net, opt, torch.from_numpy(np.array(feats)),
                                        torch.from_numpy(np.array(mask)),
                                        torch.from_numpy(labels), 2.0)
        else:
            loss = train_vad.vad_step(net, opt, wavs, labels, fcfg, 2.0, cpu)
        tl.append(float(loss))
        sd = net.state_dict()
        got_g = vad_jax_tree({**sd, **{n: p.grad for n, p in net.named_parameters()}})
        after.append((jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, grads),
                      vad_jax_tree(sd), got_g))
    return jl, tl, after


def _pairs(want: dict, got: dict):
    """(flax path, JAX leaf, port leaf) over the tree."""
    for path, a in jax.tree_util.tree_leaves_with_path(want):
        b = got
        for key in path:
            b = b[key.key]
        yield jax.tree_util.keystr(path), a, b


def _cos(a: np.ndarray, b: np.ndarray) -> float:
    a, b = a.ravel().astype(np.float64), b.ravel().astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


@pytest.mark.parametrize("steps", [1, 3])
def test_vad_update_f32_matches_jax(steps):
    """The net, loss and Adam of a step on JAX's own f32 features, each step
    from JAX's state: each step's loss within 1e-5 relative, every
    parameter within 2e-5 after each step (the bars of
    test_torch_train_step.py)."""
    jl, tl, after = _run_both("float32", steps, reseat=True, jax_feats=True)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    for want, _, got, _ in after:
        for where, a, b in _pairs(want, got):
            np.testing.assert_allclose(b, a, atol=2e-5, rtol=0, err_msg=where)


@pytest.mark.parametrize("steps", [1, 3])
def test_vad_step_f32_matches_jax(steps):
    """The whole step, K1's plain version featurizing at f32, each step from
    JAX's state: each step's loss within 1e-5 relative, every gradient leaf
    at cosine ≥ 0.999 with JAX's, and after the first step (Adam moves
    every element by ±lr) every parameter within 2e-5.

    The f32 frontends differ by up to ~2e-4 (test_torch_frontend.py), and
    the v4 net amplifies that in later steps: a near-silent frame whose
    ReLU outputs are nearly all zero gives a LayerNorm variance far below
    its ε = 1e-6, so rsqrt(var + ε) ~ 1e3 scales the difference, and
    conv1's gradient moves by a few % of its largest element (JAX's own
    step, fed the port's features, moves the same way:
    ``test_vad_step_f32_gap_is_the_frontend``).  Hence the cosine bar
    there; ``test_vad_update_f32_matches_jax`` holds the arithmetic after
    the frontend to the element."""
    jl, tl, after = _run_both("float32", steps, reseat=True)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    for i, (want, want_g, got, got_g) in enumerate(after):
        for where, a, b in _pairs(want_g, got_g):
            assert _cos(a, b) >= 0.999, f"step {i + 1} {where}: cosine {_cos(a, b)}"
        if i == 0:
            for where, a, b in _pairs(want, got):
                np.testing.assert_allclose(b, a, atol=2e-5, rtol=0, err_msg=where)


def test_vad_step_f32_gap_is_the_frontend():
    """The cause of the cosine bar above, pinned: 3 steps, each from JAX's
    state.  JAX's step fed the features of the port's whole ``vad_step``
    (K1's plain version, f32) gives the port's loss within 1e-5 relative,
    its gradients within 1e-5 of each leaf's largest element and its
    parameters within 2e-5; against JAX's step on its own features, each
    gradient leaf moves by the same share of its largest element in both
    (within 1e-4), and at step 2 conv1's kernel gradient moves by over 1 %."""
    kw = {"n_mels": 80, "deep": True, "extra_feats": True}
    model, params = _jax_init(kw, 0)
    net = _port(kw, params)
    jfcfg = jax_fbank.FrontendConfig(compute_dtype="float32")
    fcfg = FrontendConfig(compute_dtype="float32")
    tx = optax.adam(1e-3)
    opt_state = tx.init(params)
    opt = train_vad.make_optimizer(net, 1e-3)
    update = _jax_update(model, tx, 2.0)
    rng = np.random.default_rng(0)
    moved = []
    for i in range(3):
        wavs, labels = train_vad.make_batch(rng, 4, N_FRAMES)
        _seat(net, opt, params, opt_state)
        jax_feats = jax_fbank.log_mel(jnp.asarray(wavs), jfcfg)
        feats, mask = fbank_wave.log_mel_wave(torch.from_numpy(wavs), fcfg)
        port_feats = (jnp.asarray(feats.numpy()), jnp.asarray(mask.numpy()))
        own = update(params, opt_state, *jax_feats, jnp.asarray(labels))
        fed = update(params, opt_state, *port_feats, jnp.asarray(labels))
        loss = train_vad.vad_step(net, opt, wavs, labels, fcfg, 2.0, torch.device("cpu"))
        sd = net.state_dict()
        got_g = vad_jax_tree({**sd, **{n: p.grad for n, p in net.named_parameters()}})
        np.testing.assert_allclose(float(loss), float(fed[2]), rtol=1e-5)
        for where, a, b in _pairs(jax.tree.map(np.asarray, fed[0]), vad_jax_tree(sd)):
            np.testing.assert_allclose(b, a, atol=2e-5, rtol=0, err_msg=f"step {i + 1} {where}")
        fed_g = {w: a for w, a, _ in _pairs(jax.tree.map(np.asarray, fed[3]), got_g)}
        for where, a, b in _pairs(jax.tree.map(np.asarray, own[3]), got_g):
            top = np.abs(a).max()
            c = fed_g[where]
            assert np.abs(b - c).max() <= 1e-5 * top, f"step {i + 1} {where}"
            port_move, fed_move = np.abs(b - a).max() / top, np.abs(c - a).max() / top
            assert abs(port_move - fed_move) <= 1e-4, f"step {i + 1} {where}"
            if where == "['params']['conv1']['kernel']":
                moved.append(fed_move)
        params, opt_state = own[0], own[1]
    assert moved[1] > 0.01, moved


def test_vad_step_bf16_matches_jax():
    """bf16 features (the trainer's default): 3 steps' losses within 2e-2
    relative (K1's plain version rounds as JAX's einsum path does; the sums
    run in another order)."""
    jl, tl, _ = _run_both("bfloat16", 3)
    np.testing.assert_allclose(tl, jl, rtol=2e-2)


def test_saved_file_is_flax_bytes_and_serves_alike(tmp_path):
    """A JAX tree after one optax step (keys sorted, as the JAX trainer
    saves it), carried into the port and written by ``save_params``: the
    bytes equal ``flax.serialization.to_bytes`` of that tree, and both
    packages' ``VadScorer`` give equal ``frame_probs`` (exact) from it."""
    params = _run_both("float32", 1)[2][0][0]
    net = _port({"n_mels": 80, "deep": True, "extra_feats": True}, params)
    path = tmp_path / "vad.msgpack"
    save_params(net, path)
    assert path.read_bytes() == flax.serialization.to_bytes(params)
    feats = np.random.default_rng(2).standard_normal((148, 80)).astype(np.float32)
    want = jax_vad.VadScorer(path).frame_probs(feats)
    got = VadScorer(path).frame_probs(feats)
    np.testing.assert_array_equal(got, want)
    assert VadScorer(path).cfg.deep and VadScorer(path).cfg.extra_feats


def _models_digest() -> dict[str, str]:
    return {p.name: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((REPO / "models").iterdir()) if p.is_file()}


def test_cli_prints_the_jax_fields(tmp_path):
    """``--steps 2 --batch 4 --device cpu --out tmp``: one JSON line with
    the JAX script's five fields, the file written where asked, the exit
    code by the 0.9 bar, and nothing under ``models/`` changed."""
    before = _models_digest()
    out = tmp_path / "vad.msgpack"
    timings: dict = {}
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(io.StringIO()):
        rc = train_vad.main(["--steps", "2", "--batch", "4", "--device", "cpu",
                             "--out", str(out)], timings=timings)
    row = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert sorted(row) == sorted(["benchmark", "steps", "final_loss",
                                  "holdout_window_accuracy", "out"])
    assert row["benchmark"] == "train_vad" and row["steps"] == 2 and row["out"] == str(out)
    assert np.isfinite(row["final_loss"]) and 0.0 <= row["holdout_window_accuracy"] <= 1.0
    assert rc == (0 if row["holdout_window_accuracy"] >= 0.9 else 1)
    assert out.exists() and VadScorer(out).cfg.deep
    assert set(timings) == {"synth_s", "step_s", "loop_s"}
    assert _models_digest() == before


def test_cli_requires_out():
    with contextlib.redirect_stderr(io.StringIO()), pytest.raises(SystemExit) as e:
        train_vad.main(["--steps", "1", "--device", "cpu"])
    assert e.value.code == 2


def test_cli_defaults_to_cuda(tmp_path):
    """Without CUDA the default device raises; nothing is written."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_vad.main(["--steps", "1", "--out", str(tmp_path / "v.msgpack")])
    assert not (tmp_path / "v.msgpack").exists()
