"""The port's sequence-parallel attention (sdtk_tpu_torch/ops/ringattn.py)
and its ring collectives (``parallel/multihost.py``: ``ring_shift``,
``all_reduce_max``) on 1, 2 and 4 gloo ranks (CPU processes started by
``tests/torch_dist_workers.py``), against dense attention in NumPy, the
port's dense ``Conformer`` and the JAX package's ``ring_attention`` /
``conformer_sp_embed`` on a mesh of as many virtual CPU devices.  The
Conformer's weights are flax's init carried across by
``conformer_state_dict``, with BatchNorm statistics redrawn so that the
inference-mode BatchNorm is not the identity.  Tolerances are stated in
each test."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_workers as workers
from sdtk_tpu.models.conformer import Conformer as JaxConformer
from sdtk_tpu.models.conformer import ConformerConfig as JaxConformerConfig
from sdtk_tpu.ops import ringattn as jax_ringattn
from sdtk_tpu.parallel import make_mesh
from sdtk_tpu_torch.models.conformer import Conformer, ConformerConfig
from sdtk_tpu_torch.ops.ringattn import conformer_sp_embed, ring_attention, time_shard
from sdtk_tpu_torch.utils.checkpoint import conformer_state_dict

WORLDS = (1, 2, 4)
# tests/test_parallel.py's sequence-parallel case: kernel 15 (halo 7)
SP_CFG = {"dim": 64, "n_blocks": 2, "n_heads": 4, "emb_dim": 32, "attention_channels": 16,
          "dtype": "float32"}
T_SP = 160  # 13 padded frames at the tail
T_ODD = 161  # divides over 1 rank only


def _ring_inputs(seed: int, t: int = 64, h: int = 4, dh: int = 16):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((t, h, dh)).astype(np.float32) for _ in range(3))
    mask = rng.random(t) > 0.2
    mask[-9:] = False  # a whole masked block on the last rank at 4 ranks
    return q, k, v, mask


def _dense(q, k, v, mask):
    """tests/test_parallel.py's dense reference, in float64."""
    q, k, v = (a.astype(np.float64) for a in (q, k, v))
    logits = np.einsum("thd,shd->hts", q / np.sqrt(q.shape[-1]), k)
    logits = np.where(mask[None, None, :], logits, -1e30)
    w = np.exp(logits - logits.max(-1, keepdims=True))
    w /= w.sum(-1, keepdims=True)
    return np.einsum("hts,shd->thd", w, v)


def _variables(seed: int = 0) -> dict:
    """flax's init of the small Conformer, batch statistics redrawn."""
    model = JaxConformer(JaxConformerConfig(**SP_CFG))
    v = jax.tree_util.tree_map(np.asarray, model.init(jax.random.PRNGKey(seed),
                                                      jnp.zeros((1, 32, 80))))
    rng = np.random.default_rng(seed + 1)
    stats = jax.tree_util.tree_map_with_path(
        lambda p, x: (np.abs(rng.standard_normal(x.shape)) + 0.5 if p[-1].key == "var"
                      else 0.1 * rng.standard_normal(x.shape)).astype(np.float32),
        v["batch_stats"])
    return {"params": v["params"], "batch_stats": stats}


def _sp_inputs(t: int, seed: int = 7):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((t, 80)).astype(np.float32)
    return feats, np.arange(t) < T_SP - 13


@pytest.fixture(scope="module")
def cases():
    """Every case at every world size, one group of ranks per size."""
    variables = _variables()
    sd = conformer_state_dict(variables)
    payload = {"ring": {"whole": (*_ring_inputs(0), 1024), "blocks": (*_ring_inputs(1), 5)},
               "sp": {"tail": (sd, SP_CFG, *_sp_inputs(T_SP)),
                      "odd": (sd, SP_CFG, *_sp_inputs(T_ODD))}}
    return variables, payload, {w: workers.run_ranks(w, "ring_cases", payload) for w in WORLDS}


@pytest.mark.parametrize("world", WORLDS)
def test_ring_collectives(cases, world):
    """``ring_shift(x, 1)`` brings rank − 1's tensor, ``ring_shift(x, −1)``
    rank + 1's (the identity on one rank), ``all_reduce_max`` the largest."""
    *_, runs = cases
    for rank, out in enumerate(runs[world]):
        prev, nxt = (rank - 1) % world, (rank + 1) % world
        assert out["shift"]["next"] == [prev, -prev]
        assert out["shift"]["prev"] == [nxt, -nxt]
        assert out["shift"]["max"] == [world - 1, 0]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", ["whole", "blocks"])
def test_ring_attention_matches_dense(cases, world, case):
    """The ranks' blocks, concatenated, equal dense masked attention within
    2e-5 (tests/test_parallel.py's bar), and JAX's ``ring_attention`` on a
    mesh of ``world`` devices within 2e-5; ``blocks`` takes the queries 5
    rows at a time inside each hop (``ringattn.Q_BLOCK``)."""
    _, payload, runs = cases
    q, k, v, mask, _ = payload["ring"][case]
    got = np.concatenate([out["ring"][case] for out in runs[world]])
    np.testing.assert_allclose(got, _dense(q, k, v, mask), rtol=0, atol=2e-5)
    mesh = make_mesh(f"data={world}", jax.devices()[:world])
    ring = jax.jit(lambda *a: jax_ringattn.ring_attention(*a, mesh))
    want = np.asarray(ring(*(jnp.asarray(a) for a in (q, k, v, mask))))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


@pytest.mark.parametrize("world", WORLDS)
def test_conformer_sp_matches_dense_and_jax(cases, world):
    """``conformer_sp_embed`` on ``world`` ranks (queries in blocks of 16
    inside each hop), a padded tail of 13 frames: every rank returns the same embedding, within rtol = atol =
    2e-4 (tests/test_parallel.py's bar) of the port's dense Conformer
    (f32, eval) and of JAX's ``conformer_sp_embed`` on a mesh of ``world``
    devices."""
    variables, payload, runs = cases
    sd, _, feats, mask = payload["sp"]["tail"]
    got = [out["sp"]["tail"] for out in runs[world]]
    for g in got[1:]:
        np.testing.assert_array_equal(g, got[0])
    model = Conformer(ConformerConfig(**SP_CFG))
    model.load_state_dict(sd)
    with torch.no_grad():
        dense = model.eval()(torch.from_numpy(feats)[None], torch.from_numpy(mask)[None])[0]
    np.testing.assert_allclose(got[0], dense.numpy(), rtol=2e-4, atol=2e-4)
    mesh = make_mesh(f"data={world}", jax.devices()[:world])
    # jitted: the same function, compiled once instead of dispatched op by op
    sp = jax.jit(lambda v, f, m: jax_ringattn.conformer_sp_embed(
        v, JaxConformerConfig(**SP_CFG), f, m, mesh))
    want = np.asarray(sp(variables, jnp.asarray(feats), jnp.asarray(mask)))
    np.testing.assert_allclose(got[0], want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("world", WORLDS)
def test_sp_length_must_divide(cases, world):
    """161 frames: on one rank the forward runs (and equals the dense
    module within 2e-4); on 2 and 4 ranks ``time_shard`` raises."""
    _, payload, runs = cases
    sd, _, feats, mask = payload["sp"]["odd"]
    got = [out["sp"]["odd"] for out in runs[world]]
    if world == 1:
        model = Conformer(ConformerConfig(**SP_CFG))
        model.load_state_dict(sd)
        with torch.no_grad():
            dense = model.eval()(torch.from_numpy(feats)[None], torch.from_numpy(mask)[None])
        np.testing.assert_allclose(got[0], dense[0].numpy(), rtol=2e-4, atol=2e-4)
    else:
        assert all(g == f"sequence length {T_ODD} does not divide over {world} ranks"
                   for g in got)


def test_single_process_paths():
    """Without a group: ``time_shard`` is the whole sequence, a block
    shorter than the conv halo raises, and ``ring_attention`` casts bf16
    inputs to f32 (within 2e-2 of the f32 dense result)."""
    x = torch.arange(10)
    assert torch.equal(time_shard(x), x)
    model = Conformer(ConformerConfig(**SP_CFG)).eval()
    with pytest.raises(ValueError, match="shorter than the conv halo 7"):
        conformer_sp_embed(model, torch.zeros(5, 80), torch.ones(5, dtype=torch.bool))
    q, k, v, mask = _ring_inputs(3)
    out = ring_attention(*(torch.from_numpy(a).bfloat16() for a in (q, k, v)),
                         torch.from_numpy(mask))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), _dense(q, k, v, mask), rtol=0, atol=2e-2)
