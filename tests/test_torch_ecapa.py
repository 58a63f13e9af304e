"""The port's ECAPA-TDNN (sdtk_tpu_torch/models/ecapa.py) against the flax
tower, with the same weights through the converter: f32 tightly (same
algorithm, another summation order), bf16 by per-window cosine (bf16
rounding falls in different places in XLA and PyTorch).  Ragged lengths
and a length-0 row (what the engine pads a tail batch with) included."""

from __future__ import annotations

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdtk_tpu.models.ecapa import EcapaConfig as JaxConfig
from sdtk_tpu.models.ecapa import EcapaTdnn as JaxEcapa
from sdtk_tpu_torch.models.ecapa import EcapaConfig, EcapaTdnn
from sdtk_tpu_torch.utils.checkpoint import ecapa_state_dict, read_msgpack

MODELS = Path(__file__).resolve().parent.parent / "models"
B, T = 4, 60
LENGTHS = np.asarray([60, 45, 20, 0])


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((B, T, 80)).astype(np.float32)
    mask = np.arange(T)[None, :] < LENGTHS[:, None]
    return feats, mask


def _random_variables(kw: dict, seed: int = 0) -> dict:
    """flax init, with batch statistics redrawn so BatchNorm is not the
    identity."""
    v = jax.jit(JaxEcapa(JaxConfig(dtype="float32", **kw)).init)(
        jax.random.PRNGKey(seed), jnp.zeros((1, 64, 80)))
    v = jax.tree_util.tree_map(np.asarray, v)
    rng = np.random.default_rng(seed + 1)

    def redraw(t):
        return {k: redraw(x) if isinstance(x, dict) else
                (np.abs(rng.standard_normal(x.shape)) + 0.5 if k == "var"
                 else 0.1 * rng.standard_normal(x.shape)).astype(np.float32)
                for k, x in t.items()}

    return {"params": v["params"], "batch_stats": redraw(v["batch_stats"])}


def _both(variables: dict, dtype: str, **kw):
    feats, mask = _inputs()
    apply = jax.jit(JaxEcapa(JaxConfig(dtype=dtype, **kw)).apply)
    want = np.asarray(apply(variables, feats, mask=mask))
    model = EcapaTdnn(EcapaConfig(dtype=dtype, **kw))
    model.load_state_dict(ecapa_state_dict(variables))
    with torch.inference_mode():
        got = model.eval()(torch.from_numpy(feats), torch.from_numpy(mask)).numpy()
    return got, want


def _cos(a, b):
    a = a / np.linalg.norm(a, axis=1, keepdims=True)
    b = b / np.linalg.norm(b, axis=1, keepdims=True)
    return (a * b).sum(axis=1)


@pytest.mark.parametrize("kw", [
    {"channels": 64},
    {"channels": 64, "mfa_bn": True, "asp_tdnn": True, "dilations": (2, 3), "scale": 4},
], ids=["c64", "c64-speechbrain-layout"])
def test_random_init_f32_and_bf16(kw):
    """c64 random init.  f32: max|Δ| ≤ 1e-5 on outputs of magnitude ~1
    (measured ~1e-6).  bf16: per-window cosine ≥ 0.995 (measured ≥ 0.99999)."""
    variables = _random_variables(kw)
    got, want = _both(variables, "float32", **kw)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    got, want = _both(variables, "bfloat16", **kw)
    assert np.isfinite(got).all()
    assert _cos(got, want).min() >= 0.995


def test_fam5tel_checkpoint():
    """The bundled checkpoint at c512.  f32: max|Δ| ≤ 2e-4 on raw
    embeddings of magnitude ~40 (measured 2e-5).  bf16 (serving):
    per-window cosine ≥ 0.995 (measured ≥ 0.99999)."""
    variables = read_msgpack(MODELS / "ecapatdnn-fam5tel.msgpack")
    got, want = _both(variables, "float32")
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)
    got, want = _both(variables, "bfloat16")
    assert np.isfinite(got).all()
    assert _cos(got, want).min() >= 0.995


def test_padding_frames_do_not_leak():
    """A padded batch row embeds like the same row unpadded (the mask is
    re-applied after every block), and an all-masked row stays finite."""
    model = EcapaTdnn(EcapaConfig(channels=64, dtype="float32"))
    model.reset_parameters(torch.Generator().manual_seed(0))
    feats, mask = _inputs(seed=3)
    with torch.inference_mode():
        full = model.eval()(torch.from_numpy(feats), torch.from_numpy(mask)).numpy()
        alone = model(torch.from_numpy(feats[1:2, :45]), torch.ones(1, 45, dtype=torch.bool))
    np.testing.assert_allclose(full[1], alone.numpy()[0], rtol=0, atol=1e-5)
    assert np.isfinite(full[3]).all()


def test_reset_parameters_is_seeded():
    a, b = EcapaTdnn(EcapaConfig(channels=64)), EcapaTdnn(EcapaConfig(channels=64))
    a.reset_parameters(torch.Generator().manual_seed(7))
    b.reset_parameters(torch.Generator().manual_seed(7))
    for (k, x), (_, y) in zip(a.state_dict().items(), b.state_dict().items()):
        assert torch.equal(x, y), k
    assert a.stem.conv.weight.std() > 0
