"""The port's Conformer (sdtk_tpu_torch/models/conformer.py) against the flax
module, both from one flax tree carried across by ``conformer_state_dict``:
f32 at a small width and at the full width, bf16 through both packages'
backends, mask invariance, the converters both ways through
``flax.serialization``, and the GPU backend's ``conformer`` tower
(checkpoint search, seeded random init).  The trees are flax's init with
BatchNorm statistics redrawn, so the inference-mode BatchNorm is not the
identity.  Tolerances are stated in each test."""

from __future__ import annotations

from pathlib import Path

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdtk_tpu.backends.tpu import TpuBackend
from sdtk_tpu.models.conformer import Conformer as JaxConformer
from sdtk_tpu.models.conformer import ConformerConfig as JaxConfig
from sdtk_tpu_torch.backends.gpu import GpuBackend
from sdtk_tpu_torch.data.synth import synth_utterance
from sdtk_tpu_torch.models.conformer import Conformer, ConformerConfig
from sdtk_tpu_torch.ops import fbank
from sdtk_tpu_torch.utils.checkpoint import (conformer_jax_tree, conformer_state_dict,
                                             msgpack_bytes, read_msgpack, write_msgpack)

SMALL = {"dim": 64, "n_blocks": 2, "n_heads": 4, "conv_kernel": 7, "emb_dim": 32,
         "attention_channels": 16}


def _variables(seed: int = 0, **kw) -> dict:
    """flax's init of ``JaxConfig(**kw)`` (f32 leaves), batch statistics
    redrawn."""
    v = JaxConformer(JaxConfig(**kw)).init(jax.random.PRNGKey(seed), jnp.zeros((1, 32, 80)))
    v = jax.tree_util.tree_map(np.asarray, v)
    rng = np.random.default_rng(seed + 1)
    stats = jax.tree_util.tree_map_with_path(
        lambda p, x: (np.abs(rng.standard_normal(x.shape)) + 0.5 if p[-1].key == "var"
                      else 0.1 * rng.standard_normal(x.shape)).astype(np.float32),
        v["batch_stats"])
    return {"params": v["params"], "batch_stats": stats}


def _run_both(variables, feats, mask, **kw):
    want = np.asarray(JaxConformer(JaxConfig(**kw)).apply(variables, feats, mask=mask))
    model = Conformer(ConformerConfig(**kw))
    model.load_state_dict(conformer_state_dict(variables), strict=True)
    with torch.inference_mode():
        got = model.eval()(torch.from_numpy(feats), torch.from_numpy(mask)).numpy()
    return got, want


def _unit(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def test_small_tower_f32_matches_jax():
    """dim 64, 2 blocks, 4 heads, kernel 7, emb 32, f32; ragged masks and a
    row with no valid frame: max|d| <= 1e-4."""
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((4, 60, 80)).astype(np.float32)
    mask = np.arange(60)[None, :] < np.asarray([60, 41, 17, 0])[:, None]
    got, want = _run_both(_variables(**SMALL, dtype="float32"), feats, mask,
                          **SMALL, dtype="float32")
    assert got.shape == want.shape == (4, 32) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_full_width_f32_matches_jax():
    """The serving width (dim 256, 6 blocks, 4 heads, kernel 15, emb 192) in
    f32 on the log-mel of four synthetic 3 s windows, one ragged: cosine
    >= 0.99999 per window."""
    wav = np.stack([synth_utterance(v, 5, 3.0) for v in (1, 4, 9, 12)]).astype(np.float32)
    cfg = fbank.FrontendConfig(compute_dtype="float32")
    feats, mask = fbank.log_mel(torch.from_numpy(wav), cfg,
                                lengths=torch.tensor([48000, 48000, 48000, 20000]))
    got, want = _run_both(_variables(dtype="float32"), feats.numpy(), mask.numpy(),
                          dtype="float32")
    assert got.shape == (4, 192) and np.isfinite(got).all()
    cos = (_unit(got) * _unit(want)).sum(axis=1)
    assert cos.min() >= 0.99999, cos


def test_mask_invariance():
    """tests/test_models.py's check on the port: 24 frames of garbage (×50)
    behind a masked tail move the f32 embedding by <= 1e-4; in bf16 a
    padded row (every key masked) stays finite."""
    variables = _variables(**SMALL, dtype="float32")
    rng = np.random.default_rng(3)
    feats = rng.standard_normal((1, 40, 80)).astype(np.float32)
    model = Conformer(ConformerConfig(**SMALL, dtype="float32"))
    model.load_state_dict(conformer_state_dict(variables))
    garbage = 50 * rng.standard_normal((1, 24, 80)).astype(np.float32)
    padded = torch.from_numpy(np.concatenate([feats, garbage], axis=1))
    mask = torch.arange(64)[None] < 40
    with torch.inference_mode():
        ref = model.eval()(torch.from_numpy(feats))
        got = model(padded, mask)
        assert (got - ref).abs().max() <= 1e-4
        bf16 = Conformer(ConformerConfig(**SMALL))
        bf16.load_state_dict(conformer_state_dict(variables))
        out = bf16.eval()(torch.cat([padded, padded]), torch.stack([mask[0], mask[0] & False]))
    assert torch.isfinite(out).all()


def test_converters_round_trip_through_flax():
    """``conformer_state_dict`` lays the attention's kernels out flat
    ((C, H, Dh) → (H·Dh, C), (H, Dh, C) → (C, H·Dh)); ``conformer_jax_tree``
    gives back every leaf exactly; the port's msgpack bytes restore through
    ``flax.serialization.from_bytes`` onto flax's own tree, and flax writes
    them back to the same bytes."""
    variables = _variables()
    sd = conformer_state_dict(variables)
    Conformer(ConformerConfig()).load_state_dict(sd, strict=True)
    att = variables["params"]["block2"]["mhsa"]["MultiHeadDotProductAttention_0"]
    np.testing.assert_array_equal(sd["block2.mhsa.MultiHeadDotProductAttention_0.query.weight"],
                                  att["query"]["kernel"].reshape(256, 256).T)
    np.testing.assert_array_equal(sd["block2.mhsa.MultiHeadDotProductAttention_0.out.weight"],
                                  att["out"]["kernel"].reshape(256, 256).T)
    np.testing.assert_array_equal(sd["block0.conv.depthwise.weight"],
                                  variables["params"]["block0"]["conv"]["depthwise"]["kernel"]
                                  .transpose(2, 1, 0))
    back = conformer_jax_tree(sd)
    want = jax.tree_util.tree_leaves_with_path(variables)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(got[path], leaf, err_msg=str(path))
    raw = msgpack_bytes(back)
    template = JaxConformer(JaxConfig()).init(jax.random.PRNGKey(5), jnp.zeros((1, 8, 80)))
    restored = flax.serialization.from_bytes(template, raw)
    for path, leaf in want:
        np.testing.assert_array_equal(
            np.asarray(dict(jax.tree_util.tree_leaves_with_path(restored))[path]), leaf)
    assert flax.serialization.to_bytes(flax.serialization.msgpack_restore(raw)) == raw


@pytest.fixture(scope="module")
def conformer_file(tmp_path_factory):
    """flax's init of the full-width tower written by the port, and a
    narrow (dim 64) one."""
    d = tmp_path_factory.mktemp("conformer")
    write_msgpack(d / "full.msgpack", conformer_jax_tree(conformer_state_dict(_variables(2))))
    write_msgpack(d / "narrow.msgpack",
                  conformer_jax_tree(conformer_state_dict(_variables(4, dim=64))))
    return d


def _speech():
    return np.concatenate([synth_utterance(3, 1, 4.0), synth_utterance(8, 2, 4.0)])


def test_backends_bf16_agree(conformer_file):
    """Both packages' backends with the full-width tower from one file, in
    bf16 (the serving dtype): every window's cosine >= 0.995."""
    path = conformer_file / "full.msgpack"
    gpu = GpuBackend(model="conformer", params_path=path, device="cpu")
    tpu = TpuBackend(model="conformer", params_path=path)
    got, want = gpu.embed_windows(_speech()), np.asarray(tpu.embed_windows(_speech()))
    assert got.shape == want.shape == (5, 192)
    assert gpu.engine.params_source == tpu.engine.params_source == str(path)
    cos = (got * want).sum(axis=1)
    assert cos.min() >= 0.995, cos


def test_narrow_backend_matches_tpu(conformer_file):
    """``channels=64`` (a dim-64 tower, as the JAX engine cuts it):
    ``embed_windows``, ``embed_batch`` of same-length rows and of ragged
    utterances, each row at cosine >= 0.995 of TpuBackend's (bf16 on both
    sides)."""
    path = conformer_file / "narrow.msgpack"
    gpu = GpuBackend(model="conformer", channels=64, params_path=path, device="cpu")
    tpu = TpuBackend(model="conformer", channels=64, params_path=path)
    assert gpu.model_version == tpu.model_version == "conformer-c64-v1"
    assert gpu.engine.model.cfg.dim == 64
    wav = _speech()
    rows = [wav[i * 8000 : i * 8000 + 16000] for i in range(5)]
    ragged = [wav[:30000], wav[5000:60000]]
    for got, want in ((gpu.embed_windows(wav), tpu.embed_windows(wav)),
                      (gpu.embed_batch(rows), tpu.embed_batch(rows)),
                      (gpu.embed_batch(ragged), tpu.embed_batch(ragged))):
        want = np.asarray(want)
        assert got.shape == want.shape and np.isfinite(got).all()
        cos = (_unit(got) * _unit(want)).sum(axis=1)
        assert cos.min() >= 0.995, cos


def test_random_init_without_a_file(monkeypatch, tmp_path, capsys):
    """No Conformer file is bundled: the search is the JAX engine's
    ($SDTK_MODEL_PATH, model_dir()/conformer.msgpack, models/conformer.msgpack),
    and without a file the tower takes seeded random weights, says so on
    stderr and in ``params_source``, and embeds to finite unit rows.  Two
    backends with one seed have one tower."""
    monkeypatch.setenv("SDTK_MODEL_DIR", str(tmp_path))
    monkeypatch.setenv("SDTK_MODEL_PATH", str(tmp_path / "absent.msgpack"))
    b = GpuBackend(model="conformer", device="cpu")
    emb = b.embed_waveform(_speech()[:32000])
    repo_models = Path(__file__).resolve().parent.parent / "models"
    assert [str(p) for p in b.engine._searched] == [
        str(tmp_path / "absent.msgpack"), str(tmp_path / "conformer.msgpack"),
        str(repo_models / "conformer.msgpack")]
    assert b.engine.params_source == "random-init"
    assert "using RANDOM weights" in capsys.readouterr().err
    assert emb.shape == (192,) and np.isfinite(emb).all()
    assert abs(np.linalg.norm(emb) - 1.0) < 1e-5
    again = GpuBackend(model="conformer", device="cpu")
    for k, v in b.engine.model.state_dict().items():
        assert torch.equal(again.engine.model.state_dict()[k], v), k
    assert b.model_version == TpuBackend(model="conformer").model_version == "conformer-c512-v1"


def test_read_msgpack_matches_flax_restore(conformer_file):
    """The port's reader gives flax's ``msgpack_restore`` tree."""
    raw = (conformer_file / "narrow.msgpack").read_bytes()
    want = jax.tree_util.tree_leaves_with_path(flax.serialization.msgpack_restore(raw))
    got = dict(jax.tree_util.tree_leaves_with_path(read_msgpack(conformer_file
                                                                / "narrow.msgpack")))
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(got[path], leaf)
