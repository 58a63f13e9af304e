"""The port's x-vector tower (sdtk_tpu_torch/models/xvector.py) against the
flax tower, with the same weights through ``xvector_state_dict``: f32 at
small widths and with the bundled checkpoint at full width, bf16 through
both backends by per-window cosine; and the GPU backend's tower switch
(``$SDTK_BACKEND_TOWER``, checkpoint search, version, width)."""

from __future__ import annotations

import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdtk_tpu.backends.tpu import TpuBackend
from sdtk_tpu.models.xvector import XVector as JaxXVector
from sdtk_tpu.models.xvector import XVectorConfig as JaxConfig
from sdtk_tpu_torch.backends.gpu import GpuBackend
from sdtk_tpu_torch.data.synth import synth_utterance
from sdtk_tpu_torch.models.conformer import Conformer
from sdtk_tpu_torch.models.ecapa import _masked_mean_std
from sdtk_tpu_torch.models.xvector import XVector, XVectorConfig
from sdtk_tpu_torch.ops import fbank
from sdtk_tpu_torch.utils.checkpoint import read_msgpack, xvector_state_dict

MODELS = Path(__file__).resolve().parent.parent / "models"
SMALL = {"channels": 32, "pre_pool_channels": 48, "emb_dim": 16}


def _random_variables(seed: int = 0) -> dict:
    """flax init at small widths, with batch statistics redrawn so
    BatchNorm is not the identity."""
    v = JaxXVector(JaxConfig(dtype="float32", **SMALL)).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 64, 80)))
    v = jax.tree_util.tree_map(np.asarray, v)
    rng = np.random.default_rng(seed + 1)
    stats = jax.tree_util.tree_map_with_path(
        lambda p, x: (np.abs(rng.standard_normal(x.shape)) + 0.5 if p[-1].key == "var"
                      else 0.1 * rng.standard_normal(x.shape)).astype(np.float32),
        v["batch_stats"])
    return {"params": v["params"], "batch_stats": stats}


def _run_both(variables: dict, feats: np.ndarray, mask: np.ndarray, **kw):
    want = np.asarray(JaxXVector(JaxConfig(dtype="float32", **kw)).apply(
        variables, feats, mask=mask))
    model = XVector(XVectorConfig(dtype="float32", **kw))
    model.load_state_dict(xvector_state_dict(variables), strict=True)
    with torch.inference_mode():
        got = model.eval()(torch.from_numpy(feats), torch.from_numpy(mask)).numpy()
    return got, want


def test_small_tower_f32_matches_jax():
    """Random weights at small widths, ragged masks and an empty row:
    max|d| <= 1e-5."""
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((4, 60, 80)).astype(np.float32)
    mask = np.arange(60)[None, :] < np.asarray([60, 41, 17, 0])[:, None]
    got, want = _run_both(_random_variables(), feats, mask, **SMALL)
    assert got.shape == want.shape == (4, 16) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_converter_layouts():
    """Conv (k, in, out) → (out, in, k), segment6 (3000, 512) → (512, 3000),
    BN statistics from batch_stats; the bundled tree loads strictly."""
    tree = read_msgpack(MODELS / "xvector.msgpack")
    sd = xvector_state_dict(tree)
    XVector(XVectorConfig()).load_state_dict(sd, strict=True)
    p, bs = tree["params"], tree["batch_stats"]
    np.testing.assert_array_equal(sd["tdnn2.conv.weight"].numpy(),
                                  p["tdnn2"]["conv"]["kernel"].transpose(2, 1, 0))
    np.testing.assert_array_equal(sd["segment6.weight"].numpy(), p["segment6"]["kernel"].T)
    assert sd["segment6.weight"].shape == (512, 3000)
    np.testing.assert_array_equal(sd["tdnn5.bn.running_var"].numpy(), bs["tdnn5"]["bn"]["var"])
    np.testing.assert_array_equal(sd["tdnn1.bn.weight"].numpy(), p["tdnn1"]["bn"]["scale"])


def test_bundled_tower_f32_matches_jax():
    """The bundled checkpoint at full width on the log-mel of four
    synthetic windows (one ragged): max|d| <= 2e-4."""
    wav = np.stack([synth_utterance(v, 5, 3.0) for v in (1, 4, 9, 12)]).astype(np.float32)
    lengths = torch.tensor([48000, 48000, 48000, 20000])
    cfg = fbank.FrontendConfig(compute_dtype="float32")
    feats, mask = fbank.log_mel(torch.from_numpy(wav), cfg, lengths=lengths)
    got, want = _run_both(read_msgpack(MODELS / "xvector.msgpack"), feats.numpy(), mask.numpy())
    assert got.shape == (4, 512) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)


def test_pooled_stats_reach_segment6_in_f32():
    """In bf16 the TDNN blocks run in bf16 but the pooled statistics and
    segment6 stay f32: segment6 gets the f32 mean/std of the last block's
    bf16 output and applies f32 weights."""
    model = XVector(XVectorConfig(**SMALL))
    model.reset_parameters(torch.Generator().manual_seed(3))
    feats = np.random.default_rng(3).standard_normal((2, 40, 80)).astype(np.float32)
    seen = {}
    model.tdnn5.register_forward_hook(lambda mod, args, out: seen.update(last=out))
    model.segment6.register_forward_pre_hook(lambda mod, args: seen.update(pooled=args[0]))
    with torch.inference_mode():
        out = model.eval()(torch.from_numpy(feats))
        mean, std = _masked_mean_std(seen["last"], torch.ones(2, 1, 40))
        want = torch.nn.functional.linear(torch.cat([mean, std], dim=1),
                                          model.segment6.weight, model.segment6.bias)
    assert seen["last"].dtype == torch.bfloat16
    assert seen["pooled"].dtype == torch.float32 and out.dtype == torch.float32
    torch.testing.assert_close(seen["pooled"], torch.cat([mean, std], dim=1), rtol=0, atol=0)
    torch.testing.assert_close(out, want, rtol=0, atol=0)


def test_backends_bf16_agree():
    """Both packages' backends with the bundled x-vector in bf16 (its
    serving dtype): every window's cosine >= 0.995."""
    wav = np.concatenate([synth_utterance(3, 1, 4.0), synth_utterance(8, 2, 4.0)])
    gpu = GpuBackend(model="xvector", device="cpu")
    tpu = TpuBackend(model="xvector")
    got, want = gpu.embed_windows(wav), np.asarray(tpu.embed_windows(wav))
    assert got.shape == want.shape == (5, 512)
    cos = (got * want).sum(axis=1)
    assert cos.min() >= 0.995, cos


def test_tower_switch(monkeypatch, tmp_path):
    """$SDTK_BACKEND_TOWER picks the tower; version, width and the
    calibration sidecar follow it; conformer loads (no file is bundled:
    seeded random weights) and embeds to 192-d unit rows."""
    monkeypatch.setenv("SDTK_MODEL_DIR", str(tmp_path / "none"))
    monkeypatch.delenv("SDTK_MODEL_PATH", raising=False)
    monkeypatch.setenv("SDTK_BACKEND_TOWER", "xvector")
    b = GpuBackend(device="cpu")
    assert b.model_version == TpuBackend().model_version == "xvector-c512-v1"
    assert b.embedding_dim == 512
    assert b.engine.params_source == str(MODELS / "xvector.msgpack")
    assert b.raw_decision_threshold == 0.7647 and b.cluster_merge_tau == 0.5875
    assert isinstance(b.engine.model, XVector)
    monkeypatch.delenv("SDTK_BACKEND_TOWER")
    assert GpuBackend(device="cpu").model_version == "ecapa-c512-v1"
    monkeypatch.setenv("SDTK_BACKEND_TOWER", "conformer")
    b = GpuBackend(device="cpu")
    assert b.model_version == TpuBackend().model_version == "conformer-c512-v1"
    assert isinstance(b.engine.model, Conformer) and b.engine.model.cfg.dim == 256
    assert b.engine.params_source == "random-init" and b.embedding_dim == 192
    emb = b.embed_waveform(synth_utterance(2, 1, 2.0))
    assert emb.shape == (192,) and np.isfinite(emb).all()
    with pytest.raises(ValueError, match="unknown model"):
        GpuBackend(model="wav2vec", device="cpu")


def test_checkpoint_search_order(monkeypatch, tmp_path):
    """$SDTK_MODEL_PATH, then model_dir()/xvector.msgpack, then the bundled
    file, as the JAX engine searches; sidecars follow the checkpoint."""
    model_dir = tmp_path / "models"
    model_dir.mkdir()
    monkeypatch.setenv("SDTK_MODEL_DIR", str(model_dir))
    monkeypatch.delenv("SDTK_MODEL_PATH", raising=False)
    bundled = MODELS / "xvector.msgpack"

    def source():
        return GpuBackend(model="xvector", device="cpu").engine.params_source

    assert source() == str(bundled)
    shutil.copy(bundled, model_dir / "xvector.msgpack")
    b = GpuBackend(model="xvector", device="cpu")
    assert b.engine.params_source == str(model_dir / "xvector.msgpack")
    assert b.engine.calibration is None  # no sidecar beside this copy
    override = tmp_path / "other.msgpack"
    shutil.copy(bundled, override)
    shutil.copy(MODELS / "xvector.calib.json", tmp_path / "other.calib.json")
    monkeypatch.setenv("SDTK_MODEL_PATH", str(override))
    b = GpuBackend(model="xvector", device="cpu")
    assert b.engine.params_source == str(override)
    assert b.raw_decision_threshold == 0.7647
    searched = [str(p) for p in b.engine._searched]
    assert searched == [str(override), str(model_dir / "xvector.msgpack"), str(bundled)]
