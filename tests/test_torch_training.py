"""The port's trainer (sdtk_tpu_torch/training.py, parallel/checkpoint.py,
utils/checkpoint.py:write_msgpack) on the CPU at tiny sizes: the inference
file it saves is read by flax and by the JAX ``TpuBackend``, its warm start
counts leaves as the JAX trainer does, crash resume restores the saved
state exactly, and errors end the run."""

from __future__ import annotations

import re
import shutil
import subprocess
import sys
from pathlib import Path

import flax.serialization
import numpy as np
import pytest
import torch

from sdtk_tpu.backends.tpu import TpuBackend
from sdtk_tpu.training import train as jax_train
from sdtk_tpu_torch import training
from sdtk_tpu_torch.backends.gpu import GpuBackend
from sdtk_tpu_torch.data.synth_families import family_utterance
from sdtk_tpu_torch.models.ecapa import EcapaConfig, EcapaTdnn
from sdtk_tpu_torch.parallel.checkpoint import latest_checkpoint, restore_train_state
from sdtk_tpu_torch.parallel.train import TrainConfig, create_train_state
from sdtk_tpu_torch.utils.build import KernelError
from sdtk_tpu_torch.utils.checkpoint import ecapa_jax_tree, read_msgpack

REPO = Path(__file__).resolve().parent.parent
TINY = {"n_speakers": 4, "families": "0,1", "batch": 8, "seconds": 1.0, "crop_seconds": 1.0,
        "channels": 32, "log_every": 1, "device": "cpu"}


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Two steps with every augmentation on, a checkpoint after each."""
    d = tmp_path_factory.mktemp("train")
    logs: list[str] = []
    state, out = training.train(steps=2, out_path=d / "m.msgpack", ckpt_dir=d / "ck",
                                ckpt_every=1, aug_prob=0.5, noise_prob=0.5, bed_prob=0.5,
                                log=logs.append, **TINY)
    return d, state, out, logs


def test_saved_file_reads_in_flax(run):
    """flax's ``msgpack_restore`` reads the file to the tower's own arrays
    (exactly), and flax's ``to_bytes`` (the JAX trainer's writer) writes
    them back to the same bytes."""
    _, state, out, logs = run
    assert any(line.startswith("saved params -> ") for line in logs)
    raw = Path(out).read_bytes()
    restored = flax.serialization.msgpack_restore(raw)
    want = _leaves(ecapa_jax_tree(state.model.state_dict()))
    got = _leaves(restored)
    assert got.keys() == want.keys() and len(got) == 192
    for k in want:
        assert got[k].dtype == np.float32, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert flax.serialization.to_bytes(restored) == raw
    steps = state.timings["steps"]
    assert [t["step_ms"] > 0 and t["synth_s"] > 0 for t in steps] == [True, True]
    assert state.timings["loop_s"] >= sum(t["step_ms"] for t in steps) / 1e3


def test_saved_file_embeds_alike_in_both_backends(run):
    """The JAX ``TpuBackend(channels=32)`` and the port's ``GpuBackend`` on
    the CPU load the trained file; bf16 embeddings of three utterances
    agree to cosine ≥ 0.999."""
    _, _, out, _ = run
    jax_be = TpuBackend(channels=32, params_path=out)
    port_be = GpuBackend(model="ecapa", channels=32, params_path=out, device="cpu")
    assert port_be.engine.params_source == str(out)
    for fam, spk in ((0, 1), (2, 3), (4, 0)):
        wav = family_utterance(fam, spk, 77, 2.0)
        a, b = jax_be.embed_waveform(wav), port_be.embed_waveform(wav)
        assert a.shape == b.shape == (192,) and np.isfinite(b).all()
        cos = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))
        assert cos >= 0.999, (fam, spk, cos)


def _counts(logs):
    line = next(m for m in logs if m.startswith("resumed backbone"))
    return re.search(r"\((\d+) leaves, (\d+) skipped\)", line).groups()


@pytest.mark.parametrize("scale", [8, 4], ids=["same-shape", "other-scale"])
def test_resume_counts_match_jax(run, tmp_path, monkeypatch, scale):
    """``--resume`` of the port's file into the same tower (every leaf
    merged) and into scale 4 (the 3 × 3 Res2 branches' 54 leaves change
    shape): the port logs the merged and skipped counts the JAX trainer
    logs."""
    monkeypatch.setenv("SDTK_JAX_CACHE_DIR", str(tmp_path / "jaxcache"))
    _, _, out, _ = run
    jax_logs: list[str] = []
    jax_train(steps=0, n_speakers=4, batch=8, seconds=1.0, crop_seconds=1.0, channels=32,
              scale=scale, resume_path=out, out_path=tmp_path / "j.msgpack", log=jax_logs.append)
    port_logs: list[str] = []
    training.train(steps=0, scale=scale, resume_path=out, out_path=tmp_path / "p.msgpack",
                   log=port_logs.append, **{**TINY, "families": "0"})
    assert _counts(port_logs) == _counts(jax_logs)
    assert _counts(port_logs) == (("192", "0") if scale == 8 else ("66", "54"))


def test_resume_fam5tel_merges_every_leaf():
    """The bundled fam5tel file into a fresh c512 ECAPA: all 192 leaves of
    the file (134 params, 58 batch statistics) merge, none is skipped, and
    the tower then holds the file's weights."""
    path = REPO / "models" / "ecapatdnn-fam5tel.msgpack"
    tree = read_msgpack(path)
    n_file = len(_leaves(tree["params"])) + len(_leaves(tree["batch_stats"]))
    state = create_train_state(EcapaTdnn(EcapaConfig()), torch.Generator().manual_seed(0),
                               TrainConfig(n_classes=320), torch.device("cpu"))
    assert training.warm_start(state, "ecapa", path) == (n_file, 0) == (192, 0)
    got = _leaves(ecapa_jax_tree(state.model.state_dict()))
    for k, v in _leaves({"params": tree["params"], "batch_stats": tree["batch_stats"]}).items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_crash_resume_restores_saved_state(run, tmp_path):
    """A second run on the same checkpoint directory logs the restore of
    step 2; restoring that checkpoint into a fresh state gives the first
    run's final tower, AAM head, optimizer state and step exactly."""
    d, state, _, logs = run
    assert sum("checkpoint -> " in m for m in logs) == 2
    latest = latest_checkpoint(d / "ck")
    assert latest.name == "step_00000002"
    fresh = create_train_state(EcapaTdnn(EcapaConfig(channels=32)),
                               torch.Generator().manual_seed(9),
                               TrainConfig(n_classes=8, emb_dim=192), torch.device("cpu"))
    restore_train_state(latest, fresh)
    assert fresh.step == state.step == 2
    for k, v in state.model.state_dict().items():
        assert torch.equal(fresh.model.state_dict()[k], v), k
    assert torch.equal(fresh.aam_weights, state.aam_weights)
    want, got = state.optimizer.state_dict(), fresh.optimizer.state_dict()
    assert want["param_groups"] == got["param_groups"]
    for i, st in want["state"].items():
        for name, t in st.items():
            assert torch.equal(got["state"][i][name], t), (i, name)

    logs2: list[str] = []
    ck2 = tmp_path / "ck"
    shutil.copytree(d / "ck", ck2)
    again, _ = training.train(steps=1, out_path=tmp_path / "b.msgpack", ckpt_dir=ck2,
                              ckpt_every=0, log=logs2.append, **TINY)
    assert any("restored full train state" in m and "(step 2)" in m for m in logs2)
    assert again.step == 3


@pytest.fixture(scope="module")
def conformer_run(tmp_path_factory):
    """Two Conformer steps (dim 32) with a checkpoint after each."""
    d = tmp_path_factory.mktemp("train-conformer")
    logs: list[str] = []
    state, out = training.train(steps=2, model_name="conformer", out_path=d / "c.msgpack",
                                ckpt_dir=d / "ck", ckpt_every=1, log=logs.append, **TINY)
    return d, state, out, logs


def test_conformer_trains_to_a_file_jax_reads(conformer_run):
    """``train(model_name="conformer")`` takes its steps (K1's plain version
    as featurizer, finite losses) and writes a flax msgpack that flax's
    ``msgpack_restore`` reads to the tower's arrays; JAX's ``Conformer``
    (dim 32, f32) embeds features from that file to the port's embedding
    within 1e-4."""
    import jax.numpy as jnp

    from sdtk_tpu.models.conformer import Conformer as JaxConformer
    from sdtk_tpu.models.conformer import ConformerConfig as JaxConfig
    from sdtk_tpu_torch.models.conformer import Conformer, ConformerConfig
    from sdtk_tpu_torch.utils.checkpoint import conformer_jax_tree, conformer_state_dict

    _, state, out, logs = conformer_run
    assert state.step == 2 and Path(out).name == "c.msgpack"
    assert all(np.isfinite(t["loss"]) for t in state.timings["steps"])
    restored = flax.serialization.msgpack_restore(Path(out).read_bytes())
    want = _leaves(conformer_jax_tree(state.model.state_dict()))
    assert _leaves(restored).keys() == want.keys()
    for k, v in _leaves(restored).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((2, 50, 80)).astype(np.float32)
    mask = np.arange(50)[None] < np.array([[50], [33]])
    jax_emb = np.asarray(JaxConformer(JaxConfig(dim=32, dtype="float32")).apply(
        restored, jnp.asarray(feats), mask=jnp.asarray(mask)))
    model = Conformer(ConformerConfig(dim=32, dtype="float32"))
    model.load_state_dict(conformer_state_dict(read_msgpack(out)))
    with torch.inference_mode():
        port_emb = model.eval()(torch.from_numpy(feats), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(port_emb, jax_emb, rtol=0, atol=1e-4)


def test_conformer_warm_start_and_crash_resume(conformer_run, tmp_path):
    """``--resume`` of the Conformer file merges every leaf, as many as the
    JAX trainer counts for that file into its dim-32 tower (flax's init
    tree), and a second call on the checkpoint directory restores step 2;
    ``GpuBackend(model="conformer", channels=32)`` serves the file."""
    import jax

    from sdtk_tpu.models.conformer import Conformer as JaxConformer
    from sdtk_tpu.models.conformer import ConformerConfig as JaxConfig

    d, _, out, _ = conformer_run
    logs: list[str] = []
    training.train(steps=0, model_name="conformer", resume_path=out,
                   out_path=tmp_path / "w.msgpack", log=logs.append, **TINY)
    template = JaxConformer(JaxConfig(dim=32)).init(jax.random.PRNGKey(0),
                                                    np.zeros((1, 8, 80), np.float32))
    n_jax = len(jax.tree_util.tree_leaves(template))
    assert _counts(logs) == (str(n_jax), "0")
    logs2: list[str] = []
    again, _ = training.train(steps=1, model_name="conformer", out_path=tmp_path / "r.msgpack",
                              ckpt_dir=d / "ck", ckpt_every=0, log=logs2.append, **TINY)
    assert any("restored full train state" in m and "(step 2)" in m for m in logs2)
    assert again.step == 3
    be = GpuBackend(model="conformer", channels=32, params_path=out, device="cpu")
    emb = be.embed_waveform(family_utterance(1, 2, 3, 2.0))
    assert be.engine.params_source == str(out) and emb.shape == (192,)
    assert np.isfinite(emb).all()


@pytest.mark.parametrize("kw,exc,match", [
    # data-parallel training needs the process group of as many ranks
    # (tests/test_torch_train_ddp.py trains on two)
    ({"mesh_spec": "data=2"}, RuntimeError, "process group of 2 ranks"),
    ({"mesh_spec": "data=1,model=2"}, NotImplementedError, "model-axis"),
], ids=["mesh-data2", "mesh-model2"])
def test_unported_options_raise(kw, exc, match, tmp_path):
    with pytest.raises(exc, match=match):
        training.train(steps=1, out_path=tmp_path / "x.msgpack", **{**TINY, **kw})


def test_default_device_needs_cuda(tmp_path):
    """Without CUDA the default device raises before anything runs."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        training.train(steps=1, out_path=tmp_path / "x.msgpack")
    assert not (tmp_path / "x.msgpack").exists()


def test_device_and_synthesis_errors_end_the_run(tmp_path, monkeypatch):
    """A kernel error in the featurizer and a failure in the producer
    thread both propagate out of ``train()``; no file is saved."""
    def broken_featurizer(*a, **k):
        raise KernelError("log_mel_wave: launch failed")

    monkeypatch.setattr(training, "log_mel_wave", broken_featurizer)
    with pytest.raises(KernelError):
        training.train(steps=2, out_path=tmp_path / "a.msgpack", **TINY)
    monkeypatch.undo()

    def broken_batch(*a, **k):
        raise ValueError("synthesis failed")

    monkeypatch.setattr(training, "make_batch", broken_batch)
    with pytest.raises(ValueError, match="synthesis failed"):
        training.train(steps=2, out_path=tmp_path / "b.msgpack", **TINY)
    assert not list(tmp_path.glob("*.msgpack"))


def test_dispatcher_runs_train(tmp_path):
    """``python -m sdtk_tpu_torch train --device cpu ...`` exits 0 and writes
    its file; an unknown tool exits 2."""
    out = tmp_path / "cli.msgpack"
    res = subprocess.run(
        [sys.executable, "-m", "sdtk_tpu_torch", "train", "--device", "cpu", "--steps", "1",
         "--speakers", "2", "--batch", "4", "--seconds", "1.0", "--crop-seconds", "1.0",
         "--channels", "16", "--out", str(out)],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "saved params -> " in res.stderr and out.exists()
    res = subprocess.run([sys.executable, "-m", "sdtk_tpu_torch", "nope"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 2 and "unknown tool" in res.stderr
