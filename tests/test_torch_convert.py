"""The port's SpeechBrain ECAPA converter
(sdtk_tpu_torch/tools/convert_ecapa.py) against the JAX tool
(tools/convert_ecapa.py, imported by path as tests/test_convert.py does),
on seeded state dicts with the published key names, at the JAX test's
small shapes, a SpeechBrain-layout c64 of two blocks at 80 mels, and the
published width (C = 1024, MFA 3072): the same trees leaf for leaf, the
same msgpack bytes and sidecars from both CLIs, the port's tower on the
converted weights against JAX's flax forward and the float64 reference,
and the converted file served by ``GpuBackend(device="cpu")`` like
``TpuBackend``.  The port's side runs with jax, flax, optax and orbax
blocked where it runs as a command."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import flax.serialization
import jax
import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from sdtk_tpu_torch.tools import convert_ecapa as port  # noqa: E402
from tools import convert_ecapa as jax_tool  # noqa: E402

# (channels, scale, se_bottleneck, attention, mfa, emb_dim, n_mels, blocks)
SHAPES = {
    "jax-test": (64, 4, 16, 32, 192, 48, 24, 3),  # tests/test_convert.py's
    "sb-c64": (64, 8, 32, 32, 192, 192, 80, 2),
    "published": (1024, 8, 128, 128, 3072, 192, 80, 3),  # spkrec-ecapa-voxceleb
}
BLOCKED = ("jax", "flax", "optax", "orbax", "orbax.checkpoint")


def make_sb_state_dict(shape: str, seed: int = 0) -> dict[str, torch.Tensor]:
    """A SpeechBrain ECAPA state dict (published key names) with weights of
    std 1/sqrt(fan_in) and BatchNorm statistics near the identity."""
    c, scale, se, attn, mfa, emb, n_mels, blocks = SHAPES[shape]
    g = torch.Generator().manual_seed(seed)

    def conv(prefix, o, i, k):
        return {f"{prefix}.weight": torch.randn(o, i, k, generator=g) / (i * k) ** 0.5,
                f"{prefix}.bias": 0.05 * torch.randn(o, generator=g)}

    def bn(prefix, n):
        return {
            f"{prefix}.weight": 1.0 + 0.1 * torch.randn(n, generator=g),
            f"{prefix}.bias": 0.1 * torch.randn(n, generator=g),
            f"{prefix}.running_mean": 0.1 * torch.randn(n, generator=g),
            f"{prefix}.running_var": (1.0 + 0.1 * torch.randn(n, generator=g)).abs(),
            f"{prefix}.num_batches_tracked": torch.tensor(100),
        }

    sd: dict[str, torch.Tensor] = {}
    sd |= conv("blocks.0.conv.conv", c, n_mels, 5) | bn("blocks.0.norm.norm", c)
    width = c // scale
    for i in range(1, blocks + 1):
        p = f"blocks.{i}"
        sd |= conv(f"{p}.tdnn1.conv.conv", c, c, 1) | bn(f"{p}.tdnn1.norm.norm", c)
        for j in range(scale - 1):
            sd |= conv(f"{p}.res2net_block.blocks.{j}.conv.conv", width, width, 3)
            sd |= bn(f"{p}.res2net_block.blocks.{j}.norm.norm", width)
        sd |= conv(f"{p}.tdnn2.conv.conv", c, c, 1) | bn(f"{p}.tdnn2.norm.norm", c)
        sd |= conv(f"{p}.se_block.conv1.conv", se, c, 1)
        sd |= conv(f"{p}.se_block.conv2.conv", c, se, 1)
    sd |= conv("mfa.conv.conv", mfa, blocks * c, 1) | bn("mfa.norm.norm", mfa)
    sd |= conv("asp.tdnn.conv.conv", attn, 3 * mfa, 1) | bn("asp.tdnn.norm.norm", attn)
    sd |= conv("asp.conv.conv", mfa, attn, 1)
    sd |= bn("asp_bn.norm", 2 * mfa)
    sd |= conv("fc.conv", emb, 2 * mfa, 1)
    return sd


def _numpy(sd):
    return {k: v.numpy() for k, v in sd.items()}


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out |= _leaves(v, f"{prefix}{k}/")
        else:
            out[f"{prefix}{k}"] = v
    return out


def run_port(*argv: str) -> subprocess.CompletedProcess:
    """``python -m sdtk_tpu_torch.tools.convert_ecapa *argv`` with JAX blocked."""
    code = ("import sys\n"
            f"for m in {BLOCKED!r}: sys.modules[m] = None\n"
            "from sdtk_tpu_torch.tools.convert_ecapa import main\n"
            f"raise SystemExit(main({list(argv)!r}))\n")
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_trees_bytes_and_config_equal_jax(shape):
    """Leaf for leaf the same tree (names, order, dtypes, values), the
    same config dict, and ``msgpack_bytes`` equal to flax's ``to_bytes``."""
    sd = _numpy(make_sb_state_dict(shape))
    want_vars, want_cfg = jax_tool.convert(sd)
    got_vars, got_cfg = port.convert(sd)
    assert got_cfg == want_cfg
    want, got = _leaves(want_vars), _leaves(got_vars)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    from sdtk_tpu_torch.utils.checkpoint import msgpack_bytes

    assert msgpack_bytes(got_vars) == flax.serialization.to_bytes(want_vars)
    port.verify_structure(got_vars, got_cfg)  # strict load into the port's tower
    jax_tool.verify_structure(want_vars, want_cfg)
    if shape == "published":
        n = sum(int(v.size) for k, v in sd.items() if "num_batches" not in k)
        assert n == 20_805_952 and got_cfg["model"]["mfa_channels"] == 3072


@pytest.mark.parametrize("shape", list(SHAPES))
def test_cli_files_equal_jax(tmp_path, shape):
    """Both commands on one ``.ckpt``: byte-equal msgpack and sidecar, and
    the same report but for the paths."""
    ckpt = tmp_path / "embedding_model.ckpt"
    torch.save(make_sb_state_dict(shape), ckpt)
    res = run_port(str(ckpt), "-o", str(tmp_path / "port.msgpack"))
    assert res.returncode == 0, res.stderr[-3000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert jax_tool.main([str(ckpt), "-o", str(tmp_path / "jax.msgpack")]) == 0
    assert (tmp_path / "port.msgpack").read_bytes() == (tmp_path / "jax.msgpack").read_bytes()
    assert ((tmp_path / "port.config.json").read_bytes()
            == (tmp_path / "jax.config.json").read_bytes())
    assert got["model"] == port.convert(_numpy(make_sb_state_dict(shape)))[1]["model"]
    assert got["source_params"] == sum(v.numel() for v in make_sb_state_dict(shape).values())
    assert Path(got["sidecar"]) == tmp_path / "port.config.json"


@pytest.mark.parametrize("shape", ["jax-test", "sb-c64"])
def test_port_forward_matches_flax_and_reference(shape):
    """The port's ``EcapaTdnn`` in f32 on the converted tree against JAX's
    flax forward (f32) and the float64 ``TorchEcapaRef``: relative error
    ≤ 2e-4, tests/test_convert.py's bar.  The two packages' references are
    the same arithmetic: equal to the bit."""
    from sdtk_tpu.models import EcapaConfig, EcapaTdnn

    sd = _numpy(make_sb_state_dict(shape, seed=3))
    variables, config = port.convert(sd)
    n_mels = config["model"]["n_mels"]
    feats = np.random.default_rng(1).standard_normal((2, 50, n_mels)).astype(np.float32)
    model = port.verify_structure(variables, config, dtype="float32")
    with torch.inference_mode():
        got = model(torch.from_numpy(feats)).numpy()
    kw = dict(config["model"], dilations=tuple(config["model"]["dilations"]), dtype="float32")
    flax_emb = np.asarray(jax.jit(EcapaTdnn(EcapaConfig(**kw)).apply)(variables, feats))
    mc = model.cfg
    ref = port.TorchEcapaRef(sd, mc.scale, mc.dilations).forward(feats)
    np.testing.assert_array_equal(
        ref, jax_tool.TorchEcapaRef(sd, mc.scale, mc.dilations).forward(feats))
    assert got.shape == flax_emb.shape == ref.shape == (2, config["model"]["emb_dim"])
    for want in (flax_emb, ref):
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err <= 2e-4, err


def test_convert_rejects_unknown_keys():
    sd = _numpy(make_sb_state_dict("jax-test"))
    sd["classifier.weight"] = np.zeros((4, 4))
    with pytest.raises(ValueError, match="unmapped"):
        port.convert(sd)
    with pytest.raises(ValueError, match="2 entries but the checkpoint has 3"):
        port.convert(_numpy(make_sb_state_dict("jax-test")), (2, 3))


def test_load_state_dict_npz_and_nested_ckpt(tmp_path):
    sd = _numpy(make_sb_state_dict("jax-test"))
    np.savez(tmp_path / "weights.npz", **sd)
    for loaded in (port.load_state_dict(tmp_path / "weights.npz"),
                   jax_tool.load_state_dict(tmp_path / "weights.npz")):
        assert set(loaded) == set(sd)
        np.testing.assert_array_equal(loaded["fc.conv.weight"], sd["fc.conv.weight"])
    torch.save({"model": make_sb_state_dict("jax-test")}, tmp_path / "nested.ckpt")
    loaded = port.load_state_dict(tmp_path / "nested.ckpt")
    assert set(loaded) == set(sd)


HYPERPARAMS_YAML = """\
# ############################################################################
# Model: ECAPA-TDNN for speaker verification (published directory layout)
# ############################################################################

pretrained_path: speechbrain/spkrec-ecapa-voxceleb

sample_rate: 16000
n_mels: 24

embedding_model: !new:speechbrain.lobes.models.ECAPA_TDNN.ECAPA_TDNN
    input_size: !ref <n_mels>

mean_var_norm: !new:speechbrain.processing.features.InputNormalization
    norm_type: global
    std_norm: False

mean_var_norm_emb: !new:speechbrain.processing.features.InputNormalization
    norm_type: global
    std_norm: False
"""


@pytest.mark.parametrize("text", [
    HYPERPARAMS_YAML,
    HYPERPARAMS_YAML.replace("norm_type: global\n    std_norm: False\n\nmean_var_norm_emb",
                             "norm_type: sentence\n    std_norm: False\n\nmean_var_norm_emb"),
    "n_mels: 80  # comment\n  n_mels: 12\nblock:\n    norm_type: sentence\n",
    "",
], ids=["published-global", "sentence", "indented-and-comment", "empty"])
def test_parse_hyperparams_matches_jax(text):
    assert port.parse_hyperparams(text) == jax_tool.parse_hyperparams(text)
    if text == HYPERPARAMS_YAML:
        hp = port.parse_hyperparams(text)
        assert hp["n_mels"] == 24 and hp["sample_rate"] == 16000
        assert hp["norm_types"] == {"mean_var_norm": "global", "mean_var_norm_emb": "global"}


def _make_checkpoint_dir(tmp_path):
    """The published artifact layout: hyperparams.yaml, embedding_model.ckpt,
    the two mean_var_norm stats files, and classifier files to ignore."""
    d = tmp_path / "spkrec-ecapa-voxceleb"
    d.mkdir()
    (d / "hyperparams.yaml").write_text(HYPERPARAMS_YAML)
    torch.save(make_sb_state_dict("jax-test"), d / "embedding_model.ckpt")
    g = torch.Generator().manual_seed(9)
    n_mels, emb = SHAPES["jax-test"][6], SHAPES["jax-test"][5]
    torch.save({"count": 1000,
                "glob_mean": 0.5 * torch.randn(n_mels, generator=g),
                "glob_std": (1.0 + 0.1 * torch.randn(n_mels, generator=g)).abs(),
                "spk_dict_mean": {}, "spk_dict_std": {}, "spk_dict_count": {}},
               d / "mean_var_norm.ckpt")
    torch.save({"count": 1000, "glob_mean": 0.1 * torch.randn(emb, generator=g)},
               d / "mean_var_norm_emb.ckpt")
    torch.save({"weight": torch.zeros(4, emb)}, d / "classifier.ckpt")
    (d / "label_encoder.txt").write_text("'spk1' => 0\n")
    return d


def _probe_wav(path: Path) -> None:
    from sdtk_tpu_torch.utils.audio import save_wav

    rng = np.random.default_rng(4)
    save_wav(path, 0.2 * rng.standard_normal(16000).astype(np.float32), 16000)


def test_checkpoint_directory_and_verify_cpu(tmp_path, monkeypatch):
    """Directory ingestion through both commands: the same files, global
    input-norm stats and embedding-norm stats in the sidecar, classifier
    files ignored; ``--verify --device cpu`` puts the port's tower within
    cosine 0.9999 of the float64 reference; the port's backend applies the
    input norm (dropping it changes the embedding)."""
    d = _make_checkpoint_dir(tmp_path)
    _probe_wav(tmp_path / "probe.wav")
    res = run_port(str(d), "-o", str(tmp_path / "vox.msgpack"), "--verify",
                   str(tmp_path / "probe.wav"), "--device", "cpu")
    assert res.returncode == 0, res.stderr[-3000:]
    info = json.loads(res.stdout.strip().splitlines()[-1])
    assert set(info["directory_extras"]) == {"hyperparams", "input_norm", "embedding_norm"}
    assert info["verify"]["device"] == "cpu"
    assert info["verify"]["cosine_similarity"] >= 0.9999
    assert info["verify"]["max_rel_err"] < 1e-2
    assert jax_tool.main([str(d), "-o", str(tmp_path / "jax.msgpack")]) == 0
    assert (tmp_path / "vox.msgpack").read_bytes() == (tmp_path / "jax.msgpack").read_bytes()
    assert (tmp_path / "vox.config.json").read_text() == (tmp_path / "jax.config.json").read_text()

    sidecar = json.loads((tmp_path / "vox.config.json").read_text())
    assert len(sidecar["input_norm"]["mean"]) == len(sidecar["input_norm"]["std"]) == 24
    assert len(sidecar["embedding_norm"]["mean"]) == 48
    assert sidecar["frontend"]["sample_rate"] == 16000

    from sdtk_tpu_torch.backends.gpu import GpuBackend

    monkeypatch.setenv("SDTK_MODEL_PATH", str(tmp_path / "vox.msgpack"))
    wav = 0.2 * np.random.default_rng(5).standard_normal(24000).astype(np.float32)
    e_norm = GpuBackend(device="cpu").embed_waveform(wav)
    sidecar.pop("input_norm")
    (tmp_path / "vox.config.json").write_text(json.dumps(sidecar))
    e_raw = GpuBackend(device="cpu").embed_waveform(wav)
    assert e_norm.shape == e_raw.shape == (48,)
    assert not np.allclose(e_norm, e_raw)


def test_directory_nmels_mismatch_raises(tmp_path):
    d = _make_checkpoint_dir(tmp_path)
    (d / "hyperparams.yaml").write_text(HYPERPARAMS_YAML.replace("n_mels: 24", "n_mels: 80"))
    res = run_port(str(d), "-o", str(tmp_path / "x.msgpack"))
    assert res.returncode != 0
    assert "n_mels=80" in res.stderr
    assert not (tmp_path / "x.msgpack").exists()


def test_verify_needs_cuda_unless_cpu(tmp_path):
    """``--verify`` runs on cuda by default and raises without it: no
    quiet fallback to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    ckpt = tmp_path / "embedding_model.ckpt"
    torch.save(make_sb_state_dict("jax-test"), ckpt)
    _probe_wav(tmp_path / "probe.wav")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port.main([str(ckpt), "-o", str(tmp_path / "x.msgpack"), "--verify",
                   str(tmp_path / "probe.wav")])


# Both backends in f32 (tower and frontend) on one 1 s row of seeded noise:
# the same algorithm in another summation order (XLA's and PyTorch's CPU
# convolutions); measured max|Δ| 3.6e-7 (jax-test) and 1.2e-7 (sb-c64) on
# unit embeddings.
BACKEND_ATOL = 2e-6


@pytest.mark.parametrize("shape", ["jax-test", "sb-c64"])
def test_gpu_backend_serves_converted_file_like_tpu_backend(tmp_path, monkeypatch, shape):
    """``GpuBackend(device="cpu")`` under ``SDTK_MODEL_PATH`` reads the
    sidecar's tower and SpeechBrain frontend, and embeds 1 s of noise as
    JAX's ``TpuBackend`` does through a sidecar copy in f32."""
    ckpt = tmp_path / "embedding_model.ckpt"
    torch.save(make_sb_state_dict(shape, seed=7), ckpt)
    out = tmp_path / "sb.msgpack"
    assert port.main([str(ckpt), "-o", str(out)]) == 0
    sidecar = json.loads(out.with_suffix(".config.json").read_text())
    sidecar["model"]["dtype"] = "float32"
    sidecar["frontend"]["compute_dtype"] = "float32"
    out.with_suffix(".config.json").write_text(json.dumps(sidecar))
    monkeypatch.setenv("SDTK_MODEL_PATH", str(out))

    from sdtk_tpu.backends.tpu import TpuBackend
    from sdtk_tpu_torch.backends.gpu import GpuBackend

    backend = GpuBackend(device="cpu")
    eng = backend.engine
    assert eng.params_source == str(out)
    assert eng.cfg.window == "hamming" and eng.cfg.n_fft == 400 and eng.cfg.center
    assert eng.cfg.log_scale == "db" and eng.cfg.mel_fmin == 0.0 and eng.cfg.preemphasis == 0.0
    assert eng.emb_dim == backend.embedding_dim == SHAPES[shape][5]
    assert eng.model.cfg.mfa_bn and eng.model.cfg.asp_tdnn
    assert eng.model.cfg.channels == 64 and eng.model.cfg.dtype == "float32"
    wav = np.random.default_rng(2).standard_normal(16000).astype(np.float32)
    got = backend.embed_waveform(wav)
    want = TpuBackend().embed_waveform(wav)
    assert got.shape == want.shape == (eng.emb_dim,)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=BACKEND_ATOL)
