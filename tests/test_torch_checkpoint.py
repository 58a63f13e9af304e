"""The port's flax-msgpack reader and ECAPA weight converter
(sdtk_tpu_torch/utils/checkpoint.py) against flax itself, and the rule
that the port imports neither JAX nor the JAX package."""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import flax.serialization
import numpy as np
import pytest
import torch

from sdtk_tpu_torch.models.ecapa import EcapaConfig, EcapaTdnn
from sdtk_tpu_torch.utils.checkpoint import ecapa_state_dict, read_msgpack

REPO = Path(__file__).resolve().parent.parent
MODELS = REPO / "models"


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def test_port_imports_without_jax_or_sdtk_tpu():
    """Every module of the port imports with jax and flax blocked, and
    none of them pulls in sdtk_tpu."""
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['flax'] = None\n"
        "import importlib, pkgutil, sdtk_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(sdtk_tpu_torch.__path__, 'sdtk_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'sdtk_tpu' or m.startswith('sdtk_tpu.')]\n"
        "assert not bad, bad\n"
        "for m in ('sdtk_tpu_torch.ops.cosine', 'sdtk_tpu_torch.ops.topk_fused',\n"
        "          'sdtk_tpu_torch.ops.fbank_frames', 'sdtk_tpu_torch.store.profiles',\n"
        "          'sdtk_tpu_torch.pipeline.identify', 'sdtk_tpu_torch.cli.detection',\n"
        "          'sdtk_tpu_torch.models.xvector', 'sdtk_tpu_torch.pipeline.streaming',\n"
        "          'sdtk_tpu_torch.cluster.ahc', 'sdtk_tpu_torch.cluster.spectral'):\n"
        "    assert m in mods, m\n"
        "assert 'yaml' not in sys.modules\n"
        "print(len(mods))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 40


def test_chip_smoke_imports_no_jax():
    src = (REPO / "chip_smoke.py").read_text()
    assert "import jax" not in src and "sdtk_tpu." not in src.replace("sdtk_tpu_torch", "")


@pytest.mark.parametrize("name", ["ecapatdnn-fam5tel.msgpack", "vad.msgpack"])
def test_reader_matches_flax(name):
    """Same tree, same leaf dtypes/shapes/values as msgpack_restore."""
    path = MODELS / name
    want = _leaves(flax.serialization.msgpack_restore(path.read_bytes()))
    got = _leaves(read_msgpack(path))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_reader_ext_types_bf16_scalars_and_chunks(tmp_path, monkeypatch):
    """bf16 leaves (widened exactly to f32), numpy scalars, Python complex
    and flax's chunked large-array form all decode like flax."""
    import jax.numpy as jnp

    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 64)
    rng = np.random.default_rng(0)
    tree = {
        "a": {"big": rng.standard_normal((10, 7)).astype(np.float32)},  # 280 B > 64: chunked
        "bf": np.asarray(rng.standard_normal(5), jnp.bfloat16),
        "s": np.float32(2.5),
        "i": np.arange(3, dtype=np.int32),
        "c": complex(1.0, -2.0),
    }
    path = tmp_path / "t.msgpack"
    path.write_bytes(flax.serialization.msgpack_serialize(tree))
    want = flax.serialization.msgpack_restore(path.read_bytes())
    got = read_msgpack(path)
    np.testing.assert_array_equal(got["a"]["big"], want["a"]["big"])
    np.testing.assert_array_equal(got["bf"], np.asarray(want["bf"], np.float32))
    assert got["bf"].dtype == np.float32
    assert got["s"] == want["s"] and got["c"] == want["c"]
    np.testing.assert_array_equal(got["i"], want["i"])


def test_converter_layouts_fam5tel():
    """flax Conv (k, in, out) → torch (out, in, k), Dense (in, out) → (out, in),
    BN statistics from batch_stats; the state dict loads strictly."""
    tree = read_msgpack(MODELS / "ecapatdnn-fam5tel.msgpack")
    sd = ecapa_state_dict(tree)
    model = EcapaTdnn(EcapaConfig())
    model.load_state_dict(sd, strict=True)
    p, bs = tree["params"], tree["batch_stats"]
    k = p["block2"]["res2"]["conv3"]["kernel"]  # (3, 64, 64)
    np.testing.assert_array_equal(sd["block2.res2.conv3.weight"].numpy(), k.transpose(2, 1, 0))
    d = p["block1"]["se"]["fc1"]["kernel"]  # (512, 128)
    np.testing.assert_array_equal(sd["block1.se.fc1.weight"].numpy(), d.T)
    np.testing.assert_array_equal(sd["stem.bn.running_var"].numpy(), bs["stem"]["bn"]["var"])
    np.testing.assert_array_equal(sd["asp_bn.weight"].numpy(), p["asp_bn"]["scale"])
    assert all(t.dtype == torch.float32 for t in sd.values())
