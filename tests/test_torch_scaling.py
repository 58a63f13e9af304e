"""The port's data-parallel scaling harness
(sdtk_tpu_torch/evals/benchmark_scaling.py) against evals/benchmark_scaling.py:

1. the serving embed (K1's plain version -> ECAPA -> L2) at channels 64 on
   2 x 1 s in f32 equals JAX's ``fbank.log_mel`` -> ``EcapaTdnn.apply`` ->
   L2 on the same numpy-seeded waveform, the flax variables loaded through
   the port's converter (``tests/test_parallel.py``'s bar: atol 2e-4,
   rtol 1e-3);
2. the harness on 1 and 2 gloo ranks (``--device cpu``): its per-size
   lines have the JAX script's keys (read from its source: the per-size
   dict and the summary's ``summary`` / ``note`` that
   ``tests/test_parallel.py`` reads), and each rank's embeddings equal the
   one-rank run's on the same rows (the harness's bf16 on the CPU, the
   same code in another process: atol 1e-6);
3. ``roofline()`` has the JAX function's keys, and every constant names
   where it was measured (the card and its power limit) or its spec.
"""

from __future__ import annotations

import ast
import contextlib
import importlib.util
import io
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdtk_tpu.models.ecapa import EcapaConfig as JaxEcapaConfig
from sdtk_tpu.models.ecapa import EcapaTdnn as JaxEcapa
from sdtk_tpu.ops import fbank as jfbank
from sdtk_tpu_torch.evals import benchmark_scaling as bs
from sdtk_tpu_torch.ops.fbank import FrontendConfig
from sdtk_tpu_torch.utils.checkpoint import ecapa_state_dict

REPO = Path(__file__).resolve().parent.parent
JAX_SCRIPT = REPO / "evals" / "benchmark_scaling.py"
CHANNELS, BATCH, SECONDS = 64, 2, 1.0


def _jax_script():
    spec = importlib.util.spec_from_file_location("jax_benchmark_scaling", JAX_SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_row_keys() -> set[str]:
    """The keys of the per-size dict the JAX script appends to ``results``."""
    for node in ast.walk(ast.parse(JAX_SCRIPT.read_text())):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "append" and isinstance(node.func.value, ast.Name)
                and node.func.value.id == "results" and isinstance(node.args[0], ast.Dict)):
            return {k.value for k in node.args[0].keys}
    raise AssertionError("no results.append({...}) in the JAX script")


def _variables(seed: int = 0) -> dict:
    """flax init of the JAX script's tower at CHANNELS in f32, batch
    statistics redrawn so that BatchNorm is not the identity."""
    v = jax.jit(JaxEcapa(JaxEcapaConfig(channels=CHANNELS, dtype="float32")).init)(
        jax.random.PRNGKey(seed), jnp.zeros((1, 64, 80)))
    v = jax.tree_util.tree_map(np.asarray, v)
    rng = np.random.default_rng(seed + 1)

    def redraw(t):
        return {k: redraw(x) if isinstance(x, dict) else
                (np.abs(rng.standard_normal(x.shape)) + 0.5 if k == "var"
                 else 0.1 * rng.standard_normal(x.shape)).astype(np.float32)
                for k, x in t.items()}

    return {"params": v["params"], "batch_stats": redraw(v["batch_stats"])}


def test_serving_embed_equals_jax():
    wav = bs.row_block(0, BATCH, int(SECONDS * 16000))
    variables = _variables()
    jcfg = jfbank.FrontendConfig(compute_dtype="float32")
    model = JaxEcapa(JaxEcapaConfig(channels=CHANNELS, dtype="float32"))

    @jax.jit
    def jax_embed(w):
        feats, mask = jfbank.log_mel(w, jcfg)
        emb = model.apply(variables, feats, mask=mask)
        return emb / jnp.maximum(jnp.linalg.norm(emb, axis=-1, keepdims=True), 1e-12)

    want = np.asarray(jax_embed(jnp.asarray(wav)))
    embed = bs.serving_embed(CHANNELS, torch.device("cpu"), "float32",
                             FrontendConfig(compute_dtype="float32"))
    embed.model.load_state_dict(ecapa_state_dict(variables))
    got = embed(torch.from_numpy(wav)).numpy()
    assert got.shape == (BATCH, 192)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)


def test_harness_on_one_and_two_gloo_ranks(tmp_path):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = bs.main(["--devices", "1,2", "--device", "cpu", "--per-device-batch", str(BATCH),
                      "--seconds", str(SECONDS), "--iters", "2", "--channels", str(CHANNELS)],
                     dump=tmp_path)
    assert rc == 0
    lines = [json.loads(ln) for ln in out.getvalue().splitlines()]
    rows, last = lines[:-1], lines[-1]
    assert [set(r) for r in rows] == [_jax_row_keys()] * 2
    assert [r["devices"] for r in last["summary"]] == [1, 2]
    assert [r["batch"] for r in last["summary"]] == [BATCH, 2 * BATCH]
    assert last["note"].startswith("CPU ranks over gloo")
    assert "scaling_efficiency" in last["summary"][1]
    for r in last["summary"]:
        assert r["throughput_audio_s_per_s"] > 0
    assert [len(last["ranks"][n]) for n in ("1", "2")] == [1, 2]
    for rank_rows in last["ranks"].values():
        for r in rank_rows:
            assert r["ms"] > 0  # CPU tensors: the plain versions, no launch
            assert r["launches"] == {"log_mel_wave": 0, "cosine": 0, "identify_topk": 0,
                                     "fbank_frames": 0, "tower_epilogue": 0}

    one = np.load(tmp_path / "emb-1-0.npy")
    two = [np.load(tmp_path / f"emb-2-{r}.npy") for r in range(2)]
    assert one.shape == two[0].shape == two[1].shape == (BATCH, 192)
    np.testing.assert_allclose(two[0], one, atol=1e-6, rtol=0)  # the same rows 0, 1
    # rank 1's rows 2, 3 through the one-rank path of this process
    embed = bs.serving_embed(CHANNELS, torch.device("cpu"))
    want = embed(torch.from_numpy(bs.row_block(BATCH, BATCH, int(SECONDS * 16000))))
    np.testing.assert_allclose(two[1], want.float().numpy(), atol=1e-6, rtol=0)
    assert not np.allclose(two[1], one, atol=1e-3)


def test_rows_do_not_depend_on_the_split():
    whole = bs.row_block(0, 4, 800)
    np.testing.assert_array_equal(np.concatenate([bs.row_block(0, 2, 800),
                                                  bs.row_block(2, 2, 800)]), whole)


def test_roofline_keys_and_sources():
    want = _jax_script().roofline()
    got = bs.roofline()
    assert set(got) == set(want)
    assert {r["devices"] for r in got["sp_longform_1h"]} >= {2, 4}
    for row in got["sp_longform_1h"]:
        assert set(want["sp_longform_1h"][0]) <= set(row)
        assert 0 < row["efficiency_bound"] <= 1.0
    sources = got["constants"]["sources"]
    assert set(sources) == {"card_rate", "decode", "topology", "link", "longform_stages"}
    for key in ("card_rate", "decode", "longform_stages"):
        assert bs.CARD in sources[key], key
        assert "NVIDIA H100" in sources[key] and " W" in sources[key]
    assert "H100" in sources["topology"] and "data sheet" in sources["link"]
    text = json.dumps(got)
    for tpu_word in ("v5e", "TPU", "ICI", "chips_per_host"):
        assert tpu_word not in text
    assert got["constants"]["card_rate_audio_s_per_s"] != 57_000.0  # the JAX script's chip
    assert got["constants"]["link_bytes_per_s"] != 186e9
    # arguments replace the defaults, and the command line names them as given
    dp = bs.roofline(card_rate=1000.0, decode_per_core=100.0, decode_scaling=0.5,
                     host_cores=8, cards_per_host=1)["dp_embed"]
    assert dp["per_card_decode_fed_audio_s_per_s"] == 400.0
    assert dp["decode_gated_fraction"] == 0.4
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert bs.main(["--roofline", "--link-bytes-per-s", "1e11"]) == 0
    printed = json.loads(out.getvalue())
    assert printed["constants"]["link_bytes_per_s"] == 1e11
    assert printed["constants"]["sources"]["link"] == "given on the command line"
    assert printed["constants"]["sources"]["card_rate"] == bs.CARD_RATE_SOURCE


def test_main_needs_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bs.main(["--devices", "1", "--iters", "1"])
