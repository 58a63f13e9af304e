"""``GpuBackend.embed_batch`` / ``EmbedEngine.embed_rows`` against the JAX
TpuBackend's, in f32 on one narrow random ECAPA: same-length rows of
16 000, 24 000 and 48 000 samples (both length buckets; row counts that
the JAX engine spreads over its W buckets 1, 4 and 16 and the port over
``max_windows``-sized calls), and ragged input, which both pool per
utterance."""

from __future__ import annotations

import json

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sdtk_tpu.backends.tpu import TpuBackend
from sdtk_tpu.models.ecapa import EcapaConfig as JaxEcapaConfig
from sdtk_tpu.models.ecapa import EcapaTdnn as JaxEcapa
from sdtk_tpu_torch.backends.base import LocalEmbeddingBackend
from sdtk_tpu_torch.backends.gpu import GpuBackend
from sdtk_tpu_torch.data.synth import synth_utterance

TOWER = {"channels": 64, "se_bottleneck": 32, "attention_channels": 32, "mfa_channels": 192,
         "dtype": "float32"}
TOL = 1e-5


@pytest.fixture(scope="module")
def backends(tmp_path_factory):
    """Both packages' backends on one random narrow ECAPA (BatchNorm
    statistics redrawn), f32 tower and frontend, max_windows 16."""
    d = tmp_path_factory.mktemp("narrow")
    v = jax.tree_util.tree_map(np.asarray, JaxEcapa(JaxEcapaConfig(**TOWER)).init(
        jax.random.PRNGKey(5), jnp.zeros((1, 64, 80))))
    rng = np.random.default_rng(6)
    stats = jax.tree_util.tree_map_with_path(
        lambda p, x: (np.abs(rng.standard_normal(x.shape)) + 0.5 if p[-1].key == "var"
                      else 0.1 * rng.standard_normal(x.shape)).astype(np.float32),
        v["batch_stats"])
    path = d / "narrow.msgpack"
    path.write_bytes(flax.serialization.msgpack_serialize(
        {"params": v["params"], "batch_stats": stats}))
    path.with_suffix(".config.json").write_text(json.dumps(
        {"model": TOWER, "frontend": {"compute_dtype": "float32"}}))
    return (GpuBackend(channels=64, params_path=path, device="cpu"),
            TpuBackend(channels=64, params_path=path))


def _rows(n_rows: int, n: int, seed: int) -> list[np.ndarray]:
    return [synth_utterance(i % 5, seed + i, n / 16000)[:n].astype(np.float32)
            for i in range(n_rows)]


@pytest.mark.parametrize("n_rows, n", [(5, 16000), (1, 24000), (4, 24000), (3, 48000),
                                       (18, 24000)])
def test_embed_batch_same_length_rows(backends, n_rows, n):
    """Rows of one length ≤ one window go through embed_rows on both
    sides: 16 000 and 24 000 samples pad to 24 000, 48 000 stays; 18 rows
    take two of the port's calls (16 + 2)."""
    port, ref = backends
    wavs = _rows(n_rows, n, seed=n_rows + n)
    got, want = port.embed_batch(wavs), np.asarray(ref.embed_batch(wavs))
    assert got.shape == want.shape == (n_rows, 192)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)


def test_embed_rows_with_lengths(backends):
    """Explicit valid lengths below the row length mask the same frames on
    both sides."""
    port, ref = backends
    rows = np.stack(_rows(4, 24000, seed=9))
    lengths = np.asarray([24000, 9000, 400, 16001], np.int32)
    got = port.engine.embed_rows(rows, lengths)
    want = np.asarray(ref.engine.embed_rows(rows, lengths))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_embed_batch_ragged_and_long(backends):
    """Ragged lengths, or rows longer than one window, pool each utterance
    over its 3 s windows (embed_one) on both sides."""
    port, ref = backends
    wavs = [synth_utterance(1, 3, 2.0), synth_utterance(2, 4, 7.3), synth_utterance(3, 5, 0.6)]
    got, want = port.embed_batch(wavs), np.asarray(ref.embed_batch(wavs))
    assert got.shape == (3, 192)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    long = _rows(2, 60000, seed=1)
    np.testing.assert_allclose(port.embed_batch(long), np.asarray(ref.embed_batch(long)),
                               rtol=0, atol=TOL)


def test_embed_batch_empty_and_default(backends):
    """No input → (0, D); a backend without a batched path loops over
    embed_waveform, as the JAX base class does."""
    port, _ = backends
    assert port.embed_batch([]).shape == (0, 192)

    class Loop(LocalEmbeddingBackend):
        name = "loop"
        embedding_dim = 3

        def embed_waveform(self, wav):
            return np.asarray([len(wav), wav.sum(), 1.0], np.float32)

    out = Loop().embed_batch([np.ones(4, np.float32), np.ones(7, np.float32)])
    np.testing.assert_array_equal(out, [[4, 4, 1], [7, 7, 1]])
    assert Loop().embed_batch([]).shape == (0, 3)
