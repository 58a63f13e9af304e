"""The port's fixed-k ``cluster_stage`` / ``eigengap_count`` against the JAX
package's on 8 separable clusters, ``ahc_labels`` (a NumPy copy: equal
labels), ``to_transcript_skeleton`` (byte-equal JSON) and the diarize
CLI's ``--format transcript``."""

from __future__ import annotations

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdtk_tpu.cluster import ahc as jahc
from sdtk_tpu.cluster import spectral as jspectral
from sdtk_tpu.pipeline.diarize import to_transcript_skeleton as jax_skeleton
from sdtk_tpu_torch.cluster import ahc, spectral
from sdtk_tpu_torch.pipeline.diarize import to_transcript_skeleton


def _same_partition(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    pairs = set(zip(a.tolist(), b.tolist()))
    return a.shape == b.shape and len(pairs) == len(set(a.tolist())) == len(set(b.tolist()))


def _clusters(k: int = 8, per: int = 24, d: int = 64, noise: float = 0.35, seed: int = 0):
    """k separable groups of unit vectors, interleaved in time."""
    rng = np.random.default_rng(seed)
    truth = np.tile(np.arange(k), per)
    emb = rng.standard_normal((k, d))[truth] + noise * rng.standard_normal((k * per, d))
    return (emb / np.linalg.norm(emb, axis=1, keepdims=True)).astype(np.float32), truth


@pytest.mark.parametrize("subspace", [False, True])
def test_cluster_stage_matches_jax(subspace):
    """Same partition up to permutation, and the true one; labels come
    back on the input's device."""
    emb, truth = _clusters()
    got = spectral.cluster_stage(torch.from_numpy(emb), 8, use_subspace=subspace)
    want = np.asarray(jspectral.cluster_stage(jnp.asarray(emb), 8, use_subspace=subspace))
    assert got.device == torch.device("cpu") and got.shape == (len(emb),)
    assert _same_partition(got.numpy(), want)
    assert _same_partition(got.numpy(), truth)
    bench = spectral.bench_cluster_fn(8, use_subspace=subspace)
    assert torch.equal(bench(torch.from_numpy(emb)), got)


@pytest.mark.parametrize("k_true, max_speakers", [(8, 8), (3, 8), (5, 4), (1, 6)])
def test_eigengap_count_matches_jax(k_true, max_speakers):
    """On each package's own Laplacian spectrum, and on one shared
    spectrum: the same count."""
    emb, _ = _clusters(k=k_true, per=200 // k_true, seed=k_true)
    lam, _ = spectral.spectral_eig(torch.from_numpy(emb), max_speakers, use_subspace=False)
    lap = jspectral.normalized_laplacian(
        jspectral.refine_affinity(jspectral.cosine_affinity(jnp.asarray(emb))))
    jlam = jnp.linalg.eigh(lap)[0]
    got = int(spectral.eigengap_count(lam, max_speakers))
    assert got == int(jspectral.eigengap_count(jlam, max_speakers))
    assert int(spectral.eigengap_count(torch.from_numpy(np.array(jlam)), max_speakers)) == got
    assert 1 <= got <= max_speakers


@pytest.mark.parametrize("n, threshold, n_speakers", [(0, 0.55, None), (1, 0.55, None),
                                                      (23, 0.55, None), (23, 0.2, None),
                                                      (30, 0.55, 3), (17, 0.9, 1)])
def test_ahc_labels_identical(n, threshold, n_speakers):
    emb, _ = _clusters(k=4, per=8, d=16, noise=0.8, seed=n)
    emb = emb[:n]
    got = ahc.ahc_labels(emb, threshold, n_speakers)
    want = jahc.ahc_labels(emb, threshold, n_speakers)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_transcript_skeleton_byte_equal():
    segs = [(np.float64(0.0), np.float64(1.625), "S1"), (1.625, 3.0, "S2"),
            (np.float32(3.0), np.float32(7.3), "S1")]
    result = {"segments": segs, "n_speakers": 2}
    got = json.dumps(to_transcript_skeleton(result), indent=2)
    assert got == json.dumps(jax_skeleton(result), indent=2)
    assert json.loads(got)["metadata"]["source"] == "sdtk_tpu.diarize"
    assert to_transcript_skeleton({"segments": []}) == jax_skeleton({"segments": []})


def test_cli_transcript_format(tmp_path, monkeypatch):
    """``--format transcript`` writes the skeleton of the diarizer's
    segments, as the JAX CLI does."""
    from sdtk_tpu_torch.cli import diarize as cli
    from sdtk_tpu_torch.pipeline import diarize
    from sdtk_tpu_torch.utils.audio import save_wav

    path = tmp_path / "m.wav"
    save_wav(path, np.zeros(16000, np.float32))
    result = {"segments": [(0.0, 2.5, "S1"), (2.5, 4.0, "S2")], "n_speakers": 2}

    class FixedDiarizer:
        def __init__(self, *args, **kwargs):
            pass

        def diarize_file(self, audio_path):
            return dict(result)

    monkeypatch.setattr(diarize, "Diarizer", FixedDiarizer)
    out = tmp_path / "m.json"
    rc = cli.main([str(path), "--format", "transcript", "--device", "cpu", "-q", "-o", str(out)])
    assert rc == 0
    assert out.read_text() == json.dumps(jax_skeleton(result), indent=2) + "\n"
