"""The plain reference against the port's own plain (float32, CPU) path at a
small size: the same features, the same embeddings, the same clusters.
These tests import the port; the reference itself does not."""

import numpy as np
import pytest
import torch
from conftest import TINY

from benchlib import check, harness, synth, weights
from reference import cluster as ref_cluster
from reference import flaxio
from reference import frontend as ref_frontend

FRONTENDS = {
    "c512": {"sample_rate": 16000, "win_length": 400, "hop_length": 160, "n_fft": 512,
             "n_mels": 80, "window": "hann", "preemphasis": 0.97, "log_floor": 1e-6,
             "mean_norm": True, "compute_dtype": "float32", "log_scale": "ln",
             "mel_fmin": 20.0, "center": False},
    "speechbrain": {"sample_rate": 16000, "win_length": 400, "hop_length": 160, "n_fft": 400,
                    "n_mels": 80, "window": "hamming", "preemphasis": 0.0, "log_floor": 1e-10,
                    "mean_norm": True, "compute_dtype": "float32", "log_scale": "db",
                    "mel_fmin": 0.0, "center": True},
}


def clips(n_rows=4, seconds=1.5, seed=3):
    x = synth.voice_pool(seed, 2, n_rows // 2, seconds)[0]
    return torch.from_numpy(x)


@pytest.mark.parametrize("name", sorted(FRONTENDS))
def test_log_mel_matches_the_ports_plain_frontend_over_valid_frames(name):
    from sdtk_tpu_torch.ops.fbank import FrontendConfig, log_mel

    fe = FRONTENDS[name]
    x = clips()
    lengths = torch.tensor([24000, 24000, 17000, 9600])
    x = x * (torch.arange(x.shape[1])[None, :] < lengths[:, None])
    feats, mask = log_mel(x, FrontendConfig(**fe), lengths=lengths)
    for row, length in enumerate(lengths.tolist()):
        want = ref_frontend.log_mel(x[row : row + 1, :length], fe)[0]
        assert int(mask[row].sum()) == want.shape[0] == ref_frontend.n_valid(length, fe)
        got = feats[row, : want.shape[0]]
        assert float((got - want).abs().max()) < 2e-3


@pytest.mark.parametrize("layout", ["c512", "speechbrain"])
def test_ecapa_matches_the_ports_float32_tower_with_masks(layout):
    from sdtk_tpu_torch.models.ecapa import EcapaConfig, EcapaTdnn
    from sdtk_tpu_torch.ops.fbank import FrontendConfig, log_mel
    from sdtk_tpu_torch.utils.checkpoint import ecapa_state_dict

    fe = FRONTENDS[layout]
    model = dict(TINY, dtype="float32", mfa_bn=layout != "c512", asp_tdnn=layout != "c512")
    tree = weights.seeded_tree(model, 11, "cpu")
    port = EcapaTdnn(EcapaConfig(**dict(model, dilations=tuple(model["dilations"]))))
    port.load_state_dict(ecapa_state_dict(tree))
    port.eval()
    x = clips()
    lengths = torch.tensor([24000, 20000, 16000, 24000])
    x = x * (torch.arange(x.shape[1])[None, :] < lengths[:, None])
    with torch.no_grad():
        feats, mask = log_mel(x, FrontendConfig(**fe), lengths=lengths)
        got = torch.nn.functional.normalize(port(feats, mask), dim=1).numpy()
    ref = harness.Reference({"frontend": fe, "model": model}, tree, "cpu")
    want = ref.embed(x, lengths.numpy())
    assert check.cos_gap(got, want) < 1e-6


def blobs(n, k, dim=16, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((k, dim)) * 3
    truth = rng.integers(k, size=n)
    return (centers[truth] + rng.standard_normal((n, dim)) * 0.3).astype(np.float32), truth


@pytest.mark.parametrize("subspace", [False, True])
def test_fixed_k_clustering_matches_cluster_stage(subspace):
    from sdtk_tpu_torch.cluster.spectral import cluster_stage

    emb, truth = blobs(300, 8)
    got = cluster_stage(torch.from_numpy(emb), max_speakers=8, use_subspace=subspace).numpy()
    want = ref_cluster.cluster_fixed(emb, 8)
    assert check.label_mismatch(got, want) == 0
    assert check.label_mismatch(want, truth) == 0


@pytest.mark.parametrize("k", [2, 4, 5])
def test_counted_clustering_matches_spectral_cluster(k):
    from sdtk_tpu_torch.cluster.spectral import spectral_cluster

    emb, truth = blobs(400, k, seed=k)
    got, count = spectral_cluster(emb, max_speakers=8, force_device=True, device="cpu")
    want, ref_count = ref_cluster.cluster_count(emb, 8)
    assert count == ref_count
    assert check.label_mismatch(got, want) == 0


def test_label_mismatch_counts_after_the_best_matching():
    assert check.label_mismatch(np.array([0, 0, 1, 1, 2]), np.array([2, 2, 0, 0, 1])) == 0
    assert check.label_mismatch(np.array([0, 0, 1, 1, 2]), np.array([2, 2, 0, 1, 1])) == 1
    assert check.label_mismatch(np.array([0, 0]), np.array([0, 0, 0])) == 3


def test_seeded_weights_round_trip_through_the_ports_reader(tmp_path):
    from sdtk_tpu_torch.utils.checkpoint import read_msgpack

    cfg = {"name": "tiny", "model": TINY, "frontend": FRONTENDS["speechbrain"],
           "weights": {"seed": 2}}
    path = weights.weights_file(cfg, tmp_path, "cpu")
    ours, theirs = flaxio.read(path), read_msgpack(path)
    flat = {}

    def walk(a, b, key=""):
        if isinstance(a, dict):
            assert sorted(a) == sorted(b), key
            for k in a:
                walk(a[k], b[k], f"{key}/{k}")
        else:
            flat[key] = np.array_equal(a, b)
    walk(ours, theirs)
    assert flat and all(flat.values())
    assert path.with_suffix(".config.json").exists()
    assert path.parent.parent == tmp_path / ".benchcache"
