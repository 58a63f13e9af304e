"""The port's offline diarization slice against the JAX package: the host
copies (VAD, denoise, turns, resegment, boundary, DER) on fixed inputs,
the torch spectral device path (run on the CPU), and the whole
``Diarizer.diarize_waveform`` on a short synthetic meeting."""

from __future__ import annotations

import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from sdtk_tpu.backends.base import register_backend as jax_register
from sdtk_tpu.backends.tpu import TpuBackend
from sdtk_tpu.cluster import boundary as jboundary
from sdtk_tpu.cluster import der as jder
from sdtk_tpu.cluster import resegment as jreseg
from sdtk_tpu.cluster import spectral as jspectral
from sdtk_tpu.cluster import turns as jturns
from sdtk_tpu.models.vad import VadScorer as JaxVadScorer
from sdtk_tpu.pipeline import denoise as jdenoise
from sdtk_tpu.pipeline import vad as jvad
from sdtk_tpu.pipeline.diarize import DiarizeConfig as JaxDiarizeConfig
from sdtk_tpu.pipeline.diarize import Diarizer as JaxDiarizer
from sdtk_tpu_torch.backends.base import register_backend
from sdtk_tpu_torch.backends.gpu import GpuBackend
from sdtk_tpu_torch.cluster import boundary, der, resegment, spectral, turns
from sdtk_tpu_torch.data import synth
from sdtk_tpu_torch.models.vad import VadScorer
from sdtk_tpu_torch.ops.fbank import log_mel_reference
from sdtk_tpu_torch.pipeline import denoise, vad
from sdtk_tpu_torch.pipeline.diarize import DiarizeConfig, Diarizer, to_rttm

MODELS = Path(__file__).resolve().parent.parent / "models"


def _same_up_to_permutation(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        return False
    pairs = set(zip(a.tolist(), b.tolist()))
    return len(pairs) == len(set(a.tolist())) == len(set(b.tolist()))


def _embeddings(n: int = 120, k: int = 3, seed: int = 0):
    """Unit window embeddings of k speakers in runs of 4-10 windows."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((k, 192))
    labels, spk = [], 0
    while len(labels) < n:
        labels += [spk] * int(rng.integers(4, 11))
        spk = (spk + 1 + int(rng.integers(k - 1))) % k
    labels = np.asarray(labels[:n])
    emb = centers[labels] + 0.9 * rng.standard_normal((n, 192))
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    return emb.astype(np.float32), labels, np.arange(n) * 0.375


@pytest.fixture(scope="module")
def meeting():
    wav, ref = synth.build_meeting(0, 3, 8, 2.5)
    return wav, ref


def test_synth_copy_is_exact():
    from sdtk_tpu.data.synth import synth_utterance

    np.testing.assert_array_equal(synth.synth_utterance(3, 7, 0.5),
                                  synth_utterance(3, 7, 0.5))


def test_vad_scorer_matches_jax(meeting):
    """Same checkpoint, same features → same frame probabilities; the
    inferred graph flags are recorded with the port's weights."""
    wav, _ = meeting
    feats = log_mel_reference(wav[:24000])
    port, ref = VadScorer(), JaxVadScorer()
    assert port.cfg.deep == (ref.w3 is not None) and port.cfg.extra_feats == ref.extra_feats
    assert port.cfg.deep and port.cfg.extra_feats  # the bundled v4 checkpoint
    np.testing.assert_allclose(port.frame_probs(feats), ref.frame_probs(feats),
                               rtol=0, atol=1e-6)


def test_trained_vad_and_denoise_match_jax(meeting):
    wav, _ = meeting
    rng = np.random.default_rng(1)
    noisy = (wav + 0.05 * np.sin(2 * np.pi * 220 * np.arange(len(wav)) / 16000)
             + 0.01 * rng.standard_normal(len(wav))).astype(np.float32)
    got = vad.trained_vad_analysis(noisy, 16000, 1.0, 0.375, return_grid=True)
    want = jvad.trained_vad_analysis(noisy, 16000, 1.0, 0.375, return_grid=True)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]
    np.testing.assert_allclose(got[3][1], want[3][1], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(
        denoise.estimate_and_subtract(noisy, 16000, got[2], frame_probs=got[3]),
        jdenoise.estimate_and_subtract(noisy, 16000, want[2], frame_probs=want[3]))


def test_clustering_copies_give_identical_labels():
    """Fixed embeddings → the same labels from every host copy."""
    emb, _, starts = _embeddings()
    got = turns.turn_cluster(emb, starts, hop_s=0.375, tau=0.43, device="cpu")
    want = jturns.turn_cluster(emb, starts, hop_s=0.375, tau=0.43)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1] == 3
    for k in (None, 3):
        got = spectral.spectral_cluster(emb, n_speakers=k, merge_rel=0.75, device="cpu")
        want = jspectral.spectral_cluster(emb, n_speakers=k, merge_rel=0.75)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
    labels = want[0]
    noisy = labels.copy()
    noisy[::7] = (noisy[::7] + 1) % 3
    np.testing.assert_array_equal(resegment.resegment(emb, noisy, 3),
                                  jreseg.resegment(emb, noisy, 3))
    spans = [(0.0, 10.0), (10.4, 30.0), (30.2, 50.0)]
    assert boundary.refine_segments(emb, labels, starts, 1.0, speech_spans=spans) == \
        jboundary.refine_segments(emb, labels, starts, 1.0, speech_spans=spans)


def test_viterbi_decode_matches_jax_scan_path():
    """The port decodes with NumPy at every length; the JAX package's
    lax.scan decode (its path above 16,384 windows) gives the same path."""
    rng = np.random.default_rng(2)
    ll = rng.standard_normal((300, 4)).astype(np.float32) * 2.0
    fn = jreseg._viterbi_jax_fn(4, -0.1, -3.0)
    np.testing.assert_array_equal(resegment.viterbi_decode(ll, 4), np.asarray(fn(ll)))


def test_der_copy_matches():
    ref = [(0.0, 3.0, "A"), (3.0, 7.5, "B"), (7.0, 9.0, "A")]
    hyp = [(0.1, 3.2, "x"), (3.2, 9.0, "y")]
    for collar in (0.0, 0.25, 0.75):
        assert der.diarization_error_rate(ref, hyp, collar) == \
            jder.diarization_error_rate(ref, hyp, collar)


@pytest.mark.parametrize("subspace", [False, True], ids=["eigh", "subspace"])
def test_spectral_device_path_matches_jax(subspace):
    """force_device: torch (here on the CPU) against JAX.  Eigenvalues
    agree to 1e-4 (f32 solvers); labels agree up to permutation.  The
    subspace start differs (torch.Generator vs PRNGKey(0)), so
    eigenvectors are not compared."""
    import jax.numpy as jnp

    emb, truth, _ = _embeddings(n=200, seed=4)
    got = spectral.spectral_cluster(emb, n_speakers=None, force_device=True,
                                    use_subspace=subspace, device="cpu")
    want = jspectral.spectral_cluster(emb, n_speakers=None, force_device=True,
                                      use_subspace=subspace)
    assert got[1] == want[1] == 3
    assert _same_up_to_permutation(got[0], want[0])
    assert _same_up_to_permutation(got[0], truth)

    lam, _ = spectral.spectral_eig(torch.from_numpy(emb), 8, use_subspace=subspace)
    lap = jspectral.normalized_laplacian(
        jspectral.refine_affinity(jspectral.cosine_affinity(jnp.asarray(emb))))
    want_lam = (np.asarray(jspectral.topk_eigvecs_subspace(lap, 9)[0]) if subspace
                else np.asarray(jnp.linalg.eigh(lap)[0]))
    np.testing.assert_allclose(lam.numpy()[:9], want_lam[:9], rtol=0, atol=1e-4)


def test_entry_points_raise_without_cuda(monkeypatch):
    """The default device is CUDA; without it the entry points raise
    rather than run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Diarizer()
    with pytest.raises(RuntimeError, match="CUDA"):
        GpuBackend()
    with pytest.raises(RuntimeError, match="CUDA"):
        spectral.spectral_cluster(_embeddings(n=20)[0], force_device=True)


@pytest.fixture(scope="module")
def f32_checkpoint(tmp_path_factory):
    """A copy of the bundled checkpoint (with its calibration) and an f32
    ``.config.json`` sidecar, so both packages run the algorithm in f32."""
    d = tmp_path_factory.mktemp("ckpt")
    for suffix in (".msgpack", ".calib.json"):
        shutil.copy(MODELS / f"ecapatdnn-fam5tel{suffix}", d / f"ecapatdnn-fam5tel{suffix}")
    (d / "ecapatdnn-fam5tel.config.json").write_text(
        '{"model": {"dtype": "float32"}, "frontend": {"compute_dtype": "float32"}}')
    return d / "ecapatdnn-fam5tel.msgpack"


def test_whole_slice_matches_jax(meeting, f32_checkpoint):
    """Port Diarizer(device="cpu") against the JAX Diarizer on a ~22 s
    3-speaker meeting, both at f32 through registered backends.  Same
    speaker count and window labels (up to permutation); RTTM boundaries
    within 1e-4 s (the embeddings differ by f32 rounding only, measured
    ~1e-7 s)."""
    jax_register("tpu-f32-parity", TpuBackend(params_path=f32_checkpoint))
    register_backend("gpu-f32-parity", GpuBackend(params_path=f32_checkpoint, device="cpu"))
    wav, ref = meeting
    got = Diarizer("gpu-f32-parity", DiarizeConfig(embed_chunk=64),
                   device="cpu").diarize_waveform(wav)
    want = JaxDiarizer("tpu-f32-parity", JaxDiarizeConfig(embed_chunk=64)).diarize_waveform(wav)
    assert got["n_speakers"] == want["n_speakers"] == 3
    assert _same_up_to_permutation(got["window_labels"], want["window_labels"])
    np.testing.assert_array_equal(got["window_starts"], want["window_starts"])
    assert [s[2] for s in got["segments"]] == [s[2] for s in want["segments"]]
    np.testing.assert_allclose([s[:2] for s in got["segments"]],
                               [s[:2] for s in want["segments"]], rtol=0, atol=1e-4)
    assert der.diarization_error_rate(ref, got["segments"], collar=0.75)["der"] <= 0.05
    assert set(got["timings"]) >= {"vad", "embed", "cluster", "resegment", "segments"}


def test_cli_writes_rttm(tmp_path, meeting, f32_checkpoint):
    from sdtk_tpu_torch.cli import diarize as cli
    from sdtk_tpu_torch.utils.audio import load_wav, save_wav

    wav, _ = meeting
    path = tmp_path / "m.wav"
    save_wav(path, wav[: 16000 * 8])
    # 16-bit PCM: half a step of rounding plus the 32767/32768 write/read scales
    np.testing.assert_allclose(load_wav(path), wav[: 16000 * 8], rtol=0, atol=1e-4)
    register_backend("gpu-f32-cli", GpuBackend(params_path=f32_checkpoint, device="cpu"))
    out = tmp_path / "m.rttm"
    rc = cli.main([str(path), "--format", "rttm", "--device", "cpu", "-b", "gpu-f32-cli",
                   "-q", "-o", str(out)])
    lines = out.read_text().splitlines()
    assert rc == 0 and lines and all(line.startswith("SPEAKER rec 1 ") for line in lines)
    assert to_rttm({"segments": []}) == ""
