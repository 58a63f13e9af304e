"""The port's identify path (backends/base.py, backends/gpu.py,
pipeline/identify.py, cli/detection.py) against the JAX package's.

1. A ``LocalEmbeddingBackend`` subclass in each package returns the same
   NumPy window embeddings; ``identify_speaker`` must give the same rows on
   the dense route (the device cosine route, run on the CPU), the fused
   top-k route, the cohort AS-norm route and the calibrated route.
   Speaker ids and their order are equal; scores agree to 1e-5 (f32
   products summed in another order; AS-norm z-scores to 1e-4).
2. ``GpuBackend(device="cpu")`` against ``TpuBackend``, both with one
   narrow random ECAPA tower written as a flax msgpack and read by
   ``utils/checkpoint.py``, at f32, through ``enroll`` and ``identify``:
   the same ranking, scores within 1e-4.
3. The port's detection CLI with ``--device cpu``.
"""

from __future__ import annotations

import json

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sdtk_tpu.backends import base as jbase
from sdtk_tpu.backends.tpu import TpuBackend
from sdtk_tpu.models.ecapa import EcapaConfig as JaxEcapaConfig
from sdtk_tpu.models.ecapa import EcapaTdnn as JaxEcapa
from sdtk_tpu.pipeline import identify as jident
from sdtk_tpu_torch.backends import base
from sdtk_tpu_torch.backends.gpu import GpuBackend
from sdtk_tpu_torch.cli import detection
from sdtk_tpu_torch.data.synth import synth_utterance
from sdtk_tpu_torch.ops import cosine, topk_fused
from sdtk_tpu_torch.pipeline import identify
from sdtk_tpu_torch.store import profiles
from sdtk_tpu_torch.utils.audio import save_wav

from conftest import make_wav

D = 192
N_SPEAKERS = 2200  # W·N·D ≥ 2^24 at W = 40: the dense route leaves NumPy
PLANTED = {7: 0.95, 1500: 0.85, 0: 0.75}  # speaker index → query closeness


def _queries_and_profiles(seed: int = 0):
    """(40, D) window embeddings, 13-14 of them near each planted
    speaker's profile vector, and (N_SPEAKERS, D) random profile vectors."""
    rng = np.random.default_rng(seed)
    prof = rng.standard_normal((N_SPEAKERS, D)).astype(np.float32)
    groups = np.array_split(np.arange(40), len(PLANTED))
    q = np.empty((40, D), np.float32)
    for rows, (spk, mix) in zip(groups, PLANTED.items()):
        unit = prof[spk] / np.linalg.norm(prof[spk])
        noise = rng.standard_normal((len(rows), D)) / np.sqrt(D)
        q[rows] = mix * unit + np.sqrt(1 - mix**2) * noise
    return q, prof


QUERIES, PROFILE_VECS = _queries_and_profiles()


def _affine(sims, gain=0.6, eer=0.3):
    return np.clip(0.354 + (np.asarray(sims) - eer) * gain, 0.0, 1.0)


def _fixed_backend(pkg_base, calibrated: bool, cohort):
    class Fixed(pkg_base.LocalEmbeddingBackend):
        """Every recording embeds to the same fixed windows."""

        @property
        def name(self):
            return "fixed"

        def embed_waveform(self, wav):
            v = QUERIES.mean(axis=0)
            return v / np.linalg.norm(v)

        def embed_windows(self, wav, window_s=3.0, hop_s=1.5):
            return QUERIES

        def calibrate_score(self, sims):
            return _affine(sims) if calibrated else sims

    backend = Fixed()
    if cohort is not None:
        backend.cohort = cohort
    return backend


@pytest.fixture(scope="module")
def fixed_store(tmp_path_factory):
    """Candidates in memory, their vectors on disk: one record each."""
    root = tmp_path_factory.mktemp("store")
    (root / "embeddings").mkdir()
    candidates = []
    for i, v in enumerate(PROFILE_VECS):
        np.save(root / "embeddings" / f"emb-{i:05d}.npy", v)
        candidates.append({"id": f"spk-{i:05d}", "names": {"default": f"S{i}"},
                           "embeddings": {"fixed": [{"id": f"emb-{i:05d}",
                                                     "vector_file": f"emb-{i:05d}.npy",
                                                     "trust_level": "low"}]}})
    audio = make_wav(root / "q.wav", seconds=1.0, seed=0)
    return root, candidates, audio


def _cohort(seed: int = 5) -> np.ndarray:
    c = np.random.default_rng(seed).standard_normal((96, D)).astype(np.float32)
    return c / np.linalg.norm(c, axis=1, keepdims=True)


ROUTES = {
    # route: (fused threshold N, calibrated, cohort, identify threshold, score atol)
    "dense": ("8192", False, None, 0.5, 1e-5),
    "fused": ("100", False, None, 0.5, 1e-5),
    "asnorm": ("100", False, _cohort(), 8.0, 1e-4),
    "calibrated": ("8192", True, None, 0.5, 1e-5),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_identify_speaker_routes_match_jax(route, fixed_store, monkeypatch):
    root, candidates, audio = fixed_store
    fused_n, calibrated, cohort, threshold, atol = ROUTES[route]
    monkeypatch.setenv("SPEAKERS_EMBEDDINGS_DIR", str(root))
    monkeypatch.setenv("SDTK_IDENTIFY_TOPK_N", fused_n)
    port = _fixed_backend(base, calibrated, cohort)
    port.device = "cpu"
    ref = _fixed_backend(jbase, calibrated, cohort)

    launches = (cosine.cosine.launches, topk_fused.identify_topk_fused.launches)
    got = port.identify_speaker(audio, candidates, threshold=threshold)
    want = ref.identify_speaker(audio, candidates, threshold=threshold)
    assert (cosine.cosine.launches, topk_fused.identify_topk_fused.launches) == launches

    planted = [f"spk-{i:05d}" for i in PLANTED]
    assert sorted(r["speaker_id"] for r in want) == sorted(planted)
    assert [r["speaker_id"] for r in got] == [r["speaker_id"] for r in want]
    for g, w in zip(got, want):
        assert g["embedding_id"] == w["embedding_id"] and g["backend"] == "fixed"
        assert abs(g["similarity"] - w["similarity"]) <= atol
        assert g["confidence"] == g["similarity"]

    v_got = port.verify_speaker(audio, candidates[1500], threshold=threshold)
    v_want = ref.verify_speaker(audio, candidates[1500], threshold=threshold)
    assert v_got["match"] and v_want["match"]
    assert abs(v_got["confidence"] - v_want["confidence"]) <= atol


def test_fused_route_calibrates_only_survivors(fixed_store, monkeypatch):
    """The fused route and the dense route rank the same speakers with the
    same calibrated scores (calibration is monotonic)."""
    root, candidates, audio = fixed_store
    monkeypatch.setenv("SPEAKERS_EMBEDDINGS_DIR", str(root))
    backend = _fixed_backend(base, True, None)
    backend.device = "cpu"
    monkeypatch.setenv("SDTK_IDENTIFY_TOPK_N", "100")
    fused = backend.identify_speaker(audio, candidates, threshold=0.5)
    monkeypatch.setenv("SDTK_IDENTIFY_TOPK_N", "not-a-number")  # warns, uses 8192: dense
    dense = backend.identify_speaker(audio, candidates, threshold=0.5)
    assert [r["speaker_id"] for r in fused] == [r["speaker_id"] for r in dense]
    np.testing.assert_allclose([r["similarity"] for r in fused],
                               [r["similarity"] for r in dense], rtol=0, atol=1e-5)


# -- the GPU backend against the TPU backend, one narrow random tower ------

TOWER = {"channels": 64, "se_bottleneck": 32, "attention_channels": 32, "mfa_channels": 192,
         "dtype": "float32"}


@pytest.fixture(scope="module")
def narrow_checkpoint(tmp_path_factory):
    """A random narrow ECAPA, BatchNorm statistics redrawn, as a flax
    msgpack with an f32 config sidecar and a calibration sidecar."""
    d = tmp_path_factory.mktemp("narrow")
    v = jax.jit(JaxEcapa(JaxEcapaConfig(**TOWER)).init)(jax.random.PRNGKey(3),
                                                       jnp.zeros((1, 64, 80)))
    v = jax.tree_util.tree_map(np.asarray, v)
    rng = np.random.default_rng(4)

    def redraw(t):
        return {k: redraw(x) if isinstance(x, dict) else
                (np.abs(rng.standard_normal(x.shape)) + 0.5 if k == "var"
                 else 0.1 * rng.standard_normal(x.shape)).astype(np.float32)
                for k, x in t.items()}

    variables = {"params": v["params"], "batch_stats": redraw(v["batch_stats"])}
    path = d / "narrow.msgpack"
    path.write_bytes(flax.serialization.msgpack_serialize(variables))
    path.with_suffix(".config.json").write_text(json.dumps(
        {"model": TOWER, "frontend": {"compute_dtype": "float32"}}))
    path.with_suffix(".calib.json").write_text('{"eer_threshold": 0.2, "gain": 0.5}')
    return path


@pytest.fixture(scope="module")
def voices(tmp_path_factory):
    """Enrollment and held-out query WAVs of three synthetic speakers."""
    d = tmp_path_factory.mktemp("voices")
    out = {}
    for spk in (0, 1, 2):
        save_wav(d / f"enroll{spk}.wav", synth_utterance(spk, 10 + spk, 4.0))
        save_wav(d / f"query{spk}.wav", synth_utterance(spk, 50 + spk, 5.0))
        out[spk] = (d / f"enroll{spk}.wav", d / f"query{spk}.wav")
    return out


def test_gpu_backend_on_cpu_matches_tpu_backend(narrow_checkpoint, voices, tmp_path,
                                                monkeypatch):
    port = GpuBackend(channels=64, params_path=narrow_checkpoint, device="cpu")
    ref = TpuBackend(channels=64, params_path=narrow_checkpoint)
    assert port.model_version == ref.model_version == "ecapa-c64-v1"
    assert port.embedding_dim == ref.embedding_dim == 192
    np.testing.assert_allclose(port.calibrate_score(np.array([-0.5, 0.2, 0.9, 3.0])),
                               ref.calibrate_score(np.array([-0.5, 0.2, 0.9, 3.0])))
    wav = synth_utterance(1, 77, 7.3)
    np.testing.assert_allclose(port.embed_windows(wav), ref.embed_windows(wav),
                               rtol=0, atol=1e-4)

    monkeypatch.setitem(base._instances, ("gpu-narrow",), port)
    monkeypatch.setitem(base._REGISTRY, "gpu-narrow", "<instance:gpu-narrow>")
    jbase.register_backend("tpu-narrow", ref)
    results = {}
    for name, ident, pkg in (("port", identify, "gpu-narrow"), ("jax", jident, "tpu-narrow")):
        monkeypatch.setenv("SPEAKERS_EMBEDDINGS_DIR", str(tmp_path / name))
        kw = {"device": "cpu"} if name == "port" else {}
        for spk, (enroll_wav, _) in voices.items():
            ident.enroll(f"v{spk}", enroll_wav, backend_name=pkg, create_missing=True,
                         name=f"Voice {spk}", **kw)
        results[name] = [ident.identify(voices[spk][1], backend_name=pkg, threshold=-1.0, **kw)
                         for spk in voices]
        results[name + "-verify"] = ident.verify("v1", voices[1][1], backend_name=pkg,
                                                 threshold=-1.0, **kw)
    for got, want in zip(results["port"], results["jax"]):
        assert [r["speaker_id"] for r in got] == [r["speaker_id"] for r in want]
        assert len(got) == 3
        np.testing.assert_allclose([r["score"] for r in got], [r["score"] for r in want],
                                   rtol=0, atol=1e-4)
        assert [r["name"] for r in got] == [r["name"] for r in want]
        assert [r["trust_level"] for r in got] == [r["trust_level"] for r in want]
    assert results["port-verify"]["match"] == results["jax-verify"]["match"]
    assert abs(results["port-verify"]["confidence"]
               - results["jax-verify"]["confidence"]) <= 1e-4


def test_entry_points_default_to_cuda(monkeypatch, voices, speakers_dir, tmp_path):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    profiles.save_speaker(profiles.create_speaker_profile("v0", "V0"))
    with pytest.raises(RuntimeError, match="CUDA"):
        identify.enroll("v0", voices[0][0])
    transcript = tmp_path / "t.json"
    transcript.write_text(json.dumps({"results": [
        {"type": "word", "start_time": 0.5, "end_time": 1.5, "speaker": "S1",
         "alternatives": [{"content": "hi"}]},
        {"type": "word", "start_time": 1.5, "end_time": 2.0, "speaker": "S2",
         "alternatives": [{"content": "yo"}]}]}))
    assert identify.resolve_segments(None, transcript, "S1") == [(0.5, 1.5)]
    assert identify.resolve_segments(None, transcript, "S1") == \
        jident.resolve_segments(None, transcript, "S1")
    assert identify.resolve_segments([(0.0, 1.0)], transcript, "S1") == [(0.0, 1.0)]


# -- the detection CLI on the CPU --------------------------------------------


def test_detection_cli_on_cpu(narrow_checkpoint, voices, speakers_dir, monkeypatch, capsys):
    port = GpuBackend(channels=64, params_path=narrow_checkpoint, device="cpu")
    monkeypatch.setitem(base._instances, ("gpu",), port)

    def run(*argv):
        rc = detection.main(list(argv))
        out = capsys.readouterr()
        return rc, out.out, out.err

    for spk in voices:
        assert run("add", f"v{spk}", "--name", f"Voice {spk}", "--tag", "t")[0] == 0
    assert run("add", "v0", "--name", "again")[0] == 1
    assert run("add", "Bad Id!", "--name", "x")[0] == 1
    for spk, (enroll_wav, _) in voices.items():
        rc, _, status = run("enroll", f"v{spk}", str(enroll_wav), "--device", "cpu")
        assert rc == 0 and f"Enrolled 'v{spk}'" in status
    assert run("enroll", "nobody", str(voices[0][0]), "--device", "cpu")[0] == 1
    assert run("enroll", "v0", "missing.wav", "--device", "cpu")[0] == 1

    rc, out, _ = run("list", "--format", "ids")
    assert rc == 0 and out.split() == ["v0", "v1", "v2"]
    rc, out, _ = run("list")
    assert rc == 0 and "Voice 2" in out and "EMBEDDINGS" in out
    rc, out, _ = run("show", "v1")
    assert rc == 0 and json.loads(out)["embeddings"]["gpu"][0]["model_version"] == "ecapa-c64-v1"
    rc, out, _ = run("embeddings", "v1", "--show-trust")
    assert rc == 0 and "[low]" in out

    rc, out, _ = run("identify", str(voices[2][1]), "--format", "json", "--device", "cpu",
                     "--threshold", "-1")
    rows = json.loads(out)
    assert rc == 0 and {r["speaker_id"] for r in rows} == {"v0", "v1", "v2"}
    want = identify.identify(voices[2][1], threshold=-1.0, device="cpu")
    assert [r["speaker_id"] for r in rows] == [r["speaker_id"] for r in want]
    rc, out, _ = run("identify", str(voices[2][1]), "--device", "cpu", "--threshold", "2")
    assert rc == 0 and "No matching speakers found." in out
    assert run("identify", "missing.wav", "--device", "cpu")[0] == 1

    rc, out, _ = run("verify", rows[0]["speaker_id"], str(voices[2][1]), "--device", "cpu",
                     "--threshold", "-1")
    assert rc == 0 and out.startswith("MATCH")
    rc, out, _ = run("verify", "v1", str(voices[2][1]), "--device", "cpu", "--threshold", "2")
    assert rc == 1 and out.startswith("NO MATCH")
    assert run("verify", "nobody", str(voices[2][1]), "--device", "cpu")[0] == 1
