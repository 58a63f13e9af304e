"""The port's streaming diarizer (sdtk_tpu_torch/pipeline/streaming.py)
against the JAX package's ``OnlineDiarizer``, both in f32 through
registered backends with the bundled ECAPA: live events, window labels
and starts, ``segments()``, ``finalize()``, the trained speech gate,
silence mid-stream, the new-speaker bar, chunk-size equivalence, and
profiles from ``enroll_discovered`` that the JAX package reads."""

from __future__ import annotations

import shutil
from pathlib import Path

import numpy as np
import pytest

from sdtk_tpu.backends import base as jbase
from sdtk_tpu.backends.tpu import TpuBackend
from sdtk_tpu.pipeline.streaming import OnlineDiarizer as JaxOnlineDiarizer
from sdtk_tpu.pipeline.streaming import StreamingConfig as JaxStreamingConfig
from sdtk_tpu.store import profiles as jprofiles
from sdtk_tpu_torch.backends import base
from sdtk_tpu_torch.backends.gpu import GpuBackend
from sdtk_tpu_torch.cluster.der import diarization_error_rate
from sdtk_tpu_torch.data.synth import build_meeting, synth_utterance
from sdtk_tpu_torch.pipeline.streaming import OnlineDiarizer, StreamingConfig

MODELS = Path(__file__).resolve().parent.parent / "models"
CHUNK = 8000  # 0.5 s


@pytest.fixture(scope="module")
def backends(tmp_path_factory):
    """The bundled checkpoint and its calibration with an f32 sidecar,
    registered in both packages."""
    d = tmp_path_factory.mktemp("ckpt")
    for suffix in (".msgpack", ".calib.json"):
        shutil.copy(MODELS / f"ecapatdnn-fam5tel{suffix}", d / f"ecapatdnn-fam5tel{suffix}")
    (d / "ecapatdnn-fam5tel.config.json").write_text(
        '{"model": {"dtype": "float32"}, "frontend": {"compute_dtype": "float32"}}')
    path = d / "ecapatdnn-fam5tel.msgpack"
    jbase.register_backend("tpu-f32-stream", TpuBackend(params_path=path))
    base.register_backend("gpu-f32-stream", GpuBackend(params_path=path, device="cpu"))
    return "gpu-f32-stream", "tpu-f32-stream"


@pytest.fixture(scope="module")
def meeting():
    """A ~22 s three-speaker meeting."""
    return build_meeting(1, 3, 8, 2.5)


def _stream(d, wav, chunk=CHUNK):
    events = []
    for i in range(0, len(wav), chunk):
        events += d.feed(wav[i : i + chunk])
    return events


def _both(backends, wav, chunk=CHUNK, **cfg):
    port = OnlineDiarizer(backends[0], StreamingConfig(**cfg), device="cpu")
    ref = JaxOnlineDiarizer(backends[1], JaxStreamingConfig(**cfg))
    return (port, _stream(port, wav, chunk)), (ref, _stream(ref, wav, chunk))


def _assert_same_events(got, want):
    assert [(e["start"], e["end"], e["speaker"]) for e in got] == \
        [(e["start"], e["end"], e["speaker"]) for e in want]
    np.testing.assert_allclose([e["similarity"] for e in got], [e["similarity"] for e in want],
                               rtol=0, atol=1e-3 + 1e-9)


def _assert_same_segments(got, want):
    assert [s[2] for s in got] == [s[2] for s in want]
    np.testing.assert_allclose([s[:2] for s in got], [s[:2] for s in want], rtol=0, atol=1e-4)


@pytest.mark.parametrize("vad", ["energy", "trained"])
def test_online_diarizer_matches_jax(backends, meeting, vad):
    """Same events, window labels and starts, live segments and finalize()
    segments (labels equal, boundaries within 1e-4 s), 3 speakers."""
    wav, ref = meeting
    (port, got), (jax_d, want) = _both(backends, wav, vad=vad)
    assert got and len(got) == len(want)
    _assert_same_events(got, want)
    assert port.state.window_starts == jax_d.state.window_starts
    assert port.state.window_labels == jax_d.state.window_labels
    np.testing.assert_allclose(np.stack(port.state.window_embs),
                               np.stack(jax_d.state.window_embs), rtol=0, atol=1e-5)
    _assert_same_segments(port.segments(), jax_d.segments())
    fin, jfin = port.finalize(), jax_d.finalize()
    assert fin["n_speakers"] == jfin["n_speakers"] == 3
    assert fin["window_labels"] == jfin["window_labels"]
    _assert_same_segments(fin["segments"], jfin["segments"])
    assert diarization_error_rate(ref, fin["segments"], collar=0.75)["der"] <= 0.05


def test_chunk_size_equivalence(backends, meeting):
    """0.5 s, 1.7 s or one-shot feeding: identical window starts and
    labels (chunking only buffers)."""
    wav, _ = meeting

    def run(chunk):
        d = OnlineDiarizer(backends[0], StreamingConfig(), device="cpu")
        _stream(d, wav, chunk or len(wav))
        return d.state

    a, b, c = run(CHUNK), run(27200), run(None)
    assert a.window_starts == b.window_starts == c.window_starts
    assert a.window_labels == b.window_labels == c.window_labels
    np.testing.assert_allclose(np.stack(a.window_embs), np.stack(c.window_embs), rtol=0, atol=1e-5)


def test_silence_dropped_mid_stream(backends):
    """No event starts inside a silent span; both packages agree and
    finalize() counts the two voices."""
    wav = np.concatenate([synth_utterance(0, 1, 3.0), np.zeros(3 * 16000, np.float32),
                          synth_utterance(1, 2, 3.0)])
    (port, got), (jax_d, want) = _both(backends, wav)
    _assert_same_events(got, want)
    assert all(not (3.0 <= e["start"] and e["end"] <= 6.0) for e in got)
    assert port.finalize()["n_speakers"] == jax_d.finalize()["n_speakers"] == 2


def test_empty_and_silent_feed(backends):
    d = OnlineDiarizer(backends[0], StreamingConfig(), device="cpu")
    assert d.feed(np.zeros(0, np.float32)) == []
    assert d.segments() == []
    assert len(d.feed(np.zeros(32000, np.float32))) <= 1  # the first window sets the peak
    assert d.finalize()["n_speakers"] <= 1


def _shifted_backend(base_cls, name):
    """Two voices with cosine ~0.6 (above the 0.5 fallback) and a measured
    bar of 0.75; the voice is carried by the amplitude."""
    rng = np.random.default_rng(7)
    common, off = rng.standard_normal(64), rng.standard_normal((2, 64))

    class Shifted(base_cls):
        raw_decision_threshold = 0.75

        @property
        def name(self):
            return name

        def embed_waveform(self, wav):
            v = common + 0.8 * off[int(float(np.abs(wav).mean()) >= 0.1)]
            return v / np.linalg.norm(v)

    return Shifted()


def test_new_speaker_bar_from_calibration(backends):
    """The bar is the backend's raw_decision_threshold, else 0.5, unless
    the config sets one; a calibrated bar spawns both voices of a shifted
    domain where the fixed 0.5 merges them, in both packages."""
    port = OnlineDiarizer(backends[0], StreamingConfig(), device="cpu")
    assert port.new_speaker_threshold == JaxOnlineDiarizer(backends[1]).new_speaker_threshold
    assert port.new_speaker_threshold == 0.5313  # raw_eer_threshold of the calibration
    fixed = OnlineDiarizer(backends[0], StreamingConfig(new_speaker_threshold=0.6), device="cpu")
    assert fixed.new_speaker_threshold == 0.6

    base.register_backend("shifted", _shifted_backend(base.LocalEmbeddingBackend, "shifted"))
    jbase.register_backend("shifted", _shifted_backend(jbase.LocalEmbeddingBackend, "shifted"))
    wav = np.concatenate([np.full(48000, 0.05, np.float32), np.full(48000, 0.4, np.float32)])
    for bar, n in ((None, 2), (0.5, 1)):
        port = OnlineDiarizer("shifted", StreamingConfig(new_speaker_threshold=bar), device="cpu")
        ref = JaxOnlineDiarizer("shifted", JaxStreamingConfig(new_speaker_threshold=bar))
        port.state.peak_rms = ref.state.peak_rms = 0.4
        _assert_same_events(port.feed(wav), ref.feed(wav))
        assert len(port.state.centroids) == len(ref.state.centroids) == n

    class Uncalibrated(base.LocalEmbeddingBackend):
        name = "uncalibrated"

        def embed_waveform(self, wav):
            return np.ones(4, np.float32)

    base.register_backend("uncalibrated", Uncalibrated())
    assert OnlineDiarizer("uncalibrated", device="cpu").new_speaker_threshold == 0.5


def test_enroll_discovered_readable_by_jax(backends, meeting, tmp_path, monkeypatch):
    """Profiles the port enrolls from a stream load in the JAX package with
    the same ids and vectors as the JAX diarizer's own enrollment."""
    wav, _ = meeting
    (port, _), (jax_d, _) = _both(backends, wav)
    port.finalize()
    jax_d.finalize()
    out = {}
    for name, d, backend in (("port", port, "gpu"), ("jax", jax_d, "tpu")):
        monkeypatch.setenv("SPEAKERS_EMBEDDINGS_DIR", str(tmp_path / name))
        created = d.enroll_discovered(audio_b3sum="ab" * 16, prefix="meeting")
        records = {sid: jprofiles.load_speaker(sid)["embeddings"][backend] for sid in created}
        out[name] = {sid: (rec, jprofiles.load_vector(rec)) for sid, (rec,) in records.items()}
        if name == "port":
            assert len(jprofiles.ProfileMatrix.build("gpu")) == 3
    assert list(out["port"]) == list(out["jax"]) == ["meeting-01", "meeting-02", "meeting-03"]
    for sid, (rec, vec) in out["port"].items():
        jrec, jvec = out["jax"][sid]
        assert rec["model_version"] == jrec["model_version"] == "ecapa-c512-v1"
        assert rec["source_audio"] == "<stream>" and rec["source_audio_b3sum"] == "ab" * 16
        assert vec.shape == (192,)
        np.testing.assert_allclose(vec, jvec, rtol=0, atol=1e-5)


def test_entry_points_raise_without_cuda(monkeypatch):
    """The default device is CUDA; without it the streaming diarizer and
    the x-vector backend raise rather than run on the CPU."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        OnlineDiarizer()
    with pytest.raises(RuntimeError, match="CUDA"):
        GpuBackend(model="xvector")
