"""The port's Speechmatics client (sdtk_tpu_torch/backends/speechmatics.py)
against the local mock server of tests/test_speechmatics_mock.py (the same
handler, the wire-shaped payloads of tests/speechmatics_wire.py): the JAX
mock suite's cases run on the port, and where a case returns a result,
the JAX client on a fresh server of the same state gives the same result
and sends the same job config.  No traffic leaves the machine."""

from __future__ import annotations

import threading
from http.server import ThreadingHTTPServer

import numpy as np
import pytest

pytest.importorskip("requests")

import sdtk_tpu.backends.speechmatics as JSM  # noqa: E402
import sdtk_tpu_torch.backends.speechmatics as PSM  # noqa: E402
import speechmatics_wire as wire  # noqa: E402  (tests/ is on sys.path)
from test_speechmatics_mock import _Handler, _MockState, _profile  # noqa: E402
from sdtk_tpu_torch.utils.audio import save_wav  # noqa: E402


class Api:
    """A mock server per call of :meth:`run`, with this case's state."""

    def __init__(self, monkeypatch, wav):
        self.mp, self.wav = monkeypatch, wav
        self.setup = lambda state: None
        self.mp.setenv("SPEECHMATICS_API_KEY", "test-key-123")
        for mod in (JSM, PSM):
            monkeypatch.setattr(mod, "POLL_INTERVAL", 0.02)
            monkeypatch.setattr(mod, "POLL_TIMEOUT", 2.0)

    def run(self, mod, call):
        """``call(backend)`` against a fresh server; (result, state)."""
        state = _MockState()
        self.setup(state)
        server = ThreadingHTTPServer(("127.0.0.1", 0), type("H", (_Handler,), {"state": state}))
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        self.mp.setenv("SPEECHMATICS_API_URL", f"http://127.0.0.1:{server.server_address[1]}/v2")
        try:
            return call(mod.SpeechmaticsBackend()), state
        finally:
            server.shutdown()
            server.server_close()

    def both(self, call):
        """The call through the port and through JAX: equal results and
        equal jobs sent; returns the port's (result, state)."""
        got, st = self.run(PSM, call)
        want, jst = self.run(JSM, call)
        assert got == want
        assert [j["config"] for j in st.jobs.values()] == [j["config"] for j in jst.jobs.values()]
        return got, st


@pytest.fixture()
def api(monkeypatch, tmp_path):
    wav = tmp_path / "a.wav"
    save_wav(wav, np.zeros(8000, dtype=np.float32), 16000)
    return Api(monkeypatch, wav)


def test_surface_matches_jax():
    """Name, key requirement, width, version, regions and the cap."""
    p, j = PSM.SpeechmaticsBackend("us"), JSM.SpeechmaticsBackend("us")
    assert (p.name, p.requires_api_key, p.embedding_dim, p.model_version, p._region) == \
        (j.name, j.requires_api_key, j.embedding_dim, j.model_version, j._region) == \
        ("speechmatics", True, 0, "speechmatics-v2", "us1")
    assert PSM.MAX_IDENTIFIERS_PER_SPEAKER == JSM.MAX_IDENTIFIERS_PER_SPEAKER == 50
    assert p.check_embedding_compatibility({"model_version": "speechmatics-v2"})["compatible"]


def test_enroll_full_lifecycle(api):
    """create → poll (pending → running → done) → fetch: the speaker with
    the most identifiers, bearer auth on every request."""
    rec, state = api.both(lambda b: b.enroll_speaker(api.wav))
    expected = [wire.opaque_identifier(f"job1-s1-{i}") for i in range(3)]
    assert rec["external_id"] == expected[0] and rec["all_identifiers"] == expected
    assert rec["vector"] is None and rec["model_version"] == "speechmatics-v2"
    assert state.jobs["job1"]["polls"] >= state.polls_until_done
    assert all(a == "Bearer test-key-123" for a in state.seen_auth)


def test_identify_caps_identifiers_and_binary_confidence(api):
    """At most 50 identifiers per speaker, confidence 1.0."""
    profile = _profile(n_idents=PSM.MAX_IDENTIFIERS_PER_SPEAKER + 17)
    out, state = api.both(lambda b: b.identify_speaker(api.wav, [profile]))
    assert [r["speaker_id"] for r in out] == ["alice"]
    assert out[0]["confidence"] == out[0]["similarity"] == 1.0
    sent = state.jobs["job1"]["config"]["transcription_config"][
        "speaker_diarization_config"]["speakers"]
    assert len(sent) == 1 and len(sent[0]["speaker_identifiers"]) == 50


def test_verify_via_identify(api):
    res, _ = api.both(lambda b: b.verify_speaker(api.wav, _profile()))
    assert res == {"match": True, "confidence": 1.0}


def test_identify_no_identifiers_returns_empty(api):
    out, state = api.both(lambda b: b.identify_speaker(api.wav, [{"id": "bob",
                                                                  "embeddings": {}}]))
    assert out == [] and state.jobs == {}


def test_identify_dedupes_before_cap(api):
    idents = [f"blob-{i}" for i in range(50)]
    profile = {"id": "alice", "embeddings": {"speechmatics": [
        {"external_id": idents[0], "all_identifiers": idents,
         "model_version": "speechmatics-v2"}]}}
    _, state = api.both(lambda b: b.identify_speaker(api.wav, [profile]))
    sent = state.jobs["job1"]["config"]["transcription_config"][
        "speaker_diarization_config"]["speakers"][0]["speaker_identifiers"]
    assert sent == idents


def test_identify_skips_punctuation_and_unconfigured_labels(api):
    out, _ = api.both(lambda b: b.identify_speaker(api.wav, [_profile()]))
    assert [r["speaker_id"] for r in out] == ["alice"]


@pytest.mark.parametrize("case", ["rejected", "timeout", "http"])
def test_failures_raise(api, monkeypatch, case):
    """A rejected job and a job never done raise as in JAX's client; an
    HTTP error status raises ``requests.HTTPError``."""
    import requests

    if case == "rejected":
        api.setup = lambda st: setattr(st, "reject_jobs", True)
        exc, match = RuntimeError, "rejected"
    elif case == "timeout":
        api.setup = lambda st: setattr(st, "never_done", True)
        monkeypatch.setattr(PSM, "POLL_TIMEOUT", 0.1)
        exc, match = TimeoutError, "not done"
    else:
        api.setup = lambda st: setattr(st, "auth_failures", 1)
        exc, match = requests.HTTPError, "401"
    with pytest.raises(exc, match=match):
        api.run(PSM, lambda b: b.enroll_speaker(api.wav))


def test_debug_dump_path(api, monkeypatch, capsys):
    monkeypatch.setenv("SPEAKER_DETECTION_DEBUG", "1")
    api.run(PSM, lambda b: b.identify_speaker(api.wav, [_profile()]))
    err = capsys.readouterr().err
    assert "DEBUG: speakers_config labels: ['alice']" in err
    assert "DEBUG: results count: 7" in err and "DEBUG: first result:" in err


def test_missing_key_raises(monkeypatch, tmp_path):
    monkeypatch.delenv("SPEECHMATICS_API_KEY", raising=False)
    with pytest.raises(RuntimeError, match="SPEECHMATICS_API_KEY not set"):
        PSM.SpeechmaticsBackend().enroll_speaker(tmp_path / "x.wav")


def test_registry_builds_it():
    """The registry's ``speechmatics`` entry, with the device argument the
    port's pipeline passes to every backend."""
    from sdtk_tpu_torch.backends.base import get_backend

    b = get_backend("speechmatics", device="cpu")
    assert isinstance(b, PSM.SpeechmaticsBackend)
