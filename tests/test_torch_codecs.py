"""The port's audio containers (sdtk_tpu_torch/utils/{audio,flacio,
mpegaudio,syscodec,avio}.py) against the JAX package's: the FLAC and MPEG
Layer I/II encoders give the same bytes, every decoder the same samples
(bit for bit: the port's codecs are NumPy and ctypes copies), and
``load_audio`` / ``load_audio_batch`` / ``probe`` read every container
that this host can write as the JAX package reads it.  The libmpg123 /
libmp3lame and libav* tiers skip on a host without the libraries.  Then
speaker-process on a ``.flac`` with the fake backend: transcribed, not
``unsupported_format``."""

from __future__ import annotations

import json

import numpy as np
import pytest

from sdtk_tpu.utils import audio as jaudio
from sdtk_tpu.utils import avio as javio
from sdtk_tpu.utils import flacio as jflac
from sdtk_tpu.utils import mpegaudio as jmpeg
from sdtk_tpu.utils import syscodec as jsys
from sdtk_tpu_torch.utils import audio, avio, flacio, mpegaudio, syscodec
from torch_jax_native import ensure_jax_native

SR = 16000


def _signal(seconds: float, sr: int = SR, channels: int = 1, seed: int = 0) -> np.ndarray:
    """Two tones and a little noise, in [-1, 1]."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    x = 0.3 * np.sin(2 * np.pi * 220 * t) + 0.2 * np.sin(2 * np.pi * 1330 * t)
    x = x + 0.02 * rng.standard_normal(len(t))
    if channels == 1:
        return x.astype(np.float32)
    return np.stack([x, 0.5 * x[::-1]], axis=1).astype(np.float32)


@pytest.mark.parametrize("channels,seconds,sr", [(1, 0.37, 16000), (1, 2.0, 16000),
                                                 (2, 1.1, 44100), (1, 0.05, 8000)])
def test_flac_encode_and_decode_equal_jax(channels, seconds, sr):
    """``flacio.encode`` writes JAX's bytes; ``decode`` returns JAX's
    samples, rate and depth (exact)."""
    x = _signal(seconds, sr, channels, seed=channels)
    data = flacio.encode(x, sr, 16)
    assert data == jflac.encode(x, sr, 16)
    pcm, got_sr, bits = flacio.decode(data)
    want, want_sr, want_bits = jflac.decode(data)
    assert (got_sr, bits) == (want_sr, want_bits) == (sr, 16)
    np.testing.assert_array_equal(pcm, want)
    assert pcm.shape[0] == len(x)


@pytest.mark.parametrize("layer", ["layer1", "layer2"])
@pytest.mark.parametrize("sr,kbps", [(16000, 64), (32000, 128), (44100, 192)])
def test_mpeg_encode_and_decode_equal_jax(layer, sr, kbps):
    """``encode_layer1`` / ``encode_layer2`` write JAX's bytes;
    ``mpegaudio.decode`` returns JAX's samples and rate (exact)."""
    x = _signal(0.6, sr, seed=sr)
    data = getattr(mpegaudio, f"encode_{layer}")(x, sr, kbps)
    assert data == getattr(jmpeg, f"encode_{layer}")(x, sr, kbps)
    pcm, got_sr = mpegaudio.decode(data)
    want, want_sr = jmpeg.decode(data)
    assert got_sr == want_sr == sr
    np.testing.assert_array_equal(pcm, want)


def test_layer3_without_system_codec_raises_unsupported():
    """A Layer III header is outside the first-party decoder's scope: both
    packages raise ``UnsupportedFormatError``."""
    frame = bytes([0xFF, 0xFB, 0x90, 0x64]) + b"\x00" * 413
    for mod in (mpegaudio, jmpeg):
        with pytest.raises(mod.UnsupportedFormatError):
            mod.decode(frame * 4)


@pytest.mark.skipif(not (syscodec.mpg123_available() and syscodec.lame_available()),
                    reason="libmpg123 or libmp3lame absent")
def test_system_mp3_codec_equals_jax():
    """libmp3lame through the port writes JAX's bytes; libmpg123 decodes
    them to JAX's samples (exact)."""
    x = _signal(1.0)
    data = syscodec.encode_mp3(x, SR, 96)
    assert data == jsys.encode_mp3(x, SR, 96)
    pcm, sr = syscodec.decode_mpeg(data)
    want, want_sr = jsys.decode_mpeg(data)
    assert sr == want_sr
    np.testing.assert_array_equal(pcm, want)


def _write(path, x, ext):
    """Write ``x`` in the container of ``ext`` with whatever this host has;
    False when it cannot."""
    if ext == ".wav":
        audio.save_wav(path, x, SR)
    elif ext == ".flac":
        audio.save_flac(path, x, SR)
    elif ext in (".mp2", ".mpga"):
        path.write_bytes(mpegaudio.encode_layer2(x, SR, 96))
    elif ext == ".mp3":
        if not syscodec.lame_available():
            return False
        audio.save_mp3(path, x, SR)
    else:
        if not avio.can_encode(ext):
            return False
        avio.encode_file(str(path), x, SR)
    return True


@pytest.mark.parametrize("ext", sorted(audio._DECODERS))
def test_load_audio_equals_jax_for_every_container(ext, tmp_path):
    """``load_audio`` at 16 kHz, at the file's rate and resampled to 8 kHz,
    and ``probe``, equal the JAX package's for each container this host can
    write (exact).  Both packages read WAV through their C++ reader, each
    built from the same source with the same flags."""
    ensure_jax_native()
    assert sorted(audio._DECODERS) == sorted(jaudio._DECODERS)
    path = tmp_path / f"clip{ext}"
    if not _write(path, _signal(1.2, seed=len(ext)), ext):
        pytest.skip(f"this host cannot write {ext}")
    for sr in (SR, 0, 8000):
        got, got_sr = audio.load_audio(path, target_sr=sr)
        want, want_sr = jaudio.load_audio(path, target_sr=sr)
        assert got_sr == want_sr
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    assert audio.probe(path).__dict__ == jaudio.probe(path).__dict__
    np.testing.assert_array_equal(audio.load_wav(path), jaudio.load_audio(path)[0])


def test_load_audio_batch_equals_jax(tmp_path):
    """``load_audio_batch`` over a mix of containers and rates returns
    JAX's list, in order (exact), on one thread and on several."""
    paths = []
    for i, ext in enumerate([".wav", ".flac", ".mp2", ".wav", ".flac"]):
        p = tmp_path / f"b{i}{ext}"
        _write(p, _signal(0.5 + 0.25 * i, seed=i), ext)
        paths.append(p)
    want = [jaudio.load_audio(p)[0] for p in paths]
    np.testing.assert_array_equal(np.concatenate(jaudio.load_audio_batch(paths)),
                                  np.concatenate(want))
    for threads in (0, 1, 3):
        got = audio.load_audio_batch(paths, n_threads=threads)
        assert len(got) == len(want)
        for g, w, p in zip(got, want, paths):
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(g, audio.load_audio(p)[0])
    assert audio.load_audio_batch([]) == []


def test_save_flac_and_save_mp3_write_jax_bytes(tmp_path):
    """``save_flac`` and ``save_mp3`` write the JAX package's files."""
    x = _signal(0.8)
    for name in ("save_flac", "save_mp3"):
        ext = ".flac" if name == "save_flac" else ".mp3"
        getattr(audio, name)(tmp_path / f"port{ext}", x)
        getattr(jaudio, name)(tmp_path / f"jax{ext}", x)
        assert (tmp_path / f"port{ext}").read_bytes() == (tmp_path / f"jax{ext}").read_bytes()


@pytest.mark.parametrize("name", ["clip.xyz", "clip", "clip.aiff"])
def test_unknown_suffix_raises_audio_format_error(name, tmp_path):
    """A suffix no decoder reads raises ``AudioFormatError`` from
    ``load_audio`` and ``probe``, as in JAX."""
    path = tmp_path / name
    path.write_bytes(b"\x00" * 64)
    for fn in (audio.load_audio, audio.probe):
        with pytest.raises(audio.AudioFormatError, match="unsupported container"):
            fn(path)
    with pytest.raises(jaudio.AudioFormatError):
        jaudio.load_audio(path)


def test_corrupt_mpeg_raises_audio_format_error_in_both(tmp_path):
    """Bytes no MPEG tier decodes raise ``AudioFormatError`` in both
    packages (speaker-process's ``unsupported_format``)."""
    path = tmp_path / "noise.mp3"
    path.write_bytes(b"\x00" * 1000)
    for mod in (audio, jaudio):
        with pytest.raises(mod.AudioFormatError):
            mod.load_audio(path)


@pytest.mark.skipif(not avio.available(), reason="AV libraries absent")
def test_av_decoder_equals_jax(tmp_path):
    """``avio.decode_file`` of an AAC in MP4 returns JAX's samples and rate
    (exact); availability reads the same in both packages."""
    assert (avio.available(), avio.disabled_reason()) == (javio.available(),
                                                          javio.disabled_reason())
    if not avio.can_encode(".m4a"):
        pytest.skip("no AAC encoder on this host")
    path = tmp_path / "clip.m4a"
    avio.encode_file(str(path), _signal(1.0), SR)
    got, sr = avio.decode_file(str(path))
    want, want_sr = javio.decode_file(str(path))
    assert sr == want_sr
    np.testing.assert_array_equal(got, want)


def test_process_batch_transcribes_a_flac(tmp_path, monkeypatch):
    """speaker-process queues a ``.flac`` and now decodes it: with the fake
    backend the batch completes, ``unsupported_format`` is false, and the
    transcript equals the one of the same samples as a WAV."""
    from sdtk_tpu_torch.data.synth import synth_utterance
    from sdtk_tpu_torch.pipeline import process
    from sdtk_tpu_torch.store.queue import ProcessingQueue

    monkeypatch.setenv("SPEAKER_DETECTION_BACKEND", "fake")
    monkeypatch.setenv("SPEAKERS_EMBEDDINGS_DIR", str(tmp_path / "store"))
    d = tmp_path / "audio"
    d.mkdir()
    x = np.concatenate([synth_utterance(0, 900, 2.5), synth_utterance(1, 901, 2.5)])
    audio.save_wav(d / "same.wav", x)
    audio.save_flac(d / "meeting.flac", audio.load_audio(d / "same.wav")[0])  # the same samples
    q = ProcessingQueue(tmp_path / "queue.yaml")
    items = [q.add(d / "meeting.flac", backends=["tpu-diarize"]),
             q.add(d / "same.wav", backends=["tpu-diarize"])]
    out = tmp_path / "transcripts"
    results = process.process_batch(items, queue=q, parallel=2, output_dir=out,
                                    embed_backend="fake", quiet=True, device="cpu")
    by_name = {r.audio_path.rsplit("/", 1)[-1]: r for r in results}
    flac = by_name["meeting.flac"]
    assert flac.success and not flac.unsupported_format, flac.error
    assert "transcribe_tpu-diarize" in flac.steps_completed
    assert [i["status"] for i in q.items()] == ["completed", "completed"]
    got = json.loads((out / "meeting.tpu-diarize.json").read_text())
    want = json.loads((out / "same.tpu-diarize.json").read_text())
    assert got == want and got
