"""The port's held-out voice family and corpus manifests
(sdtk_tpu_torch/data/synth_heldout.py, data/corpus.py) against the JAX
package's: voices, utterances, every channel tier and the held-out music
bed bit for bit (both are NumPy/SciPy on the same seeds); RTTM parsing and
WAV + RTTM pairing equal on synthetic corpus trees."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from sdtk_tpu.data import corpus as jcorpus
from sdtk_tpu.data import synth_heldout as jheld
from sdtk_tpu_torch.data import corpus, synth_heldout


@pytest.mark.parametrize("speaker", [0, 1, 7, 15, 123_456])
def test_heldout_voice_equals_jax(speaker):
    """``HeldoutVoice.for_speaker``: every field equal."""
    assert (dataclasses.asdict(synth_heldout.HeldoutVoice.for_speaker(speaker))
            == dataclasses.asdict(jheld.HeldoutVoice.for_speaker(speaker)))


@pytest.mark.parametrize("speaker,utterance,seconds", [(0, 0, 3.0), (3, 1, 3.0), (15, 6, 1.0),
                                                       (2, 2003, 2.37), (9, 0, 0.2)])
def test_heldout_utterance_equals_jax(speaker, utterance, seconds):
    """``heldout_utterance``: bit for bit, float32 of ``seconds · 16 000``
    samples."""
    got = synth_heldout.heldout_utterance(speaker, utterance, seconds)
    want = jheld.heldout_utterance(speaker, utterance, seconds)
    assert got.dtype == np.float32 and len(got) == int(seconds * 16000)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("tier", synth_heldout.TIERS)
def test_every_tier_equals_jax(tier):
    """``apply_tier`` on a held-out utterance, at two seeds and two SNRs:
    bit for bit."""
    assert synth_heldout.TIERS == jheld.TIERS
    x = jheld.heldout_utterance(4, 2, 2.0)
    for seed, snr in ((0, 15.0), (1003, 5.0)):
        got = synth_heldout.apply_tier(x, tier, seed=seed, snr_db=snr)
        want = jheld.apply_tier(x, tier, seed=seed, snr_db=snr)
        assert got.dtype == want.dtype and got.shape == x.shape
        np.testing.assert_array_equal(got, want)


def test_unknown_tier_raises():
    with pytest.raises(ValueError, match="unknown tier"):
        synth_heldout.apply_tier(np.zeros(16, np.float32), "underwater")


@pytest.mark.parametrize("seconds,seed", [(1.0, 0), (3.3, 77), (0.3, 5)])
def test_heldout_music_equals_jax(seconds, seed):
    np.testing.assert_array_equal(synth_heldout.heldout_music(seconds, seed),
                                  jheld.heldout_music(seconds, seed))


RTTM = """;; comment
SPEAKER rec1 1 0.00 1.50 <NA> <NA> alice <NA> <NA>
SPEAKER rec1 1 3.25 0.75 <NA> <NA> bob <NA> <NA>
LEXEME rec1 1 0.10 0.20 hello <NA> alice <NA>
# another comment
SPEAKER rec1 1 1.50 0.00 <NA> <NA> carol <NA> <NA>
speaker rec1 1 2.00 1.00 <NA> <NA> alice <NA> <NA>
"""


def test_parse_rttm_equals_jax(tmp_path):
    """SPEAKER rows (any case) sorted, zero-length rows and other row types
    dropped, as in JAX; a malformed row raises in both."""
    p = tmp_path / "a.rttm"
    p.write_text(RTTM)
    got = corpus.parse_rttm(p)
    assert got == jcorpus.parse_rttm(p)
    assert got == [(0.0, 1.5, "alice"), (2.0, 3.0, "alice"), (3.25, 4.0, "bob")]
    bad = tmp_path / "bad.rttm"
    bad.write_text("SPEAKER rec1 1 0.0\n")
    for mod in (corpus, jcorpus):
        with pytest.raises(ValueError, match="malformed"):
            mod.parse_rttm(bad)
    bad.write_text("SPEAKER rec1 1 x 1.0 <NA> <NA> a <NA>\n")
    for mod in (corpus, jcorpus):
        with pytest.raises(ValueError, match="bad tbeg"):
            mod.parse_rttm(bad)


def test_scan_corpus_equals_jax(tmp_path, capsys):
    """An AMI-shaped tree (audio/ and rttm/ apart, a pair side by side, a
    WAV without an RTTM): the same sorted entries and the same warning."""
    root = tmp_path / "corpus"
    for rel in ("audio/ES2002a.wav", "audio/sub/IS1009b.wav", "audio/TS3003c.wav",
                "pairs/m1.wav", "pairs/m1.rttm", "rttm/ES2002a.rttm", "rttm/IS1009b.rttm",
                "rttm/orphan.rttm"):
        (root / rel).parent.mkdir(parents=True, exist_ok=True)
        (root / rel).write_text(RTTM if rel.endswith(".rttm") else "")
    got = corpus.scan_corpus(root)
    port_err = capsys.readouterr().err
    want = jcorpus.scan_corpus(root)
    assert capsys.readouterr().err == port_err and "TS3003c" in port_err
    assert [tuple(e) for e in got] == [tuple(e) for e in want]
    assert [e.recording_id for e in got] == ["ES2002a", "IS1009b", "m1"]
    assert corpus.scan_corpus(root / "pairs") == jcorpus.scan_corpus(root / "pairs")
    with pytest.raises(FileNotFoundError):
        corpus.scan_corpus(tmp_path / "nowhere")
