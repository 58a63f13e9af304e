"""The port's training data (sdtk_tpu_torch/data/synth_families.py,
augment.py, nonspeech.py, batches.py) against the JAX package's: every
array bit-equal (tolerance 0), and the batch stream equal to the one the
JAX trainer's ``make_batch`` closure (``sdtk_tpu/training.py``) draws
from the same seed."""

from __future__ import annotations

import numpy as np
import pytest

from sdtk_tpu.data import augment as jax_augment
from sdtk_tpu.data import nonspeech as jax_nonspeech
from sdtk_tpu.data import synth_families as jax_families
from sdtk_tpu_torch.data import augment, nonspeech, synth_families
from sdtk_tpu_torch.data.batches import BatchSpec, make_batch

SR = 16000


def test_family_batches_bit_equal():
    """Families 0-4, two speakers each, 1.5 s: the same float32 arrays."""
    fams = np.repeat(np.arange(5), 2)
    sids = np.tile([3, 41], 5)
    uids = np.arange(10) * 7919
    got = synth_families.synth_family_batch(fams, sids, uids, 1.5)
    want = jax_families.synth_family_batch(fams, sids, uids, 1.5)
    assert got.dtype == want.dtype == np.float32 and got.shape == (10, 24000)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("prob", [1.0, 0.5])
def test_augment_batch_bit_equal(prob):
    """Every effect (prob 1.0) and a random subset (0.5) under one seeded
    Generator: equal output and the Generator left in the same state."""
    wavs = synth_families.synth_family_batch(
        np.array([0, 1, 2, 3, 4, 1]), np.arange(6), np.arange(6) + 100, 1.0)
    rng_a, rng_b = np.random.default_rng(11), np.random.default_rng(11)
    got = augment.augment_batch(wavs, rng_a, augment.AugmentSpec.uniform(prob))
    want = jax_augment.augment_batch(wavs, rng_b, jax_augment.AugmentSpec.uniform(prob))
    np.testing.assert_array_equal(got, want)
    assert rng_a.integers(1 << 30) == rng_b.integers(1 << 30)


def test_nonspeech_and_mix_bit_equal():
    """``sample_nonspeech`` over seeds that reach all nine classes, and
    ``mix_at_snr`` of each clip under a speech utterance (a clip shorter
    than the speech is tiled)."""
    speech = synth_families.family_utterance(2, 5, 9, 1.0)
    kinds = set()
    for seed in range(40):
        kinds.add(list(jax_nonspeech.GENERATORS)[
            int(np.random.default_rng(seed).integers(len(jax_nonspeech.GENERATORS)))])
        seconds = 0.6 if seed % 2 else 1.1
        got = nonspeech.sample_nonspeech(seconds, seed)
        want = jax_nonspeech.sample_nonspeech(seconds, seed)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(nonspeech.mix_at_snr(speech, got, 3.0 + seed % 7),
                                      jax_nonspeech.mix_at_snr(speech, want, 3.0 + seed % 7))
    assert kinds == set(jax_nonspeech.GENERATORS)


def _jax_make_batch(rng, family_ids, n_speakers, batch, seconds, crop_seconds, aug_prob,
                    noise_prob, noise_snr_db, bed_prob, bed_snr_db):
    """The JAX trainer's ``make_batch`` closure, written out with the JAX
    package's data functions in its draw order."""
    n_classes = n_speakers * len(family_ids)
    n_samples = int(min(crop_seconds or seconds, seconds) * SR)
    full_len = int(seconds * SR)
    cls = rng.integers(0, n_classes, batch)
    fam_idx, sids = np.divmod(cls, n_speakers)
    fams = np.asarray([family_ids[i] for i in fam_idx])
    uids = rng.integers(0, 1_000_000, batch)
    wavs = jax_families.synth_family_batch(fams, sids, uids, seconds)
    if n_samples < full_len:
        offs = rng.integers(0, full_len - n_samples + 1, batch)
        wavs = np.stack([w[o : o + n_samples] for w, o in zip(wavs, offs)])
    wavs = wavs * rng.uniform(0.3, 1.2, (batch, 1)).astype(np.float32)
    if aug_prob > 0:
        wavs = jax_augment.augment_batch(wavs, rng, jax_augment.AugmentSpec.uniform(aug_prob))
    if noise_prob > 0:
        mask_n = rng.uniform(size=batch) < noise_prob
        if mask_n.any():
            rms = np.sqrt((wavs**2).mean(axis=1, keepdims=True) + 1e-12)
            snr_db = rng.uniform(*noise_snr_db, (batch, 1))
            sigma = rms * 10.0 ** (-snr_db / 20.0) * mask_n[:, None]
            wavs = (wavs + sigma * rng.standard_normal(wavs.shape)).astype(np.float32)
    if bed_prob > 0:
        for i in np.nonzero(rng.uniform(size=batch) < bed_prob)[0]:
            bed = jax_nonspeech.sample_nonspeech(n_samples / SR + 0.1, int(rng.integers(1 << 30)))
            wavs[i] = jax_nonspeech.mix_at_snr(wavs[i], bed, float(rng.uniform(*bed_snr_db)))
    return wavs, cls


@pytest.mark.parametrize("prob,crop", [(1.0, 1.0), (0.5, 1.0), (0.0, 1.5)],
                         ids=["every-augmentation", "half", "clean-uncropped"])
def test_batch_stream_matches_jax_trainer(prob, crop):
    """Three batches of 4 from seed 5 over families 0-4: 1.0 s crops of
    1.5 s utterances with every augmentation on (prob 1.0, then 0.5), and
    clean whole utterances; waveforms and classes bit-equal."""
    spec = BatchSpec(family_ids=(0, 1, 2, 3, 4), n_speakers=8, batch=4, seconds=1.5,
                     crop_seconds=crop, aug_prob=prob, noise_prob=prob, bed_prob=prob)
    rng_a, rng_b = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(3):
        wavs, cls = make_batch(rng_a, spec)
        want_w, want_c = _jax_make_batch(
            rng_b, spec.family_ids, spec.n_speakers, spec.batch, spec.seconds,
            spec.crop_seconds, spec.aug_prob, spec.noise_prob, spec.noise_snr_db,
            spec.bed_prob, spec.bed_snr_db)
        assert wavs.dtype == np.float32 and wavs.shape == (4, int(crop * SR))
        np.testing.assert_array_equal(cls, want_c)
        np.testing.assert_array_equal(wavs, want_w)
