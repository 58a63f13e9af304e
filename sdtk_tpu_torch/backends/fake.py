"""Deterministic fake backend: a copy of ``sdtk_tpu/backends/fake.py``.

Embeddings are deterministic functions of the audio's coarse spectrum,
computed in NumPy, so recordings of the same synthetic "voice" (e.g. a
440 Hz test tone) land close together and different voices land far
apart: identify/verify semantics are real, with no model.  The vectors
are the JAX package's to the bit, which makes the port's assignment
output comparable with the JAX package's byte for byte.  Scoring goes
through ``LocalEmbeddingBackend.score_matrix`` on ``device`` (default
CUDA), so a second backend on the card (``--cross-backends gpu,fake``)
scores through the cosine kernel once the work leaves NumPy's route.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import resolve_device
from .base import LocalEmbeddingBackend

_BANDS = 128
_NFFT = 4096
_BIN_LO, _BIN_HI = 16, 1200  # ~62 Hz .. ~4.7 kHz at 16 kHz / 4096-pt FFT


class FakeBackend(LocalEmbeddingBackend):
    def __init__(self, embedding_dim: int = 192, device: str | torch.device | None = None):
        self._dim = embedding_dim
        self.device = resolve_device(device)
        # Fixed random projection bands → embedding space (seeded, stable
        # across processes).
        rng = np.random.default_rng(1234)
        self._proj = rng.standard_normal((_BANDS, embedding_dim)).astype(np.float32)

    @property
    def name(self) -> str:
        return "fake"

    @property
    def embedding_dim(self) -> int:
        return self._dim

    @property
    def model_version(self) -> str:
        return "fake-spectral-v2"

    def embed_waveform(self, wav: np.ndarray) -> np.ndarray:
        # Average log-power in geometrically spaced bands: a crude but
        # deterministic "voice timbre" signature.
        n = len(wav)
        if n < _NFFT:
            wav = np.pad(wav, (0, _NFFT - n))
            n = _NFFT
        n_frames = n // _NFFT
        frames = wav[: n_frames * _NFFT].reshape(n_frames, _NFFT)
        spec = np.abs(np.fft.rfft(frames, axis=-1)) ** 2
        edges = np.unique(np.geomspace(_BIN_LO, _BIN_HI, _BANDS + 1).astype(int))
        bands = np.zeros(_BANDS, dtype=np.float32)
        for i in range(min(_BANDS, len(edges) - 1)):
            hi = max(edges[i] + 1, edges[i + 1])
            bands[i] = np.log(spec[:, edges[i] : hi].mean() + 1e-9)
        # Keep only bands that stand out above the noise floor (median),
        # cubed to sharpen the harmonic peaks: different voices separate
        # well below the 0.354 decision threshold.
        bands = np.maximum(bands - np.median(bands), 0.0) ** 3
        bands /= max(np.linalg.norm(bands), 1e-12)
        vec = bands @ self._proj
        return (vec / max(np.linalg.norm(vec), 1e-12)).astype(np.float32)
