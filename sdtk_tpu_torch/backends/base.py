"""Embedding backends: defaults, enroll / identify / verify, registry.

The counterpart of ``sdtk_tpu/backends/base.py`` for in-process backends.
A ``LocalEmbeddingBackend`` maps a waveform to a dense vector; enrollment
pooling and window-level identify/verify against the profile matrix are
shared here.  Scoring runs on the backend's ``device``: the dense route
through ``ops.cosine.score_rows`` (the cosine kernel on CUDA), the large-N
route through ``ops.topk.identify_topk`` (the fused top-k kernel on CUDA).
The default threshold 0.354 is the JAX package's.
"""

from __future__ import annotations

import importlib
import os
import sys
from abc import ABC, abstractmethod
from pathlib import Path
from typing import Any

import numpy as np
import torch

from .. import config

DEFAULT_THRESHOLD = 0.354
FUSED_IDENTIFY_N = 8192  # profile rows from which identify takes the fused route


class LocalEmbeddingBackend(ABC):
    """A backend that maps a waveform to a dense vector in-process."""

    sample_rate: int = 16000
    # Where scoring runs; None is CUDA (raises without it).
    device: torch.device | None = None
    # Same-speaker cosine bar for cluster-merge speaker counting (a
    # property of the embedding geometry; checkpoints may override it
    # through their calibration sidecar).
    cluster_merge_tau: float = 0.47
    # Scale-free relative merge bar (cluster.spectral.merge_count ``rel``).
    cluster_merge_rel: float | None = 0.75
    # Raw-cosine same/different-speaker boundary, where a checkpoint
    # measured one; None lets the caller use its own default.
    raw_decision_threshold: float | None = None
    # Optional (C, D) cohort of unit embeddings: when present, scores are
    # AS-normalized against it before calibration (ops.cosine.asnorm).
    cohort: np.ndarray | None = None
    asnorm_top_k: int = 64
    # True asserts that calibrate_score is monotonic, so the fused large-N
    # route may calibrate only its top-k survivors; False forces the dense
    # route.
    monotonic_calibration: bool = True

    @property
    @abstractmethod
    def name(self) -> str: ...

    @property
    def embedding_dim(self) -> int | None:
        return None

    @property
    def model_version(self) -> str:
        return f"{self.name}-unknown"

    @abstractmethod
    def embed_waveform(self, wav: np.ndarray) -> np.ndarray:
        """float32 mono waveform @ self.sample_rate → (embedding_dim,)."""

    def embed_batch(self, wavs: list[np.ndarray]) -> np.ndarray:
        """Many waveforms → (N, embedding_dim).  This default loops over
        embed_waveform; the GPU backend batches same-length windows."""
        if not wavs:
            return np.zeros((0, self.embedding_dim), np.float32)
        return np.stack([np.asarray(self.embed_waveform(w)) for w in wavs])

    def check_embedding_compatibility(self, embedding: dict[str, Any]) -> dict[str, Any]:
        """Is a stored embedding record usable with this backend?  Its
        model_version must be prefixed by the backend name; otherwise the
        result carries a re-enroll warning."""
        emb_version = embedding.get("model_version", "unknown")
        compatible = emb_version.startswith(f"{self.name}-")
        return {
            "compatible": compatible,
            "version": emb_version,
            "current": self.model_version,
            "warning": None if compatible else (
                f"Embedding created with {emb_version} may not work with "
                f"backend {self.name}. Consider re-enrolling."),
        }

    def score_matrix(self, queries: np.ndarray, profiles: np.ndarray) -> np.ndarray:
        """(Q, D) queries vs (P, D) profiles → calibrated scores (Q, P): raw
        cosine → AS-norm (when a cohort is attached) → calibrate_score."""
        from ..ops.cosine import asnorm, score_rows

        q = np.asarray(queries, np.float32)
        raw = score_rows(q, np.asarray(profiles, np.float32), device=self.device)
        cohort = self.cohort
        if cohort is not None and len(cohort) >= 8:
            qc = score_rows(q, cohort, device=self.device)
            pc = score_rows(np.asarray(profiles, np.float32), cohort, device=self.device)
            raw = asnorm(raw, qc, pc, top_k=self.asnorm_top_k)
        return self.calibrate_score(raw)

    def calibrate_score(self, sims: np.ndarray) -> np.ndarray:
        """Map raw similarity into the 0.354-threshold score space; identity
        here.  Overrides must be monotonic non-decreasing, or set
        ``monotonic_calibration = False``."""
        return sims

    def _load(self, audio_path: str | Path, segments: list[tuple[float, float]] | None
              ) -> np.ndarray:
        from ..utils import audio as audio_util

        wav, sr = audio_util.load_audio(audio_path, target_sr=self.sample_rate)
        if segments:
            wav = audio_util.slice_segments(wav, sr, segments)
        if len(wav) < self.sample_rate // 2:  # pad ultra-short clips
            wav = np.pad(wav, (0, self.sample_rate // 2 - len(wav)))
        return wav

    def embed_windows(self, wav: np.ndarray, window_s: float = 3.0, hop_s: float = 1.5
                      ) -> np.ndarray:
        """(n_windows, D) per-window embeddings; this default loops over
        embed_waveform (device backends batch it)."""
        sr = self.sample_rate
        win, hop = int(window_s * sr), int(hop_s * sr)
        n = len(wav)
        n_win = 1 if n <= win else 1 + (n - win + hop - 1) // hop
        return np.stack([np.asarray(self.embed_waveform(wav[i * hop : i * hop + win]))
                         for i in range(n_win)])

    def enroll_speaker(self, audio_path, segments=None) -> dict[str, Any]:
        """{"vector", "external_id", "model_version"} of (segments of) a
        recording."""
        wav = self._load(audio_path, segments)
        return {"vector": np.asarray(self.embed_waveform(wav), dtype=np.float32),
                "external_id": None, "model_version": self.model_version}

    def identify_speaker(self, audio_path, candidates, threshold=DEFAULT_THRESHOLD,
                         segments=None) -> list[dict[str, Any]]:
        """Window-level identification: every 3 s window scores against the
        profile matrix, and a speaker matches if any window clears the
        threshold.  Rows {"speaker_id", "similarity", "confidence",
        "embedding_id", "backend"}, best first."""
        from ..store.profiles import ProfileMatrix

        pm = ProfileMatrix.build(self.name, speakers=candidates)
        if len(pm) == 0:
            return []
        queries = np.asarray(self.embed_windows(self._load(audio_path, segments)),
                             dtype=np.float32)  # (W, D)
        try:
            fused_n = int(os.environ.get("SDTK_IDENTIFY_TOPK_N", str(FUSED_IDENTIFY_N)))
        except ValueError:
            print("Warning: malformed SDTK_IDENTIFY_TOPK_N "
                  f"{os.environ['SDTK_IDENTIFY_TOPK_N']!r}; using {FUSED_IDENTIFY_N}",
                  file=sys.stderr)
            fused_n = FUSED_IDENTIFY_N
        if len(pm) >= fused_n and self.cohort is None and self.monotonic_calibration:
            # Large N: fused cosine → window-max → top-k; only the top
            # 64·E profile rows come back (E = most embeddings of one
            # speaker), which holds the best row of each of the top 64
            # speakers.  Calibration is monotonic, so calibrating only the
            # survivors is exact.
            from ..ops.topk import identify_topk

            per_spk: dict[str, int] = {}
            for row in pm.rows:
                per_spk[row["speaker_id"]] = per_spk.get(row["speaker_id"], 0) + 1
            k = min(64 * max(per_spk.values(), default=1), len(pm))
            top_s, top_i = identify_topk(queries, pm.matrix, k=k, device=self.device)
            top_s = np.asarray(self.calibrate_score(top_s), dtype=np.float32)
            row_iter = ((pm.rows[int(i)], s) for i, s in zip(top_i, top_s))
        else:
            sims = self.score_matrix(queries, pm.matrix)  # (W, N) calibrated
            row_iter = zip(pm.rows, sims.max(axis=0))  # best window per profile row

        best: dict[str, tuple[float, str]] = {}
        for row, sim in row_iter:
            sid = row["speaker_id"]
            if sid not in best or sim > best[sid][0]:
                best[sid] = (float(sim), row["embedding_id"])
        out = [{"speaker_id": sid, "similarity": sim, "confidence": sim,
                "embedding_id": emb_id, "backend": self.name}
               for sid, (sim, emb_id) in best.items() if sim >= threshold]
        out.sort(key=lambda r: r["confidence"], reverse=True)
        return out

    def verify_speaker(self, audio_path, profile, threshold=DEFAULT_THRESHOLD, segments=None
                       ) -> dict[str, Any]:
        """Identify against the one profile: {"match", "confidence"}."""
        results = self.identify_speaker(audio_path, [profile], threshold, segments)
        if results and results[0]["speaker_id"] == profile["id"]:
            return {"match": True, "confidence": results[0]["confidence"]}
        return {"match": False, "confidence": results[0]["confidence"] if results else 0.0}


_REGISTRY: dict[str, str] = {
    "gpu": "sdtk_tpu_torch.backends.gpu:GpuBackend",
}
_instances: dict[tuple, LocalEmbeddingBackend] = {}


def register_backend(name: str, target: str | LocalEmbeddingBackend) -> None:
    """Register a ``"module:Class"`` path, or an instance, under ``name``."""
    if isinstance(target, LocalEmbeddingBackend):
        _instances[(name,)] = target
        _REGISTRY[name] = f"<instance:{name}>"
    else:
        _REGISTRY[name] = target
        for key in [k for k in _instances if k[0] == name]:
            del _instances[key]


def get_backend(name: str | None = None, **kwargs: Any) -> LocalEmbeddingBackend:
    """The backend registered as ``name`` (default: $SPEAKER_DETECTION_BACKEND,
    else ``"gpu"``); one instance per name and constructor arguments."""
    name = name or config.default_backend()
    if (name,) in _instances:
        return _instances[(name,)]
    if name not in _REGISTRY:
        raise ValueError(f"Unknown backend '{name}'. Available: {', '.join(sorted(_REGISTRY))}")
    key = (name, *sorted(kwargs.items()))
    if key not in _instances:
        module_name, _, cls_name = _REGISTRY[name].partition(":")
        cls = getattr(importlib.import_module(module_name), cls_name)
        _instances[key] = cls(**kwargs)
    return _instances[key]


def list_backends() -> list[str]:
    return sorted(_REGISTRY)
