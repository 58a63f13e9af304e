"""Embedding backends: the protocol, defaults, enroll / identify / verify,
and the registry.

The counterpart of ``sdtk_tpu/backends/base.py``.  ``EmbeddingBackend`` is
the protocol every backend meets (the cloud one, ``speechmatics.py``,
included): a name, an embedding width and model version, an audio
profile (``audio_profiles.py``), enroll / identify / verify.  A
``LocalEmbeddingBackend`` maps a waveform to a dense vector in-process;
enrollment pooling and window-level identify/verify against the profile
matrix are shared there.  Scoring runs on the backend's ``device``: the
dense route through ``ops.cosine.score_rows`` (the cosine kernel on CUDA),
the large-N route through ``ops.topk.identify_topk`` (the fused top-k
kernel on CUDA).  The default threshold 0.354 is the JAX package's.

The registry maps a name to a ``"module:Class"`` path: ``gpu``, ``fake``
and ``speechmatics``, then the entries of the YAML file that
``$SPEAKER_BACKENDS_CONFIG`` names (``backends: {name: "module:Class"}``
or ``{name: {class: "module:Class"}}``), read once until
:func:`reload_backends_config`.
"""

from __future__ import annotations

import importlib
import os
import sys
import threading
from abc import ABC, abstractmethod
from pathlib import Path
from typing import Any

import numpy as np
import torch

from .. import config
from .audio_profiles import AudioProfile, get_profile

DEFAULT_THRESHOLD = 0.354
FUSED_IDENTIFY_N = 8192  # profile rows from which identify takes the fused route


class EmbeddingBackend(ABC):
    """The backend protocol."""

    @property
    @abstractmethod
    def name(self) -> str: ...

    @property
    def requires_api_key(self) -> bool:
        return False

    @property
    def embedding_dim(self) -> int | None:
        """Width of the embeddings (None for a backend without vectors)."""
        return None

    @property
    def model_version(self) -> str:
        return f"{self.name}-unknown"

    @property
    def audio_profile(self) -> str | AudioProfile:
        """A profile name of ``audio_profiles.PROFILES``, or a profile."""
        return "default"

    def get_audio_profile(self) -> AudioProfile:
        """:attr:`audio_profile` resolved to an ``AudioProfile``."""
        profile = self.audio_profile
        return get_profile(profile) if isinstance(profile, str) else profile

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

    @abstractmethod
    def enroll_speaker(self, audio_path, segments=None) -> dict[str, Any]:
        """{"vector", "external_id", "model_version"} of (segments of) a
        recording."""

    @abstractmethod
    def identify_speaker(self, audio_path, candidates, threshold=DEFAULT_THRESHOLD,
                         segments=None) -> list[dict[str, Any]]:
        """Rows {"speaker_id", "similarity", "confidence", "embedding_id",
        "backend"} of the candidates that match, best first."""

    def verify_speaker(self, audio_path, profile, threshold=DEFAULT_THRESHOLD, segments=None
                       ) -> dict[str, Any]:
        """Identify against the one profile: {"match", "confidence"}."""
        results = self.identify_speaker(audio_path, [profile], threshold, segments)
        if results and results[0]["speaker_id"] == profile["id"]:
            return {"match": True, "confidence": results[0]["confidence"]}
        return {"match": False, "confidence": results[0]["confidence"] if results else 0.0}

    def extract_segments_from_transcript(self, transcript_data: dict[str, Any],
                                         speaker_label: str) -> list[tuple[float, float]]:
        from ..transcripts import extract_segments_as_tuples

        return extract_segments_as_tuples(transcript_data, speaker_label)


class LocalEmbeddingBackend(EmbeddingBackend):
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

    @abstractmethod
    def embed_waveform(self, wav: np.ndarray) -> np.ndarray:
        """float32 mono waveform @ self.sample_rate → (embedding_dim,)."""

    def embed_batch(self, wavs: list[np.ndarray]) -> np.ndarray:
        """Many waveforms → (N, embedding_dim).  This default loops over
        embed_waveform; the GPU backend batches same-length windows."""
        if not wavs:
            return np.zeros((0, self.embedding_dim), np.float32)
        return np.stack([np.asarray(self.embed_waveform(w)) for w in wavs])

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


_DEFAULT_REGISTRY: dict[str, str] = {
    "gpu": "sdtk_tpu_torch.backends.gpu:GpuBackend",
    "fake": "sdtk_tpu_torch.backends.fake:FakeBackend",
    "speechmatics": "sdtk_tpu_torch.backends.speechmatics:SpeechmaticsBackend",
}
_REGISTRY: dict[str, str] = dict(_DEFAULT_REGISTRY)
_config_read = False  # the YAML file's entries are in _REGISTRY
_instances: dict[tuple, EmbeddingBackend] = {}
_registry_lock = threading.Lock()  # one instance per key, whichever thread asks first


def _registry() -> dict[str, str]:
    """The registry, with the ``$SPEAKER_BACKENDS_CONFIG`` file's entries
    merged in on first use."""
    global _config_read
    if not _config_read:
        cfg_path = config.backends_config_path()
        if cfg_path and cfg_path.exists():
            import yaml

            with open(cfg_path) as f:
                data = yaml.safe_load(f) or {}
            for name, spec in (data.get("backends") or {}).items():
                if isinstance(spec, str):
                    _REGISTRY[name] = spec
                elif isinstance(spec, dict) and "class" in spec:
                    _REGISTRY[name] = spec["class"]
        _config_read = True
    return _REGISTRY


def register_backend(name: str, target: str | EmbeddingBackend) -> None:
    """Register a ``"module:Class"`` path, or an instance, under ``name``."""
    registry = _registry()
    if isinstance(target, EmbeddingBackend):
        _instances[(name,)] = target
        registry[name] = f"<instance:{name}>"
    else:
        registry[name] = target
        for key in [k for k in _instances if k[0] == name]:
            del _instances[key]


def get_backend(name: str | None = None, **kwargs: Any) -> EmbeddingBackend:
    """The backend registered as ``name`` (default: $SPEAKER_DETECTION_BACKEND,
    else ``"gpu"``); one instance per name and constructor arguments."""
    name = name or config.default_backend()
    if (name,) in _instances:
        return _instances[(name,)]
    registry = _registry()
    if name not in registry:
        raise ValueError(f"Unknown backend '{name}'. Available: {', '.join(sorted(registry))}")
    key = (name, *sorted(kwargs.items()))
    with _registry_lock:
        if key not in _instances:
            module_name, _, cls_name = registry[name].partition(":")
            cls = getattr(importlib.import_module(module_name), cls_name)
            _instances[key] = cls(**kwargs)
        return _instances[key]


def list_backends() -> list[str]:
    return sorted(_registry())


def reload_backends_config() -> None:
    """Forget the registry's YAML entries, registrations and instances; the
    next lookup reads ``$SPEAKER_BACKENDS_CONFIG`` again."""
    global _config_read
    _REGISTRY.clear()
    _REGISTRY.update(_DEFAULT_REGISTRY)
    _instances.clear()
    _config_read = False
