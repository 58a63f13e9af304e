"""Embedding-backend defaults and registry — what the diarizer needs.

The counterpart of the parts of ``sdtk_tpu/backends/base.py`` the
offline diarizer reads: the clustering defaults a local embedding backend
advertises, and the name → class registry.  Identify/verify scoring is
later work.
"""

from __future__ import annotations

import importlib
from abc import ABC, abstractmethod
from typing import Any

import numpy as np


class LocalEmbeddingBackend(ABC):
    """A backend that maps a waveform to a dense vector in-process."""

    sample_rate: int = 16000
    # Same-speaker cosine bar for cluster-merge speaker counting (a
    # property of the embedding geometry; checkpoints may override it
    # through their calibration sidecar).
    cluster_merge_tau: float = 0.47
    # Scale-free relative merge bar (cluster.spectral.merge_count ``rel``).
    cluster_merge_rel: float | None = 0.75

    @property
    @abstractmethod
    def name(self) -> str: ...

    @abstractmethod
    def embed_waveform(self, wav: np.ndarray) -> np.ndarray:
        """float32 mono waveform @ self.sample_rate → (embedding_dim,)."""


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
    """The backend registered as ``name`` (default ``"gpu"``); one instance
    per name and constructor arguments."""
    name = name or "gpu"
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
