"""Embedding backends: defaults, registry, and the GPU backend."""

from .base import LocalEmbeddingBackend, get_backend, register_backend

__all__ = ["LocalEmbeddingBackend", "get_backend", "register_backend"]
