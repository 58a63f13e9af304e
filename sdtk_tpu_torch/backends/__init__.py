"""Embedding backends: the protocol, defaults, registry, the GPU backend
and the Speechmatics client."""

from .base import (EmbeddingBackend, LocalEmbeddingBackend, get_backend, list_backends,
                   register_backend, reload_backends_config)

__all__ = ["EmbeddingBackend", "LocalEmbeddingBackend", "get_backend", "list_backends",
           "register_backend", "reload_backends_config"]
