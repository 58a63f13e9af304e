"""Environment lookups the port needs (a copy of the relevant part of
``sdtk_tpu/config.py``: the same variables, read in the same place).

- ``SPEAKERS_EMBEDDINGS_DIR``   root of the file DB (shared with the JAX
  package: either package reads a store the other wrote)
- ``SPEAKER_DETECTION_BACKEND`` default embedding backend name (``gpu``)
- ``SPEAKER_BACKENDS_CONFIG``   backend registry YAML override
- ``SPEAKER_DETECTION_DEBUG``   debug dumps
- ``SPEAKER_LLM_CACHE_DIR``     LLM analysis cache
- ``SPEAKER_REVIEW_SESSION_DIR`` review session (else ``$XDG_CACHE_HOME``)
- ``SPEAKER_REVIEW_PLAYER``     audio player for the review TUI
- ``SDTK_MODEL_DIR``, ``SDTK_MODEL_PATH``  checkpoints
"""

from __future__ import annotations

import os
from pathlib import Path

DEFAULT_BACKEND_ENV = "SPEAKER_DETECTION_BACKEND"
DEFAULT_BACKEND = "gpu"


def speakers_dir() -> Path:
    """Root of the file DB ($SPEAKERS_EMBEDDINGS_DIR)."""
    return Path(os.environ.get("SPEAKERS_EMBEDDINGS_DIR",
                               os.path.expanduser("~/.config/speakers_embeddings")))


def db_dir() -> Path:
    """Speaker profile JSONs (db/{id}.json)."""
    return speakers_dir() / "db"


def embeddings_dir() -> Path:
    """Dense embedding vectors (embeddings/{emb-id}.npy)."""
    return speakers_dir() / "embeddings"


def samples_dir() -> Path:
    """Per-speaker audio samples + metadata (samples/{speaker}/sample-NNN.*)."""
    return speakers_dir() / "samples"


def catalog_dir() -> Path:
    """Recording catalog entries (catalog/{b3sum}.yaml)."""
    return speakers_dir() / "catalog"


def assignments_dir() -> Path:
    """Assignment files (assignments/{b3sum}.yaml)."""
    return speakers_dir() / "assignments"


def contexts_path() -> Path:
    """Context registry (contexts.yaml)."""
    return speakers_dir() / "contexts.yaml"


def queue_path() -> Path:
    """Persistent processing queue (process_queue.yaml)."""
    return speakers_dir() / "process_queue.yaml"


def llm_cache_dir() -> Path:
    return Path(os.environ.get("SPEAKER_LLM_CACHE_DIR", os.path.expanduser("~/.cache/speaker-llm")))


def review_session_dir() -> Path:
    """$SPEAKER_REVIEW_SESSION_DIR > $XDG_CACHE_HOME/speaker-review >
    ~/.cache/speaker-review."""
    explicit = os.environ.get("SPEAKER_REVIEW_SESSION_DIR")
    if explicit:
        return Path(explicit)
    xdg = os.environ.get("XDG_CACHE_HOME")
    if xdg:
        return Path(xdg) / "speaker-review"
    return Path(os.path.expanduser("~/.cache/speaker-review"))


def default_backend() -> str:
    return os.environ.get(DEFAULT_BACKEND_ENV, DEFAULT_BACKEND)


def backends_config_path() -> Path | None:
    """Backend registry YAML override ($SPEAKER_BACKENDS_CONFIG)."""
    p = os.environ.get("SPEAKER_BACKENDS_CONFIG")
    return Path(p) if p else None


def debug_enabled() -> bool:
    return bool(os.environ.get("SPEAKER_DETECTION_DEBUG"))


def ensure_layout() -> Path:
    """Create the file-DB directory layout (the JAX package's, catalog and
    assignments included); returns the root."""
    root = speakers_dir()
    for d in (db_dir(), embeddings_dir(), samples_dir(), catalog_dir(), assignments_dir()):
        d.mkdir(parents=True, exist_ok=True)
    return root


def model_dir() -> Path:
    """Where user checkpoints live ($SDTK_MODEL_DIR)."""
    return Path(
        os.environ.get("SDTK_MODEL_DIR", os.path.expanduser("~/.cache/sdtk_tpu/models"))
    )


def model_path_override() -> Path | None:
    """Explicit checkpoint ($SDTK_MODEL_PATH) — searched before model_dir()."""
    p = os.environ.get("SDTK_MODEL_PATH")
    return Path(p) if p else None


def repo_models_dir() -> Path:
    """The checkpoints bundled with the repository (``models/``)."""
    return Path(__file__).resolve().parent.parent / "models"
