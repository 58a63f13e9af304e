"""Environment lookups the port needs (a copy of the relevant part of
``sdtk_tpu/config.py``: the same variables, read in the same place)."""

from __future__ import annotations

import os
from pathlib import Path


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
