"""Atomic file IO for the JSON/YAML file database (a copy of
``sdtk_tpu/utils/ioutil.py``: same bytes on disk).

Every write goes through a same-directory temp file and ``os.replace``.
``yaml`` is imported only inside the YAML functions, so the identify path
runs where PyYAML is not installed.
"""

from __future__ import annotations

import json
import os
import tempfile
from pathlib import Path
from typing import Any


def atomic_write_bytes(path: str | Path, data: bytes) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=str(path.parent), prefix=f".{path.name}.", suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def atomic_write_text(path: str | Path, text: str) -> None:
    atomic_write_bytes(path, text.encode("utf-8"))


def save_json(path: str | Path, obj: Any, indent: int = 2) -> None:
    atomic_write_text(path, json.dumps(obj, indent=indent, ensure_ascii=False) + "\n")


def load_json(path: str | Path) -> Any:
    with open(path, "r", encoding="utf-8") as f:
        return json.load(f)


def save_yaml(path: str | Path, obj: Any) -> None:
    import yaml

    atomic_write_text(
        path, yaml.safe_dump(obj, default_flow_style=False, allow_unicode=True, sort_keys=False)
    )


def load_yaml(path: str | Path) -> Any:
    import yaml

    with open(path, "r", encoding="utf-8") as f:
        return yaml.safe_load(f)


def load_yaml_or(path: str | Path, default: Any = None) -> Any:
    try:
        return load_yaml(path)
    except FileNotFoundError:
        return default


def load_json_or(path: str | Path, default: Any = None) -> Any:
    try:
        return load_json(path)
    except FileNotFoundError:
        return default
