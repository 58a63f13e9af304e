"""Versioned schema migrations for speaker profiles and sample metadata.

A copy of ``sdtk_tpu/store/migrations.py``'s migrations (same schema
versions, same results): a registry of (from, to) → function per kind,
applied sequentially.
"""

from __future__ import annotations

import sys
from typing import Any, Callable

PROFILE_SCHEMA_VERSION = 1
SAMPLE_METADATA_VERSION = 2

MigrationFunc = Callable[[dict[str, Any]], dict[str, Any]]


def _migrate_profile_v0_to_v1(profile: dict[str, Any]) -> dict[str, Any]:
    """v0 (unversioned) → v1: add version + required containers
    (reference migrations.py:42-71)."""
    profile = dict(profile)
    profile["version"] = 1
    profile.setdefault("tags", [])
    profile.setdefault("embeddings", {})
    profile.setdefault("metadata", {})
    profile.setdefault("name_contexts", {})
    return profile


PROFILE_MIGRATIONS: dict[tuple[int, int], MigrationFunc] = {
    (0, 1): _migrate_profile_v0_to_v1,
}


def _migrate_metadata_v0_to_v1(meta: dict[str, Any]) -> dict[str, Any]:
    """v0 → v1: version + basic structure (reference migrations.py:161-182)."""
    meta = dict(meta)
    meta["version"] = 1
    meta.setdefault("sample_id", "unknown")
    meta.setdefault("source", {})
    meta.setdefault("segment", {})
    meta.setdefault("extraction", {})
    return meta


def _migrate_metadata_v1_to_v2(meta: dict[str, Any]) -> dict[str, Any]:
    """v1 → v2: review section + b3sum placeholders
    (reference migrations.py:130-158)."""
    meta = dict(meta)
    meta["version"] = 2
    meta.setdefault("review", {"status": "pending", "reviewed_at": None, "notes": None})
    meta.setdefault("b3sum", None)  # requires recomputation by caller
    if "source" in meta and isinstance(meta["source"], dict):
        meta["source"].setdefault("audio_b3sum", None)
    return meta


SAMPLE_METADATA_MIGRATIONS: dict[tuple[int, int], MigrationFunc] = {
    (0, 1): _migrate_metadata_v0_to_v1,
    (1, 2): _migrate_metadata_v1_to_v2,
}


def _run_migrations(obj: dict[str, Any], registry: dict[tuple[int, int], MigrationFunc],
                    target_version: int, label: str) -> dict[str, Any]:
    """Apply the registered steps from ``obj``'s version up to
    ``target_version``; a missing step warns and stops."""
    current = obj.get("version", 0)
    while current < target_version:
        fn = registry.get((current, current + 1))
        if fn is None:
            print(f"Warning: No migration from {label} v{current} to v{current + 1}",
                  file=sys.stderr)
            break
        obj = fn(obj)
        current += 1
        obj["version"] = current
    return obj


def migrate_profile(profile: dict[str, Any]) -> dict[str, Any]:
    return _run_migrations(profile, PROFILE_MIGRATIONS, PROFILE_SCHEMA_VERSION, "profile")


def migrate_sample_metadata(meta: dict[str, Any], target_version: int | None = None
                            ) -> dict[str, Any]:
    return _run_migrations(
        meta, SAMPLE_METADATA_MIGRATIONS,
        SAMPLE_METADATA_VERSION if target_version is None else target_version,
        "sample metadata")
