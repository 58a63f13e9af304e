"""Versioned schema migrations for speaker profiles.

A copy of the profile part of ``sdtk_tpu/store/migrations.py`` (same
schema version, same results): a registry of (from, to) → function,
applied sequentially.  Sample-metadata migrations come with the sample
store's write side.
"""

from __future__ import annotations

import sys
from typing import Any, Callable

PROFILE_SCHEMA_VERSION = 1

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


def migrate_profile(profile: dict[str, Any]) -> dict[str, Any]:
    """Apply the registered steps from the profile's version up to
    ``PROFILE_SCHEMA_VERSION``."""
    current = profile.get("version", 0)
    while current < PROFILE_SCHEMA_VERSION:
        fn = PROFILE_MIGRATIONS.get((current, current + 1))
        if fn is None:
            print(f"Warning: No migration from profile v{current} to v{current + 1}",
                  file=sys.stderr)
            break
        profile = fn(profile)
        current += 1
        profile["version"] = current
    return profile
