"""Structural validation for the file DB.

A copy of ``sdtk_tpu/store/schemas.py``, with the same checks and warning
strings: validators return a list of warning strings; with
``strict=True`` the first problem raises ``ValidationError``.
"""

from __future__ import annotations

from datetime import datetime
from typing import Any


class ValidationError(Exception):
    pass


PROFILE_REQUIRED_FIELDS = {"id", "names"}
EMBEDDING_REQUIRED_FIELDS = {"id", "external_id", "created_at"}
SAMPLE_METADATA_REQUIRED_FIELDS = {"sample_id", "source", "segment"}

VALID_TRUST_LEVELS = {"high", "medium", "low", "invalidated"}
VALID_REVIEW_STATUSES = {"pending", "reviewed", "rejected"}


def _issue(warnings: list[str], msg: str, strict: bool) -> None:
    if strict:
        raise ValidationError(msg)
    warnings.append(msg)


def validate_profile(profile: dict[str, Any], strict: bool = False) -> list[str]:
    """Validate a speaker profile (reference schemas.py:45-137)."""
    warnings: list[str] = []
    if not isinstance(profile, dict):
        msg = f"Profile must be a dict, got {type(profile).__name__}"
        if strict:
            raise ValidationError(msg)
        return [msg]

    missing = PROFILE_REQUIRED_FIELDS - set(profile)
    if missing:
        _issue(warnings, f"Missing required fields: {', '.join(sorted(missing))}", strict)

    if "id" in profile and (not isinstance(profile["id"], str) or not profile["id"]):
        _issue(warnings, "Profile 'id' must be a non-empty string", strict)

    names = profile.get("names")
    if "names" in profile:
        if not isinstance(names, dict):
            _issue(warnings, f"Profile 'names' must be a dict, got {type(names).__name__}", strict)
        elif "default" not in names:
            warnings.append("Profile 'names' should have a 'default' entry")

    tags = profile.get("tags")
    if "tags" in profile:
        if not isinstance(tags, list):
            _issue(warnings, f"Profile 'tags' must be a list, got {type(tags).__name__}", strict)
        elif not all(isinstance(t, str) for t in tags):
            _issue(warnings, "All tags must be strings", strict)

    embs = profile.get("embeddings")
    if "embeddings" in profile:
        if not isinstance(embs, dict):
            _issue(
                warnings,
                f"Profile 'embeddings' must be a dict, got {type(embs).__name__}",
                strict,
            )
        else:
            for backend, emb_list in embs.items():
                if not isinstance(emb_list, list):
                    _issue(warnings, f"Embeddings for '{backend}' must be a list", strict)
                    continue
                for i, emb in enumerate(emb_list):
                    for w in validate_embedding(emb, strict=False):
                        warnings.append(f"embeddings.{backend}[{i}]: {w}")

    if "version" in profile and not isinstance(profile["version"], int):
        warnings.append(
            f"Profile 'version' must be an int, got {type(profile['version']).__name__}"
        )
    return warnings


def validate_embedding(embedding: dict[str, Any], strict: bool = False) -> list[str]:
    """Validate an embedding record (reference schemas.py:140-251)."""
    warnings: list[str] = []
    if not isinstance(embedding, dict):
        msg = f"Embedding must be a dict, got {type(embedding).__name__}"
        if strict:
            raise ValidationError(msg)
        return [msg]

    missing = EMBEDDING_REQUIRED_FIELDS - set(embedding)
    if missing:
        _issue(warnings, f"Missing required fields: {', '.join(sorted(missing))}", strict)

    if "id" in embedding and (not isinstance(embedding["id"], str) or not embedding["id"]):
        _issue(warnings, "Embedding 'id' must be a non-empty string", strict)

    ext_id = embedding.get("external_id")
    if "external_id" in embedding and ext_id is not None and not isinstance(ext_id, str):
        _issue(
            warnings,
            f"Embedding 'external_id' must be a string or null, got {type(ext_id).__name__}",
            strict,
        )

    if "vector_file" in embedding:
        vf = embedding["vector_file"]
        if vf is not None and not isinstance(vf, str):
            warnings.append("Embedding 'vector_file' must be a string or null")

    if "model_version" in embedding:
        mv = embedding["model_version"]
        if not isinstance(mv, str):
            warnings.append(
                f"Embedding 'model_version' must be a string, got {type(mv).__name__}"
            )
        elif mv == "unknown":
            warnings.append("Embedding has unknown model_version")

    if "trust_level" in embedding and embedding["trust_level"] not in VALID_TRUST_LEVELS:
        _issue(
            warnings,
            f"Invalid trust_level '{embedding['trust_level']}', expected one of: "
            f"{', '.join(sorted(VALID_TRUST_LEVELS))}",
            strict,
        )

    if "created_at" in embedding:
        ca = embedding["created_at"]
        if isinstance(ca, str):
            try:
                datetime.fromisoformat(ca.replace("Z", "+00:00"))
            except ValueError:
                warnings.append(f"Embedding 'created_at' is not valid ISO format: {ca}")
        else:
            warnings.append(
                f"Embedding 'created_at' must be a string, got {type(ca).__name__}"
            )

    samples = embedding.get("samples")
    if "samples" in embedding:
        if isinstance(samples, dict):
            for key in ("reviewed", "unreviewed", "rejected"):
                if key in samples:
                    if not isinstance(samples[key], list):
                        warnings.append(f"samples.{key} must be a list")
                    elif not all(isinstance(s, str) for s in samples[key]):
                        warnings.append(
                            f"samples.{key} must contain only strings (b3sum hashes)"
                        )
        elif samples is not None:
            warnings.append(
                f"Embedding 'samples' must be a dict or null, got {type(samples).__name__}"
            )

    segs = embedding.get("source_segments")
    if "source_segments" in embedding:
        if segs is not None and not isinstance(segs, list):
            warnings.append("Embedding 'source_segments' must be a list or null")
        elif isinstance(segs, list):
            for i, seg in enumerate(segs):
                if not isinstance(seg, dict):
                    warnings.append(f"source_segments[{i}] must be a dict")
                elif "start" not in seg or "end" not in seg:
                    warnings.append(f"source_segments[{i}] must have 'start' and 'end' keys")
    return warnings


def validate_sample_metadata(metadata: dict[str, Any], strict: bool = False) -> list[str]:
    """Validate sample metadata (reference schemas.py:254-345)."""
    warnings: list[str] = []
    if not isinstance(metadata, dict):
        msg = f"Metadata must be a dict, got {type(metadata).__name__}"
        if strict:
            raise ValidationError(msg)
        return [msg]

    missing = SAMPLE_METADATA_REQUIRED_FIELDS - set(metadata)
    if missing:
        _issue(warnings, f"Missing required fields: {', '.join(sorted(missing))}", strict)

    if "sample_id" in metadata and not isinstance(metadata["sample_id"], str):
        _issue(warnings, "Metadata 'sample_id' must be a string", strict)

    src = metadata.get("source")
    if "source" in metadata:
        if not isinstance(src, dict):
            _issue(warnings, f"Metadata 'source' must be a dict, got {type(src).__name__}", strict)
        elif "audio_b3sum" in src and src["audio_b3sum"] is not None:
            if not isinstance(src["audio_b3sum"], str):
                warnings.append("source.audio_b3sum must be a string or null")

    seg = metadata.get("segment")
    if "segment" in metadata:
        if not isinstance(seg, dict):
            _issue(warnings, f"Metadata 'segment' must be a dict, got {type(seg).__name__}", strict)

    review = metadata.get("review")
    if "review" in metadata and isinstance(review, dict):
        status = review.get("status")
        if status is not None and status not in VALID_REVIEW_STATUSES:
            _issue(
                warnings,
                f"Invalid review status '{status}', expected one of: "
                f"{', '.join(sorted(VALID_REVIEW_STATUSES))}",
                strict,
            )
    return warnings


def validate_all(root: Any = None) -> dict[str, list[str]]:
    """Validate every profile and sample-metadata file in the DB; returns
    {relative_path: [warnings]} for files with issues
    (reference schemas.py:348-387)."""
    from .. import config
    from ..utils.ioutil import load_json, load_yaml

    issues: dict[str, list[str]] = {}
    db = config.db_dir()
    if db.exists():
        for p in sorted(db.glob("*.json")):
            try:
                warnings = validate_profile(load_json(p))
            except Exception as e:  # unreadable file is itself an issue
                warnings = [f"unreadable: {e}"]
            if warnings:
                issues[f"db/{p.name}"] = warnings
    samples_root = config.samples_dir()
    if samples_root.exists():
        for p in sorted(samples_root.glob("*/*.meta.yaml")):
            try:
                warnings = validate_sample_metadata(load_yaml(p))
            except Exception as e:
                warnings = [f"unreadable: {e}"]
            if warnings:
                issues[f"samples/{p.parent.name}/{p.name}"] = warnings
    return issues
