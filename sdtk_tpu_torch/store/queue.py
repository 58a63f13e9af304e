"""Persistent processing queue — the host-side work ledger (the
counterpart of ``sdtk_tpu/store/queue.py``: the same ``process_queue.yaml``
layout, states and crash recovery).

Mirrors reference ``speaker-process`` ``ProcessingQueue`` (:201-341): a
lock-guarded, YAML-persisted queue keyed by recording b3sum whose items
move ``pending → processing → completed | failed | skipped``; re-adding a
failed/completed item resets it to pending, which is what makes crash
recovery free (work is idempotent per b3sum).

Item shape (reference QueueItem.to_dict :215-227): audio_path, b3sum,
status, context, backends, queued_at, started_at, completed_at, error,
results.

Serves both the single-host thread pool and the multi-host variant
(each host filters items by ``hash(path) % num_hosts == host_id``).
"""

from __future__ import annotations

import threading
from datetime import datetime, timezone
from pathlib import Path
from typing import Any

from .. import config
from ..utils.hashing import compute_b3sum
from ..utils.ioutil import load_yaml_or, save_yaml

SCHEMA_VERSION = 1
VALID_STATES = ("pending", "processing", "completed", "failed", "skipped")
DEFAULT_BACKENDS = ["speechmatics", "assemblyai"]


def _now() -> str:
    return datetime.now(timezone.utc).isoformat()


class ProcessingQueue:
    def __init__(self, path: str | Path | None = None):
        self.path = Path(path) if path else config.queue_path()
        self._lock = threading.Lock()
        self._items: dict[str, dict[str, Any]] = {}
        self._load()

    def _load(self) -> None:
        data = load_yaml_or(self.path, {}) or {}
        for item in data.get("items", []):
            key = item.get("b3sum") or item.get("path", "")
            item.setdefault("audio_path", item.get("path", ""))
            self._items[key] = item
        # Crash recovery: anything left 'processing' goes back to pending.
        for item in self._items.values():
            if item.get("status") == "processing":
                item["status"] = "pending"

    def _save_locked(self) -> None:
        save_yaml(
            self.path,
            {
                "schema_version": SCHEMA_VERSION,
                "updated_at": _now(),
                "items": list(self._items.values()),
            },
        )

    def add(
        self,
        path: str | Path,
        force: bool = False,
        context: str | None = None,
        backends: list[str] | None = None,
    ) -> dict[str, Any] | None:
        """Add (or re-arm) a work item; None when the file doesn't exist.

        Duplicate adds update context/backends and reset failed/completed
        items to pending (reference :272-283)."""
        audio_path = Path(path)
        if not audio_path.exists():
            return None
        b3sum = compute_b3sum(audio_path)
        with self._lock:
            item = self._items.get(b3sum)
            if item is not None:
                if item.get("status") != "processing":
                    item["context"] = context or item.get("context")
                    item["backends"] = backends or item.get("backends") or []
                    if item.get("status") in ("failed", "completed", "skipped") or force:
                        item["status"] = "pending"
                        item["error"] = None
                    self._save_locked()
                return dict(item)
            item = {
                "audio_path": str(audio_path.resolve()),
                "b3sum": b3sum,
                "status": "pending",
                "context": context,
                "backends": list(backends or DEFAULT_BACKENDS),
                "queued_at": _now(),
                "started_at": None,
                "completed_at": None,
                "error": None,
                "results": {},
                "attempts": 0,
            }
            self._items[b3sum] = item
            self._save_locked()
            return dict(item)

    def _resolve_key(self, key: str | Path) -> str | None:
        """Accept a b3sum or an audio path."""
        k = str(key)
        if k in self._items:
            return k
        resolved = str(Path(k).resolve())
        for b3, item in self._items.items():
            if item.get("audio_path") == resolved:
                return b3
        return None

    def next_pending(self) -> dict[str, Any] | None:
        """Claim the next pending item (marks it processing)."""
        with self._lock:
            pending = sorted(
                (i for i in self._items.values() if i["status"] == "pending"),
                key=lambda i: i.get("queued_at") or "",
            )
            if not pending:
                return None
            item = pending[0]
            item["status"] = "processing"
            item["started_at"] = _now()
            item["attempts"] = item.get("attempts", 0) + 1
            self._save_locked()
            return dict(item)

    def get_pending(self, limit: int | None = None) -> list[dict[str, Any]]:
        with self._lock:
            pending = sorted(
                (dict(i) for i in self._items.values() if i["status"] == "pending"),
                key=lambda i: i.get("queued_at") or "",
            )
        return pending[:limit] if limit else pending

    def mark(
        self,
        key: str | Path,
        status: str,
        error: str | None = None,
        results: dict[str, Any] | None = None,
    ) -> None:
        if status not in VALID_STATES:
            raise ValueError(status)
        with self._lock:
            k = self._resolve_key(key)
            if k is None:
                return
            item = self._items[k]
            item["status"] = status
            item["error"] = error
            if status == "processing":
                item["started_at"] = _now()
            if status in ("completed", "failed", "skipped"):
                item["completed_at"] = _now()
            if results is not None:
                item["results"] = results
            self._save_locked()

    # reference name (speaker-process:306)
    update_status = mark

    def items(self, status: str | None = None) -> list[dict[str, Any]]:
        with self._lock:
            out = [dict(i) for i in self._items.values()]
        if status:
            out = [i for i in out if i["status"] == status]
        return out

    def counts(self) -> dict[str, int]:
        with self._lock:
            counts = {s: 0 for s in VALID_STATES}
            for item in self._items.values():
                counts[item["status"]] = counts.get(item["status"], 0) + 1
            return counts

    def get_stats(self) -> dict[str, int]:
        """Per-state counts plus total (reference get_stats :333-341)."""
        stats = self.counts()
        stats["total"] = sum(stats.values())
        return stats

    def clear(
        self, only_completed: bool = False, status: str | None = None
    ) -> int:
        with self._lock:
            if status:
                keys = [k for k, v in self._items.items() if v["status"] == status]
            elif only_completed:
                keys = [k for k, v in self._items.items() if v["status"] == "completed"]
            else:
                keys = list(self._items)
            for k in keys:
                del self._items[k]
            self._save_locked()
            return len(keys)
