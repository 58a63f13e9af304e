"""The Speechmatics cloud backend (a parity and migration aid).

A copy of ``sdtk_tpu/backends/speechmatics.py``: a batch job is created
(multipart upload of the audio and a JSON config), polled until done, and
its json-v2 transcript fetched.  Speaker "embeddings" are the cloud's
opaque identifier strings, kept in ``external_id`` / ``all_identifiers``;
identify sends at most 50 identifiers per speaker (the API's limit) and
reports binary confidence.  ``requests`` is imported only when a job is
sent; ``$SPEECHMATICS_API_KEY`` is required then, and
``$SPEECHMATICS_API_URL`` overrides the endpoint (a local mock server in
the tests).  Nothing on the GPU: the backend runs no model of its own.
"""

from __future__ import annotations

import os
import time
from pathlib import Path
from typing import Any

from .base import DEFAULT_THRESHOLD, EmbeddingBackend

REGIONS = {"eu": "eu1", "us": "us1", "au": "au1"}
API_VERSION = "v2"
POLL_INTERVAL = 3.0
POLL_TIMEOUT = 600.0
MAX_IDENTIFIERS_PER_SPEAKER = 50  # API limit (reference :425)


class SpeechmaticsBackend(EmbeddingBackend):
    def __init__(self, region: str = "eu", device=None):
        # ``device`` is taken, as the registry passes one to every backend,
        # and unused: the work runs in the cloud
        self._region = REGIONS.get(region, region)

    @property
    def name(self) -> str:
        return "speechmatics"

    @property
    def requires_api_key(self) -> bool:
        return True

    @property
    def embedding_dim(self) -> int:
        return 0  # opaque cloud identifiers, no local vector

    @property
    def model_version(self) -> str:
        return f"speechmatics-{API_VERSION}"

    # -- helpers ------------------------------------------------------------

    def _api(self):
        try:
            import requests
        except ImportError as e:
            raise RuntimeError("speechmatics backend requires 'requests'") from e
        key = os.environ.get("SPEECHMATICS_API_KEY")
        if not key:
            raise RuntimeError("SPEECHMATICS_API_KEY not set")
        # $SPEECHMATICS_API_URL overrides the cloud endpoint (a local mock
        # server drives the whole create/poll/fetch lifecycle in the tests)
        base = os.environ.get("SPEECHMATICS_API_URL") or (
            f"https://{self._region}.asr.api.speechmatics.com/{API_VERSION}"
        )
        return requests, base, {"Authorization": f"Bearer {key}"}

    def _submit_and_fetch(self, audio_path: Path, job_config: dict[str, Any]) -> dict[str, Any]:
        import json

        requests, base, headers = self._api()
        with open(audio_path, "rb") as f:
            resp = requests.post(
                f"{base}/jobs",
                headers=headers,
                files={"data_file": f},
                data={"config": json.dumps(job_config)},
            )
        resp.raise_for_status()
        job_id = resp.json()["id"]

        deadline = time.time() + POLL_TIMEOUT
        while time.time() < deadline:
            st = requests.get(f"{base}/jobs/{job_id}", headers=headers)
            st.raise_for_status()
            status = st.json().get("job", {}).get("status")
            if status == "done":
                break
            if status in ("rejected", "deleted", "expired"):
                raise RuntimeError(f"speechmatics job {job_id} {status}")
            time.sleep(POLL_INTERVAL)
        else:
            raise TimeoutError(f"speechmatics job {job_id} not done in {POLL_TIMEOUT}s")

        tr = requests.get(f"{base}/jobs/{job_id}/transcript?format=json-v2", headers=headers)
        tr.raise_for_status()
        return tr.json()

    def _base_config(self) -> dict[str, Any]:
        return {
            "type": "transcription",
            "transcription_config": {
                "language": "en",
                "diarization": "speaker",
            },
        }

    # -- API ----------------------------------------------------------------

    def enroll_speaker(self, audio_path, segments=None):
        cfg = self._base_config()
        cfg["transcription_config"]["speaker_diarization_config"] = {"get_speakers": True}
        result = self._submit_and_fetch(Path(audio_path), cfg)
        speakers = result.get("speakers", [])
        if not speakers:
            raise RuntimeError("no speakers returned by enrollment job")
        # Pick the speaker with the most identifiers (reference :342).
        best = max(speakers, key=lambda s: len(s.get("speaker_identifiers", [])))
        idents = best.get("speaker_identifiers", [])
        return {
            "vector": None,
            "external_id": idents[0] if idents else None,
            "all_identifiers": idents,
            "model_version": self.model_version,
        }

    def identify_speaker(self, audio_path, candidates, threshold=DEFAULT_THRESHOLD,
                         segments=None):
        cfg = self._base_config()
        speakers_cfg = []
        configured: set[str] = set()
        for profile in candidates:
            idents: list[str] = []
            for rec in profile.get("embeddings", {}).get(self.name, []):
                if rec.get("external_id"):
                    idents.append(rec["external_id"])
                idents.extend(rec.get("all_identifiers", []))
            # de-duplicate (a profile's external_id is usually also its
            # first all_identifiers entry) BEFORE the 50-identifier API
            # cap, as the reference does (:425 `list(set(...))[:50]`) —
            # but order-preserving, so which identifiers survive the cap
            # is deterministic.
            idents = list(dict.fromkeys(idents))
            if idents:
                speakers_cfg.append(
                    {
                        "label": profile["id"],
                        "speaker_identifiers": idents[:MAX_IDENTIFIERS_PER_SPEAKER],
                    }
                )
                configured.add(profile["id"])
        if not speakers_cfg:
            return []
        cfg["transcription_config"]["speaker_diarization_config"] = {
            "speakers": speakers_cfg
        }
        result = self._submit_and_fetch(Path(audio_path), cfg)

        # Word items carry the label either at the top level or inside
        # alternatives[0] (reference :453-462); punctuation items are
        # skipped.  Only labels we CONFIGURED count as identifications —
        # the cloud still emits S1/S2/UU for unenrolled voices
        # (reference :463-466 id_to_speaker membership).
        found: set[str] = set()
        seen: set[str] = set()
        results = result.get("results", [])
        for item in results:
            if item.get("type") != "word":
                continue
            spk = item.get("speaker") or (
                item.get("alternatives", [{}])[0].get("speaker")
                if item.get("alternatives")
                else None
            )
            if spk:
                seen.add(spk)
                if spk in configured:
                    found.add(spk)
        if os.environ.get("SPEAKER_DETECTION_DEBUG"):
            # the reference's debug dump (:469-478), kept field-for-field
            # so existing debugging workflows read identically
            import sys

            cfg_labels = [s["label"] for s in speakers_cfg]
            print(f"DEBUG: speakers_config labels: {cfg_labels}",
                  file=sys.stderr)
            print(f"DEBUG: all speakers found in transcript: {seen}",
                  file=sys.stderr)
            print(f"DEBUG: matched to candidates: {found}", file=sys.stderr)
            print(f"DEBUG: transcript keys: {result.keys()}", file=sys.stderr)
            print(f"DEBUG: results count: {len(results)}", file=sys.stderr)
            if results:
                print(f"DEBUG: first result: {results[0]}", file=sys.stderr)
        # The cloud gives no score: binary confidence (reference :486).
        return [
            {
                "speaker_id": sid,
                "similarity": 1.0,
                "confidence": 1.0,
                "embedding_id": None,
                "backend": self.name,
            }
            for sid in sorted(found)
        ]
