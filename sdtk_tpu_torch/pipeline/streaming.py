"""Streaming diarization with incremental clustering and online enrollment.

The counterpart of ``sdtk_tpu/pipeline/streaming.py`` (BASELINE.json
config 5).  Audio arrives in chunks; completed 1.5 s windows (0.75 s hop)
pass a speech gate, are embedded in one batched device call per
``embed_chunk`` windows (``backend.embed_batch``: the log-mel kernel and
the tower on the backend's device) and are greedily assigned to running
speaker centroids: a new centroid is spawned when the best cosine falls
below the new-speaker bar.  Centroids are EMA-updated.  ``finalize()``
re-clusters all window embeddings as the offline path does, and
``enroll_discovered()`` writes discovered speakers to the profile store.
The host logic is NumPy, as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np

from ..cluster.der import Segment
from ..utils.device import resolve_device


@dataclass
class StreamingConfig:
    sample_rate: int = 16000
    window_seconds: float = 1.5
    hop_seconds: float = 0.75
    # Raw-cosine bar below which a window spawns a new speaker.  None takes
    # the backend's measured raw_decision_threshold, else 0.5.
    new_speaker_threshold: float | None = None
    centroid_momentum: float = 0.9
    max_speakers: int = 16
    vad_threshold_db: float = -40.0
    # "energy" (window RMS against the running peak) | "trained" (the frame
    # classifier of models/vad.py, causal, with one-sided hysteresis) |
    # "auto" (trained when its checkpoint exists).
    vad: str = "energy"
    embed_chunk: int = 16  # windows per device call
    _FALLBACK_THRESHOLD = 0.5


@dataclass
class _State:
    buffer: np.ndarray = field(default_factory=lambda: np.zeros(0, np.float32))
    consumed_windows: int = 0
    centroids: list[np.ndarray] = field(default_factory=list)
    counts: list[int] = field(default_factory=list)
    window_labels: list[int] = field(default_factory=list)
    window_starts: list[float] = field(default_factory=list)
    window_embs: list[np.ndarray] = field(default_factory=list)
    peak_rms: float = 1e-9


class OnlineDiarizer:
    """Runs its backend on ``device`` (default CUDA; raises if CUDA is
    missing)."""

    def __init__(self, backend_name: str | None = None,
                 cfg: StreamingConfig = StreamingConfig(), device: str | None = None):
        from ..backends.base import get_backend

        self.cfg = cfg
        self.device = resolve_device(device)
        self.backend = get_backend(backend_name, device=str(self.device))
        self.state = _State()
        self._vad_scorer = None
        self._prev_strong = False
        if cfg.vad in ("trained", "auto"):
            try:
                from ..models.vad import VadScorer

                self._vad_scorer = VadScorer()
            except FileNotFoundError:
                if cfg.vad == "trained":
                    raise
        if cfg.new_speaker_threshold is None:
            measured = getattr(self.backend, "raw_decision_threshold", None)
            self.new_speaker_threshold = (float(measured) if measured is not None
                                          else StreamingConfig._FALLBACK_THRESHOLD)
        else:
            self.new_speaker_threshold = float(cfg.new_speaker_threshold)

    # -- feeding ------------------------------------------------------------

    def _is_speech(self, seg: np.ndarray, win: int) -> bool:
        st, cfg = self.state, self.cfg
        if self._vad_scorer is not None:
            from ..ops.fbank import log_mel_reference

            seg_p = seg if len(seg) == win else np.pad(seg, (0, win - len(seg)))
            p = self._vad_scorer.frame_probs(log_mel_reference(seg_p.astype(np.float32)))
            frac = float(np.mean(p > 0.5))
            # a weak window counts only after a strong one
            is_speech = frac >= 0.5 or (frac >= 0.25 and self._prev_strong)
            self._prev_strong = frac >= 0.5
            return is_speech
        rms = float(np.sqrt(np.mean(seg.astype(np.float64) ** 2) + 1e-12))
        st.peak_rms = max(st.peak_rms, rms)
        return 20.0 * np.log10(rms / st.peak_rms + 1e-12) > cfg.vad_threshold_db

    def feed(self, chunk: np.ndarray) -> list[dict[str, Any]]:
        """Append audio; returns assignments for the windows this chunk
        completed: [{start, end, speaker, similarity}]."""
        st, cfg = self.state, self.cfg
        st.buffer = np.concatenate([st.buffer, np.asarray(chunk, np.float32)])
        win = int(cfg.window_seconds * cfg.sample_rate)
        hop = int(cfg.hop_seconds * cfg.sample_rate)
        n_total = 0 if len(st.buffer) < win else 1 + (len(st.buffer) - win) // hop
        events: list[dict[str, Any]] = []

        pending = list(range(st.consumed_windows, n_total))
        for b0 in range(0, len(pending), cfg.embed_chunk):
            wavs, starts = [], []
            for w_idx in pending[b0 : b0 + cfg.embed_chunk]:
                seg = st.buffer[w_idx * hop : w_idx * hop + win]
                if self._is_speech(seg, win):
                    wavs.append(seg)
                    starts.append(w_idx * hop / cfg.sample_rate)
            if not wavs:
                continue
            for emb, start in zip(self._embed(wavs), starts):
                label, sim = self._assign(emb)
                st.window_labels.append(label)
                st.window_starts.append(start)
                st.window_embs.append(emb)
                events.append({"start": start, "end": start + cfg.window_seconds,
                               "speaker": f"S{label + 1}", "similarity": round(sim, 3)})
        st.consumed_windows = n_total
        return events

    def _embed(self, wavs: list[np.ndarray]) -> np.ndarray:
        embs = np.asarray(self.backend.embed_batch(wavs))
        return embs / np.maximum(np.linalg.norm(embs, axis=1, keepdims=True), 1e-12)

    def _assign(self, emb: np.ndarray) -> tuple[int, float]:
        st, cfg = self.state, self.cfg
        if st.centroids:
            cents = np.stack(st.centroids)
            cents = cents / np.maximum(np.linalg.norm(cents, axis=1, keepdims=True), 1e-12)
            sims = cents @ emb
            best = int(np.argmax(sims))
            if sims[best] >= self.new_speaker_threshold or len(st.centroids) >= cfg.max_speakers:
                m = cfg.centroid_momentum
                st.centroids[best] = m * st.centroids[best] + (1 - m) * emb
                st.counts[best] += 1
                return best, float(sims[best])
        st.centroids.append(emb.copy())
        st.counts.append(1)
        return len(st.centroids) - 1, 1.0

    # -- results ------------------------------------------------------------

    def segments(self) -> list[Segment]:
        """Segments of the labels so far, one localized cut per label
        change (``cluster.boundary.refine_segments``), labels S1, S2, …"""
        from ..cluster.boundary import refine_segments

        st = self.state
        if not st.window_labels:
            return []
        order = np.argsort(st.window_starts)
        raw = refine_segments(np.stack(st.window_embs)[order],
                              np.asarray(st.window_labels)[order],
                              np.asarray(st.window_starts)[order],
                              self.cfg.window_seconds, prefix="SPK")
        return [(s, e, lbl.replace("SPK0", "S").replace("SPK", "S")) for s, e, lbl in raw]

    def finalize(self, recluster: bool = True) -> dict[str, Any]:
        """Re-cluster all buffered window embeddings as the offline path
        does (turn clustering, then resegmentation)."""
        st = self.state
        if not st.window_embs:
            return {"segments": [], "n_speakers": 0}
        if recluster and len(st.window_embs) >= 4:
            from ..cluster.resegment import resegment
            from ..cluster.turns import turn_cluster

            emb = np.stack(st.window_embs)
            labels, k = turn_cluster(
                emb, np.asarray(st.window_starts), hop_s=self.cfg.hop_seconds,
                tau=getattr(self.backend, "cluster_merge_tau", 0.47),
                rel=getattr(self.backend, "cluster_merge_rel", None) or 0.75,
                max_speakers=self.cfg.max_speakers, device=self.device,
            )
            if k > 1:
                labels = resegment(emb, labels, k)
            st.window_labels = labels.tolist()
            st.centroids = [emb[labels == j].mean(axis=0) for j in range(k)]
            st.counts = [int((labels == j).sum()) for j in range(k)]
        return {"segments": self.segments(), "n_speakers": len(st.centroids),
                "window_labels": list(st.window_labels)}

    def enroll_discovered(self, audio_b3sum: str = "", min_windows: int = 3,
                          prefix: str = "unknown") -> list[str]:
        """Persist each discovered speaker's centroid (of at least
        ``min_windows`` windows) as a profile embedding, creating the
        profile ``{prefix}-NN`` if it is missing.  Returns the ids."""
        from ..store import profiles as P

        created = []
        for j, (centroid, count) in enumerate(zip(self.state.centroids, self.state.counts)):
            if count < min_windows:
                continue
            sid = f"{prefix}-{j + 1:02d}"
            if P.load_speaker(sid) is None:
                P.save_speaker(P.create_speaker_profile(sid, sid.title()))
            vec = centroid / max(np.linalg.norm(centroid), 1e-12)
            rec = P.create_embedding_record(
                source_audio="<stream>", source_audio_b3sum=audio_b3sum or "0" * 32,
                source_segments=[], model_version=self.backend.model_version,
                vector=vec.astype(np.float32))
            profile = P.load_speaker(sid)
            P.add_embedding(profile, self.backend.name, rec)
            P.save_speaker(profile)
            created.append(sid)
        return created
