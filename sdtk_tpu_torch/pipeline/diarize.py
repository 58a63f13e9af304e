"""Offline diarization of one recording on the GPU.

The counterpart of ``sdtk_tpu/pipeline/diarize.py``: waveform → trained
VAD gate → bed denoise → 1.0 s / 0.375 s windows embedded in static
chunks on the device (log-mel kernel → ECAPA → L2) → turn clustering →
resegmentation → boundary refinement → RTTM segments.  The host stages
are NumPy copies of the JAX package's; the embedding (and spectral
clustering from 1024 windows on) runs on ``device``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any

import numpy as np

from ..cluster.der import Segment, labels_to_segments
from ..cluster.spectral import spectral_cluster
from ..utils.device import resolve_device
from ..utils.profiling import stage


@dataclass(frozen=True)
class DiarizeConfig:
    # r4 window sweep (docs/PERFORMANCE.md): 1.0 s windows at 0.375 s hop
    # HALVED mean held-out DER vs the original 1.5/0.75 (0.112 -> 0.054
    # across 7 tiers at collar 0.75; clean 18.4% -> 4.6%, overlap tier
    # 17.8% -> 1.0%).  Shorter windows cut boundary contamination and
    # quantization; turn-level pooling recovers the per-window SNR loss.
    # 0.75 s windows are too short (0.172) - the knee is at 1.0 s.
    window_seconds: float = 1.0
    hop_seconds: float = 0.375
    sample_rate: int = 16000
    max_speakers: int = 8
    n_speakers: int | None = None  # None = eigengap auto
    vad_threshold_db: float = -40.0  # relative to peak RMS
    # "energy" (RMS vs loudest window) | "trained" (models/vad.py frame
    # classifier) | "auto" (trained when the bundled checkpoint exists,
    # else energy).  The energy gate calls any LOUD window speech —
    # music/keyboard/hum beds become speakers; the trained gate rejects
    # them (evals/benchmark_der.py --tier music A/B).
    vad: str = "auto"
    # With the trained VAD: clip hypothesis segments to the 10 ms speech
    # intervals (pipeline/vad.py speech_intervals).  Window-quantized
    # segments overhang turns by up to window_seconds at edges/gaps —
    # the dominant false-alarm term once windows are gated correctly.
    vad_clip: bool = True
    min_segment_seconds: float = 0.0
    embed_chunk: int = 128  # windows per device batch (static shape)
    resegment: bool = True  # sticky-HMM Viterbi smoothing of window labels
    # Meeting-adaptive bed suppression (pipeline/denoise.py): when the
    # trained VAD exposes ≥1.5 s of bed-only audio within 30 dB of the
    # speech level, the bed's median spectrum (estimated from those very
    # regions) is Wiener-subtracted before embedding.  Self-gating: on
    # clean/reverb/telephone meetings the non-speech regions are
    # near-silence and the pass is a measured no-op.  "auto" = on for
    # the offline pipeline; streaming never uses it (non-causal).
    denoise: str = "auto"  # "auto" | "off"
    # Sub-window boundary localization (cluster/boundary.py): place ONE
    # cut per label change — at the interpolated similarity crossing
    # between the adjacent windows, snapped to a VAD pause when one is
    # near — instead of letting both windows claim their full span
    # (which overlaps hypothesis claims by window-hop at every turn).
    # The r4 oracle measurement identified this quantization as the
    # dominant collar-0.25 residual; collar 0.75 absorbed it.
    boundary_refine: bool = True
    merge_tau: float | None = None  # same-speaker merge bar; None = backend's
    detect_overlap: bool = False  # emit secondary-speaker segments
    # Residual-alignment bar: a window is overlapped when, after removing
    # its assigned speaker's centroid component, the residual direction
    # aligns this strongly with another speaker's (orthogonalized)
    # centroid.  Chance alignment of a pure window's residual is
    # ~1/sqrt(D) ≈ 0.07 at D=192; mixed windows measured 0.4-0.8.
    overlap_threshold: float = 0.45
    # Only windows within this many hops of a primary-label change are
    # overlap candidates: overlap lives at turn boundaries
    # (interruptions / backchannels), and the r3 ratio-gate detector's
    # losses were mid-turn false alarms.
    overlap_boundary_windows: int = 2


def energy_vad_mask(
    wav: np.ndarray, sr: int, window: float, hop: float, threshold_db: float
) -> tuple[np.ndarray, np.ndarray]:
    """Per-window speech mask from RMS energy relative to the loudest
    window.  Returns (starts_sec, keep_mask)."""
    win = int(window * sr)
    hop_n = int(hop * sr)
    n = len(wav)
    if n < win:
        wav = np.pad(wav, (0, win - n))
        n = win
    n_win = 1 + (n - win) // hop_n
    starts = np.arange(n_win) * hop_n
    # vectorized per-window mean square via cumulative sums (an hour of
    # audio is ~4800 windows — the python loop was the host hot spot)
    sq = np.cumsum(np.square(wav, dtype=np.float64))
    ends = np.minimum(starts + win, n) - 1
    seg_sums = sq[ends] - np.where(starts > 0, sq[starts - 1], 0.0)
    seg_lens = ends - starts + 1  # tail windows can be shorter than win
    rms = np.sqrt(seg_sums / seg_lens + 1e-12)
    ref = rms.max() + 1e-12
    db = 20.0 * np.log10(rms / ref)
    keep = db > threshold_db
    if not keep.any():
        keep[:] = True
    return starts / sr, keep


def detect_overlap_windows(
    emb: np.ndarray, labels: np.ndarray, n_spk: int,
    threshold: float = 0.45, boundary_windows: int = 2,
) -> list[tuple[int, int]]:
    """Residual-alignment overlapped-speech detector.

    Remove the assigned speaker's centroid component from each window
    embedding and test whether the residual points along another
    speaker's centroid direction (itself orthogonalized against the
    primary).  A pure window's residual is within-speaker noise with no
    preferred direction (chance alignment ~1/sqrt(D)); a mixed window
    e ≈ α·c_p + β·c_s leaves a residual parallel to c_s's component
    orthogonal to c_p.  This replaces the r3 ratio gate (2nd-best ≥
    0.93 × best), whose best swept setting still lost to detector-off:
    raw 2nd-best similarity confuses "between two centroids" with
    "two active voices", while the residual test only fires on energy
    the primary speaker cannot explain.

    Windows farther than ``boundary_windows`` hops from a primary-label
    change are skipped — overlap lives at turn boundaries
    (interruptions / backchannels), and the measured false alarms of the
    old detector were mid-turn.  Returns (window_index, secondary_label).

    (The reference has no overlap concept — Speechmatics emits one label
    per word; this matters for DER on real meetings.)
    """
    e = emb / np.maximum(np.linalg.norm(emb, axis=-1, keepdims=True), 1e-12)
    labels = np.asarray(labels)
    centroids = np.stack([
        e[labels == k].mean(axis=0) if np.any(labels == k)
        else np.zeros(e.shape[1])
        for k in range(n_spk)
    ])
    centroids /= np.maximum(
        np.linalg.norm(centroids, axis=-1, keepdims=True), 1e-12
    )
    n = len(e)
    # residual of each window against its own centroid
    cp = centroids[labels]                     # (N, D)
    resid = e - (e * cp).sum(axis=1, keepdims=True) * cp
    rn = np.linalg.norm(resid, axis=1)
    resid = resid / np.maximum(rn, 1e-12)[:, None]
    # per-(primary, other) orthogonalized centroid directions
    dots = centroids @ centroids.T             # (K, K)
    perp = centroids[None, :, :] - dots[:, :, None] * centroids[:, None, :]
    perp /= np.maximum(np.linalg.norm(perp, axis=-1, keepdims=True), 1e-12)
    scores = np.einsum("nd,nkd->nk", resid, perp[labels])  # (N, K)
    scores[np.arange(n), labels] = -np.inf
    # distance (in hops) to the nearest primary-label change
    near = np.zeros(n, dtype=bool)
    change = np.flatnonzero(labels[1:] != labels[:-1])  # boundary after i
    for c in change:
        lo = max(0, c - boundary_windows + 1)
        hi = min(n, c + 1 + boundary_windows)
        near[lo:hi] = True
    out: list[tuple[int, int]] = []
    sec = np.argmax(scores, axis=1)
    val = scores[np.arange(n), sec]
    for i in range(n):
        if near[i] and rn[i] > 1e-6 and val[i] >= threshold:
            out.append((i, int(sec[i])))
    return out


class _StageClock:
    """Host wall seconds per pipeline stage (``result["timings"]``)."""

    def __init__(self):
        self.laps: dict[str, float] = {}
        self._t = time.perf_counter()

    def lap(self, name: str) -> None:
        now = time.perf_counter()
        self.laps[name] = now - self._t
        self._t = now


class Diarizer:
    """Owns the embedding backend and the clustering config.  Runs on
    ``device`` (default CUDA; raises if CUDA is missing)."""

    def __init__(self, backend_name: str | None = None,
                 cfg: DiarizeConfig = DiarizeConfig(), device: str | None = None):
        from ..backends.base import get_backend

        self.cfg = cfg
        self.device = resolve_device(device)
        self.backend = get_backend(backend_name, device=str(self.device))

    def _embed_windows(self, wav: np.ndarray, starts_sec: np.ndarray) -> np.ndarray:
        """Embed all windows in fixed-size device batches (pad rows are
        zero windows of full length, as in the JAX package).  A backend
        without a device engine (``fake``) embeds the real windows one by
        one, as the JAX package's does."""
        cfg = self.cfg
        sr = cfg.sample_rate
        win = int(cfg.window_seconds * sr)
        chunk = cfg.embed_chunk
        engine = getattr(self.backend, "engine", None)
        out = []
        for i in range(0, len(starts_sec), chunk):
            batch_starts = starts_sec[i : i + chunk]
            windows = np.zeros((chunk, win), dtype=np.float32)
            lengths = np.full(chunk, win, dtype=np.int32)
            for j, s in enumerate(batch_starts):
                a = int(s * sr)
                seg = wav[a : a + win]
                windows[j, : len(seg)] = seg
                lengths[j] = max(len(seg), 400)
            if engine is None:
                out.append(np.stack([self.backend.embed_waveform(w)
                                     for w in windows[: len(batch_starts)]]))
                continue
            emb = engine.embed(windows, lengths)
            out.append(emb[: len(batch_starts)].float().cpu().numpy())
        return np.concatenate(out, axis=0)

    def diarize_waveform(self, wav: np.ndarray) -> dict[str, Any]:
        cfg = self.cfg
        clock = _StageClock()
        speech_spans: list[tuple[float, float]] | None = None
        with stage("diarize.vad"):
            use_trained = cfg.vad == "trained"
            if cfg.vad == "auto":
                from .vad import trained_vad_available

                use_trained = trained_vad_available()
            vad_grid = None
            if use_trained:
                from .vad import trained_vad_analysis

                starts, keep, speech_spans, vad_grid = trained_vad_analysis(
                    wav, cfg.sample_rate, cfg.window_seconds,
                    cfg.hop_seconds, return_grid=True,
                )
            else:
                starts, keep = energy_vad_mask(
                    wav, cfg.sample_rate, cfg.window_seconds,
                    cfg.hop_seconds, cfg.vad_threshold_db,
                )
        clock.lap("vad")
        speech_starts = starts[keep]
        if len(speech_starts) == 0:
            return {"segments": [], "n_speakers": 0, "window_labels": []}

        if cfg.denoise == "auto" and speech_spans:
            from .denoise import estimate_and_subtract

            with stage("diarize.denoise"):
                wav = estimate_and_subtract(
                    wav, cfg.sample_rate, speech_spans, frame_probs=vad_grid)
            clock.lap("denoise")

        with stage("diarize.embed"):
            emb = self._embed_windows(wav, speech_starts)  # ends on a device→host copy
        clock.lap("embed")
        with stage("diarize.cluster"):
            tau = cfg.merge_tau if cfg.merge_tau is not None else self.backend.cluster_merge_tau
            rel = self.backend.cluster_merge_rel
            if cfg.n_speakers is None:
                from ..cluster.turns import turn_cluster

                labels, n_spk = turn_cluster(
                    emb, speech_starts, hop_s=cfg.hop_seconds, tau=tau,
                    rel=rel or 0.75, max_speakers=cfg.max_speakers, device=self.device,
                )
            else:
                labels, n_spk = spectral_cluster(
                    emb, n_speakers=cfg.n_speakers, max_speakers=cfg.max_speakers,
                    merge_tau=tau, merge_rel=rel, device=self.device,
                )
        clock.lap("cluster")
        if cfg.resegment:
            from ..cluster.resegment import resegment

            with stage("diarize.resegment"):
                labels = resegment(emb, labels, n_spk)
            clock.lap("resegment")

        overlap_pairs: list[tuple[int, int]] = []  # (window_idx, 2nd label)
        if cfg.detect_overlap and n_spk > 1:
            overlap_pairs = detect_overlap_windows(
                emb, labels, n_spk,
                threshold=cfg.overlap_threshold,
                boundary_windows=cfg.overlap_boundary_windows,
            )
        if cfg.boundary_refine:
            from ..cluster.boundary import refine_segments

            segments = refine_segments(
                emb, labels, speech_starts, cfg.window_seconds,
                prefix="S", speech_spans=speech_spans,
            )
        else:
            segments = labels_to_segments(
                labels, speech_starts, cfg.window_seconds, prefix="S"
            )
        # Relabel to S1..Sk in order of first appearance.
        order: dict[str, str] = {}
        renamed: list[Segment] = []
        for s, e, lbl in segments:
            if lbl not in order:
                order[lbl] = f"S{len(order) + 1}"
            renamed.append((s, e, order[lbl]))
        if speech_spans is not None and cfg.vad_clip:
            from .vad import clip_segments_to_speech

            renamed = clip_segments_to_speech(renamed, speech_spans)
        if cfg.min_segment_seconds > 0:
            renamed = [
                (s, e, l) for s, e, l in renamed if e - s >= cfg.min_segment_seconds
            ]

        overlap_segments: list[Segment] = []
        if overlap_pairs:
            sec_by_label: dict[int, list[float]] = {}
            for widx, sec in overlap_pairs:
                sec_by_label.setdefault(sec, []).append(speech_starts[widx])
            for sec, starts_list in sec_by_label.items():
                name = order.get(f"S{int(sec):02d}")
                if name is None:
                    continue
                segs = labels_to_segments(
                    np.zeros(len(starts_list), dtype=int),
                    np.asarray(sorted(starts_list)),
                    cfg.window_seconds,
                    prefix="X",
                )
                overlap_segments.extend((s, e, name) for s, e, _ in segs)
            overlap_segments.sort()

        out: dict[str, Any] = {
            "segments": renamed,
            "n_speakers": n_spk,
            "window_labels": np.asarray(labels).tolist(),
            "window_starts": speech_starts.tolist(),
        }
        if cfg.detect_overlap:
            out["overlap_segments"] = overlap_segments
        clock.lap("segments")
        out["timings"] = clock.laps
        return out

    def diarize_file(self, audio_path: str | Path) -> dict[str, Any]:
        from ..utils.audio import load_wav

        wav = load_wav(audio_path, target_sr=self.cfg.sample_rate)
        result = self.diarize_waveform(wav)
        result["audio_path"] = str(audio_path)
        result["duration"] = len(wav) / self.cfg.sample_rate
        return result


def to_rttm(result: dict[str, Any], recording_id: str = "rec") -> str:
    """Standard RTTM serialization of a diarization result.  Overlap
    segments (when detected) appear as additional SPEAKER lines for the
    secondary speaker — the NIST convention for overlapped speech."""
    lines = []
    all_segments = sorted(
        list(result["segments"]) + list(result.get("overlap_segments", []))
    )
    for start, end, label in all_segments:
        lines.append(
            f"SPEAKER {recording_id} 1 {start:.3f} {end - start:.3f} "
            f"<NA> <NA> {label} <NA> <NA>"
        )
    return "\n".join(lines) + ("\n" if lines else "")


def to_transcript_skeleton(result: dict[str, Any]) -> dict[str, Any]:
    """Speechmatics-format transcript skeleton (one empty pseudo-word per
    segment), so diarization output feeds the assign / review tooling.
    ``metadata.source`` is the JAX package's, so either package writes
    the same file."""
    items = [{"type": "word", "start_time": float(start), "end_time": float(end),
              "speaker": label, "alternatives": [{"content": "", "speaker": label}]}
             for start, end, label in result["segments"]]
    return {"results": items, "metadata": {"source": "sdtk_tpu.diarize"}}
