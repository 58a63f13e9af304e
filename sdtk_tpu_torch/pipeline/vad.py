"""Window-level speech masks for the diarizer front gates.

A NumPy copy of ``sdtk_tpu/pipeline/vad.py`` (identical numerics), on the
port's own ``ops/fbank.log_mel_reference`` and ``models/vad.VadScorer``.
The trained frame classifier is scored per window (per-window log-mel +
CMN) with double-threshold hysteresis; :func:`trained_vad_analysis`
also returns the 10 ms speech intervals the diarizer clips its segments
to, and the raw probability grid the bed denoiser reads.  The VAD runs
on the host, before the embedding program, as in the JAX package.
"""

from __future__ import annotations

import numpy as np

from ..ops.fbank import FrontendConfig, log_mel_reference

_scorer_cache: dict[str, object] = {}


def _get_scorer(params_path: str | None = None):
    from ..models.vad import VadScorer

    key = params_path or "__default__"
    if key not in _scorer_cache:
        _scorer_cache[key] = VadScorer(params_path)
    return _scorer_cache[key]


def trained_vad_available(params_path: str | None = None) -> bool:
    try:
        _get_scorer(params_path)
        return True
    except FileNotFoundError:
        return False


def trained_vad_mask(
    wav: np.ndarray,
    sr: int,
    window: float,
    hop: float,
    frame_threshold: float = 0.5,
    strong_frac: float = 0.5,
    weak_frac: float = 0.25,
    params_path: str | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Per-window speech mask from the trained VAD, with hysteresis.

    Each window is scored exactly as trained (per-window log-mel + CMN)
    into the fraction of frames above ``frame_threshold``.  Double
    threshold: a window is speech when its fraction clears
    ``strong_frac`` on its own, or clears ``weak_frac`` while adjacent
    to a strong window (classic VAD hangover — keeps turn-edge windows
    whose speech only partially covers them, without letting an isolated
    speech-ish music bar through; measured window fractions on the music
    tier: speech 0.91–1.0, music 0.0–0.32, turn edges 0.16–0.4).
    Same (starts_sec, keep) contract as energy_vad_mask.
    """
    scorer = _get_scorer(params_path)
    fcfg = FrontendConfig()
    win_n = int(window * sr)
    hop_n = int(hop * sr)
    n = len(wav)
    if n < win_n:
        wav = np.pad(wav, (0, win_n - n))
        n = win_n
    n_win = 1 + (n - win_n) // hop_n
    starts = np.arange(n_win) * hop_n

    frac, _, _ = _score_windows(scorer, wav, win_n, hop_n,
                                frame_threshold)
    strong = frac >= strong_frac
    near_strong = strong.copy()
    near_strong[:-1] |= strong[1:]
    near_strong[1:] |= strong[:-1]
    keep = strong | ((frac >= weak_frac) & near_strong)
    if not keep.any():
        keep[:] = True  # degrade to "all speech" rather than empty output
    return starts / sr, keep


def _score_windows(scorer, wav: np.ndarray, win_n: int, hop_n: int,
                   frame_threshold: float = 0.5,
                   ) -> tuple[np.ndarray, np.ndarray, float]:
    """One pass over the recording's windows (scored exactly as trained:
    per-window log-mel + CMN) → (per-window speech fractions, 10 ms
    frame-probability grid combined by MAX over overlaps, frame period)."""
    fcfg = FrontendConfig()
    n = len(wav)
    n_win = 1 + max(0, n - win_n) // hop_n
    frames_per_hop = hop_n // fcfg.hop_length
    total = fcfg.num_frames(n)
    frac = np.zeros(n_win, np.float32)
    grid = np.zeros(total, np.float32)
    for i in range(n_win):
        a = i * hop_n
        seg = wav[a : a + win_n]
        if len(seg) < win_n:
            seg = np.pad(seg, (0, win_n - len(seg)))
        p = scorer.frame_probs(log_mel_reference(seg.astype(np.float32), fcfg))
        frac[i] = float(np.mean(p > frame_threshold))
        f0 = i * frames_per_hop
        span = min(len(p), total - f0)
        grid[f0 : f0 + span] = np.maximum(grid[f0 : f0 + span], p[:span])
    return frac, grid, fcfg.hop_length / fcfg.sample_rate


def speech_frame_probs(
    wav: np.ndarray, sr: int,
    window: float = 1.5, hop: float = 0.75,
    params_path: str | None = None,
) -> tuple[float, np.ndarray]:
    """Recording-level 10 ms speech-probability track (MAX over
    overlapping windows).  Returns (frame_period_seconds, probs)."""
    scorer = _get_scorer(params_path)
    win_n = int(window * sr)
    n = len(wav)
    if n < win_n:
        wav = np.pad(wav, (0, win_n - n))
    _, grid, period = _score_windows(scorer, wav, win_n, int(hop * sr))
    return period, grid


def speech_intervals(
    wav: np.ndarray, sr: int,
    threshold: float = 0.35, min_dur: float = 0.15,
    max_gap: float = 0.3, pad: float = 0.25,
    params_path: str | None = None,
) -> list[tuple[float, float]]:
    """Merged (start, end) speech intervals at 10 ms resolution: frames
    above ``threshold``, gaps shorter than ``max_gap`` bridged, runs
    shorter than ``min_dur`` dropped, survivors padded by ``pad`` s."""
    period, probs = speech_frame_probs(wav, sr, params_path=params_path)
    return _intervals_from_grid(probs, period, len(wav) / sr, threshold,
                                min_dur, max_gap, pad)


def trained_vad_analysis(
    wav: np.ndarray, sr: int, window: float, hop: float,
    params_path: str | None = None, return_grid: bool = False,
):
    """One scoring pass → (window starts_sec, keep mask, 10 ms speech
    intervals[, (frame_period, prob_grid)]).  The Diarizer's trained-VAD
    entry point: gates windows AND supplies the frame-level intervals
    its segments are clipped to, without scoring the recording twice.
    ``return_grid`` additionally exposes the RAW 10 ms probability track
    (no padding/bridging) — the bed-spectrum estimator
    (pipeline/denoise.py) needs the unpadded non-speech frames, which
    the merged intervals deliberately swallow."""
    scorer = _get_scorer(params_path)
    win_n, hop_n = int(window * sr), int(hop * sr)
    n = len(wav)
    if n < win_n:
        wav = np.pad(wav, (0, win_n - n))
        n = win_n
    n_win = 1 + (n - win_n) // hop_n
    starts = np.arange(n_win) * hop_n
    frac, grid, period = _score_windows(scorer, wav, win_n, hop_n)
    strong = frac >= 0.5
    near_strong = strong.copy()
    near_strong[:-1] |= strong[1:]
    near_strong[1:] |= strong[:-1]
    keep = strong | ((frac >= 0.25) & near_strong)
    if not keep.any():
        # The VAD sees NO speech anywhere (e.g. synthetic tone fixtures,
        # or an out-of-domain channel): degrade to the null gate — keep
        # every window and DON'T clip — rather than emptying the output
        # on the strength of a model that has already disclaimed the
        # input.
        keep[:] = True
        if return_grid:
            return starts / sr, keep, None, (period, grid)
        return starts / sr, keep, None
    intervals = _intervals_from_grid(grid, period, len(wav) / sr)
    if return_grid:
        return starts / sr, keep, intervals, (period, grid)
    return starts / sr, keep, intervals


def _intervals_from_grid(
    probs: np.ndarray, period: float, duration: float,
    threshold: float = 0.35, min_dur: float = 0.15,
    max_gap: float = 0.3, pad: float = 0.25,
) -> list[tuple[float, float]]:
    """Defaults from the r4 clip sweep (docs/PERFORMANCE.md): thr 0.35 /
    pad 0.25 keeps clean-tier miss at exactly 0 while still cutting
    music-gap false alarm; the tighter thr 0.5 / pad 0.1 bought 2.2 more
    points on the music tier by eating 2.4 points of true speech on
    clean — the wrong trade for a default."""
    active = probs >= threshold
    out: list[tuple[float, float]] = []
    t0 = None
    for i, a in enumerate(active):
        if a and t0 is None:
            t0 = i * period
        elif not a and t0 is not None:
            out.append((t0, i * period))
            t0 = None
    if t0 is not None:
        out.append((t0, len(active) * period))
    merged: list[tuple[float, float]] = []
    for s, e in out:
        if merged and s - merged[-1][1] <= max_gap:
            merged[-1] = (merged[-1][0], e)
        else:
            merged.append((s, e))
    return [
        (max(0.0, s - pad), min(duration, e + pad))
        for s, e in merged if e - s >= min_dur
    ]


def clip_segments_to_speech(
    segments: list, intervals: list[tuple[float, float]],
    min_piece: float = 0.1,
) -> list:
    """Intersect labeled (start, end, label) segments with speech
    intervals — removes the non-speech slack that window-quantized
    hypothesis segments carry at turn edges and across gaps (the
    dominant false-alarm term once the VAD gates windows correctly)."""
    out = []
    for s, e, lbl in segments:
        for a, b in intervals:
            lo, hi = max(s, a), min(e, b)
            if hi - lo >= min_piece:
                out.append((lo, hi, lbl))
    out.sort()
    return out
