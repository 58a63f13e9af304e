"""Diarization of hour-scale recordings, time-sharded over a process group.

The port of ``sdtk_tpu/pipeline/longform.py``.  Every rank of the group
(``parallel/multihost.py``; one rank of one without a group) drives one
device and runs:

    waveform, this rank's contiguous chunk
      → sharded log-mel frontend  (K1 on the chunk; one all_gather for the
        halo, an all_reduce for global CMN; ``ops/longform.py``)
      → windows along time        (a strided view of the features)
      → ECAPA embeddings          (this rank's share of the windows, in
        chunks of ``EMBED_CHUNK``; all_gather)
      → energy gate on the host   (or the trained VAD)
      → row-block refined affinity → normalized Laplacian → subspace
        eigensolve → k-means on the device (every rank holds the whole
        matrix and solves it; the JAX package shards the solve with GSPMD)
      → merge count, resegmentation and segments on the host.

The order of operations is the JAX package's, so the same weights and
signal give the same windows kept and the same labels.  One departure:
a window's start is where its frames start.  Windows step
``int(hop_seconds · frames_per_second)`` frames; the JAX package labels
window i at ``i · hop_seconds``, which at the CLI's 0.375 s hop (37
frames, 0.37 s) runs 5 ms a window ahead, 48 s over an hour.  Here
window i starts at ``i · 37 · hop_length / sample_rate``; at a hop of
whole frames (the 0.75 s default) the two are the same numbers.  The
trained gate scores windows at the same positions.

Each window is embedded with an all-ones mask and L2-normalized.
Embedding in chunks bounds memory: in exact arithmetic a window's
embedding does not depend on its batch, though cuDNN may sum a bf16
convolution in another order for another batch size, so the ranks' chunk
boundaries can move a borderline window's label.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from ..backends.gpu import EmbedEngine
from ..cluster.der import Segment, labels_to_segments
from ..cluster.spectral import kmeans, merge_count, normalized_laplacian, topk_eigvecs_subspace
from ..models.ecapa import l2_normalize
from ..ops.longform import pad_for_sharding, sharded_affinity_rows, sharded_log_mel
from ..parallel.multihost import all_gather_rows, rank_and_world, rank_device
from ..utils.profiling import stage
from .diarize import _StageClock

# Windows a rank embeds in one call of the tower (1024 windows of 1.0 s:
# the size of chip_smoke's embed + cluster batch in frames, a third of it).
EMBED_CHUNK = 1024


@dataclass(frozen=True)
class LongformConfig:
    window_seconds: float = 1.5
    hop_seconds: float = 0.75
    sample_rate: int = 16000
    max_speakers: int = 8
    n_speakers: int | None = None
    vad_threshold_db: float = -40.0  # on the window's mean log-mel, relative to the loudest
    # "energy": mean log-mel per window, computed beside the embeddings (the
    # hour-scale default); "trained": the frame classifier (pipeline/vad.py),
    # which rejects music/keyboard/hum beds the energy gate clusters as
    # speakers, at serial host cost per window.
    vad: str = "energy"
    resegment: bool = True
    merge_tau: float = 0.47  # same-speaker merge bar (cluster.spectral.MERGE_TAU)
    merge_rel: float | None = 0.75  # scale-free bar (cluster.spectral.MERGE_REL)


def frame_axis0(x: torch.Tensor, win: int, hop: int) -> torch.Tensor:
    """(T, M) → (W, win, M) windows along time, ``W = max(1 + (T − win) //
    hop, 1)``, zero-padded at the end when T < win (the JAX package's
    ``_frame_axis0``).  A strided view where no pad is needed."""
    t = x.shape[0]
    w = max(1 + (t - win) // hop, 1)
    need = (w - 1) * hop + win
    if t < need:
        x = torch.nn.functional.pad(x, (0, 0, 0, need - t))
    return x.unfold(0, win, hop)[:w].transpose(1, 2)


class LongformDiarizer:
    """Owns this rank's device, the ECAPA weights and the process group.

    The tower is ECAPA whatever ``$SDTK_BACKEND_TOWER`` says, with the
    checkpoint search of ``backends/gpu.py`` (the JAX package's);
    ``channels`` picks the width.  ``device`` defaults to CUDA (this rank's
    card); the ranks are those of the process group, if one exists.
    ``subspace_start(n, m)``, when given, supplies the eigensolver's
    (n, m) start (a test passes the JAX package's)."""

    def __init__(
        self,
        cfg: LongformConfig = LongformConfig(),
        channels: int = 512,
        params_path: str | None = None,
        seed: int = 0,
        device: str | torch.device | None = None,
        subspace_start: Callable[[int, int], np.ndarray] | None = None,
    ):
        self.cfg = cfg
        self.device = rank_device(device)
        self.subspace_start = subspace_start
        self._engine = EmbedEngine("ecapa", channels, 1, params_path, seed, self.device)

    def _embed(self, windows: torch.Tensor, lo: int, hi: int, per: int) -> torch.Tensor:
        """Unit embeddings of windows [lo, hi), in chunks, into (per, D)
        rows (rows past hi − lo stay zero: the pad rows the gather
        drops)."""
        eng = self._engine
        out = torch.zeros((per, eng.emb_dim), dtype=torch.float32, device=self.device)
        for s in range(lo, hi, EMBED_CHUNK):
            e = min(s + EMBED_CHUNK, hi)
            x = windows[s:e].contiguous()
            mask = torch.ones(x.shape[:2], dtype=torch.bool, device=self.device)
            out[s - lo : e - lo] = l2_normalize(eng.model(x, mask).float())
        return out

    def _keep(self, wav: np.ndarray, energy: np.ndarray, w: int, win_s: float,
              hop_s: float) -> np.ndarray:
        cfg = self.cfg
        if cfg.vad == "trained":
            from .vad import trained_vad_mask

            _, keep = trained_vad_mask(np.asarray(wav, np.float32), cfg.sample_rate, win_s, hop_s)
            keep = keep[:w]
            if len(keep) < w:
                keep = np.pad(keep, (0, w - len(keep)), constant_values=True)
        else:
            # mean log-mel per window against the loudest window: log scale,
            # so a fixed offset is a relative-dB bar
            keep = energy > (energy.max() + cfg.vad_threshold_db / 8.686)
        if not keep.any():
            keep[:] = True
        return keep

    @torch.inference_mode()
    def diarize_waveform(self, wav: np.ndarray) -> dict[str, Any]:
        """Diarize one mono recording (every rank passes the whole signal
        and reads its own chunk).  Returns the JAX package's keys, the same
        on every rank, plus ``timings``: seconds of ``frontend``, ``embed``,
        ``affinity``, ``eigensolve`` and ``labels`` (host labelling)."""
        cfg, fcfg, dev = self.cfg, self._engine.cfg, self.device
        rank, world = rank_and_world()
        clock = _StageClock()

        def lap(name: str) -> None:  # a stage's device work counts in it
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            clock.lap(name)

        wav = np.asarray(wav, np.float32)

        with stage("longform.embed_program"):
            # every rank holds an equal chunk of the padded signal
            padded = pad_for_sharding(wav, world, fcfg)
            n_local = len(padded) // world
            x_local = torch.from_numpy(padded[rank * n_local : (rank + 1) * n_local]).to(dev)
            feats = sharded_log_mel(x_local, fcfg)  # (T, n_mels) on every rank
            lap("frontend")

            hop_frames = int(cfg.hop_seconds * fcfg.frames_per_second)
            win_frames = int(cfg.window_seconds * fcfg.frames_per_second)
            hop_s = hop_frames * fcfg.hop_length / fcfg.sample_rate
            win_s = win_frames * fcfg.hop_length / fcfg.sample_rate
            windows = frame_axis0(feats, win_frames, hop_frames)
            w = windows.shape[0]
            per = -(-w // world)  # windows a rank embeds (the last rank's tail is padding)
            lo, hi = min(rank * per, w), min((rank + 1) * per, w)
            emb = all_gather_rows(self._embed(windows, lo, hi, per))[:w]
            energy = windows.mean(dim=(1, 2))
            emb_np, energy_np = emb.cpu().numpy(), energy.cpu().numpy()
            lap("embed")

        # gate BEFORE clustering: non-speech must not vote in the affinity,
        # the eigensolve or the count
        keep = self._keep(wav, energy_np, w, win_s, hop_s)
        kept_idx = np.nonzero(keep)[0]
        wk = len(kept_idx)
        emb_kept = emb_np[kept_idx]
        # bucket the kept count as the JAX package does (its bound on
        # recompiles): pad rows repeat the first kept row, join its
        # cluster, and enter the percentile k and the Laplacian
        bucket = max(world * 8, 16)
        wb = -(-wk // bucket) * bucket
        emb_padded = np.repeat(emb_kept[:1], wb, axis=0)
        emb_padded[:wk] = emb_kept
        with stage("longform.cluster_program"):
            rows = wb // world
            block = torch.from_numpy(emb_padded[rank * rows : (rank + 1) * rows]).to(dev)
            lap_matrix = normalized_laplacian(sharded_affinity_rows(block))
            lap("affinity")

            k_eig = cfg.max_speakers + 1
            start = None
            if self.subspace_start is not None:
                start = self.subspace_start(wb, min(wb, k_eig + 8))
            _, eigvecs = topk_eigvecs_subspace(lap_matrix, k_eig, start=start)
            eigvecs = eigvecs[:wk]
            del lap_matrix
            lap("eigensolve")

            def unit_rows(x: torch.Tensor) -> torch.Tensor:
                return x / torch.clamp(torch.linalg.norm(x, dim=1, keepdim=True), min=1e-12)

            n_spk = cfg.n_speakers
            if n_spk is None:
                # over-cluster at the cap, merge same-speaker groups on the host
                kmax = min(cfg.max_speakers, wk)
                labels0 = kmeans(unit_rows(eigvecs[:, :kmax]), kmax).cpu().numpy()
                n_spk, _ = merge_count(emb_kept, labels0, cfg.merge_tau, rel=cfg.merge_rel)
            n_spk = max(1, min(n_spk, cfg.max_speakers))
            if n_spk == 1:
                labels = np.zeros(wk, dtype=np.int32)
            else:
                labels = kmeans(unit_rows(eigvecs[:, :n_spk]),
                                n_spk).cpu().numpy().astype(np.int32)
        if cfg.resegment and n_spk > 1:
            from ..cluster.resegment import resegment

            labels = resegment(emb_kept, labels, n_spk)

        starts = np.arange(w) * hop_s
        order: dict[str, str] = {}
        renamed: list[Segment] = []
        for s, e, lbl in labels_to_segments(labels, starts[kept_idx], win_s, prefix="S"):
            if lbl not in order:
                order[lbl] = f"S{len(order) + 1}"
            renamed.append((s, e, order[lbl]))
        # full-length label track: -1 marks windows the gate dropped
        full_labels = np.full(w, -1, dtype=np.int32)
        full_labels[kept_idx] = labels
        lap("labels")
        return {
            "segments": renamed,
            "n_speakers": int(n_spk),
            "window_labels": full_labels.tolist(),
            "window_starts": starts.tolist(),
            "windows_kept": int(wk),
            "mesh_devices": int(world),
            "timings": clock.laps,
        }
