"""The on-device embedding backend: log-mel kernel + a speaker tower on the GPU.

The counterpart of ``sdtk_tpu/backends/tpu.py``.  Audio windows are
batched on the host, then featurized by the fused log-mel kernel
(``ops/fbank_wave.py``), embedded by the tower and L2-normalized on the
device.  The tower is ``ecapa`` (ECAPA-TDNN) or ``xvector``, chosen by
the ``model`` argument, else ``$SDTK_BACKEND_TOWER`` (default ``ecapa``).
The checkpoint search and its sidecars are the JAX package's:

- checkpoint: ``$SDTK_MODEL_PATH``, then ``model_dir()/<slug>.msgpack``
  (``ecapatdnn`` or ``xvector``), then the bundled one:
  ``models/ecapatdnn-fam5tel.msgpack`` for ECAPA at 512 channels, else
  ``models/<slug>.msgpack``;
- ``<ckpt>.config.json``: ``{"model": {EcapaConfig overrides},
  "frontend": {FrontendConfig overrides}, "input_norm": {"mean", "std"}}``
  (the x-vector, as in the JAX package, takes no ``model`` overrides);
- ``<ckpt>.calib.json``: score calibration (affine into the 0.354
  threshold space); its ``suggested_merge_tau`` is the diarizer's merge
  bar;
- ``<ckpt>.cohort.npy``: the AS-norm cohort for identify/verify scoring.

Float32 convolutions run in full float32: the engine turns off cuDNN's
TF32 (``torch.backends.cudnn.allow_tf32``, on by default), as the JAX
reference computes them; the bf16 serving path is unaffected.
"""

from __future__ import annotations

import json
import os
import sys
from pathlib import Path

import numpy as np
import torch

from .. import config
from ..models.ecapa import EcapaConfig, EcapaTdnn, l2_normalize
from ..models.xvector import XVector, XVectorConfig
from ..ops.fbank import FrontendConfig
from ..ops.fbank_wave import log_mel_wave
from ..utils.checkpoint import ecapa_state_dict, read_msgpack, xvector_state_dict
from ..utils.device import resolve_device
from .base import LocalEmbeddingBackend

WINDOW_SECONDS = 3.0
HOP_SECONDS = 1.5
# tower name → checkpoint file stem
CKPT_SLUG = {"ecapa": "ecapatdnn", "xvector": "xvector"}


class GpuBackend(LocalEmbeddingBackend):
    def __init__(
        self,
        model: str | None = None,
        channels: int = 512,
        max_windows: int = 16,
        params_path: str | Path | None = None,
        seed: int = 0,
        device: str | torch.device | None = None,
    ):
        model = model or os.environ.get("SDTK_BACKEND_TOWER", "ecapa")
        if model == "conformer":
            raise NotImplementedError(
                "tower 'conformer' is not ported yet (ROADMAP M14); use ecapa or xvector")
        if model not in CKPT_SLUG:
            raise ValueError(f"unknown model '{model}' (ecapa | xvector)")
        self.device = resolve_device(device)
        self._args = (model, channels, max_windows, params_path, seed)
        self._engine = None

    @property
    def name(self) -> str:
        return "gpu"

    @property
    def engine(self) -> "EmbedEngine":
        if self._engine is None:
            self._engine = EmbedEngine(*self._args, device=self.device)
        return self._engine

    @property
    def cluster_merge_tau(self) -> float:
        """The checkpoint's measured merge bar (calibration sidecar), else
        the class default."""
        calib = self.engine.calibration
        if calib and "suggested_merge_tau" in calib:
            return float(calib["suggested_merge_tau"])
        return LocalEmbeddingBackend.cluster_merge_tau

    @property
    def raw_decision_threshold(self) -> float | None:
        """Same/different-speaker boundary in raw cosine space from the
        calibration sidecar (``raw_eer_threshold``, else a raw-space
        ``eer_threshold``)."""
        calib = self.engine.calibration
        if calib and "raw_eer_threshold" in calib:
            return float(calib["raw_eer_threshold"])
        if calib and "eer_threshold" in calib and calib.get("score_space", "raw") == "raw":
            return float(calib["eer_threshold"])
        return None

    @property
    def cohort(self) -> np.ndarray | None:
        """AS-norm cohort from the checkpoint's ``.cohort.npy`` sidecar."""
        return self.engine.cohort

    @property
    def embedding_dim(self) -> int:
        return self.engine.emb_dim

    @property
    def model_version(self) -> str:
        """The JAX TpuBackend's format, so records of either compare."""
        model, channels = self._args[:2]
        return f"{model}-c{channels}-v1"

    def calibrate_score(self, sims: np.ndarray) -> np.ndarray:
        """Affine calibration from the ``.calib.json`` sidecar: the raw EER
        threshold maps onto 0.354, clipped to [0, 1]; identity without a
        sidecar."""
        calib = self.engine.calibration
        if calib is None:
            return sims
        mapped = 0.354 + (np.asarray(sims) - calib["eer_threshold"]) * calib["gain"]
        return np.clip(mapped, 0.0, 1.0)

    def embed_waveform(self, wav: np.ndarray) -> np.ndarray:
        return self.engine.embed_one(wav)

    def embed_windows(self, wav: np.ndarray, window_s: float = WINDOW_SECONDS,
                      hop_s: float = HOP_SECONDS) -> np.ndarray:
        """Embeddings of every 3 s window (1.5 s hop) of the recording, in
        ``max_windows``-sized device batches."""
        return self.engine.embed_all_windows(np.asarray(wav, np.float32))

    def embed_batch(self, wavs: list[np.ndarray]) -> np.ndarray:
        """Many waveforms → (N, D).  Same-length waveforms of at most one
        window go through ``engine.embed_rows`` as batched rows; longer or
        ragged input is pooled per utterance (``embed_one``)."""
        eng = self.engine
        if not wavs:
            return np.zeros((0, eng.emb_dim), np.float32)
        n0 = len(wavs[0])
        if n0 <= eng.window_len and all(len(w) == n0 for w in wavs):
            return eng.embed_rows(np.stack([np.asarray(w, np.float32) for w in wavs]))
        return np.stack([eng.embed_one(np.asarray(w, np.float32)) for w in wavs])


class EmbedEngine:
    """Owns the tower's weights on the device and the embed call."""

    def __init__(self, model_name: str, channels: int, max_windows: int,
                 params_path, seed: int, device: torch.device):
        self.device = device
        self._model_name = model_name
        self._channels = channels
        self._ckpt_path = self._resolve_checkpoint(params_path)
        sidecar = self._load_config_sidecar(self._ckpt_path)

        self.cfg = FrontendConfig(**sidecar.get("frontend", {}))
        norm = sidecar.get("input_norm")
        self._input_norm = (
            (torch.tensor(np.asarray(norm["mean"], np.float32), device=device),
             torch.tensor(np.maximum(np.asarray(norm.get("std", 1.0), np.float32), 1e-8),
                          device=device))
            if norm else None
        )
        self.window_len = int(WINDOW_SECONDS * self.cfg.sample_rate)
        self.hop_len = int(HOP_SECONDS * self.cfg.sample_rate)
        self.max_windows = max_windows

        if model_name == "xvector":  # the JAX engine applies no sidecar "model" here
            self.model = XVector(XVectorConfig(channels=channels))
            to_state_dict = xvector_state_dict
        else:
            model_over = dict(sidecar.get("model", {}))
            if "dilations" in model_over:
                model_over["dilations"] = tuple(model_over["dilations"])
            self.model = EcapaTdnn(EcapaConfig(**({"channels": channels} | model_over)))
            to_state_dict = ecapa_state_dict
        self.emb_dim = self.model.cfg.emb_dim
        if self._ckpt_path is not None:
            self.model.load_state_dict(to_state_dict(read_msgpack(self._ckpt_path)))
            self.params_source = str(self._ckpt_path)
        else:
            self.model.reset_parameters(torch.Generator().manual_seed(seed))
            self.params_source = "random-init"
            print(f"Warning: no trained checkpoint found (searched: "
                  f"{', '.join(str(p) for p in self._searched)}); using RANDOM weights.",
                  file=sys.stderr)
        self.model.to(device).eval()
        if device.type == "cuda":
            torch.backends.cudnn.allow_tf32 = False
        self.calibration = self._load_calibration()
        self.cohort = self._load_cohort()

    def _resolve_checkpoint(self, params_path) -> Path | None:
        if params_path:
            candidates = [Path(params_path)]
        else:
            name = f"{CKPT_SLUG[self._model_name]}.msgpack"
            bundled = ("ecapatdnn-fam5tel.msgpack"
                       if self._model_name == "ecapa" and self._channels == 512 else name)
            override = config.model_path_override()
            candidates = ([override] if override else []) + [
                config.model_dir() / name, config.repo_models_dir() / bundled]
        self._searched = candidates
        return next((p for p in candidates if p.exists()), None)

    @staticmethod
    def _read_json_sidecar(path: Path, what: str) -> dict | None:
        if not path.exists():
            return None
        try:
            data = json.loads(path.read_text())
            if not isinstance(data, dict):
                raise ValueError("not a JSON object")
            return data
        except (ValueError, OSError) as e:
            print(f"Warning: ignoring malformed {what} sidecar {path}: {e}", file=sys.stderr)
            return None

    def _load_config_sidecar(self, ckpt_path) -> dict:
        if ckpt_path is None:
            return {}
        return self._read_json_sidecar(Path(ckpt_path).with_suffix(".config.json"),
                                       "config") or {}

    def _load_calibration(self) -> dict | None:
        if self._ckpt_path is None:
            return None
        calib = self._read_json_sidecar(self._ckpt_path.with_suffix(".calib.json"),
                                        "calibration")
        try:
            if calib is not None:
                float(calib["eer_threshold"]), float(calib["gain"])
            return calib
        except (KeyError, TypeError, ValueError) as e:
            print(f"Warning: ignoring malformed calibration sidecar: {e}", file=sys.stderr)
            return None

    def _load_cohort(self) -> np.ndarray | None:
        """``<checkpoint>.cohort.npy``: (C, D) unit embeddings for AS-norm."""
        if self._ckpt_path is None:
            return None
        path = self._ckpt_path.with_suffix(".cohort.npy")
        if not path.exists():
            return None
        try:
            cohort = np.load(path)
            if cohort.ndim != 2 or cohort.shape[1] != self.emb_dim:
                raise ValueError(f"bad cohort shape {cohort.shape}")
            return np.asarray(cohort, np.float32)
        except (ValueError, OSError) as e:
            print(f"Warning: ignoring malformed cohort sidecar {path}: {e}", file=sys.stderr)
            return None

    @torch.inference_mode()
    def embed(self, windows, lengths) -> torch.Tensor:
        """(W, L) windows + (W,) valid sample counts (numpy or tensors) →
        (W, emb_dim) float32 unit rows on the engine's device."""
        x = torch.as_tensor(windows, dtype=torch.float32).to(self.device, non_blocking=True)
        lens = torch.as_tensor(lengths, dtype=torch.int64).to(self.device)
        feats, mask = log_mel_wave(x, self.cfg, lengths=lens)
        if self._input_norm is not None:
            feats = (feats - self._input_norm[0]) / self._input_norm[1]
        return l2_normalize(self.model(feats, mask))

    def _window_all(self, wav: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Cut the whole recording into fixed windows: (n, L) and (n,)
        valid lengths (at least one frame)."""
        L, hop = self.window_len, self.hop_len
        n = len(wav)
        n_win = 1 if n <= L else 1 + (n - L + hop - 1) // hop
        windows = np.zeros((n_win, L), dtype=np.float32)
        lengths = np.zeros(n_win, dtype=np.int32)
        for i in range(n_win):
            chunk = wav[i * hop : i * hop + L]
            windows[i, : len(chunk)] = chunk
            lengths[i] = max(len(chunk), self.cfg.win_length)
        return windows, lengths

    def embed_all_windows(self, wav: np.ndarray) -> np.ndarray:
        """Every window of a recording, in ``max_windows``-sized batches
        (the tail padded with length-0 rows) → (n, D) unit rows."""
        all_w, all_l = self._window_all(np.asarray(wav, dtype=np.float32))
        W = self.max_windows
        out = []
        for start in range(0, all_w.shape[0], W):
            w = np.zeros((W, all_w.shape[1]), np.float32)
            lens = np.zeros(W, np.int32)
            n = min(W, all_w.shape[0] - start)
            w[:n], lens[:n] = all_w[start : start + n], all_l[start : start + n]
            out.append(self.embed(w, lens)[:n].cpu().numpy())
        return np.concatenate(out, axis=0)

    def embed_one(self, wav: np.ndarray) -> np.ndarray:
        pooled = self.embed_all_windows(wav).mean(axis=0)
        return (pooled / max(np.linalg.norm(pooled), 1e-12)).astype(np.float32)

    def embed_rows(self, rows: np.ndarray, lengths: np.ndarray | None = None) -> np.ndarray:
        """(N, n) same-length rows of n ≤ window_len samples → (N, D) unit
        rows.

        Rows are zero-padded to L = window_len / 2 samples when they fit in
        it, else to window_len: the JAX engine's length buckets, which fix
        the frame count and so the result.  The JAX engine also pads the
        row count up to a bucket W ∈ {1, 4, 16}, for XLA's static shapes
        and the cost of its host transfer.  Here the kernel and the tower
        take any row count without a new compile, so the rows go in calls
        of up to ``max_windows`` rows with no pad rows, which would cost a
        whole window of device work each."""
        n_rows, n = rows.shape
        if n_rows == 0:
            return np.zeros((0, self.emb_dim), np.float32)
        half = self.window_len // 2
        padded = np.zeros((n_rows, half if n <= half else self.window_len), np.float32)
        padded[:, :n] = rows
        if lengths is None:
            lengths = np.full(n_rows, max(n, self.cfg.win_length), np.int32)
        W = self.max_windows
        return np.concatenate([self.embed(padded[i : i + W], lengths[i : i + W]).cpu().numpy()
                               for i in range(0, n_rows, W)])
