"""What every loop shares: the run's settings, the trace of a window, the
plain reference's embeddings, and the result a loop hands back."""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from benchlib import trace as tracelib
from reference import ecapa as ref_ecapa
from reference import frontend as ref_frontend
from reference.precision import PRECISIONS

SR = 16000


@dataclass
class Run:
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    config: dict
    traffic: dict
    root: Path
    t_start: float
    mode: str = "program"  # "program", or "control": the fp8 reference in its place


@dataclass
class Outcome:
    setup_s: float
    attempted: int
    failed: int
    end_to_end: dict[str, float]
    memory_peak_bytes: int
    numbers: dict[str, float]
    trace: tracelib.Trace | None = None
    work: dict = field(default_factory=dict)  # what the metric readers count with


def step_seed(seed: int, step: int) -> int:
    """A 64-bit generator seed for step ``step`` of run ``seed``."""
    return int(np.random.SeedSequence([seed & (2**63 - 1), step & (2**63 - 1)])
               .generate_state(1, np.uint64)[0])


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def span(name: str):
    """A benchmark span: a profiler range ``bench.<name>`` (nothing is
    recorded while no profiler runs)."""
    return torch.profiler.record_function(f"bench.{name}")


@contextlib.contextmanager
def traced(device: torch.device, holder: dict):
    """Profile the block as the traced window (ended by a synchronize);
    ``holder["trace"]`` receives the parsed trace."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    sync(device)
    with profile(activities=acts) as prof:
        with span("window"):
            yield
            sync(device)
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        holder["trace"] = tracelib.load(path)


@contextlib.contextmanager
def full_f32():
    """float32 products in float32 (TF32 off) inside, restored after."""
    flags = torch.backends.cuda.matmul, torch.backends.cudnn
    before = [f.allow_tf32 for f in flags]
    for f in flags:
        f.allow_tf32 = False
    try:
        yield
    finally:
        for f, v in zip(flags, before):
            f.allow_tf32 = v


class Reference:
    """The plain tower and frontend of a configuration, float32 or (for the
    control) fp8; embeds clips by groups of equal valid length."""

    def __init__(self, cfg: dict, tree: dict, device, precision: str = "float32",
                 block: int = 128):
        self.quant = PRECISIONS[precision]
        self.fe = cfg["frontend"]
        self.tower = ref_ecapa.Ecapa(tree, cfg["model"], device, self.quant)
        self.device = device
        self.block = block

    def embed(self, x: torch.Tensor, lengths) -> np.ndarray:
        """(B, L) clips and (B,) valid lengths → (B, D) float32 unit rows."""
        lengths = np.asarray(torch.as_tensor(lengths).cpu()).astype(np.int64)
        out = None
        with torch.no_grad(), full_f32():
            for length in np.unique(lengths):
                rows = np.flatnonzero(lengths == length)
                for i in range(0, len(rows), self.block):
                    idx = torch.as_tensor(rows[i : i + self.block], device=x.device)
                    clip = x.index_select(0, idx)[:, : int(length)].to(self.device)
                    e = self.tower(ref_frontend.log_mel(clip, self.fe, self.quant)).cpu().numpy()
                    if out is None:
                        out = np.zeros((len(lengths), e.shape[1]), np.float32)
                    out[rows[i : i + self.block]] = e
        return out


def reference(r: Run, precision: str = "float32") -> Reference:
    """The plain reference of the run's configuration, from the raw weight
    file the program reads (never from what the program derived)."""
    from benchlib import weights
    from reference import flaxio

    return Reference(r.config, flaxio.read(weights.weights_file(r.config, r.root, r.device)),
                     r.device, precision)


def device_info(device: torch.device, chips: int, memory_peak: int) -> dict:
    info = {"platform": "gpu" if device.type == "cuda" else device.type,
            "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
            "count": chips, "memory_peak_bytes": int(memory_peak)}
    if device.type == "cuda":
        import subprocess

        try:
            info["nvidia_smi"] = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                 "-i", str(device.index or 0)], capture_output=True, text=True,
                timeout=30).stdout.strip()
        except (OSError, subprocess.SubprocessError):
            pass
    return info


def config_mismatch(cfg: dict, engine) -> list[str]:
    """Where the program's engine departs from the configuration: the
    tower's sizes, its dtype, the frontend."""
    m = engine.model.cfg
    bad = [k for k, v in cfg["model"].items()
           if (list(getattr(m, k)) if k == "dilations" else getattr(m, k)) != v]
    fe = engine.cfg
    bad += [f"frontend.{k}" for k, v in cfg["frontend"].items() if getattr(fe, k) != v]
    return bad


def now() -> float:
    return time.perf_counter()


def set_model_path(path: Path) -> None:
    """Serve ``path`` through the program's own checkpoint search
    (``$SDTK_MODEL_PATH``, searched first), with its sidecars."""
    os.environ["SDTK_MODEL_PATH"] = str(path)
