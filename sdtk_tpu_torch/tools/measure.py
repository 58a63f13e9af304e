"""Timing helpers shared by the bench tools: the card's name from
``nvidia-smi``, device time by kernel (``torch.profiler``), CUDA-event time,
the host time of a call, a kernel library built with an extra ``-D`` flag,
a tool run once per checkout in fresh processes, the card's least time for
some bytes and operations, every kernel wrapper (for its launch count);
and two small helpers of the multi-rank tools: a free TCP port and the
cosine of two tensors."""

from __future__ import annotations

import contextlib
import json
import os
import socket
import statistics
import subprocess
import sys
import time

# H100 SXM data-sheet peaks (dense): bf16 tensor cores, f32 CUDA cores, HBM3.
# "tf32x3" is f32-accurate work at the card's fastest route for it: three
# TF32 tensor-core products (3xTF32) per f32 product, 495 / 3 TFLOP/s.
# "tf32x2" is the same with one operand exact in TF32 (bf16 values, say):
# two products, 495 / 2 TFLOP/s.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "tf32x3": 495e12 / 3,
              "tf32x2": 495e12 / 2}
PEAK_BYTES = 3.35e12


def bound(nbytes: float, flops: float, dtype: str = "float32") -> dict:
    """The least time the card could take: bytes over HBM rate against
    operations over the peak rate of ``dtype``, whichever is larger."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes > t_ops else "operations",
            "bytes": nbytes, "flops": flops}


def smi(query: str, index: int | None = None) -> str:
    """``nvidia-smi --query-gpu=<query> --format=csv,noheader`` for the card
    ``index`` (``-i``; the first card when None)."""
    cmd = ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"]
    if index is not None:
        cmd += ["-i", str(index)]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def kernel_wrappers() -> dict:
    """Every kernel wrapper, by kernel name (each counts its launches in
    ``.launches``)."""
    from ..ops import cosine, fbank_frames, fbank_wave, topk_fused, tower_epilogue

    return {"log_mel_wave": fbank_wave.log_mel_wave, "cosine": cosine.cosine,
            "identify_topk": topk_fused.identify_topk_fused,
            "fbank_frames": fbank_frames.fbank_frames,
            "tower_epilogue": tower_epilogue.tower_epilogue}


def free_port() -> int:
    """A free TCP port on this machine, for a process group's rendezvous."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def cos(a, b) -> float:
    """Cosine of two tensors of any shape, flattened, in float64 on the host."""
    import torch

    a, b = a.detach().double().flatten().cpu(), b.detach().double().flatten().cpu()
    return float(torch.nn.functional.cosine_similarity(a, b, dim=0))


def device_ms_by_kernel(fn, reps: int = 20) -> dict[str, float]:
    """Mean device ms per call of ``fn``, by CUDA kernel name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key: float(getattr(e, "self_device_time_total", 0.0)
                         or getattr(e, "self_cuda_time_total", 0.0)) / reps / 1e3
            for e in prof.key_averages() if str(e.device_type).endswith("CUDA")}


def device_ms_total(fn, reps: int = 20, traces: int = 2, kernel: str = ""):
    """Device ms per call of ``fn`` summed over its kernels whose name holds
    ``kernel`` ("": every kernel and copy): the larger of ``traces`` traces
    (a trace can drop kernels), or "not measured" where none showed
    device time."""
    best = max(sum(ms for name, ms in device_ms_by_kernel(fn, reps).items() if kernel in name)
               for _ in range(traces))
    return best if best > 0 else "not measured"


def event_ms(fn, reps: int = 30, warmup: int = 5) -> float:
    """Median ms between CUDA events recorded around each call of ``fn``:
    the device's time, or the host's where the host issues more slowly."""
    import torch

    for _ in range(warmup):
        fn()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(reps)]
    for a, b in events:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in events)


def host_ms(fn, reps: int = 50, warmup: int = 5) -> float:
    """Median host ms of a call of ``fn``, from its start to its return,
    the card left to drain between calls so that no launch waits for room."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return statistics.median(times) * 1e3


@contextlib.contextmanager
def built_with(flag: str):
    """Kernel libraries loaded inside the block are built with ``flag``
    added to the nvcc flags (another hash, so another library file)."""
    from ..utils import build

    flags = build.NVCC_FLAGS
    build.NVCC_FLAGS = (*flags, flag)
    build._loaded.clear()
    try:
        yield
    finally:
        build.NVCC_FLAGS = flags
        build._loaded.clear()


def run_per_tree(module: str, trees: list[str], args: list[str]) -> int:
    """``python -m module *args`` once per checkout in ``trees``, in the
    order given, each in a fresh process with the checkout as its working
    directory and import path (device times read in a process that has
    loaded several builds of one kernel drift).  Returns the OR of the
    exit codes."""
    rc, card = 0, smi("name,power.limit")
    for tree in trees:
        print(json.dumps({"nvidia_smi": card, "tree": tree}), flush=True)
        env = {**os.environ, "PYTHONPATH": os.path.abspath(tree)}
        rc |= subprocess.run([sys.executable, "-m", module, *args], cwd=tree, env=env).returncode
    return rc
