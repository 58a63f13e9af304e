"""Timing helpers shared by the bench tools: the card's name from
``nvidia-smi``, device time by kernel (``torch.profiler``), CUDA-event time,
the host time of a call, a kernel library built with an extra ``-D`` flag,
and a tool run once per checkout in fresh processes."""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time


def smi(query: str) -> str:
    """``nvidia-smi --query-gpu=<query> --format=csv,noheader`` for the first card."""
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


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
