"""Device selection for the port's entry points.

Entry points run on ``cuda`` unless the caller names another device.
Asking for CUDA on a machine without it raises: nothing falls back to
the CPU behind the caller's back.

:data:`DEVICE_ERRORS` are the failures that no caller may degrade
around: a kernel that did not build or launch, and torch's own CUDA
errors.  Code that keeps the JAX package's graceful degradation (the
assignment collectors, the batch orchestrator's steps) re-raises these
and degrades on everything else.
"""

from __future__ import annotations

import contextlib

import torch

from .build import KernelError

DEVICE_ERRORS: tuple[type[BaseException], ...] = (
    KernelError, torch.cuda.OutOfMemoryError,
    *((torch.AcceleratorError,) if hasattr(torch, "AcceleratorError") else ()))


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the port on the CPU"
        )
    return dev


@contextlib.contextmanager
def full_f32():
    """float32 convolutions and products in full float32 on the card: TF32
    off inside (cuDNN's is on by default), the caller's setting restored
    after."""
    flags = torch.backends.cudnn, torch.backends.cuda.matmul
    before = [f.allow_tf32 for f in flags]
    for f in flags:
        f.allow_tf32 = False
    try:
        yield
    finally:
        for f, v in zip(flags, before):
            f.allow_tf32 = v
