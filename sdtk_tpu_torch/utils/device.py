"""Device selection for the port's entry points.

Entry points run on ``cuda`` unless the caller names another device.
Asking for CUDA on a machine without it raises: nothing falls back to
the CPU behind the caller's back.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the port on the CPU"
        )
    return dev
