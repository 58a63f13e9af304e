"""Full train-state checkpoints for crash resume.

The JAX package saves its train state with orbax; the port saves its own
payload — ``torch.save`` of the step, the tower's state dict, the AAM
head and the optimizer's state — so the two packages' crash-resume
directories are not interchangeable (their inference files are, see
``utils/checkpoint.py:write_msgpack``).  The layout and the "latest"
rule are JAX's: one ``step_XXXXXXXX`` directory per checkpoint, and the
last such directory in sorted order is the latest.  A checkpoint is
written into a temporary directory and renamed into place, so a crash
never leaves a half-written ``step_*``.  A checkpoint holds the whole
state (``parallel/train.py:full_state`` gathers what a mesh splits), so
it restores into a whole state at any mesh shape, which ``shard_state``
then splits.
"""

from __future__ import annotations

import io
import os
import shutil
import tempfile
from pathlib import Path

import torch

from .multihost import rank_and_world
from .train import TrainState, full_state

STATE_FILE = "train_state.pt"


def save_train_state(ckpt_dir: str | Path, state: TrainState, step: int | None = None) -> Path:
    """Every rank calls it (a sharded state is gathered); rank 0 writes.
    Returns the checkpoint's directory."""
    ckpt_dir = Path(ckpt_dir).resolve()
    step = int(state.step if step is None else step)
    path = ckpt_dir / f"step_{step:08d}"
    payload = full_state(state)
    if rank_and_world()[0] != 0:
        return path
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    payload["model"] = {k: v.cpu() for k, v in payload["model"].items()}
    payload["aam_weights"] = payload["aam_weights"].cpu()
    buf = io.BytesIO()
    torch.save(payload, buf)
    tmp = Path(tempfile.mkdtemp(dir=ckpt_dir, prefix=f".{path.name}.", suffix=".tmp"))
    try:
        (tmp / STATE_FILE).write_bytes(buf.getvalue())
        if path.exists():  # a rerun of the same step overwrites, as orbax's force=True
            shutil.rmtree(path)
        os.replace(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return path


def latest_checkpoint(ckpt_dir: str | Path) -> Path | None:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = sorted(p for p in ckpt_dir.glob("step_*") if p.is_dir())
    return steps[-1] if steps else None


def restore_train_state(ckpt_path: str | Path, state: TrainState) -> TrainState:
    """Load a checkpoint into a whole ``state`` (from
    ``create_train_state``, same tower and class count, not yet sharded)
    in place, and return it."""
    device = state.aam_weights.device
    payload = torch.load(Path(ckpt_path) / STATE_FILE, map_location=device, weights_only=True)
    state.model.load_state_dict(payload["model"])
    with torch.no_grad():
        state.aam_weights.copy_(payload["aam_weights"])
    state.optimizer.load_state_dict(payload["optimizer"])
    state.step = int(payload["step"])
    return state
