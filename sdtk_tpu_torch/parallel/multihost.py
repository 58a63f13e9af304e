"""Multi-process runtime: the process group, one device per rank, and the
host-sharded batch runner.

The counterpart of ``sdtk_tpu/parallel/multihost.py``.  The JAX package
joins ``jax.distributed`` and lets its mesh span every device; the port
runs one process (rank) per device and joins a ``torch.distributed``
process group: NCCL when the ranks drive CUDA devices, gloo on the CPU.

:func:`initialize` takes the coordinator from its arguments, else from
``SDTK_COORDINATOR`` / ``SDTK_NUM_PROCESSES`` / ``SDTK_PROCESS_ID`` (the
JAX package's variables), else from torchrun's ``MASTER_ADDR`` /
``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK``.  Without any of them it is a
no-op: world size 1, rank 0, and no group is created.  The collectives
below run through the group when one exists (a group of one rank too, so
their code runs), and are identities without one.
"""

from __future__ import annotations

import hashlib
import os
from pathlib import Path
from typing import Any

import torch
import torch.distributed as dist

from ..utils.device import resolve_device

_owned = False  # this module created the process group


def _coordinator(address: str | None) -> str | None:
    if address:
        return address
    if os.environ.get("SDTK_COORDINATOR"):
        return os.environ["SDTK_COORDINATOR"]
    if os.environ.get("MASTER_ADDR") and os.environ.get("WORLD_SIZE"):
        return f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
    return None


def _env_int(*names: str, default: int) -> int:
    for name in names:
        if os.environ.get(name):
            return int(os.environ[name])
    return default


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device: str | torch.device | None = None,
) -> dict[str, int]:
    """Join the process group (once per process) and return the JAX
    package's counts: ``process_index``, ``process_count``,
    ``local_devices`` (1: a rank drives one device) and
    ``global_devices``.  ``coordinator_address`` is ``host:port`` (as for
    ``jax.distributed``) or an ``init_method`` URL (``tcp://``,
    ``file://``).  ``device`` picks the backend: NCCL for CUDA (the
    default, which must then be available), gloo for the CPU; a CUDA rank
    makes :func:`rank_device` its current device."""
    global _owned
    address = _coordinator(coordinator_address)
    if address and not dist.is_initialized():
        n = num_processes or _env_int("SDTK_NUM_PROCESSES", "WORLD_SIZE", default=1)
        pid = process_id if process_id is not None else _env_int(
            "SDTK_PROCESS_ID", "RANK", default=0)
        kind = resolve_device(device).type
        if kind == "cuda":
            torch.cuda.set_device(rank_device(device, rank=pid))
        init_method = address if "://" in address else f"tcp://{address}"
        dist.init_process_group("nccl" if kind == "cuda" else "gloo", init_method=init_method,
                                world_size=int(n), rank=int(pid))
        _owned = True
    rank, world = rank_and_world()
    return {"process_index": rank, "process_count": world, "local_devices": 1,
            "global_devices": world}


def shutdown() -> None:
    """Leave the process group that :func:`initialize` created, if it
    created one (a caller's own group stays)."""
    global _owned
    if _owned and dist.is_initialized():
        dist.destroy_process_group()
    _owned = False


def rank_and_world() -> tuple[int, int]:
    """(rank, world size) in the process group; (0, 1) when no group
    exists."""
    if not (dist.is_available() and dist.is_initialized()):
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def in_group() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank_device(device: str | torch.device | None = None, rank: int | None = None
                ) -> torch.device:
    """The device this rank drives: for CUDA, ``cuda:$LOCAL_RANK`` (else
    the rank modulo the visible devices) unless ``device`` names an index;
    any other device as it is."""
    dev = resolve_device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    if rank is None:
        rank = rank_and_world()[0]
    local = _env_int("LOCAL_RANK", default=rank % max(torch.cuda.device_count(), 1))
    return torch.device("cuda", local)


def all_gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` (same shape on every rank) concatenated along
    dim 0 in rank order; ``x`` itself without a group."""
    if not in_group():
        return x
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, x.contiguous())
    return torch.cat(parts, dim=0)


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of every rank's ``x`` (a new tensor; no autograd); ``x``
    without a group."""
    if not in_group():
        return x
    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM)
    return out


def all_reduce_max(x: torch.Tensor) -> torch.Tensor:
    """The elementwise maximum of every rank's ``x`` (a new tensor; no
    autograd); ``x`` without a group."""
    if not in_group():
        return x
    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX)
    return out


def ring_shift(x: torch.Tensor, shift: int = 1) -> torch.Tensor:
    """``x`` sent to rank + ``shift`` and received from rank − ``shift``
    (modulo the world size), the JAX package's ``ppermute`` over a ring:
    the send and the receive are posted together in one
    ``batch_isend_irecv``, so no rank blocks in a send that its neighbour
    has not met with a receive.  ``x`` itself without a group or in a group
    of one rank (a rank cannot send to itself)."""
    rank, world = rank_and_world()
    if world == 1:
        return x
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, (rank + shift) % world),
           dist.P2POp(dist.irecv, out, (rank - shift) % world)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def host_work_shard(paths: list[Path | str], process_index: int | None = None,
                    process_count: int | None = None) -> list[Path]:
    """This process's share of the recording list: the first four bytes of
    the path's MD5, little-endian, modulo the process count, as the JAX
    package splits it, so processes of either package agree on the
    shard.  Stable across restarts."""
    rank, world = rank_and_world()
    pid = rank if process_index is None else process_index
    n = world if process_count is None else process_count
    out = []
    for p in paths:
        h = int.from_bytes(hashlib.md5(str(p).encode()).digest()[:4], "little")
        if h % n == pid:
            out.append(Path(p))
    return out


def process_corpus(
    directory: str | Path,
    parallel: int = 4,
    backends: list[str] | None = None,
    **kwargs: Any,
) -> dict[str, Any]:
    """Multi-process batch runner: each process queues its shard of the
    corpus (:func:`host_work_shard`) and runs the port's batch pipeline on
    it (``pipeline/process.py:process_batch``; ``kwargs`` go there)."""
    from ..pipeline.process import find_audio_files, process_batch
    from ..store.queue import ProcessingQueue

    paths = find_audio_files(directory, recursive=True)
    mine = host_work_shard(paths)
    queue = ProcessingQueue()
    items = [it for p in mine if (it := queue.add(p, backends=backends))]
    results = process_batch(items, queue=queue, parallel=parallel, **kwargs)
    return {
        "completed": sum(1 for r in results if r.success),
        "failed": sum(1 for r in results if not r.success),
        "host_shard": len(mine),
        "corpus_total": len(paths),
    }
