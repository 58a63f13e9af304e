"""Mesh specs (a copy of ``sdtk_tpu/parallel/mesh.py:parse_mesh_spec``).

A spec such as ``"data=8"`` or ``"data=4,model=2"`` names the size of
each mesh axis: ``data`` splits the batch, ``model`` the tower's
channels.  The port parses the trainer's ``--mesh`` flag as the JAX
package does; ``data=N`` trains over a process group of N ranks
(``training.py:data_parallel_ranks``), ``model`` is not ported.
"""

from __future__ import annotations

AXES = ("data", "model")


def parse_mesh_spec(spec: str) -> dict[str, int]:
    out: dict[str, int] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, _, val = part.partition("=")
        name = name.strip()
        if name not in AXES:
            raise ValueError(f"unknown mesh axis '{name}' (expected {AXES})")
        out[name] = int(val)
    return out
