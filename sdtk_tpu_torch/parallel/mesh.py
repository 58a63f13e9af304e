"""Device meshes over the process group (the counterpart of
``sdtk_tpu/parallel/mesh.py``).

Mesh axes:
- ``data``  — batch rows (data parallel);
- ``model`` — the tower's channels (tensor parallel,
  ``parallel/sharding.py``).

A spec such as ``"data=8"`` or ``"data=4,model=2"`` names the size of
each axis; ``data`` is inferred when the spec leaves it out, and an empty
spec puts every rank on ``data`` (``$SDTK_DEVICE_MESH`` when no spec is
given).  The port runs one rank per device, so the mesh is laid over the
process group's ranks as JAX lays it over devices,
``np.asarray(devices).reshape(data, model)``: rank r sits at
(r // model, r % model).  :func:`make_mesh` creates the two kinds of
sub-group: the ``model`` ranks of one data row, and the ``data`` ranks
of one model column.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from .. import config

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


def mesh_sizes(spec: str, n: int) -> tuple[int, int]:
    """(data, model) of ``spec`` over ``n`` ranks, with JAX's ``make_mesh``
    inference and errors."""
    sizes = parse_mesh_spec(spec)
    data = sizes.get("data", 0)
    model = sizes.get("model", 1)
    if data == 0:
        if n % model:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    return data, model


@dataclass(frozen=True)
class Mesh:
    """A (data, model) grid of ranks and this rank's place in it.

    ``data_group`` holds the ranks of this rank's model column (they split
    the batch), ``model_group`` those of its data row (they split the
    channels); ``None`` means the default group, or no group at all when
    the process has none.  A mesh built by hand (``Mesh(2, 2, rank=3)``)
    has no sub-groups: enough for shapes and slices, not for a step."""

    data: int = 1
    model: int = 1
    rank: int = 0
    data_group: Any = None
    model_group: Any = None

    @property
    def shape(self) -> dict[str, int]:
        return {"data": self.data, "model": self.model}

    @property
    def coords(self) -> dict[str, int]:
        """This rank's index along each axis."""
        return {"data": self.rank // self.model, "model": self.rank % self.model}


def make_mesh(spec: str | None = None) -> Mesh:
    """The mesh of ``spec`` (default ``$SDTK_DEVICE_MESH``) over the process
    group's ranks; one rank without a group.  Every rank of the group must
    call it, in the same order, since it creates the sub-groups."""
    import torch.distributed as dist

    from .multihost import rank_and_world

    rank, world = rank_and_world()
    data, model = mesh_sizes(config.mesh_spec() if spec is None else spec, world)
    if model == 1:  # every rank on data: the default group is the data group
        return Mesh(data, 1, rank)
    groups = {}
    for d in range(data):
        groups["model", d] = dist.new_group([d * model + m for m in range(model)])
    for m in range(model):
        groups["data", m] = dist.new_group([d * model + m for d in range(data)])
    return Mesh(data, model, rank, data_group=groups["data", rank % model],
                model_group=groups["model", rank // model])


def mesh_axes(mesh: Mesh) -> dict[str, int]:
    return dict(mesh.shape)
