"""Distribution layer: meshes over the process group, sharding rules,
multi-rank programs (the counterpart of ``sdtk_tpu/parallel``)."""

from .mesh import make_mesh, mesh_axes, parse_mesh_spec
from .sharding import batch_sharding, ecapa_param_spec, replicate, shard_params

__all__ = [
    "make_mesh",
    "mesh_axes",
    "parse_mesh_spec",
    "batch_sharding",
    "ecapa_param_spec",
    "replicate",
    "shard_params",
]
