"""Sharding rules and the tensor-parallel collectives (the counterpart of
``sdtk_tpu/parallel/sharding.py``).

The rules are the JAX package's, regex for regex: conv kernels are split
on their output channels and Dense kernels on their input rows, so that
consecutive layers alternate column and row parallelism; whatever no
rule matches (BatchNorm scales, biases) is replicated.  A rule matches
the flax path of a parameter (``params/block1/res2/conv3/kernel``), which
the port derives from its module names (``utils/checkpoint.py:
flax_leaf``), and names the split axis in flax's layout; the port's
Conv and Dense weights hold flax's axes reversed ((out, in, k) for
(k, in, out), (out, in) for (in, out)), so the axis is mapped, not the
index.  A leaf whose split dimension the mesh's axis size does not divide
stays whole, as in JAX.

JAX annotates and lets GSPMD insert the collectives.  The port runs them
itself, in :func:`copy_to`, :func:`reduce_from`, :func:`gather_from` and
:func:`scatter_to` over the mesh's ``model`` group, whose backward passes
are the ones each forward needs (Megatron's pairs).  A split layer
(``models/ecapa.py:Conv``, ``Dense``, ``SEBlock``) takes a replicated
input and returns a replicated output, so every model rank runs what lies
between split layers on the whole tensors, and a replicated parameter
gets its whole gradient on every rank.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

import torch
import torch.distributed as dist
from torch import nn

from ..utils.checkpoint import flax_leaf
from .mesh import Mesh

# (regex over 'path/to/param', spec) — first match wins.
ECAPA_RULES: tuple[tuple[str, tuple], ...] = (
    # conv kernels are (k, in_ch, out_ch) → shard out channels
    (r".*res2/conv\d+/kernel$", (None, None, "model")),
    (r".*(stem|tdnn_in|tdnn_out|mfa|att1|att2)/conv/kernel$", (None, None, "model")),
    (r".*(mfa|att1|att2)/kernel$", (None, None, "model")),
    # SE dense (in, out): fc1 shard out, fc2 shard in (row) — pair fuses
    (r".*se/fc1/kernel$", (None, "model")),
    (r".*se/fc2/kernel$", ("model", None)),
    # final embedding projection: (in, out) shard in
    (r".*embedding/kernel$", ("model", None)),
    # AAM-softmax class weights (never a tower leaf: parallel/train.py
    # shards the head by classes itself)
    (r".*aam/weights$", ("model", None)),
)


def ecapa_param_spec(path: str) -> tuple:
    """The spec of a flax path, in flax's layout; () replicates."""
    for pattern, spec in ECAPA_RULES:
        if re.fullmatch(pattern, path):
            return spec
    return ()


@dataclass(frozen=True)
class Sharding:
    """How one tensor lies on a mesh (JAX's ``NamedSharding``): ``spec``
    names, per dimension of the tensor in the port's layout, the mesh axis
    that splits it, or None; () replicates."""

    mesh: Mesh
    spec: tuple = ()

    def _axes(self, ndim: int):
        return [(dim, axis) for dim, axis in enumerate(self.spec[:ndim]) if axis is not None]

    def shard_shape(self, shape) -> tuple[int, ...]:
        out = list(shape)
        for dim, axis in self._axes(len(out)):
            out[dim] //= self.mesh.shape[axis]
        return tuple(out)

    def shard(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of the global ``x`` (a view)."""
        for dim, axis in self._axes(x.dim()):
            n = x.shape[dim] // self.mesh.shape[axis]
            x = x.narrow(dim, self.mesh.coords[axis] * n, n)
        return x

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The global tensor from every rank's block (a collective over
        each splitting axis's group; no autograd)."""
        for dim, axis in self._axes(x.dim()):
            group = self.mesh.model_group if axis == "model" else self.mesh.data_group
            x = _all_gather(x, dim, self.mesh.shape[axis], group)
        return x


def batch_sharding(mesh: Mesh) -> Sharding:
    """Leading-axis data sharding for input batches."""
    return Sharding(mesh, ("data",))


def replicate(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def param_shardings(model: nn.Module, mesh: Mesh, rules=ecapa_param_spec) -> dict[str, Sharding]:
    """Every state-dict entry of the (whole) ``model`` → its ``Sharding``,
    with JAX's filter: a spec whose axis does not divide its dimension
    replicates the leaf.  An axis of size 1 splits nothing, and is
    dropped from the spec."""
    out = {}
    for name, t in model.state_dict().items():
        collection, path = flax_leaf(name, t.dim())
        spec = tuple(rules(f"{collection}/{path}"))
        flax_shape = tuple(reversed(t.shape))
        if any(axis is not None and d % mesh.shape[axis] for d, axis in zip(flax_shape, spec)):
            spec = ()
        spec = tuple(a if a is not None and mesh.shape[a] > 1 else None for a in spec)
        spec = spec + (None,) * (t.dim() - len(spec))
        out[name] = Sharding(mesh, tuple(reversed(spec)) if any(spec) else ())
    return out


@dataclass(frozen=True)
class Split:
    """A Conv or Dense layer whose weight holds this rank's block of
    dimension ``dim`` (the port's layout) over ``mesh``'s model axis."""

    mesh: Mesh
    dim: int


def shard_params(model: nn.Module, mesh: Mesh, rules=ecapa_param_spec) -> nn.Module:
    """Keep this rank's block of every leaf the rules split, in place, and
    mark each split layer (its ``tp`` attribute) so that its forward runs
    the collectives; returns ``model``.  Only the ``model`` axis splits
    parameters.  :func:`gather_state_dict` inverts it."""
    for name, sh in param_shardings(model, mesh, rules).items():
        if not sh.spec:
            continue
        if "data" in sh.spec:
            raise ValueError(f"{name}: parameters split over 'model' only, not {sh.spec}")
        mod_name, _, leaf = name.rpartition(".")
        t = getattr(model.get_submodule(mod_name), leaf)
        t.data = sh.shard(t.data).clone()
        if leaf == "weight":
            model.get_submodule(mod_name).tp = Split(mesh, sh.spec.index("model"))
    return model


def gather_state_dict(model: nn.Module, shardings: dict[str, Sharding]) -> dict[str, torch.Tensor]:
    """The whole model's state dict from every model rank's blocks (a
    collective over the model group when a leaf is split)."""
    return {k: shardings[k].gather(v) if k in shardings else v
            for k, v in model.state_dict().items()}


# -- collectives over the model group, with the backward each needs -----------

def _all_gather(x: torch.Tensor, dim: int, size: int, group) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def _all_reduce_f32(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over the group, taken in float32 (bf16 partial sums are
    rounded once, after the sum), in ``x``'s dtype."""
    y = x.to(torch.float32, copy=True).contiguous()
    dist.all_reduce(y, group=group)
    return y.to(x.dtype)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_f32(g, ctx.mesh.model_group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return _all_reduce_f32(x, mesh.model_group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, mesh):
        ctx.dim, ctx.n, ctx.index = dim, x.shape[dim], mesh.coords["model"]
        return _all_gather(x, dim, mesh.model, mesh.model_group)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.index * ctx.n, ctx.n), None, None


class _ScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, mesh):
        ctx.dim, ctx.mesh = dim, mesh
        n = x.shape[dim] // mesh.model
        return x.narrow(dim, mesh.coords["model"] * n, n)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.mesh.model, ctx.mesh.model_group), None, None


def copy_to(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A replicated input to a column-split layer: the identity; backward
    sums the gradient over the model ranks."""
    return _CopyTo.apply(x, mesh)


def reduce_from(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A row-split layer's partial products, summed over the model ranks;
    backward passes the (replicated) gradient through."""
    return _ReduceFrom.apply(x, mesh)


def gather_from(x: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    """Every model rank's block of ``dim``, concatenated in rank order;
    backward keeps this rank's block of the (replicated) gradient."""
    return _GatherFrom.apply(x, dim % x.dim(), mesh)


def scatter_to(x: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    """This rank's block of ``dim`` of a replicated ``x``; backward gathers
    every rank's block of the gradient."""
    return _ScatterTo.apply(x, dim % x.dim(), mesh)
