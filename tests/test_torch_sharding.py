"""The port's sharding rules and meshes (sdtk_tpu_torch/parallel/sharding.py,
mesh.py) against the JAX package's (sdtk_tpu/parallel/sharding.py,
mesh.py): the spec of every leaf of the three towers at full width (JAX's
trees from ``jax.eval_shape``, nothing initialized), each rank's local
shape and block against ``NamedSharding`` on meshes over the virtual CPU
devices, the mesh spec's inference and errors, and the rank coordinates.
Everything is compared exactly; no process group is needed."""

from __future__ import annotations

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdtk_tpu import parallel as jax_parallel
from sdtk_tpu.models.conformer import Conformer as JaxConformer
from sdtk_tpu.models.conformer import ConformerConfig as JaxConformerConfig
from sdtk_tpu.models.ecapa import EcapaConfig as JaxEcapaConfig
from sdtk_tpu.models.ecapa import EcapaTdnn as JaxEcapa
from sdtk_tpu.models.xvector import XVector as JaxXVector
from sdtk_tpu.models.xvector import XVectorConfig as JaxXVectorConfig
from sdtk_tpu.parallel import mesh as jax_mesh
from sdtk_tpu.parallel import sharding as jax_sharding
from sdtk_tpu_torch import parallel
from sdtk_tpu_torch.models.conformer import Conformer, ConformerConfig
from sdtk_tpu_torch.models.ecapa import EcapaConfig, EcapaTdnn
from sdtk_tpu_torch.models.xvector import XVector, XVectorConfig
from sdtk_tpu_torch.parallel import multihost
from sdtk_tpu_torch.parallel.mesh import Mesh, make_mesh, mesh_axes, mesh_sizes, parse_mesh_spec
from sdtk_tpu_torch.parallel.sharding import (ECAPA_RULES, batch_sharding, ecapa_param_spec,
                                              param_shardings, replicate)
from sdtk_tpu_torch.utils.checkpoint import flax_leaf

TOWERS = {
    "ecapa": (lambda: JaxEcapa(JaxEcapaConfig()), lambda: EcapaTdnn(EcapaConfig())),
    "xvector": (lambda: JaxXVector(JaxXVectorConfig()), lambda: XVector(XVectorConfig())),
    "conformer": (lambda: JaxConformer(JaxConformerConfig()), lambda: Conformer(ConformerConfig())),
}
# how many leaves the rules split at full width
SPLIT_LEAVES = {"ecapa": 38, "xvector": 0, "conformer": 3}
MESHES = {"data=2,model=2": 4, "data=1,model=4": 4, "model=3": 3}


@pytest.fixture(scope="module")
def jax_trees():
    """Each tower's flax variables as shapes (``jax.eval_shape``): path →
    shape, as JAX's sharding module names the paths."""
    out = {}
    for name, (make_jax, _) in TOWERS.items():
        model = make_jax()
        shapes = jax.eval_shape(lambda m=model: m.init(jax.random.PRNGKey(0),
                                                       jnp.zeros((1, 50, 80))))
        _, paths, leaves = jax_sharding._tree_paths(shapes)
        out[name] = (shapes, dict(zip(paths, [tuple(x.shape) for x in leaves])))
    return out


@pytest.fixture(scope="module")
def port_models():
    return {name: make_port() for name, (_, make_port) in TOWERS.items()}


def _port_paths(model) -> dict[str, str]:
    """state-dict key → the flax path JAX's sharding module would see."""
    return {k: "/".join(flax_leaf(k, v.dim())) for k, v in model.state_dict().items()}


def test_rules_are_jax_rules():
    assert [(p, tuple(s)) for p, s in jax_sharding.ECAPA_RULES] == list(ECAPA_RULES)


def test_parallel_exports_jax_names():
    assert parallel.__all__ == jax_parallel.__all__


@pytest.mark.parametrize("tower", list(TOWERS))
def test_every_leaf_spec_equals_jax(tower, jax_trees, port_models):
    """Every leaf of the full-width tower has JAX's path and JAX's spec; the
    rules split 38 ECAPA leaves, no x-vector leaf and three Conformer
    leaves (``asp/att1``, ``asp/att2``, ``embedding``)."""
    _, jax_paths = jax_trees[tower]
    paths = _port_paths(port_models[tower])
    assert sorted(paths.values()) == sorted(jax_paths)
    split = []
    for key, path in paths.items():
        spec = ecapa_param_spec(path)
        assert spec == tuple(jax_sharding.ecapa_param_spec(path)), path
        if spec:
            split.append(key)
    assert len(split) == SPLIT_LEAVES[tower]
    if tower == "conformer":
        assert sorted(split) == ["asp.att1.weight", "asp.att2.weight", "embedding.weight"]


def _jax_mesh(spec: str, n: int):
    return jax_mesh.make_mesh(spec, jax.devices()[:n])


@pytest.mark.parametrize("spec", list(MESHES))
@pytest.mark.parametrize("tower", list(TOWERS))
def test_local_shapes_and_blocks_equal_jax(tower, spec, jax_trees, port_models):
    """On each rank of the mesh (no group: the mesh's sizes and the rank's
    coordinates), every leaf's local shape is JAX's ``shard_shape`` (in the
    port's layout, flax's axes reversed), and a split leaf's block is the
    one JAX puts on that rank's device; at ``model=3`` only the 1 536-wide
    and 3 072-wide leaves split."""
    shapes, jax_paths = jax_trees[tower]
    n = MESHES[spec]
    jmesh = _jax_mesh(spec, n)
    jsh = jax_sharding.param_shardings(shapes, jmesh)
    _, paths, leaves = jax_sharding._tree_paths(jsh)
    jax_leaf = dict(zip(paths, leaves))
    model = port_models[tower]
    data, model_size = mesh_sizes(spec, n)
    full = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    split_names = set()
    for rank in range(n):
        port = param_shardings(model, Mesh(data, model_size, rank))
        device = jax.devices()[rank]
        for key, path in _port_paths(model).items():
            ns, gshape = jax_leaf[path], jax_paths[path]
            want = ns.shard_shape(gshape)
            got = port[key].shard_shape(full[key])
            if len(gshape) == len(full[key]):
                assert got == tuple(reversed(want)), (rank, path)
            else:  # the Conformer's attention kernels: (C, H, Dh) in flax, (H·Dh, C) here
                assert got == full[key] and want == gshape, (rank, path)
            if not port[key].spec:
                continue
            split_names.add(key)
            block = port[key].shard(torch.empty(full[key]))
            dim = port[key].spec.index("model")
            start = block.storage_offset() // torch.empty(full[key]).stride(dim)
            want_slice = ns.devices_indices_map(gshape)[device][len(gshape) - 1 - dim]
            assert (start, start + block.shape[dim]) == (want_slice.start, want_slice.stop)
    if spec == "model=3":
        want = {"ecapa": {"mfa.weight", "asp.att2.weight", "embedding.weight"},
                "xvector": set(), "conformer": set()}[tower]
        assert split_names == want


@pytest.mark.parametrize("spec,n", [
    ("", 8), ("data=4,model=2", 8), ("model=2", 8), ("model=4", 4), ("data=2", 2),
    ("data=2", 8), ("model=3", 8), ("data=3,model=2", 8), ("model=8", 8),
])
def test_mesh_sizes_match_jax(spec, n):
    """``data`` inferred when left out; a product other than the rank count
    and a model size that does not divide it raise JAX's errors."""
    try:
        want = tuple(_jax_mesh(spec, n).devices.shape)
    except ValueError as e:
        with pytest.raises(ValueError, match=re.escape(str(e))):
            mesh_sizes(spec, n)
        return
    assert mesh_sizes(spec, n) == want


@pytest.mark.parametrize("spec,n", [("data=4,model=2", 8), ("data=2,model=2", 4),
                                    ("model=4", 8), ("data=8", 8)])
def test_rank_coordinates_match_jax_devices(spec, n):
    """Rank r sits where JAX puts device r: (r // model, r % model)."""
    jmesh = _jax_mesh(spec, n)
    data, model = mesh_sizes(spec, n)
    for rank, device in enumerate(jax.devices()[:n]):
        where = np.argwhere(jmesh.devices == device)[0]
        assert Mesh(data, model, rank).coords == {"data": int(where[0]), "model": int(where[1])}
    assert mesh_axes(Mesh(data, model)) == jax_mesh.mesh_axes(jmesh)


def test_parse_mesh_spec():
    assert parse_mesh_spec("data=4,model=2") == jax_mesh.parse_mesh_spec("data=4,model=2")
    assert parse_mesh_spec("") == {}
    with pytest.raises(ValueError, match="unknown mesh axis 'bogus'"):
        parse_mesh_spec("bogus=2")


def test_make_mesh_in_one_process(monkeypatch):
    """Without a group the mesh has one rank: ``""`` and ``data=1`` give
    (1, 1), ``model=2`` raises JAX's error; no spec reads
    ``$SDTK_DEVICE_MESH``, as JAX's does; ``global_mesh`` is ``make_mesh``."""
    assert not multihost.in_group()
    assert make_mesh("") == Mesh(1, 1, 0) == multihost.global_mesh()
    with pytest.raises(ValueError, match="1 devices not divisible by model=2"):
        make_mesh("model=2")
    monkeypatch.setenv("SDTK_DEVICE_MESH", "data=2")
    with pytest.raises(ValueError, match="mesh 2x1 != 1 devices"):
        make_mesh()
    monkeypatch.setenv("SDTK_DEVICE_MESH", "data=1,model=1")
    assert make_mesh() == Mesh(1, 1, 0)


def test_batch_sharding_and_replicate():
    """The batch splits over ``data`` only: the model ranks of a data row
    take the same rows; ``replicate`` keeps the whole tensor."""
    x = torch.arange(24).reshape(8, 3)
    blocks = {r: batch_sharding(Mesh(2, 2, r)).shard(x) for r in range(4)}
    assert torch.equal(blocks[0], x[:4]) and torch.equal(blocks[1], x[:4])
    assert torch.equal(blocks[2], x[4:]) and torch.equal(blocks[3], x[4:])
    assert batch_sharding(Mesh(2, 2, 3)).shard_shape((8, 3)) == (4, 3)
    assert torch.equal(replicate(Mesh(2, 2, 3)).shard(x), x)


def test_model_axis_of_one_splits_nothing(port_models):
    """An axis of size 1 splits no leaf (JAX's split over one device is the
    whole leaf)."""
    assert not any(sh.spec for sh in param_shardings(port_models["ecapa"], Mesh(4, 1, 0)).values())
