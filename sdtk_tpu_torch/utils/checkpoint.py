"""Flax msgpack checkpoints without flax, and the tower weight converters.

Flax writes a checkpoint as a msgpack map whose array leaves are msgpack
extension objects: type 1 (ndarray) holds a packed ``(shape, dtype name,
raw C-order bytes)`` triple, type 3 (numpy scalar) the same for a 0-d
array, type 2 a Python complex.  Leaves above 1 GiB are split into a
``{"__msgpack_chunked_array__": True, "shape": ..., "chunks": ...}``
map.  :func:`read_msgpack` decodes all of that with plain ``msgpack``
into nested dicts of numpy arrays — the same tree as
``flax.serialization.msgpack_restore``.
"""

from __future__ import annotations

from pathlib import Path

import msgpack
import numpy as np
import torch

_EXT_NDARRAY = 1
_EXT_COMPLEX = 2
_EXT_NPSCALAR = 3


def _ndarray(data: bytes) -> np.ndarray:
    shape, dtype_name, buffer = msgpack.unpackb(data, raw=True)
    if dtype_name == b"bfloat16":  # numpy has no bfloat16: widen via the bits
        bits = np.frombuffer(buffer, dtype=np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name.decode())).reshape(shape)


def _ext_hook(code: int, data: bytes):
    if code == _EXT_NDARRAY:
        return _ndarray(data)
    if code == _EXT_COMPLEX:
        re, im = msgpack.unpackb(data)
        return complex(re, im)
    if code == _EXT_NPSCALAR:
        return _ndarray(data)[()]
    return msgpack.ExtType(code, data)


def _unchunk(tree):
    if isinstance(tree, dict):
        if "__msgpack_chunked_array__" in tree:
            chunks = tree["chunks"]
            shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
            flat = np.concatenate([chunks[str(i)] for i in range(len(chunks))])
            return flat.reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def read_msgpack(path: str | Path) -> dict:
    """Flax msgpack checkpoint → nested dict of numpy arrays.
    (bfloat16 leaves come back widened to float32, which is exact.)"""
    with open(path, "rb") as f:
        tree = msgpack.unpackb(f.read(), ext_hook=_ext_hook, raw=False)
    return _unchunk(tree)


def _flatten(tree: dict, prefix: str = "") -> dict[str, np.ndarray]:
    out: dict[str, np.ndarray] = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key + "."))
        else:
            out[key] = np.asarray(v)
    return out


def ecapa_state_dict(jax_tree: dict) -> dict[str, torch.Tensor]:
    """JAX ECAPA variables ``{"params": ..., "batch_stats": ...}`` (numpy
    leaves) → the port's ``EcapaTdnn.state_dict()``.

    Module names are kept, so a flax path ``block1/res2/conv3/kernel``
    becomes ``block1.res2.conv3.weight``.  Layouts: a flax Conv kernel
    ``(k, in, out)`` becomes torch ``(out, in, k)``; a Dense kernel
    ``(in, out)`` becomes ``(out, in)``; BatchNorm ``scale`` becomes
    ``weight``, and its running ``mean``/``var`` come from the
    ``batch_stats`` collection.
    """
    sd: dict[str, torch.Tensor] = {}
    for key, arr in _flatten(jax_tree["params"]).items():
        mod, _, leaf = key.rpartition(".")
        a = np.array(arr, np.float32)  # a writable copy
        if leaf == "kernel":
            a = a.transpose(2, 1, 0) if a.ndim == 3 else a.T
            leaf = "weight"
        elif leaf == "scale":
            leaf = "weight"
        sd[f"{mod}.{leaf}"] = torch.from_numpy(np.ascontiguousarray(a))
    names = {"mean": "running_mean", "var": "running_var"}
    for key, arr in _flatten(jax_tree.get("batch_stats", {})).items():
        mod, _, leaf = key.rpartition(".")
        sd[f"{mod}.{names[leaf]}"] = torch.from_numpy(np.array(arr, np.float32))
    return sd


def xvector_state_dict(jax_tree: dict) -> dict[str, torch.Tensor]:
    """JAX x-vector variables → the port's ``XVector.state_dict()``.  The
    tower is built from ECAPA's ``Conv``/``Dense``/``BatchNorm`` modules, so
    the conversion is ECAPA's: ``tdnn{1..5}.conv`` kernels (k, in, out) →
    (out, in, k), BatchNorm ``scale``/``bias`` and ``batch_stats``
    ``mean``/``var`` on each block, ``segment6.kernel`` (3000, 512) →
    (512, 3000)."""
    return ecapa_state_dict(jax_tree)
