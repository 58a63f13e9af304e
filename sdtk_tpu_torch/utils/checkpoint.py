"""Flax msgpack checkpoints without flax, and the tower weight converters.

Flax writes a checkpoint as a msgpack map whose array leaves are msgpack
extension objects: type 1 (ndarray) holds a packed ``(shape, dtype name,
raw C-order bytes)`` triple, type 3 (numpy scalar) the same for a 0-d
array, type 2 a Python complex.  Leaves above 1 GiB are split into a
``{"__msgpack_chunked_array__": True, "shape": ..., "chunks": ...}``
map.  :func:`read_msgpack` decodes all of that with plain ``msgpack``
into nested dicts of numpy arrays — the same tree as
``flax.serialization.msgpack_restore``; :func:`write_msgpack` is its
inverse and writes the bytes ``flax.serialization.msgpack_serialize``
writes.  The converters carry a model's weights both ways: flax
variables → the port's state dict (``ecapa_state_dict``,
``vad_state_dict``, ``conformer_state_dict``), and back
(``ecapa_jax_tree``, ``vad_jax_tree``, ``conformer_jax_tree``).
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import msgpack
import numpy as np
import torch

from .ioutil import atomic_write_bytes

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


_MAX_LEAF_BYTES = 2**30  # flax splits larger leaves into chunks; no tower has one


def _ndarray_bytes(arr: np.ndarray) -> bytes:
    return msgpack.packb((arr.shape, arr.dtype.name, arr.tobytes("C")), use_bin_type=True)


def _ext_pack(obj):
    if isinstance(obj, np.ndarray):
        if obj.dtype.hasobject or obj.nbytes > _MAX_LEAF_BYTES:
            raise ValueError(f"cannot write a {obj.dtype} leaf of {obj.nbytes} bytes")
        return msgpack.ExtType(_EXT_NDARRAY, _ndarray_bytes(obj))
    if isinstance(obj, np.generic):
        return msgpack.ExtType(_EXT_NPSCALAR, _ndarray_bytes(np.asarray(obj)))
    if isinstance(obj, complex):
        return msgpack.ExtType(_EXT_COMPLEX, msgpack.packb((obj.real, obj.imag)))
    raise TypeError(f"cannot serialize {type(obj).__name__}")


def msgpack_bytes(tree: dict) -> bytes:
    """Nested dicts of numpy arrays → flax msgpack bytes (maps in the
    dicts' own key order)."""
    return msgpack.packb(tree, default=_ext_pack, strict_types=True)


def write_msgpack(path: str | Path, tree: dict) -> None:
    """Write ``tree`` as a flax msgpack checkpoint, atomically (a temp file
    in the same directory, then ``os.replace``)."""
    atomic_write_bytes(path, msgpack_bytes(tree))


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


def _nest(flat: dict[str, np.ndarray]) -> dict:
    """``{"a.b.c": x}`` → ``{"a": {"b": {"c": x}}}`` with every level's keys
    sorted, the order in which JAX's tree functions rebuild a dict."""
    tree: dict = {}
    for key in sorted(flat):
        *mods, leaf = key.split(".")
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = flat[key]

    def order(node):
        return {k: order(node[k]) for k in sorted(node)} if isinstance(node, dict) else node

    return order(tree)


def ecapa_jax_tree(state_dict: dict[str, torch.Tensor]) -> dict:
    """The port's ``EcapaTdnn.state_dict()`` → JAX ECAPA variables
    ``{"params": ..., "batch_stats": ...}`` (float32 numpy leaves, copies,
    keys sorted at every level), the inverse of :func:`ecapa_state_dict`:
    Conv weights ``(out, in, k)`` → kernels ``(k, in, out)``, Dense ``(out,
    in)`` → ``(in, out)``, a norm's (1-D) ``weight`` → ``scale``, and
    BatchNorm's running statistics → ``batch_stats`` ``mean``/``var``."""
    out: dict[str, dict[str, np.ndarray]] = {"params": {}, "batch_stats": {}}
    for key, t in state_dict.items():
        a = t.detach().to("cpu", torch.float32).numpy().copy()  # no view of a live parameter
        collection, path = flax_leaf(key, a.ndim)
        if path.endswith("/kernel"):
            a = a.transpose(2, 1, 0) if a.ndim == 3 else a.T
        out[collection][path.replace("/", ".")] = np.ascontiguousarray(a)
    return {"params": _nest(out["params"]), "batch_stats": _nest(out["batch_stats"])}


def write_wavlm_ecapa(path: str | Path, model: torch.nn.Module) -> None:
    """``model``'s (a ``WavLMEcapa``) variables file at ``path`` and its
    ``.config.json`` sidecar ``{"model": its WavLMEcapaConfig}``, which
    ``GpuBackend(model="wavlm_ecapa")`` serves through ``$SDTK_MODEL_PATH``.
    The tree is ECAPA's conversion throughout (:func:`ecapa_jax_tree`, read
    back by :func:`ecapa_state_dict`): Conv kernels (k, in/groups, out),
    Dense kernels (in, out), a norm's 1-D ``weight`` as ``scale``, the
    head's BatchNorm statistics in ``batch_stats``; ``layers/0/rel_table``
    (320, H), each layer's ``gate_const`` (H,) and ``mix/scale`` (the 25
    state weights) as they are."""
    write_msgpack(path, ecapa_jax_tree(model.state_dict()))
    sidecar = {"model": dataclasses.asdict(model.cfg)}
    atomic_write_bytes(Path(path).with_suffix(".config.json"),
                       (json.dumps(sidecar, indent=1) + "\n").encode())


def flax_leaf(key: str, ndim: int) -> tuple[str, str]:
    """A state-dict key of the port's towers → (flax collection, flax path):
    ``block1.res2.conv3.weight`` → ("params", "block1/res2/conv3/kernel"),
    a 1-D ``weight`` → ``scale``, ``running_mean``/``running_var`` →
    ("batch_stats", ".../mean" or ".../var")."""
    mod, _, leaf = key.rpartition(".")
    mod = mod.replace(".", "/")
    if leaf in ("running_mean", "running_var"):
        return "batch_stats", f"{mod}/{leaf[len('running_'):]}"
    if leaf == "weight":
        leaf = "kernel" if ndim > 1 else "scale"
    return "params", f"{mod}/{leaf}"


def xvector_jax_tree(state_dict: dict[str, torch.Tensor]) -> dict:
    """The port's ``XVector.state_dict()`` → JAX x-vector variables, the
    inverse of :func:`xvector_state_dict` (ECAPA's conversion)."""
    return ecapa_jax_tree(state_dict)


def vad_state_dict(jax_tree: dict) -> dict[str, torch.Tensor]:
    """JAX VAD variables ``{"params": ...}`` → the port's
    ``VadNet.state_dict()``: conv kernels (k, in, out) → ``Conv1d`` weights
    (out, in, k), the Dense ``out`` kernel (32, 1) → ``Linear`` (1, 32),
    LayerNorm ``scale`` → ``weight`` (ECAPA's conversion, without
    BatchNorm statistics)."""
    return ecapa_state_dict({"params": jax_tree["params"]})


def vad_jax_tree(state_dict: dict[str, torch.Tensor]) -> dict:
    """The port's ``VadNet.state_dict()`` → JAX VAD variables ``{"params":
    ...}``, the inverse of :func:`vad_state_dict` (ECAPA's conversion: a
    LayerNorm ``weight`` → ``scale``; keys sorted at every level, as in the
    JAX trainer's tree after an optax update)."""
    return {"params": ecapa_jax_tree(state_dict)["params"]}


_ATTENTION = "MultiHeadDotProductAttention_0"


def conformer_state_dict(jax_tree: dict) -> dict[str, torch.Tensor]:
    """JAX Conformer variables → the port's ``Conformer.state_dict()``.

    ECAPA's conversion (module names kept, Dense and conv kernels
    transposed, the depthwise kernel (K, 1, C) → (C, 1, K), LayerNorm and
    BatchNorm ``scale`` → ``weight``, ``batch_stats``), except for the
    attention's ``DenseGeneral`` leaves: a ``query``/``key``/``value``
    kernel (C, H, Dh) becomes the weight (H·Dh, C) and its bias (H, Dh)
    becomes (H·Dh,); the ``out`` kernel (H, Dh, C) becomes (C, H·Dh)."""
    params = jax_tree["params"]
    flat = {k: v for k, v in _flatten(params).items() if f".{_ATTENTION}." not in k}
    sd = ecapa_state_dict({"params": _nest(flat),
                           "batch_stats": jax_tree.get("batch_stats", {})})
    for key, arr in _flatten(params).items():
        if f".{_ATTENTION}." not in key:
            continue
        mod, _, leaf = key.rpartition(".")
        a = np.array(arr, np.float32)
        if leaf == "kernel":
            fan_in = a.shape[0] if not mod.endswith(".out") else a.shape[0] * a.shape[1]
            a, leaf = a.reshape(fan_in, -1).T, "weight"
        else:
            a = a.reshape(-1)
        sd[f"{mod}.{leaf}"] = torch.from_numpy(np.ascontiguousarray(a))
    return sd


def conformer_jax_tree(state_dict: dict[str, torch.Tensor], n_heads: int = 4) -> dict:
    """The port's ``Conformer.state_dict()`` → JAX Conformer variables, the
    inverse of :func:`conformer_state_dict` (``n_heads`` splits the
    attention's flat weights back into (C, H, Dh), (H, Dh) and (H, Dh, C))."""
    plain = {k: v for k, v in state_dict.items() if f".{_ATTENTION}." not in k}
    tree = ecapa_jax_tree(plain)
    flat = _flatten(tree["params"])
    for key, t in state_dict.items():
        if f".{_ATTENTION}." not in key:
            continue
        mod, _, leaf = key.rpartition(".")
        a = t.detach().to("cpu", torch.float32).numpy()
        if leaf == "weight":
            out_f, in_f = a.shape
            a = (a.T.reshape(n_heads, in_f // n_heads, out_f) if mod.endswith(".out")
                 else a.T.reshape(in_f, n_heads, out_f // n_heads))
            leaf = "kernel"
        else:
            a = a if mod.endswith(".out") else a.reshape(n_heads, -1)
        flat[f"{mod}.{leaf}"] = np.ascontiguousarray(a)
    return {"params": _nest(flat), "batch_stats": tree["batch_stats"]}
