"""Flax msgpack tower files, read and written with the ``msgpack`` package alone.

The format is ``flax.serialization``'s: nested maps whose leaves are
extension 1 objects holding ``(shape, dtype name, C-order bytes)``; flax
splits leaves above 2 GiB into chunks, which no tower here has.
"""

from __future__ import annotations

from pathlib import Path

import msgpack
import numpy as np

_NDARRAY = 1


def _ext_hook(code: int, data: bytes):
    if code != _NDARRAY:
        raise ValueError(f"unexpected msgpack extension {code}")
    shape, dtype, buf = msgpack.unpackb(data, raw=True)
    if dtype == b"bfloat16":  # widen through the bits; exact
        bits = np.frombuffer(buf, np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buf, np.dtype(dtype.decode())).reshape(shape).astype(np.float32)


def read(path: str | Path) -> dict:
    """The file's tree: nested dicts of float32 arrays."""
    with open(path, "rb") as f:
        tree = msgpack.unpackb(f.read(), ext_hook=_ext_hook, raw=False)
    if not isinstance(tree, dict) or "params" not in tree:
        raise ValueError(f"{path}: not a flax variables file")
    return tree


def _ext(obj):
    if isinstance(obj, np.ndarray):
        arr = np.ascontiguousarray(obj)
        return msgpack.ExtType(_NDARRAY, msgpack.packb(
            (arr.shape, arr.dtype.name, arr.tobytes("C")), use_bin_type=True))
    raise TypeError(f"cannot write {type(obj).__name__}")


def write(path: str | Path, tree: dict) -> None:
    """Write ``tree`` (keys sorted at every level, as flax writes them)."""
    def order(node):
        return {k: order(node[k]) for k in sorted(node)} if isinstance(node, dict) else node

    Path(path).write_bytes(msgpack.packb(order(tree), default=_ext, strict_types=True))
