"""A configuration's weights: the file the program loads, and the same
variables for the reference.

A configuration names either a checkpoint in the repository
(``"weights": {"file": ...}``) or seeded weights
(``"weights": {"seed": n}``).  Seeded weights are drawn on the device in two
calls (a normal draw for every leaf, a uniform one for the running
variances) at the scale of trained weights: kernels with standard deviation
1/sqrt(fan_in), biases 0.05, BatchNorm scales 1 ± 0.1, shifts and running
means 0.1, running variances in [1, 1.1).  They are written once per
checkout, with the ``.config.json`` sidecar that carries the configuration's
tower and frontend to the program, under ``.benchcache/<config>-<hash of
both and the seed>/``, and read from there by later runs.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
from pathlib import Path

import torch

from reference import flaxio


def ecapa_leaves(m: dict) -> list[tuple[tuple[str, ...], tuple[int, ...], str]]:
    """(path, shape, law) of every leaf of the port's ECAPA variables."""
    c, w = m["channels"], m["channels"] // m["scale"]
    mfa, att = m["mfa_channels"], m["attention_channels"]
    out = []

    def conv(path, k, cin, cout):
        out.extend([(("params", *path, "kernel"), (k, cin, cout), "conv"),
                    (("params", *path, "bias"), (cout,), "bias")])

    def dense(path, cin, cout):
        out.extend([(("params", *path, "kernel"), (cin, cout), "dense"),
                    (("params", *path, "bias"), (cout,), "bias")])

    def bn(path, n):
        out.extend([(("params", *path, "scale"), (n,), "scale"),
                    (("params", *path, "bias"), (n,), "shift"),
                    (("batch_stats", *path, "mean"), (n,), "shift"),
                    (("batch_stats", *path, "var"), (n,), "var")])

    conv(("stem", "conv"), 5, m["n_mels"], c)
    bn(("stem", "bn"), c)
    for i in range(1, len(m["dilations"]) + 1):
        b = f"block{i}"
        conv((b, "tdnn_in", "conv"), 1, c, c)
        bn((b, "tdnn_in", "bn"), c)
        for j in range(1, m["scale"]):
            conv((b, "res2", f"conv{j}"), 3, w, w)
            bn((b, "res2", f"bn{j}"), w)
        conv((b, "tdnn_out", "conv"), 1, c, c)
        bn((b, "tdnn_out", "bn"), c)
        dense((b, "se", "fc1"), c, m["se_bottleneck"])
        dense((b, "se", "fc2"), m["se_bottleneck"], c)
    conv(("mfa",), 1, len(m["dilations"]) * c, mfa)
    if m["mfa_bn"]:
        bn(("mfa_bn",), mfa)
    conv(("asp", "att1"), 1, 3 * mfa, att)
    if m["asp_tdnn"]:
        bn(("asp", "att_bn"), att)
    conv(("asp", "att2"), 1, att, mfa)
    bn(("asp_bn",), 2 * mfa)
    dense(("embedding",), 2 * mfa, m["emb_dim"])
    return out


def seeded_tree(m: dict, seed: int, device) -> dict:
    """The variables tree of seeded weights, drawn on ``device``."""
    leaves = ecapa_leaves(m)
    sizes = [math.prod(shape) for _, shape, _ in leaves]
    g = torch.Generator(device=device).manual_seed(seed)
    normal = torch.randn(sum(sizes), generator=g, device=device)
    uniform = torch.rand(sum(sizes), generator=g, device=device)
    tree: dict = {}
    at = 0
    for (path, shape, law), size in zip(leaves, sizes):
        z = normal[at : at + size].view(shape)
        if law == "conv":
            v = z / math.sqrt(shape[0] * shape[1])
        elif law == "dense":
            v = z / math.sqrt(shape[0])
        elif law == "bias":
            v = 0.05 * z
        elif law == "scale":
            v = 1.0 + 0.1 * z
        elif law == "shift":
            v = 0.1 * z
        else:
            v = 1.0 + 0.1 * uniform[at : at + size]
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = v.float().cpu().numpy()
        at += size
    return tree


def weights_file(cfg: dict, root: Path, device) -> Path:
    """The checkpoint the program loads for configuration ``cfg``; seeded
    weights and their sidecar are written on the first call in a checkout."""
    spec = cfg["weights"]
    if "file" in spec:
        return root / spec["file"]
    stamp = hashlib.sha1(json.dumps([cfg["model"], cfg["frontend"], spec], sort_keys=True)
                         .encode()).hexdigest()[:12]
    path = root / ".benchcache" / f"{cfg['name']}-{stamp}" / "ecapatdnn.msgpack"
    sidecar = path.with_suffix(".config.json")
    if path.exists() and sidecar.exists():
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f".{path.name}.{os.getpid()}")
    flaxio.write(tmp, seeded_tree(cfg["model"], int(spec["seed"]), device))
    sidecar_tmp = sidecar.with_name(f".{sidecar.name}.{os.getpid()}")
    sidecar_tmp.write_text(json.dumps({"model": cfg["model"], "frontend": cfg["frontend"]},
                                      indent=1) + "\n")
    os.replace(sidecar_tmp, sidecar)
    os.replace(tmp, path)
    return path

