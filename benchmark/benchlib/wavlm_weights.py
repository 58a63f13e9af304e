"""Seeded weights of the WavLM + ECAPA configuration: the file the program
loads, and the same variables for the reference.

The leaves are those of the program's variables file for the model
(``models/wavlm.py``; ECAPA's tree layout: Conv kernels (k, in/groups,
out), Dense kernels (in, out), norms' ``scale`` and ``bias``, the head's
BatchNorm statistics in ``batch_stats``), enumerated here from the
configuration alone.  They are drawn on the device in two calls (a normal
draw for every leaf, a uniform one for the running variances) at the scale
of trained weights: kernels with standard deviation 1/sqrt(fan_in), biases
0.05, norm and BatchNorm scales and the gate constants 1 ± 0.1, shifts and
running means 0.1, running variances in [1, 1.1), the relative-position
table 1, the 25 state weights 0.1.  The head's last BatchNorm (over the
pooled statistics) then takes running statistics as training leaves them,
the mean and variance of the plain reference's pooled statistics over 64
seeded clips (8 voices × 4 utterances × 2 crops of 8 s, drawn from the
weights' seed).  With drawn ones the pooled statistics of every clip share
one offset: on the card any two clips' embeddings met at cosine 0.9988,
the fp8 control's gap was only 200× the program's, and one seed in 16 left
the clustering to rounding (56 of 256 clips apart); measured, the
embeddings' mean cosine falls to about 0.05.  They are stored in bfloat16 (the
configuration's compute type; both readers widen them to float32 exactly),
632 MB at the published widths, with the ``.config.json`` sidecar that
carries the configuration to the program, under ``.benchcache/<config>-<hash
of both and the seed>/``, once per checkout.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
from pathlib import Path

import msgpack
import numpy as np
import torch

from benchlib import synth
from benchlib import weights as ecapa_weights
from reference.wavlm_ecapa import WavLMEcapa as PlainModel

FORMAT = 2  # bumped when the leaves or their laws change
CALIBRATION = {"speakers": 8, "per_speaker": 4, "utterance_s": 12.0, "clip_s": 8.0,
               "crops": 2, "block": 16}


def leaves(m: dict) -> list[tuple[tuple[str, ...], tuple[int, ...], str]]:
    """(path, shape, law) of every leaf of the model's variables."""
    d, heads, f = m["hidden_size"], m["num_attention_heads"], m["intermediate_size"]
    out = []

    def norm(path, n):
        out.extend([(("params", *path, "scale"), (n,), "scale"),
                    (("params", *path, "bias"), (n,), "shift")])

    def dense(path, cin, cout):
        out.extend([(("params", *path, "kernel"), (cin, cout), "dense"),
                    (("params", *path, "bias"), (cout,), "bias")])

    cin = 1
    for i, (c, k) in enumerate(zip(m["conv_dim"], m["conv_kernel"])):
        out.append((("params", f"conv{i}", "kernel"), (k, cin, c), "conv"))
        if m["conv_bias"]:
            out.append((("params", f"conv{i}", "bias"), (c,), "bias"))
        norm((f"conv{i}_norm",), c)
        cin = c
    norm(("proj_norm",), cin)
    dense(("proj",), cin, d)
    k, groups = m["num_conv_pos_embeddings"], m["num_conv_pos_embedding_groups"]
    out.extend([(("params", "pos_conv", "kernel"), (k, d // groups, d), "conv"),
                (("params", "pos_conv", "bias"), (d,), "bias")])
    for i in range(m["num_hidden_layers"]):
        layer = ("layers", str(i))
        norm((*layer, "ln1"), d)
        for name in ("q", "k", "v", "o"):
            dense((*layer, name), d, d)
        dense((*layer, "gate"), d // heads, m["gate_dim"])
        out.append((("params", *layer, "gate_const"), (heads,), "scale"))
        if i == 0:
            out.append((("params", *layer, "rel_table"), (m["num_buckets"], heads), "table"))
        norm((*layer, "ln2"), d)
        dense((*layer, "fc1"), d, f)
        dense((*layer, "fc2"), f, d)
    out.append((("params", "mix", "scale"), (m["num_hidden_layers"] + 1,), "mix"))
    head = dict(m, n_mels=d, mfa_bn=False, asp_tdnn=False)
    for path, shape, law in ecapa_weights.ecapa_leaves(head):
        if path[1:] == ("asp", "att1", "kernel"):  # attention over h_t alone
            shape = (1, m["mfa_channels"], m["attention_channels"])
        out.append(((path[0], "head", *path[1:]), shape, law))
    return out


def seeded_tree(m: dict, seed: int, device) -> dict:
    """The variables tree of seeded weights, drawn on ``device``: nested
    dicts of bfloat16 CPU tensors."""
    spec = leaves(m)
    sizes = [math.prod(shape) for _, shape, _ in spec]
    g = torch.Generator(device=device).manual_seed(seed)
    normal = torch.randn(sum(sizes), generator=g, device=device)
    uniform = torch.rand(sum(sizes), generator=g, device=device)
    laws = {"conv": lambda z, s: z / math.sqrt(s[0] * s[1]),
            "dense": lambda z, s: z / math.sqrt(s[0]),
            "bias": lambda z, s: 0.05 * z, "scale": lambda z, s: 1.0 + 0.1 * z,
            "shift": lambda z, s: 0.1 * z, "table": lambda z, s: z,
            "mix": lambda z, s: 0.1 * z}
    tree: dict = {}
    at = 0
    for (path, shape, law), size in zip(spec, sizes):
        if law == "var":
            v = 1.0 + 0.1 * uniform[at : at + size].view(shape)
        else:
            v = laws[law](normal[at : at + size].view(shape), shape)
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = v.to(torch.bfloat16).cpu()
        at += size
    return tree


def measure_head_statistics(tree: dict, m: dict, seed: int, device) -> None:
    """Set the head's last BatchNorm's running mean and variance, in place,
    to those of the plain reference's pooled statistics over the seeded
    calibration clips (``CALIBRATION``), computed on ``device``."""
    cal = CALIBRATION
    pool, _ = synth.voice_pool(seed, cal["speakers"], cal["per_speaker"], cal["utterance_s"])
    n = int(cal["clip_s"] * synth.SR)
    step = (pool.shape[1] - n) // max(cal["crops"] - 1, 1)
    clips = torch.from_numpy(np.concatenate([pool[:, i * step : i * step + n]
                                             for i in range(cal["crops"])])).to(device)
    plain = PlainModel(_float_tree(tree), m, device)
    pooled = torch.cat([plain.pooled(clips[i : i + cal["block"]]).double().cpu()
                        for i in range(0, len(clips), cal["block"])])
    stats = tree["batch_stats"]["head"]["asp_bn"]
    stats["mean"] = pooled.mean(0).to(torch.bfloat16)
    stats["var"] = pooled.var(0, unbiased=False).to(torch.bfloat16)


def _float_tree(tree: dict) -> dict:
    return {k: _float_tree(v) if isinstance(v, dict) else v.float().numpy()
            for k, v in tree.items()}


def _ext(obj):
    if isinstance(obj, torch.Tensor) and obj.dtype == torch.bfloat16:
        bits = obj.contiguous().view(torch.int16).numpy().tobytes()
        return msgpack.ExtType(1, msgpack.packb((list(obj.shape), "bfloat16", bits),
                                                use_bin_type=True))
    raise TypeError(f"cannot write {type(obj).__name__}")


def write(path: Path, tree: dict) -> None:
    """A flax msgpack variables file of bfloat16 leaves, keys sorted."""
    def order(node):
        return {k: order(node[k]) for k in sorted(node)} if isinstance(node, dict) else node

    path.write_bytes(msgpack.packb(order(tree), default=_ext, strict_types=True))


def weights_file(cfg: dict, root: Path, device) -> Path:
    """The checkpoint the program loads for configuration ``cfg``, written
    with its sidecar on the first call in a checkout."""
    spec = cfg["weights"]
    stamp = hashlib.sha1(json.dumps([cfg["model"], spec, FORMAT], sort_keys=True)
                         .encode()).hexdigest()[:12]
    path = root / ".benchcache" / f"{cfg['name']}-{stamp}" / "wavlm_ecapa.msgpack"
    sidecar = path.with_suffix(".config.json")
    if path.exists() and sidecar.exists():
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f".{path.name}.{os.getpid()}")
    tree = seeded_tree(cfg["model"], int(spec["seed"]), device)
    measure_head_statistics(tree, cfg["model"], int(spec["seed"]), device)
    write(tmp, tree)
    sidecar_tmp = sidecar.with_name(f".{sidecar.name}.{os.getpid()}")
    sidecar_tmp.write_text(json.dumps({"model": cfg["model"]}, indent=1) + "\n")
    os.replace(sidecar_tmp, sidecar)
    os.replace(tmp, path)
    return path
