"""Convert a public pretrained SpeechBrain ECAPA-TDNN checkpoint into a
flax-msgpack tower file (+ ``.config.json`` sidecar) that the port serves.

The counterpart of ``tools/convert_ecapa.py``, without JAX or flax: the
file is written by ``utils/checkpoint.py:msgpack_bytes``, byte for byte
what ``flax.serialization.to_bytes`` writes for the same tree, so either
package reads it.  One command converts, one environment variable serves:

    python -m sdtk_tpu_torch.tools.convert_ecapa embedding_model.ckpt \\
        -o models/ecapatdnn-voxceleb.msgpack [--verify meeting.wav]
    SDTK_MODEL_PATH=models/ecapatdnn-voxceleb.msgpack \\
        python -m sdtk_tpu_torch.cli.diarize meeting.wav

Input: a torch state dict (``torch.save`` .ckpt/.pt, or a .npz with the
same key names), or a SpeechBrain checkpoint DIRECTORY as published
(``hyperparams.yaml`` + ``embedding_model.ckpt`` + optional
``mean_var_norm*.ckpt`` normalization stats).  For a directory the
converter also:

- cross-checks ``n_mels`` between hyperparams.yaml and the stem conv;
- reads the input ``mean_var_norm`` stats (InputNormalization's
  glob_mean/glob_std) and, when the recipe declares global input
  normalization, writes them to the sidecar's ``input_norm``, which the
  serving backend applies after log-mel; sentence-level mean norm (the
  published spkrec-ecapa-voxceleb setting) is the frontend's own;
- records ``mean_var_norm_emb`` embedding-space stats under
  ``embedding_norm`` (cosine scoring of raw embeddings does not use them).

``--verify <wav>`` embeds the audio with the port's ``EcapaTdnn`` on the
converted weights (float32, on ``--device``, default cuda) and with
:class:`TorchEcapaRef`, an independent float64 reimplementation of the
SpeechBrain forward on the CPU, and prints their cosine and relative
error.

SpeechBrain layout (speechbrain.lobes.models.ECAPA_TDNN):

    blocks.0.{conv.conv,norm.norm}.*          TDNN stem (k=5)
    blocks.i.tdnn1|res2net_block|tdnn2|se_block.*   SERes2NetBlocks
    mfa.{conv.conv,norm.norm}.*               multi-layer aggregation
    asp.{tdnn.*,conv.conv}.*                  attentive stats pooling
    asp_bn.norm.*                             post-pooling BatchNorm
    fc.conv.*                                 embedding projection

The sidecar carries what differs from the tower's defaults: SpeechBrain's
MFA and attention bottleneck are full TDNN blocks (conv → relu → BN), so
it sets ``mfa_bn`` / ``asp_tdnn``, and it pins the frontend SpeechBrain
trained on (Hamming window, no preemphasis, centered framing, 10·log10
filterbanks from 0 Hz, n_fft 400).  SpeechBrain's Conv1d pads with
``reflect`` where the tower pads zeros, so the outermost k//2·dilation
frames of an utterance differ slightly.

Layouts: torch Conv1d (O, I, K) → flax (K, I, O); k=1 convs that are
flax Dense layers (SE fc1/fc2, the final fc) drop K and become (I, O);
BatchNorm weight/bias → scale/bias (params), running stats → batch_stats.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from pathlib import Path

import numpy as np

# SpeechBrain's Fbank defaults (speechbrain.lobes.features.Fbank /
# processing.features.STFT+Filterbank), which the published
# spkrec-ecapa-voxceleb recipe leaves untouched except n_mels.
SB_FRONTEND = {
    "win_length": 400,
    "hop_length": 160,
    "n_fft": 400,
    "window": "hamming",
    "preemphasis": 0.0,
    "log_scale": "db",
    "log_floor": 1e-10,  # SB Filterbank amin
    "mel_fmin": 0.0,
    "center": True,
    "mean_norm": True,  # InputNormalization(norm_type="sentence")
}


def parse_hyperparams(text: str) -> dict:
    """Tolerant scan of a SpeechBrain hyperparams.yaml (HyperPyYAML uses
    ``!new:``/``!ref`` tags, so yaml.safe_load cannot parse it).  Extracts
    the scalars the converter cross-checks: n_mels, sample_rate, and the
    norm_type declared under each InputNormalization block."""
    out: dict = {"norm_types": {}}
    current_block = None
    for raw in text.splitlines():
        line = raw.split("#", 1)[0].rstrip()
        if not line:
            continue
        indented = line[0] in " \t"
        stripped = line.strip()
        if not indented:
            current_block = stripped.split(":", 1)[0] if ":" in stripped else None
        m = re.match(r"n_mels:\s*(\d+)", stripped)
        if m and not indented:
            out["n_mels"] = int(m.group(1))
        m = re.match(r"sample_rate:\s*(\d+)", stripped)
        if m and not indented:
            out["sample_rate"] = int(m.group(1))
        m = re.match(r"norm_type:\s*(\w+)", stripped)
        if m and indented and current_block:
            out["norm_types"][current_block] = m.group(1)
    return out


def _load_norm_stats(path: Path) -> dict[str, np.ndarray] | None:
    """SpeechBrain InputNormalization checkpoint → {mean, std} arrays.
    The artifact is a torch.save of the module's statistics dict
    (glob_mean/glob_std/count + per-speaker dicts); only the global
    stats matter for inference.  Loaded with ``weights_only=True``: tensors,
    numbers and containers, no arbitrary pickled objects."""
    import torch

    try:
        obj = torch.load(path, map_location="cpu", weights_only=True)
    except Exception as e:  # a corrupt artifact: convert without its stats
        print(f"Warning: cannot read norm stats {path}: {e}", file=sys.stderr)
        return None
    if not isinstance(obj, dict):
        return None
    out = {}
    for src, dst in (("glob_mean", "mean"), ("glob_std", "std")):
        v = obj.get(src)
        if v is not None:
            out[dst] = np.asarray(
                v.detach().numpy() if hasattr(v, "detach") else v,
                dtype=np.float64)
    return out or None


def load_checkpoint_dir(path: Path) -> tuple[dict[str, np.ndarray], dict]:
    """A published SpeechBrain checkpoint directory → (state dict, extras).

    extras: {"hyperparams": parsed scalars, "input_norm": {mean,std}?,
    "embedding_norm": {mean,std}?}, whatever the directory provides."""
    sd_path = path / "embedding_model.ckpt"
    if not sd_path.exists():
        candidates = [p for p in sorted(path.glob("*.ckpt"))
                      if not p.name.startswith(("classifier",
                                                "mean_var_norm",
                                                "label_encoder"))]
        if len(candidates) != 1:
            raise FileNotFoundError(
                f"{path}: no embedding_model.ckpt and no unambiguous "
                f".ckpt candidate (found {[p.name for p in candidates]})")
        sd_path = candidates[0]
    sd = load_state_dict(sd_path)
    extras: dict = {}
    hp = path / "hyperparams.yaml"
    if hp.exists():
        extras["hyperparams"] = parse_hyperparams(hp.read_text())
    for fname, key in (("mean_var_norm.ckpt", "input_norm"),
                       ("mean_var_norm_emb.ckpt", "embedding_norm")):
        p = path / fname
        if p.exists():
            stats = _load_norm_stats(p)
            if stats:
                extras[key] = stats
    return sd, extras


def load_state_dict(path: str | Path) -> dict[str, np.ndarray]:
    """A ``.npz``, or a ``torch.save`` state dict (tensors only, loaded
    with ``weights_only=True``; ``{"model": sd}``-style nestings
    unwrapped) → {key: numpy array}."""
    path = Path(path)
    if path.suffix == ".npz":
        with np.load(path) as z:
            return {k: np.asarray(z[k]) for k in z.files}
    import torch

    obj = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    if not isinstance(obj, dict):
        raise ValueError(f"{path}: expected a state dict, got {type(obj)}")
    for key in ("embedding_model", "model", "state_dict"):
        if key in obj and isinstance(obj[key], dict):
            obj = obj[key]
    return {k: np.asarray(v.detach().numpy() if hasattr(v, "detach") else v)
            for k, v in obj.items()}


def _conv(w: np.ndarray) -> np.ndarray:
    """torch Conv1d (O, I, K) → flax nn.Conv kernel (K, I, O)."""
    return np.ascontiguousarray(w.transpose(2, 1, 0))


def _dense(w: np.ndarray) -> np.ndarray:
    """torch Conv1d k=1 (O, I, 1) → flax nn.Dense kernel (I, O)."""
    if w.shape[-1] != 1:
        raise ValueError(f"expected a k=1 conv, got {w.shape}")
    return np.ascontiguousarray(w[:, :, 0].T)


class Mapper:
    """Moves state-dict entries into the flax ``params`` and
    ``batch_stats`` trees, remembering which keys it consumed."""

    def __init__(self, sd: dict[str, np.ndarray]):
        self.sd = dict(sd)
        self.params: dict = {}
        self.stats: dict = {}
        self.consumed: set[str] = set()

    def _take(self, key: str) -> np.ndarray:
        if key not in self.sd:
            raise KeyError(f"missing key in state dict: {key}")
        self.consumed.add(key)
        return self.sd[key]

    @staticmethod
    def _put(tree: dict, path: tuple[str, ...], leaf: dict) -> None:
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node.update(leaf)

    def conv(self, sb: str, path: tuple[str, ...]) -> None:
        self._put(self.params, path, {
            "kernel": _conv(self._take(f"{sb}.weight")),
            "bias": self._take(f"{sb}.bias"),
        })

    def dense(self, sb: str, path: tuple[str, ...]) -> None:
        self._put(self.params, path, {
            "kernel": _dense(self._take(f"{sb}.weight")),
            "bias": self._take(f"{sb}.bias"),
        })

    def bn(self, sb: str, path: tuple[str, ...]) -> None:
        self._put(self.params, path, {
            "scale": self._take(f"{sb}.weight"),
            "bias": self._take(f"{sb}.bias"),
        })
        self._put(self.stats, path, {
            "mean": self._take(f"{sb}.running_mean"),
            "var": self._take(f"{sb}.running_var"),
        })
        # present in torch BN state dicts; meaningless for inference
        self.consumed.add(f"{sb}.num_batches_tracked")


def convert(sd: dict[str, np.ndarray], dilations: tuple[int, ...] | None = None
            ) -> tuple[dict, dict]:
    """State dict → ({"params": ..., "batch_stats": ...}, config dict)."""
    m = Mapper(sd)

    stem_w = sd["blocks.0.conv.conv.weight"]  # (C, n_mels, 5)
    channels, n_mels, _ = stem_w.shape
    n_se_blocks = len({
        mt.group(1)
        for k in sd
        for mt in [re.match(r"blocks\.(\d+)\.tdnn1\.", k)]
        if mt
    })
    res2_convs = len({
        mt.group(1)
        for k in sd
        for mt in [re.match(r"blocks\.1\.res2net_block\.blocks\.(\d+)\.conv\.", k)]
        if mt
    })
    scale = res2_convs + 1
    se_bottleneck = sd["blocks.1.se_block.conv1.conv.weight"].shape[0]
    mfa_channels = sd["mfa.conv.conv.weight"].shape[0]
    attention_channels = sd["asp.tdnn.conv.conv.weight"].shape[0]
    emb_dim = sd["fc.conv.weight"].shape[0]
    if dilations is None:
        dilations = tuple(range(2, 2 + n_se_blocks))  # published: (2, 3, 4)
    if len(dilations) != n_se_blocks:
        raise ValueError(
            f"--dilations has {len(dilations)} entries but the checkpoint "
            f"has {n_se_blocks} SERes2Net blocks")

    m.conv("blocks.0.conv.conv", ("stem", "conv"))
    m.bn("blocks.0.norm.norm", ("stem", "bn"))
    for i in range(1, n_se_blocks + 1):
        t = f"block{i}"
        m.conv(f"blocks.{i}.tdnn1.conv.conv", (t, "tdnn_in", "conv"))
        m.bn(f"blocks.{i}.tdnn1.norm.norm", (t, "tdnn_in", "bn"))
        for j in range(res2_convs):
            m.conv(f"blocks.{i}.res2net_block.blocks.{j}.conv.conv",
                   (t, "res2", f"conv{j + 1}"))
            m.bn(f"blocks.{i}.res2net_block.blocks.{j}.norm.norm",
                 (t, "res2", f"bn{j + 1}"))
        m.conv(f"blocks.{i}.tdnn2.conv.conv", (t, "tdnn_out", "conv"))
        m.bn(f"blocks.{i}.tdnn2.norm.norm", (t, "tdnn_out", "bn"))
        m.dense(f"blocks.{i}.se_block.conv1.conv", (t, "se", "fc1"))
        m.dense(f"blocks.{i}.se_block.conv2.conv", (t, "se", "fc2"))
    m.conv("mfa.conv.conv", ("mfa",))
    m.bn("mfa.norm.norm", ("mfa_bn",))
    m.conv("asp.tdnn.conv.conv", ("asp", "att1"))
    m.bn("asp.tdnn.norm.norm", ("asp", "att_bn"))
    m.conv("asp.conv.conv", ("asp", "att2"))
    m.bn("asp_bn.norm", ("asp_bn",))
    m.dense("fc.conv", ("embedding",))

    leftover = set(sd) - m.consumed
    if leftover:
        raise ValueError(
            "unmapped keys in state dict (not a SpeechBrain ECAPA layout?): "
            + ", ".join(sorted(leftover)[:8]))

    config = {
        "model": {
            "n_mels": int(n_mels),
            "channels": int(channels),
            "emb_dim": int(emb_dim),
            "scale": int(scale),
            "se_bottleneck": int(se_bottleneck),
            "attention_channels": int(attention_channels),
            "mfa_channels": int(mfa_channels),
            "dilations": list(dilations),
            "mfa_bn": True,
            "asp_tdnn": True,
        },
        "frontend": dict(SB_FRONTEND, n_mels=int(n_mels)),
        "source": "speechbrain-ecapa",
    }
    return {"params": m.params, "batch_stats": m.stats}, config


def verify_structure(variables: dict, config: dict, dtype: str = "bfloat16"):
    """Build the port's ``EcapaTdnn`` from the derived config and load the
    converted tree into it through ``ecapa_state_dict``, strictly: every
    name and shape must match.  Returns the loaded model (on the CPU)."""
    from ..models.ecapa import EcapaConfig, EcapaTdnn
    from ..utils.checkpoint import ecapa_state_dict

    kw = dict(config["model"], dtype=dtype)
    kw["dilations"] = tuple(kw["dilations"])
    model = EcapaTdnn(EcapaConfig(**kw))
    sd = ecapa_state_dict(variables)
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in sd.items()}
    missing = sorted(set(want) - set(got))
    extra = sorted(set(got) - set(want))
    bad = [k for k in want if k in got and want[k] != got[k]]
    if missing or extra or bad:
        lines = []
        if missing:
            lines.append("missing: " + ", ".join(missing[:6]))
        if extra:
            lines.append("extra: " + ", ".join(extra[:6]))
        for k in bad[:6]:
            lines.append(f"shape {k}: want {want[k]} got {got[k]}")
        raise ValueError("converted tree does not match the port's tower:\n"
                         + "\n".join(lines))
    model.load_state_dict(sd, strict=True)
    return model.eval()


class TorchEcapaRef:
    """Independent torch reimplementation of the SpeechBrain ECAPA
    forward (eval mode, float64; written from the published architecture,
    not from speechbrain code, and generalized to any converted shape).
    ``--verify`` holds the port's tower against it."""

    def __init__(self, sd: dict[str, np.ndarray], scale: int,
                 dilations: tuple[int, ...]):
        import torch

        self.t = torch
        self.sd = {k: torch.as_tensor(np.asarray(v)).double()
                   for k, v in sd.items()}
        self.scale = scale
        self.dilations = dilations

    def conv(self, p, x, dilation=1):
        w, b = self.sd[f"{p}.weight"], self.sd[f"{p}.bias"]
        pad = (w.shape[-1] - 1) // 2 * dilation
        return self.t.nn.functional.conv1d(x, w, b, padding=pad,
                                           dilation=dilation)

    def bn(self, p, x):
        return self.t.nn.functional.batch_norm(
            x, self.sd[f"{p}.running_mean"], self.sd[f"{p}.running_var"],
            self.sd[f"{p}.weight"], self.sd[f"{p}.bias"], training=False)

    def tdnn(self, p, x, dilation=1):
        return self.bn(f"{p}.norm.norm",
                       self.t.relu(self.conv(f"{p}.conv.conv", x, dilation)))

    def forward(self, feats: np.ndarray) -> np.ndarray:
        """(B, T, n_mels) features → (B, emb_dim) float64 embeddings."""
        t = self.t
        x = t.as_tensor(np.asarray(feats)).double().transpose(1, 2)
        x = self.tdnn("blocks.0", x)
        outs = []
        for i, dil in enumerate(self.dilations, start=1):
            p = f"blocks.{i}"
            r = x
            x = self.tdnn(f"{p}.tdnn1", x)
            chunks = x.chunk(self.scale, dim=1)
            ys = [chunks[0]]
            for j in range(1, self.scale):
                inp = chunks[j] if j == 1 else chunks[j] + ys[-1]
                ys.append(self.tdnn(f"{p}.res2net_block.blocks.{j - 1}",
                                    inp, dil))
            x = t.cat(ys, dim=1)
            x = self.tdnn(f"{p}.tdnn2", x)
            s = x.mean(dim=2, keepdim=True)
            s = t.relu(self.conv(f"{p}.se_block.conv1.conv", s))
            s = t.sigmoid(self.conv(f"{p}.se_block.conv2.conv", s))
            x = x * s + r
            outs.append(x)
        x = self.tdnn("mfa", t.cat(outs, dim=1))
        tt = x.shape[2]
        mu = x.mean(dim=2, keepdim=True).expand(-1, -1, tt)
        sd_ = x.std(dim=2, unbiased=False, keepdim=True).expand(-1, -1, tt)
        a = self.tdnn("asp.tdnn", t.cat([x, mu, sd_], dim=1))
        a = self.conv("asp.conv.conv", t.tanh(a))
        w = t.softmax(a, dim=2)
        mean = (w * x).sum(dim=2)
        std = t.sqrt(((w * x * x).sum(dim=2) - mean * mean).clamp(min=1e-5))
        pooled = t.cat([mean, std], dim=1)
        pooled = self.bn("asp_bn.norm", pooled.unsqueeze(-1)).squeeze(-1)
        fw, fb = self.sd["fc.conv.weight"], self.sd["fc.conv.bias"]
        return (pooled @ fw[:, :, 0].T + fb).numpy()


def verify_on_audio(sd: dict, variables: dict, config: dict, wav_path: str,
                    device=None) -> dict:
    """Embed the audio with the port's tower on the converted weights
    (float32 on ``device``, default cuda, TF32 off) and with the float64
    :class:`TorchEcapaRef` on the CPU, both on the sidecar frontend's
    features (the NumPy oracle); return their distance."""
    import torch

    from ..ops.fbank import FrontendConfig, log_mel_reference
    from ..utils.audio import load_audio
    from ..utils.device import full_f32, resolve_device

    dev = resolve_device(device)
    fcfg = FrontendConfig(**config["frontend"])
    wav, _ = load_audio(wav_path, target_sr=fcfg.sample_rate)
    feats = log_mel_reference(wav.astype(np.float32), fcfg)[None]
    in_norm = config.get("input_norm")
    if in_norm is not None:
        feats = ((feats - np.asarray(in_norm["mean"]))
                 / np.maximum(np.asarray(in_norm.get("std", 1.0)), 1e-8))
    feats = np.asarray(feats, np.float32)

    model = verify_structure(variables, config, dtype="float32").to(dev)
    with full_f32(), torch.inference_mode():
        port_emb = model(torch.from_numpy(feats).to(dev))[0].double().cpu().numpy()

    mcfg = model.cfg
    ref_emb = TorchEcapaRef(sd, mcfg.scale, mcfg.dilations).forward(feats)[0]
    cos = float(np.dot(port_emb, ref_emb)
                / (np.linalg.norm(port_emb) * np.linalg.norm(ref_emb)
                   + 1e-12))
    return {
        "wav": wav_path,
        "seconds": round(len(wav) / fcfg.sample_rate, 2),
        "device": str(dev),
        "cosine_similarity": round(cos, 6),
        "max_rel_err": round(float(
            np.abs(port_emb - ref_emb).max()
            / max(np.abs(ref_emb).max(), 1e-9)), 6),
        "emb_norm": round(float(np.linalg.norm(port_emb)), 4),
    }


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="sdtk_tpu_torch.tools.convert_ecapa",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("checkpoint",
                    help=".ckpt/.pt torch state dict, .npz, or a "
                         "SpeechBrain checkpoint DIRECTORY "
                         "(hyperparams.yaml + embedding_model.ckpt + "
                         "mean_var_norm stats)")
    ap.add_argument("-o", "--output", required=True,
                    help="output .msgpack path (sidecar written next to it)")
    ap.add_argument("--dilations", default=None,
                    help="comma-separated per-block dilations "
                         "(default 2,3,... matching the block count)")
    ap.add_argument("--verify", metavar="WAV", default=None,
                    help="embed this audio with BOTH the port's tower on the "
                         "converted weights and the independent torch "
                         "reference and print their distance")
    ap.add_argument("--device", default="cuda",
                    help="torch device of --verify's tower (default cuda)")
    args = ap.parse_args(argv)

    ckpt = Path(args.checkpoint)
    extras: dict = {}
    if ckpt.is_dir():
        sd, extras = load_checkpoint_dir(ckpt)
    else:
        sd = load_state_dict(ckpt)
    dil = (tuple(int(x) for x in args.dilations.split(","))
           if args.dilations else None)
    variables, config = convert(sd, dil)

    hp = extras.get("hyperparams", {})
    if "n_mels" in hp and hp["n_mels"] != config["model"]["n_mels"]:
        raise ValueError(
            f"hyperparams.yaml says n_mels={hp['n_mels']} but the stem "
            f"conv consumes {config['model']['n_mels']}: not the "
            "matching checkpoint directory?")
    if "sample_rate" in hp:
        config["frontend"]["sample_rate"] = hp["sample_rate"]
    in_norm = extras.get("input_norm")
    if in_norm is not None and hp.get("norm_types", {}).get(
            "mean_var_norm") == "global":
        # global input normalization: the stats ride their own sidecar key
        # (FrontendConfig would reject them), applied by the serving
        # backend after log-mel
        config["input_norm"] = {"mean": in_norm["mean"].tolist()}
        if "std" in in_norm:
            config["input_norm"]["std"] = in_norm["std"].tolist()
    if "embedding_norm" in extras:
        config["embedding_norm"] = {
            k: v.tolist() for k, v in extras["embedding_norm"].items()}

    verify_structure(variables, config)

    from ..utils.checkpoint import write_msgpack
    from ..utils.ioutil import atomic_write_bytes

    out = Path(args.output)
    write_msgpack(out, variables)
    sidecar = out.with_suffix(".config.json")
    atomic_write_bytes(sidecar, (json.dumps(config, indent=2) + "\n").encode())
    n_params = sum(int(np.size(v)) for v in sd.values())
    report = {
        "output": str(out),
        "sidecar": str(sidecar),
        "model": config["model"],
        "source_params": n_params,
    }
    if extras:
        report["directory_extras"] = sorted(extras)
    if args.verify:
        report["verify"] = verify_on_audio(sd, variables, config, args.verify,
                                           device=args.device)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
