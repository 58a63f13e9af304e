"""Plain float32 ECAPA-TDNN forward (Desplanques et al., Interspeech 2020).

The tower as the port serves it, written from its flax variables file with
plain ``torch`` operations (TF32 off) and nothing of the port:

- TDNN block: Conv1d (zero "same" padding d·(k−1)/2) → ReLU → BatchNorm with
  the running statistics (ε = 1e-5);
- SE-Res2 block: 1×1 TDNN → Res2 (split 0 passes, split i ≥ 1 is a k = 3
  dilated TDNN of split i plus the previous split's output) → 1×1 TDNN →
  squeeze-excitation (mean over time, dense → ReLU → dense → sigmoid) →
  plus the block's input;
- multi-layer aggregation: the three blocks' outputs concatenated → 1×1 conv
  → ReLU (→ BatchNorm in SpeechBrain's layout, ``mfa_bn``);
- attentive statistics pooling: attention over [h_t, mean, std] → 1×1 conv
  (→ ReLU → BatchNorm in SpeechBrain's layout, ``asp_tdnn``) → tanh → 1×1
  conv → softmax over time per channel; weighted mean and std, the std as
  sqrt(max(var, 1e-5)) as the port takes it → BatchNorm → dense → L2.

Departures from SpeechBrain's own forward, kept because the port serves the
tower so: zero padding where SpeechBrain pads by reflection, and the 1e-5
floor under the variances.  Each clip is computed over its own valid frames
alone, so no mask enters.  ``quant`` rounds the operands of every product
(the control).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


class Ecapa:
    def __init__(self, tree: dict, model: dict, device, quant=None):
        dev = torch.device(device)
        self.p = _to_torch(tree["params"], dev)
        self.s = _to_torch(tree.get("batch_stats", {}), dev)
        self.m = model
        self.q = quant or (lambda x: x)

    def _conv(self, x, p, dilation=1):
        k = p["kernel"]  # (k, in, out)
        w = k.permute(2, 1, 0)
        pad = dilation * (k.shape[0] - 1) // 2
        return F.conv1d(self.q(x), self.q(w), p["bias"], padding=pad, dilation=dilation)

    def _dense(self, x, p):
        return self.q(x) @ self.q(p["kernel"]) + p["bias"]

    @staticmethod
    def _bn(x, p, s):
        shape = (1, -1) + (1,) * (x.dim() - 2)
        inv = torch.rsqrt(s["var"] + 1e-5) * p["scale"]
        return (x - s["mean"].view(shape)) * inv.view(shape) + p["bias"].view(shape)

    def _tdnn(self, x, p, s, dilation=1):
        return self._bn(torch.relu(self._conv(x, p["conv"], dilation)), p["bn"], s["bn"])

    def _block(self, x, p, s, dilation):
        res = x
        x = self._tdnn(x, p["tdnn_in"], s["tdnn_in"])
        xs = torch.chunk(x, self.m["scale"], dim=1)
        outs, prev = [xs[0]], None
        for i in range(1, self.m["scale"]):
            inp = xs[i] if prev is None else xs[i] + prev
            prev = self._bn(torch.relu(self._conv(inp, p["res2"][f"conv{i}"], dilation)),
                            p["res2"][f"bn{i}"], s["res2"][f"bn{i}"])
            outs.append(prev)
        x = self._tdnn(torch.cat(outs, dim=1), p["tdnn_out"], s["tdnn_out"])
        z = torch.sigmoid(self._dense(torch.relu(self._dense(x.mean(dim=2), p["se"]["fc1"])),
                                      p["se"]["fc2"]))
        return x * z[:, :, None] + res

    def _pool(self, x):
        p, s = self.p["asp"], self.s.get("asp", {})
        t = x.shape[2]
        mean = x.mean(dim=2)
        std = torch.sqrt(torch.clamp((x * x).mean(dim=2) - mean * mean, min=1e-5))
        ctx = torch.cat([x, mean[:, :, None].expand(-1, -1, t),
                         std[:, :, None].expand(-1, -1, t)], dim=1)
        a = self._conv(ctx, p["att1"])
        if self.m["asp_tdnn"]:
            a = self._bn(torch.relu(a), p["att_bn"], s["att_bn"])
        w = torch.softmax(self._conv(torch.tanh(a), p["att2"]), dim=2)
        mu = (w * x).sum(dim=2)
        sd = torch.sqrt(torch.clamp((w * x * x).sum(dim=2) - mu * mu, min=1e-5))
        return torch.cat([mu, sd], dim=1)

    @torch.no_grad()
    def __call__(self, feats: torch.Tensor) -> torch.Tensor:
        """(B, T, n_mels) features → (B, emb_dim) unit embeddings."""
        p, s = self.p, self.s
        x = self._tdnn(feats.transpose(1, 2), p["stem"], s["stem"])
        outs = []
        for i, d in enumerate(self.m["dilations"]):
            x = self._block(x, p[f"block{i + 1}"], s[f"block{i + 1}"], d)
            outs.append(x)
        x = torch.relu(self._conv(torch.cat(outs, dim=1), p["mfa"]))
        if self.m["mfa_bn"]:
            x = self._bn(x, p["mfa_bn"], s["mfa_bn"])
        e = self._dense(self._bn(self._pool(x), p["asp_bn"], s["asp_bn"]), p["embedding"])
        return e / torch.clamp(torch.linalg.norm(e, dim=1, keepdim=True), min=1e-12)


def _to_torch(tree: dict, dev) -> dict:
    return {k: _to_torch(v, dev) if isinstance(v, dict)
            else torch.tensor(v, dtype=torch.float32, device=dev) for k, v in tree.items()}
