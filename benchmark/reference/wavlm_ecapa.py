"""Plain float32 WavLM Large + ECAPA-TDNN forward (UniSpeech's speaker
verification model), written from its variables file with plain ``torch``
operations, TF32 off, and nothing of the port.

The equations (WavLM: Chen et al., arXiv:2110.13900, at
``huggingface.co/microsoft/wavlm-large``'s widths; the head: UniSpeech's
``ECAPA_TDNN_SMALL``):

1. the clip layer-normalized over its samples (no affine, ε 1e-5);
2. for each of the seven convolutions: Conv1d (stride, no padding, no bias)
   → LayerNorm over the channels (affine) → GELU (erf);
3. LayerNorm → Linear 512 → D;
4. x + GELU(Conv1d(x; kernel K, padding K/2, G groups) without its last
   frame);
5. each layer: h = LN₁(x); per head, scores s_ij = q_i·k_j/√d_h +
   g_i·r[bucket(j − i)] with r the (buckets, H) table of layer 0 and
   bucket(n) = 160·[n > 0] + (|n| if |n| < 80 else min(80 + ⌊ln(|n|/80) /
   ln(10)·80⌋, 159)) (for 320 buckets and distance 800), g_i = a·(b·c − 1)
   + 2 where (a, b) = sigmoid of the sums of the first and last four outputs
   of Linear(64 → 8) of the head's slice of h_i; x += O·softmax(s)·V;
   x += W₂·GELU(W₁·LN₂(x));
6. the softmax-weighted sum of the 25 states (step 4's output and each
   layer's), instance norm over time per channel (ε 1e-5), then ECAPA-TDNN:
   stem TDNN (k 5); three SE-Res2 blocks (dilations 2, 3, 4), block i + 1
   fed the sum of the stem's and every earlier block's output, each block's
   output its residual branch plus its input; the blocks' outputs
   concatenated → 1×1 conv → ReLU; attentive statistics pooling with
   attention over h_t alone (1×1 conv → tanh → 1×1 conv → softmax over
   time per channel), weighted mean and std (sqrt(max(var, 1e-5))) →
   BatchNorm → Linear → L2.

Departures from the sources, as the port serves the model: the position
convolution's weight norm folded into its stored weight; the Res2 split
order of the port's variables (split 0 passes through, split i ≥ 1 is
convolved after adding split i − 1's output; UniSpeech passes its last
split, a rotation of the block's channels); the std floor 1e-5 (UniSpeech
1e-9).  Each clip is computed over its own samples alone, so no mask
enters.  ``quant`` rounds the operands of every product (the control).
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def _no_tf32():
    flags = torch.backends.cuda.matmul, torch.backends.cudnn
    before = [f.allow_tf32 for f in flags]
    for f in flags:
        f.allow_tf32 = False
    try:
        yield
    finally:
        for f, v in zip(flags, before):
            f.allow_tf32 = v


def bucket(n: torch.Tensor, num_buckets: int = 320, max_distance: int = 800) -> torch.Tensor:
    """WavLM's bidirectional relative-position bucket of key − query
    offsets ``n`` (any integer tensor), in float64 logarithms."""
    side = num_buckets // 2
    exact = side // 2
    m = n.abs().to(torch.int64)
    far = exact + torch.floor(torch.log(m.double().clamp(min=1) / exact)
                              / math.log(max_distance / exact) * (side - exact)).to(torch.int64)
    near = torch.where(m < exact, m, torch.clamp(far, max=side - 1))
    return near + side * (n > 0).to(torch.int64)


class WavLMEcapa:
    def __init__(self, tree: dict, model: dict, device, quant=None):
        dev = torch.device(device)
        self.p = _to_torch(tree["params"], dev)
        self.s = _to_torch(tree.get("batch_stats", {}), dev)
        self.m = model
        self.q = quant or (lambda x: x)
        self.eps = model["layer_norm_eps"]

    def _dense(self, x, p):
        return self.q(x) @ self.q(p["kernel"]) + p["bias"]

    def _conv(self, x, p, **kw):
        w = p["kernel"].permute(2, 1, 0)  # (k, in, out) → (out, in, k)
        return F.conv1d(self.q(x), self.q(w), p.get("bias"), **kw)

    def _ln(self, x, p):
        mean = x.mean(-1, keepdim=True)
        var = (x - mean).square().mean(-1, keepdim=True)
        return (x - mean) / torch.sqrt(var + self.eps) * p["scale"] + p["bias"]

    @staticmethod
    def _bn(x, p, s):
        shape = (1, -1) + (1,) * (x.dim() - 2)
        inv = torch.rsqrt(s["var"] + 1e-5) * p["scale"]
        return (x - s["mean"].view(shape)) * inv.view(shape) + p["bias"].view(shape)

    def _layer(self, x, p, table, offsets):
        m = self.m
        b, t, d = x.shape
        nh = m["num_attention_heads"]
        dh = d // nh
        h = self._ln(x, p["ln1"])

        def heads(y):
            return y.view(b, t, nh, dh).transpose(1, 2)  # (B, H, T, dh)

        q, k, v = (heads(self._dense(h, p[n])) for n in ("q", "k", "v"))
        z = self._dense(heads(h), p["gate"])  # (B, H, T, 8)
        half = z.shape[-1] // 2
        a = torch.sigmoid(z[..., :half].sum(-1))
        c = torch.sigmoid(z[..., half:].sum(-1))
        gate = a * (c * p["gate_const"][None, :, None] - 1.0) + 2.0  # (B, H, T)
        rel = table[bucket(offsets, m["num_buckets"], m["max_bucket_distance"])]  # (T, T, H)
        scores = self.q(q) @ self.q(k).transpose(-1, -2) / math.sqrt(dh)
        scores = scores + gate[..., None] * rel.permute(2, 0, 1)[None]
        att = torch.softmax(scores, dim=-1)
        o = (self.q(att) @ self.q(v)).transpose(1, 2).reshape(b, t, d)
        x = x + self._dense(o, p["o"])
        f = F.gelu(self._dense(self._ln(x, p["ln2"]), p["fc1"]))
        return x + self._dense(f, p["fc2"])

    def _encode(self, wav):
        p, m = self.p, self.m
        mean = wav.mean(1, keepdim=True)
        var = (wav - mean).square().mean(1, keepdim=True)
        x = ((wav - mean) / torch.sqrt(var + self.eps))[:, None, :]
        for i, s in enumerate(m["conv_stride"]):
            y = self._conv(x, p[f"conv{i}"], stride=s)
            x = F.gelu(self._ln(y.transpose(1, 2), p[f"conv{i}_norm"])).transpose(1, 2)
        x = self._dense(self._ln(x.transpose(1, 2), p["proj_norm"]), p["proj"])
        kk = m["num_conv_pos_embeddings"]
        pos = self._conv(x.transpose(1, 2), p["pos_conv"], padding=kk // 2,
                         groups=m["num_conv_pos_embedding_groups"])
        x = x + F.gelu(pos[..., :-1]).transpose(1, 2)
        w = torch.softmax(p["mix"]["scale"], dim=0)
        t = x.shape[1]
        at = torch.arange(t, device=x.device)
        offsets = at[None, :] - at[:, None]
        table = p["layers"]["0"]["rel_table"]
        total = w[0] * x
        for i in range(m["num_hidden_layers"]):
            x = self._layer(x, p["layers"][str(i)], table, offsets)
            total = total + w[i + 1] * x
        return total  # (B, T, D)

    def _tdnn(self, x, p, s, dilation=1):
        k = p["conv"]["kernel"].shape[0]
        y = self._conv(x, p["conv"], padding=dilation * (k - 1) // 2, dilation=dilation)
        return self._bn(torch.relu(y), p["bn"], s["bn"])

    def _block(self, x, p, s, dilation):
        res = x
        x = self._tdnn(x, p["tdnn_in"], s["tdnn_in"])
        xs = torch.chunk(x, self.m["scale"], dim=1)
        outs, prev = [xs[0]], None
        for i in range(1, self.m["scale"]):
            inp = xs[i] if prev is None else xs[i] + prev
            prev = self._tdnn(inp, {"conv": p["res2"][f"conv{i}"], "bn": p["res2"][f"bn{i}"]},
                              {"bn": s["res2"][f"bn{i}"]}, dilation)
            outs.append(prev)
        x = self._tdnn(torch.cat(outs, dim=1), p["tdnn_out"], s["tdnn_out"])
        z = torch.sigmoid(self._dense(torch.relu(self._dense(x.mean(dim=2), p["se"]["fc1"])),
                                      p["se"]["fc2"]))
        return x * z[:, :, None] + res

    def _pooled(self, feats):
        """The head up to its attentive statistics: (B, 2·MFA), before the
        last BatchNorm."""
        p, s = self.p["head"], self.s["head"]
        x = self._tdnn(feats.transpose(1, 2), p["stem"], s["stem"])
        total, outs = x, []
        for i, d in enumerate(self.m["dilations"]):
            out = self._block(total, p[f"block{i + 1}"], s[f"block{i + 1}"], d)
            outs.append(out)
            total = total + out
        x = torch.relu(self._conv(torch.cat(outs, dim=1), p["mfa"]))
        a = self._conv(torch.tanh(self._conv(x, p["asp"]["att1"])), p["asp"]["att2"])
        w = torch.softmax(a, dim=2)
        mu = (w * x).sum(dim=2)
        sd = torch.sqrt(torch.clamp((w * x * x).sum(dim=2) - mu * mu, min=1e-5))
        return torch.cat([mu, sd], dim=1)

    @torch.no_grad()
    def pooled(self, wav: torch.Tensor) -> torch.Tensor:
        """(B, n) clips, every sample valid → (B, 2·MFA) pooled statistics."""
        with _no_tf32():
            h = self._encode(wav.float())
            mean = h.mean(1, keepdim=True)
            var = (h - mean).square().mean(1, keepdim=True)
            return self._pooled((h - mean) / torch.sqrt(var + 1e-5))

    @torch.no_grad()
    def __call__(self, wav: torch.Tensor) -> torch.Tensor:
        """(B, n) clips, every sample valid → (B, emb_dim) unit embeddings."""
        p, s = self.p["head"], self.s["head"]
        with _no_tf32():
            e = self._dense(self._bn(self.pooled(wav), p["asp_bn"], s["asp_bn"]), p["embedding"])
            return e / torch.clamp(torch.linalg.norm(e, dim=1, keepdim=True), min=1e-12)


def _to_torch(tree: dict, dev) -> dict:
    return {k: _to_torch(v, dev) if isinstance(v, dict)
            else torch.tensor(v, dtype=torch.float32, device=dev) for k, v in tree.items()}
