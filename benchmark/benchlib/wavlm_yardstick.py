"""Work counts of the WavLM + ECAPA configuration, for its per-layer metrics:
the whole model's analytic FLOPs per clip (products only: convolutions,
dense layers, the attention's two products; elementwise work left out), and
the gated-bias attention's own operations and bytes per launch (the peaks
are ``yardstick.py``'s)."""

from __future__ import annotations


def frames(n: int, m: dict) -> list[int]:
    """Frames after each of the CNN's convolutions for an n-sample clip."""
    out = []
    for k, s in zip(m["conv_kernel"], m["conv_stride"]):
        n = (n - k) // s + 1
        out.append(n)
    return out


def flops_per_clip(m: dict, n: int) -> float:
    """Multiply-adds × 2 of one n-sample clip through the model, padded
    frames included (the card computes them)."""
    ts = frames(n, m)
    t, d = ts[-1], m["hidden_size"]
    f, cin = 0.0, 1
    for ti, c, k in zip(ts, m["conv_dim"], m["conv_kernel"]):
        f += ti * c * cin * k
        cin = c
    f += t * cin * d  # projection
    f += t * d * (d // m["num_conv_pos_embedding_groups"]) * m["num_conv_pos_embeddings"]
    per_layer = (4 * t * d * d + 2 * t * d * m["intermediate_size"]  # q, k, v, o; the FFN
                 + t * d * m["gate_dim"]                              # the gates
                 + 2 * t * t * d)                                     # QKᵀ and AV
    f += m["num_hidden_layers"] * per_layer
    f += ecapa_head_macs(m, t)
    return 2.0 * f


def ecapa_head_macs(m: dict, t: int) -> float:
    """Multiply-adds of UniSpeech's ECAPA head over t frames (attention over
    h_t alone)."""
    c, s, mfa, att = m["channels"], m["scale"], m["mfa_channels"], m["attention_channels"]
    w = c // s
    f = t * 5 * m["hidden_size"] * c
    for _ in m["dilations"]:
        f += 2 * t * c * c + (s - 1) * t * 3 * w * w + 2 * c * m["se_bottleneck"]
    f += t * len(m["dilations"]) * c * mfa
    f += 2 * t * mfa * att
    f += 2 * mfa * m["emb_dim"]
    return float(f)


def attention_work(b: int, t: int, m: dict) -> tuple[float, float]:
    """(bytes, operations) of one layer's gated-bias attention on (b, t):
    q, k, v and o once each in bf16, the (b, H, t) gates and the table once;
    QKᵀ and AV.  The materialised (b, H, t, t) bias is not counted, so a
    kernel that builds it in place reads the same work."""
    d, heads = m["hidden_size"], m["num_attention_heads"]
    nbytes = 2 * (4 * b * t * d + b * heads * t + m["num_buckets"] * heads)
    flops = 2 * 2 * b * t * t * d
    return float(nbytes), float(flops)


# name fragments of the kernels that run the attention with a float mask:
# ``F.scaled_dot_product_attention``'s cuDNN kernel (its choice on the H100,
# ``cudnn_generated_fort_native_sdpa_sm90_flash_fprop_...``), its
# memory-efficient one, a flash kernel
ATTENTION_KERNELS = ("native_sdpa", "fmha_cutlassF", "flash_fwd")
