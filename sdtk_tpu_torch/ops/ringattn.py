"""Sequence-parallel (ring) attention and the time-sharded Conformer forward.

The counterpart of ``sdtk_tpu/ops/ringattn.py``.  The JAX package shards
the time axis over a mesh axis inside ``shard_map``; here each rank of a
``torch.distributed`` group holds one contiguous block of the sequence
(``parallel/multihost.py``), every block the same length, and the blocks
travel the ring by :func:`multihost.ring_shift`.  Without a group, or in a
group of one rank, the same code runs on the whole sequence.

- :func:`ring_attention` — full (non-causal) attention over one long
  sequence.  K/V blocks (and their mask) rotate around the ring while each
  rank keeps a streaming-softmax accumulator (running max, denominator,
  numerator), so no rank holds the (T, T) score matrix.  Inside a hop the
  rank's queries go in blocks of ``Q_BLOCK`` rows: the JAX function
  materializes the (T_loc, H, T_loc) logits of a hop at once, which at an
  hour on one rank cannot fit; the blocks compute the same function, each
  query row's accumulator being its own.
- :func:`conformer_sp_embed` — the whole tower of ``models/conformer.py``
  evaluated time-sharded from the module's own parameters: pointwise
  pieces run locally, the depthwise conv exchanges (kernel − 1)/2 halo
  frames with both neighbours (zeros at the sequence ends, flax's SAME
  padding), attention uses the ring, and attentive-stats pooling reduces
  with ``all_reduce_sum`` / ``all_reduce_max``.  Inference mode (BatchNorm
  on its running statistics), float32 math, and LayerNorm with the
  two-pass variance, as the JAX function computes them.

:func:`time_shard` cuts this rank's block out of a whole sequence; the
length must divide evenly over the ranks, as ``shard_map`` requires.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..parallel.multihost import all_reduce_max, all_reduce_sum, rank_and_world, ring_shift

_NEG = -1e30
Q_BLOCK = 1024  # query rows per block inside a hop


def time_shard(x: torch.Tensor) -> torch.Tensor:
    """This rank's contiguous block of ``x`` along dim 0; raises unless the
    length divides evenly over the ranks."""
    rank, world = rank_and_world()
    t = x.shape[0]
    if t % world:
        raise ValueError(f"sequence length {t} does not divide over {world} ranks")
    n = t // world
    return x[rank * n : (rank + 1) * n]


def _check_even(t_loc: int, device: torch.device) -> None:
    """Every rank must hold a block of the same length (the ring sends
    blocks of one shape)."""
    if rank_and_world()[1] == 1:
        return
    ext = all_reduce_max(torch.tensor([t_loc, -t_loc], dtype=torch.float32, device=device))
    if ext[0] != -ext[1]:
        raise ValueError(f"ranks hold blocks of {int(-ext[1])} to {int(ext[0])} frames; "
                         "the sequence must divide evenly over the ranks")


def _ring_attention_local(q, k, v, mask):
    """q/k/v (T_loc, H, Dh) f32 and this rank's (T_loc,) bool mask →
    (T_loc, H, Dh).  Non-causal, so the ring's order does not matter."""
    t_loc, h, dh = q.shape
    q = q / torch.sqrt(torch.tensor(float(dh), dtype=q.dtype, device=q.device))
    m = torch.full((t_loc, h), _NEG, dtype=q.dtype, device=q.device)  # running max
    l = torch.zeros((t_loc, h), dtype=q.dtype, device=q.device)  # running denominator
    o = torch.zeros_like(q)  # running numerator
    world = rank_and_world()[1]
    # K, V and the mask travel as one message a hop
    block = torch.cat([k.reshape(t_loc, -1), v.reshape(t_loc, -1),
                       mask[:, None].to(q.dtype)], dim=1)
    for hop in range(world):
        k_cur = block[:, : h * dh].view(t_loc, h, dh)
        v_cur = block[:, h * dh : 2 * h * dh].view(t_loc, h, dh)
        valid = block[:, -1] > 0
        for s in range(0, t_loc, Q_BLOCK):
            rows = slice(s, s + Q_BLOCK)
            logits = torch.einsum("thd,shd->ths", q[rows], k_cur)
            logits = logits.masked_fill(~valid, _NEG)
            m_new = torch.maximum(m[rows], logits.amax(dim=-1))
            scale = torch.exp(m[rows] - m_new)
            p = torch.exp(logits - m_new[..., None]).masked_fill(~valid, 0.0)
            l[rows] = l[rows] * scale + p.sum(dim=-1)
            o[rows] = o[rows] * scale[..., None] + torch.einsum("ths,shd->thd", p, v_cur)
            m[rows] = m_new
        if hop < world - 1:
            block = ring_shift(block)
    return o / torch.clamp(l, min=1e-30)[..., None]


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor
                   ) -> torch.Tensor:
    """This rank's block of q/k/v (T_loc, H, Dh) and of the (T_loc,) key
    mask → its block of the attention output (T_loc, H, Dh), float32:
    softmax(q·kᵀ/√Dh) over the whole sequence's valid keys, times v."""
    _check_even(q.shape[0], q.device)
    f = torch.float32
    return _ring_attention_local(q.to(f), k.to(f), v.to(f), mask.bool())


def _halo_extend(x: torch.Tensor, halo: int) -> torch.Tensor:
    """(T_loc, C) → (T_loc + 2·halo, C): the left neighbour's tail, the
    block, the right neighbour's head; zeros beyond the sequence's ends."""
    rank, world = rank_and_world()
    left = ring_shift(x[-halo:].contiguous(), 1)
    right = ring_shift(x[:halo].contiguous(), -1)
    if rank == 0:
        left = torch.zeros_like(left)
    if rank == world - 1:
        right = torch.zeros_like(right)
    return torch.cat([left, x, right], dim=0)


def _ln(x: torch.Tensor, ln) -> torch.Tensor:
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + 1e-6) * ln.weight + ln.bias


def _dense(x: torch.Tensor, d) -> torch.Tensor:
    return F.linear(x, d.weight, d.bias)


def _ff(x: torch.Tensor, ff) -> torch.Tensor:
    return _dense(F.silu(_dense(_ln(x, ff.LayerNorm_0), ff.Dense_0)), ff.Dense_1)


@torch.no_grad()
def conformer_sp_embed(model, feats: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The time-sharded Conformer forward: this rank's block of the
    features (T_loc, n_mels) and of the (T_loc,) mask → the (emb_dim,)
    embedding of the whole sequence, the same on every rank.  ``model`` is
    a ``models.conformer.Conformer`` on the features' device; its
    parameters are read in float32 whatever its compute dtype."""
    cfg = model.cfg
    t_loc = feats.shape[0]
    halo = (cfg.conv_kernel - 1) // 2
    _check_even(t_loc, feats.device)
    if t_loc < halo:
        raise ValueError(f"a rank's block of {t_loc} frames is shorter than the conv halo {halo}")
    mask = mask.bool()
    mf = mask[:, None].float()
    x = _dense(feats.float(), model.input_proj) * mf
    heads, dh = cfg.n_heads, cfg.dim // cfg.n_heads

    for i in range(cfg.n_blocks):
        blk = getattr(model, f"block{i}")
        x = x + 0.5 * _ff(x, blk.ff1)

        att = blk.mhsa.MultiHeadDotProductAttention_0
        h = _ln(x, blk.mhsa.LayerNorm_0)
        q, k, v = (_dense(h, getattr(att, n)).view(t_loc, heads, dh)
                   for n in ("query", "key", "value"))
        o = _ring_attention_local(q, k, v, mask)
        x = x + _dense(o.reshape(t_loc, cfg.dim), att.out)

        cm = blk.conv
        a, g = _dense(_ln(x, cm.LayerNorm_0), cm.Dense_0).chunk(2, dim=-1)
        h = _halo_extend(a * torch.sigmoid(g) * mf, halo)  # (T_loc + 2·halo, C)
        dw = cm.depthwise
        out = F.conv1d(h.T[None], dw.weight, dw.bias, groups=cfg.dim)[0].T
        bn = cm.BatchNorm_0
        out = (out - bn.running_mean) / torch.sqrt(bn.running_var + 1e-5) * bn.weight + bn.bias
        x = x + _dense(F.silu(out), cm.Dense_1) * mf

        x = x + 0.5 * _ff(x, blk.ff2)
        x = _ln(x, blk.final_norm) * mf

    # attentive-stats pooling, its sums over the whole sequence
    sums = all_reduce_sum(torch.cat([mf.sum(0), (x * mf).sum(0), (x * x * mf).sum(0)]))
    c = cfg.dim
    cnt = torch.clamp(sums[0], min=1.0)
    mean = sums[1 : c + 1] / cnt
    std = torch.sqrt(torch.clamp(sums[c + 1 :] / cnt - mean * mean, min=1e-5))
    ctx = torch.cat([x, mean.expand(t_loc, c), std.expand(t_loc, c)], dim=-1)
    asp = model.asp
    a1 = torch.tanh(F.linear(ctx, asp.att1.weight[:, :, 0], asp.att1.bias))
    a2 = F.linear(a1, asp.att2.weight[:, :, 0], asp.att2.bias)
    a2 = a2.masked_fill(~mask[:, None], -1e9)
    g_max = all_reduce_max(a2.amax(dim=0))  # per-channel softmax over all time
    e = torch.exp(a2 - g_max) * mf
    red = all_reduce_sum(torch.cat([e.sum(0), (e * x).sum(0), (e * x * x).sum(0)]))
    denom = torch.clamp(red[:c], min=1e-30)
    mu = red[c : 2 * c] / denom
    var = red[2 * c :] / denom - mu * mu
    pooled = torch.cat([mu, torch.sqrt(torch.clamp(var, min=1e-5))])
    return _dense(pooled, model.embedding)
