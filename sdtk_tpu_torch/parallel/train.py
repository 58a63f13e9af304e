"""Speaker-embedding training step: AAM-softmax over the tower, AdamW.

The counterpart of ``sdtk_tpu/parallel/train.py``.  The tower runs in
train mode (BatchNorm on batch statistics, see
``models/ecapa.py:BatchNorm``), an additive-angular-margin (ArcFace)
softmax head scores its embeddings against one weight row per class,
and :class:`AdamW` updates the tower's parameters and the head, all of
them decayed, in ``optax.adamw``'s arithmetic (no mask).  BatchNorm's
running statistics are buffers, moved by the forward pass.

Data parallel (the JAX step over a ``data`` mesh): each rank of a
``torch.distributed`` group holds an equal share of the global batch.
:func:`sync_batchnorm` makes BatchNorm's statistics the global batch's,
the loss is the global mean (each rank's mean, summed over the ranks
and divided by their number), and so is the gradient: each rank's is
summed by one all-reduce and scaled by 1 / world.  AdamW then runs
replicated on equal gradients, so the ranks' parameters stay equal.
Without a group the step is the one-device step; in a group of one rank
the collectives run and change nothing.

Data × model (the JAX step over a ``data=D,model=M`` mesh):
:func:`shard_state` keeps on each rank its block of every leaf the rules
split (``parallel/sharding.py``), the AAM head's block of classes when M
divides them, and the optimizer's moments beside them, so each rank
stores and updates 1/M of those leaves.  The batch splits over ``data``
only; the M model ranks of a data row take the same rows.  BatchNorm's
statistics, the gradients, the loss and the accuracy are summed over the
data ranks of a model column, and the head is gathered for the loss.
:func:`make_distributed_step` takes the global batch, as JAX's does.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import torch
import torch.nn.functional as F
from torch import nn

from .mesh import Mesh, make_mesh
from .multihost import all_reduce_sum, in_group
from .sharding import (Sharding, batch_sharding, gather_from, gather_state_dict,
                       param_shardings, shard_params)


@dataclass(frozen=True)
class TrainConfig:
    n_classes: int = 64
    emb_dim: int = 192
    margin: float = 0.2
    scale: float = 30.0
    learning_rate: float = 1e-3
    weight_decay: float = 2e-5


@dataclass
class TrainState:
    model: nn.Module
    aam_weights: nn.Parameter  # (n_classes, emb_dim)
    optimizer: torch.optim.Optimizer
    step: int = 0
    # host and device times of the last train() call (not checkpointed)
    timings: dict = field(default_factory=dict)
    # the mesh of shard_state; None: every rank of the group on ``data``
    mesh: Mesh | None = None
    # state-dict names (and "aam_weights") of the tensors split over ``model``
    shardings: dict[str, Sharding] = field(default_factory=dict)


def aam_softmax_loss(
    emb: torch.Tensor, weights: torch.Tensor, labels: torch.Tensor,
    margin: float, scale: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Additive-angular-margin softmax loss; returns (loss, accuracy).

    JAX's numerics: rows normalized by max(‖x‖, 1e-12); sin = sqrt(max(1 −
    cos², 1e-12)); the margin only where cos > 0 (the easy-margin guard);
    mean softmax cross-entropy; accuracy from the argmax of the unmargined
    cosine."""
    emb_n = emb / torch.clamp(torch.linalg.norm(emb, dim=-1, keepdim=True), min=1e-12)
    w_n = weights / torch.clamp(torch.linalg.norm(weights, dim=-1, keepdim=True), min=1e-12)
    cos = emb_n @ w_n.T  # (B, C)
    sin = torch.sqrt(torch.clamp(1.0 - cos * cos, min=1e-12))
    cos_m = cos * math.cos(margin) - sin * math.sin(margin)
    cos_m = torch.where(cos > 0, cos_m, cos)
    onehot = F.one_hot(labels, weights.shape[0]).to(cos.dtype)
    logits = scale * (onehot * cos_m + (1.0 - onehot) * cos)
    loss = -(onehot * F.log_softmax(logits, dim=-1)).sum(dim=-1).mean()
    acc = (torch.argmax(cos, dim=-1) == labels).float().mean()
    return loss, acc


class AdamW(torch.optim.Optimizer):
    """AdamW in ``optax.adamw``'s arithmetic, on every parameter.

    Per step t: m ← (1 − β1)·g + β1·m, v ← (1 − β2)·g² + β2·v, u = m̂ /
    (√v̂ + ε) with m̂ = m / (1 − β1^t) and v̂ = v / (1 − β2^t), then
    p ← p + (−lr)·(u + wd·p), with one step count t for the group, as
    optax keeps one count for the tree.  ``torch.optim.AdamW`` decays by
    p ← p·(1 − lr·wd) first; at lr·wd = 2e-8 that factor rounds to 1.0 in
    float32, so it would never decay, where optax's decay term shifts the
    update.  Multi-tensor (``torch._foreach_*``) ops keep a step to a few
    launches on the GPU.  A parameter without a gradient is left alone."""

    def __init__(self, params, lr: float = 1e-3, betas: tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 1e-4):
        super().__init__(params, {"lr": lr, "betas": betas, "eps": eps,
                                  "weight_decay": weight_decay, "step": 0})

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise TypeError("AdamW.step takes no closure")
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            (b1, b2), eps, lr, wd = group["betas"], group["eps"], group["lr"], group["weight_decay"]
            for p in params:
                if not self.state[p]:
                    self.state[p]["exp_avg"] = torch.zeros_like(p)
                    self.state[p]["exp_avg_sq"] = torch.zeros_like(p)
            group["step"] += 1
            t = group["step"]
            grads = [p.grad for p in params]
            m = [self.state[p]["exp_avg"] for p in params]
            v = [self.state[p]["exp_avg_sq"] for p in params]
            torch._foreach_mul_(m, b1)
            torch._foreach_add_(m, torch._foreach_mul(grads, 1.0 - b1))
            torch._foreach_mul_(v, b2)
            torch._foreach_add_(v, torch._foreach_mul(torch._foreach_mul(grads, grads), 1.0 - b2))
            f32 = torch.float32
            bc1 = float(1.0 - torch.tensor(b1, dtype=f32) ** t)  # in float32, as optax
            bc2 = float(1.0 - torch.tensor(b2, dtype=f32) ** t)
            denom = torch._foreach_sqrt(torch._foreach_div(v, bc2))
            torch._foreach_add_(denom, eps)
            u = torch._foreach_div(torch._foreach_div(m, bc1), denom)
            torch._foreach_add_(u, torch._foreach_mul(params, wd))
            torch._foreach_mul_(u, -lr)
            torch._foreach_add_(params, u)


def make_optimizer(model: nn.Module, aam_weights: nn.Parameter,
                   cfg: TrainConfig) -> torch.optim.Optimizer:
    return AdamW([*model.parameters(), aam_weights], lr=cfg.learning_rate,
                 betas=(0.9, 0.999), eps=1e-8, weight_decay=cfg.weight_decay)


def create_train_state(model: nn.Module, generator: torch.Generator, cfg: TrainConfig,
                       device: torch.device) -> TrainState:
    """Fresh weights from ``generator`` (the tower's ``reset_parameters``,
    then the AAM head as N(0, 1)·0.01), on ``device``, with a fresh
    optimizer."""
    model.reset_parameters(generator)
    aam = torch.randn((cfg.n_classes, cfg.emb_dim), generator=generator) * 0.01
    model.to(device)
    aam_weights = nn.Parameter(aam.to(device))
    return TrainState(model, aam_weights, make_optimizer(model, aam_weights, cfg))


def sync_batchnorm(model: nn.Module, group=None) -> None:
    """Make every train-mode BatchNorm of ``model`` take the statistics of
    the batch summed over ``group``'s ranks (default: the process
    group's)."""
    from ..models.ecapa import BatchNorm

    for mod in model.modules():
        if isinstance(mod, BatchNorm):
            mod.sync = True
            mod.sync_group = group


def shard_state(state: TrainState, mesh: Mesh) -> TrainState:
    """Place a whole train state on ``mesh``, in place: the tower's leaves
    by the rules, the AAM head by classes when ``mesh.model`` divides them,
    each AdamW moment as its parameter; BatchNorm statistics over the data
    ranks (in a group).  Returns ``state``."""
    model, opt = state.model, state.optimizer
    split = {k: sh for k, sh in param_shardings(model, mesh).items() if sh.spec}
    aam = state.aam_weights
    if mesh.model > 1 and aam.shape[0] % mesh.model == 0:
        split["aam_weights"] = Sharding(mesh, ("model", None))
    params = {**dict(model.named_parameters()), "aam_weights": aam}
    moments = {k: st for k in split if (st := opt.state.get(params[k]))}
    shard_params(model, mesh)
    if "aam_weights" in split:
        aam.data = split["aam_weights"].shard(aam.data).clone()
    for k, st in moments.items():
        for name in ("exp_avg", "exp_avg_sq"):
            st[name] = split[k].shard(st[name]).clone()
    if in_group():
        sync_batchnorm(model, mesh.data_group)
    state.mesh, state.shardings = mesh, split
    return state


def full_state(state: TrainState) -> dict:
    """The whole state as ``parallel/checkpoint.py`` saves it — the step,
    the tower's state dict, the AAM head and the optimizer's state dict —
    with every split tensor gathered (a collective over the model group:
    every rank calls it)."""
    sh = state.shardings
    aam = state.aam_weights.detach()
    opt = state.optimizer.state_dict()
    names = [n for n, _ in state.model.named_parameters()] + ["aam_weights"]
    for i, st in opt["state"].items():
        if names[i] in sh:
            opt["state"][i] = {k: sh[names[i]].gather(v) if torch.is_tensor(v) and v.dim() else v
                               for k, v in st.items()}
    return {"step": state.step,
            "model": {k: v.detach() for k, v in gather_state_dict(state.model, sh).items()},
            "aam_weights": sh["aam_weights"].gather(aam) if "aam_weights" in sh else aam,
            "optimizer": opt}


def _all_reduce_mean_grads(params: list[torch.Tensor], mesh: Mesh) -> None:
    """Every data rank's gradients, summed and divided by their number, in
    one all-reduce of a flat buffer."""
    grads = [p.grad for p in params if p.grad is not None]
    flat = all_reduce_sum(torch.cat([g.reshape(-1) for g in grads]), mesh.data_group)
    flat.mul_(1.0 / mesh.data)
    offset = 0
    for g in grads:
        g.copy_(flat[offset : offset + g.numel()].view_as(g))
        offset += g.numel()


def train_step(state: TrainState, feats: torch.Tensor, mask: torch.Tensor,
               labels: torch.Tensor, cfg: TrainConfig) -> dict[str, torch.Tensor]:
    """One AdamW step on (feats, mask, labels); updates ``state`` in place
    and returns the step's loss and accuracy (device tensors).  In a
    process group the arguments are this rank's share of the global batch,
    and the loss and accuracy returned are the global batch's: in a
    sharded state (:func:`shard_state`) this rank's share is its data
    row's."""
    mesh = state.mesh or make_mesh("")
    state.model.train()
    emb = state.model(feats, mask)
    aam = state.aam_weights
    if "aam_weights" in state.shardings:
        aam = gather_from(aam, 0, mesh)
    loss, acc = aam_softmax_loss(emb, aam, labels, cfg.margin, cfg.scale)
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    loss = loss.detach()
    if in_group():
        _all_reduce_mean_grads([p for g in state.optimizer.param_groups for p in g["params"]],
                               mesh)
        loss, acc = all_reduce_sum(torch.stack([loss, acc]), mesh.data_group) / mesh.data
    state.optimizer.step()
    state.step += 1
    return {"loss": loss, "acc": acc}


def make_distributed_step(mesh: Mesh, cfg: TrainConfig):
    """The step over ``mesh`` on a global batch: each rank takes its data
    row's rows (``batch_sharding``) and steps a state from
    :func:`shard_state` on them."""
    rows = batch_sharding(mesh)

    def run(state: TrainState, feats, mask, labels) -> dict[str, torch.Tensor]:
        return train_step(state, rows.shard(feats), rows.shard(mask), rows.shard(labels), cfg)

    return run
