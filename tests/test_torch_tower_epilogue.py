"""The tower's serving route (models/ecapa.py) and its epilogue's plain
version (ops/tower_epilogue.py) on the CPU.

The plain epilogue is what the CUDA kernel computes; here it stands in for
the kernel (``SERVING_DEVICES`` widened to the CPU), so the serving route's
plumbing (the serving copies, the Res2 slices and next-split sums, the MFA
and attention epilogues) is held to the eager route bit for bit.  Without
that, the CPU, train mode, a tensor-parallel split and f32 take the eager
route.  The kernel itself is held to the plain version on the card
(``test_torch_kernels_cuda.py``)."""

from __future__ import annotations

import pytest
import torch

from sdtk_tpu_torch.models import ecapa
from sdtk_tpu_torch.models.ecapa import (BatchNorm, EcapaConfig, EcapaTdnn, Res2Conv, TdnnBlock,
                                         prepare_serving)
from sdtk_tpu_torch.models.xvector import XVector, XVectorConfig
from sdtk_tpu_torch.ops.tower_epilogue import bn_affine, tower_epilogue, tower_epilogue_plain
from sdtk_tpu_torch.utils import profiling

BF16 = torch.bfloat16
C512 = dict(channels=64, mfa_channels=192, se_bottleneck=16, attention_channels=16)
C1024 = dict(C512, mfa_bn=True, asp_tdnn=True)


@pytest.fixture()
def serve_on_cpu(monkeypatch):
    """The serving route on the CPU, the plain epilogue in the kernel's
    place."""
    monkeypatch.setattr(ecapa, "SERVING_DEVICES", ("cuda", "cpu"))


@pytest.fixture()
def counted(monkeypatch):
    monkeypatch.setenv("SDTK_PROFILE", "1")
    profiling.reset()
    yield profiling.counters
    profiling.reset()


def _mask(b, t, seed=0):
    """Ragged lengths, one row with no valid frame."""
    g = torch.Generator().manual_seed(seed)
    lengths = torch.randint(1, t + 1, (b,), generator=g)
    lengths[0], lengths[-1] = t, 0
    return torch.arange(t)[None, :] < lengths[:, None]


def _randomize(model: torch.nn.Module, seed: int = 0) -> torch.nn.Module:
    """Random weights and BatchNorm statistics, so no BatchNorm is the
    identity."""
    g = torch.Generator().manual_seed(seed)
    model.reset_parameters(g)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, BatchNorm):
                c = mod.weight.shape[0]
                mod.running_mean.copy_(0.3 * torch.randn(c, generator=g))
                mod.running_var.copy_(torch.rand(c, generator=g) + 0.2)
                mod.weight.copy_(1 + 0.2 * torch.randn(c, generator=g))
                mod.bias.copy_(0.2 * torch.randn(c, generator=g))
    return model.eval()


def _bn(c, seed):
    return _randomize_bn(BatchNorm(c), seed)


def _randomize_bn(bn, seed):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        c = bn.weight.shape[0]
        bn.running_mean.copy_(2 * torch.randn(c, generator=g))
        bn.running_var.copy_(3 * torch.rand(c, generator=g) + 1e-3)
        bn.weight.copy_(torch.randn(c, generator=g))
        bn.bias.copy_(torch.randn(c, generator=g))
    return bn.eval()


# The eager chain after a convolution: relu in bf16, f32 BatchNorm, the
# cast back, the float mask cast to bf16 and multiplied; against the plain
# epilogue on the BatchNorm's (scale, shift), to the bit.
@pytest.mark.parametrize("b,c,t", [(4, 64, 298), (3, 48, 301), (5, 16, 98), (2, 8, 7), (2, 1536, 19)])
@pytest.mark.parametrize("with_bn", [True, False])
@pytest.mark.parametrize("with_mask", [True, False])
def test_plain_epilogue_is_the_eager_chain(b, c, t, with_bn, with_mask):
    g = torch.Generator().manual_seed(b * c + t)
    y = (3 * torch.randn(b, c, t, generator=g)).to(BF16)
    bn = _bn(c, t) if with_bn else None
    mask = _mask(b, t, c) if with_mask else None
    want = torch.relu(y)
    if bn is not None:
        want = bn(want).to(BF16)
    if mask is not None:
        want = want * mask[:, None, :].float().to(BF16)
    scale, shift = bn.serving_affine() if bn is not None else (None, None)
    got = tower_epilogue_plain(y, mask, scale, shift)
    assert got.dtype == BF16 and torch.equal(got, want)
    if mask is not None:
        assert not got[~mask[:, None, :].expand_as(got)].any()
    # the dispatcher takes the plain version for a CPU tensor
    assert torch.equal(tower_epilogue(y, mask, scale, shift), want)


def test_plain_epilogue_writes_a_slice_and_the_next_sum():
    """A Res2 split: its output into a channel slice of a wider buffer and
    the next split's input, add + out, rounded as bf16's add."""
    b, w, t = 3, 8, 50
    g = torch.Generator().manual_seed(1)
    x = torch.randn(b, 4 * w, t, generator=g).to(BF16)
    y = torch.randn(b, w, t, generator=g).to(BF16)
    bn, mask = _bn(w, 2), _mask(b, t)
    buf = torch.full_like(x, 7.0)
    out, nxt = tower_epilogue_plain(y, mask, *bn.serving_affine(), out=buf[:, w : 2 * w],
                                    add=x[:, 2 * w : 3 * w])
    want = bn(torch.relu(y)).to(BF16) * mask[:, None, :].float().to(BF16)
    assert out.data_ptr() == buf[:, w:].data_ptr() and torch.equal(buf[:, w : 2 * w], want)
    assert torch.equal(nxt, x[:, 2 * w : 3 * w] + want)
    assert (buf[:, :w] == 7).all() and (buf[:, 2 * w :] == 7).all()


def test_bn_affine_is_cpu_batch_norm():
    """(scale, shift) applied as one f32 fma give F.batch_norm's bits."""
    bn = _bn(32, 5)
    x = 4 * torch.randn(6, 32, 41, generator=torch.Generator().manual_seed(3))
    scale, shift = bn_affine(bn.running_mean, bn.running_var, bn.weight, bn.bias, bn.eps)
    fma = (x.double() * scale.double()[:, None] + shift.double()[:, None]).float()
    assert scale.dtype == shift.dtype == torch.float32
    assert torch.equal(fma, bn(x))


@pytest.mark.parametrize("block", ["tdnn", "res2"])
def test_serving_blocks_equal_eager(serve_on_cpu, block):
    b, c, t = 3, 64, 37
    mod = TdnnBlock(c, c, 3, 2) if block == "tdnn" else Res2Conv(c, 3, 2, 8)
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for p in mod.parameters():
            p.copy_(0.2 * torch.randn(p.shape, generator=g))
        for i, bn in enumerate(m for m in mod.modules() if isinstance(m, BatchNorm)):
            _randomize_bn(bn, i)
    mod.eval()
    mask = _mask(b, t, 9)
    m = mask[:, None, :].float()
    x = (torch.randn(b, c, t, generator=g).to(BF16) * m.to(BF16))
    want = mod(x, m, BF16, mask)  # autograd on: the eager route
    with torch.no_grad():
        got = mod(x, m, BF16, mask)
    assert torch.equal(got, want)


def _towers():
    return {"c512": lambda: EcapaTdnn(EcapaConfig(**C512)),
            "c1024": lambda: EcapaTdnn(EcapaConfig(**C1024)),
            "xvector": lambda: XVector(XVectorConfig(channels=32, pre_pool_channels=48,
                                                     emb_dim=24))}


def _feats(b=5, t=41, seed=0):
    return torch.randn(b, t, 80, generator=torch.Generator().manual_seed(seed)), _mask(b, t, seed)


@pytest.mark.parametrize("name", ["c512", "c1024", "xvector"])
def test_serving_tower_equals_eager(serve_on_cpu, counted, name):
    model = _randomize(_towers()[name]())
    feats, mask = _feats()
    want = model(feats, mask)  # autograd on: eager
    eager = counted()
    profiling.reset()
    with torch.inference_mode():
        got = model(feats, mask)
    fused = counted()
    assert torch.equal(got, want.detach())
    assert eager["tower.epilogues"] == fused["tower.epilogues"] == fused["tower.fused_epilogues"]
    assert "tower.fused_epilogues" not in eager


def _analytic_epilogues(model) -> int:
    """Stem, each block's two TDNNs and scale − 1 splits, the MFA, and
    SpeechBrain's attention TDNN; the x-vector's five TDNNs."""
    if isinstance(model, XVector):
        return 5
    cfg = model.cfg
    return 1 + len(cfg.dilations) * (2 + cfg.scale - 1) + 1 + int(cfg.asp_tdnn)


@pytest.mark.parametrize("name,count", [("c512", 29), ("c1024", 30), ("xvector", 5)])
def test_epilogue_counters_on_the_cpu(counted, name, count):
    """The CPU takes the eager route: every epilogue counted, none fused."""
    model = _randomize(_towers()[name]())
    assert _analytic_epilogues(model) == count
    feats, mask = _feats()
    with torch.inference_mode():
        model(feats, mask)
    assert counted().get("tower.epilogues") == count
    assert counted().get("tower.fused_epilogues", 0) == 0


def test_counters_count_only_while_profiling(monkeypatch):
    monkeypatch.delenv("SDTK_PROFILE", raising=False)
    profiling.reset()
    model = _randomize(_towers()["c512"]())
    with torch.inference_mode():
        model(*_feats())
    assert profiling.counters() == {}


def test_route_is_eager_on_the_cpu_in_train_mode_with_tp_and_at_f32(serve_on_cpu, monkeypatch):
    conv = ecapa.Conv(8, 8, 3).eval()
    x = torch.zeros(2, 8, 5)
    with torch.no_grad():
        assert ecapa.serving(conv, x, BF16)
        assert not ecapa.serving(conv, x, torch.float32)
        conv.train()
        assert not ecapa.serving(conv, x, BF16)
        conv.eval()
        conv.tp = object()
        assert not ecapa.serving(conv, x, BF16)
        conv.tp = None
    assert not ecapa.serving(conv, x, BF16)  # autograd on
    monkeypatch.setattr(ecapa, "SERVING_DEVICES", ("cuda",))
    with torch.no_grad():
        assert not ecapa.serving(conv, x, BF16)


def test_train_mode_and_f32_count_no_fused_epilogue(serve_on_cpu, counted):
    model = _randomize(_towers()["c512"]())
    feats, mask = _feats()
    with torch.no_grad():
        model.train()(feats, mask)
        EcapaTdnn(EcapaConfig(dtype="float32", **C512)).eval()(feats, mask)
    assert counted()["tower.epilogues"] == 58
    assert "tower.fused_epilogues" not in counted()


def test_serving_copies_follow_new_weights(serve_on_cpu):
    """load_state_dict, an in-place update, .train() and .to() after the
    serving copies were built: the next serving forward gives the new
    weights' eager result."""
    model = _randomize(_towers()["c1024"](), seed=1)
    prepare_serving(model)
    feats, mask = _feats(seed=2)
    with torch.no_grad():
        first = model(feats, mask)
    other = _randomize(_towers()["c1024"](), seed=3)
    model.load_state_dict(other.state_dict())
    with torch.no_grad():
        got = model(feats, mask)
        want = other.train().eval()(feats, mask)
        assert not torch.equal(got, first) and torch.equal(got, want)
        for p in model.parameters():
            p.mul_(1.01)  # as an optimizer step writes them
        for p in other.parameters():
            p.mul_(1.01)
    want = other(feats, mask)  # autograd on: eager
    with torch.no_grad():
        assert torch.equal(model(feats, mask), want)
        model.train()(feats, mask)  # moves the running statistics
        model.eval()
        want = model(feats, mask)
    assert torch.equal(model(feats, mask), want)  # eager vs the copies rebuilt above
    model.to(torch.float64).to(torch.float32)  # new storage
    with torch.no_grad():
        assert torch.equal(model(feats, mask), want)


def test_state_dict_keys_are_unchanged():
    model = _randomize(_towers()["c512"]())
    keys = list(model.state_dict())
    prepare_serving(model)
    with torch.no_grad():
        model(*_feats())
    assert list(model.state_dict()) == keys
    EcapaTdnn(EcapaConfig(**C512)).load_state_dict(model.state_dict())
