"""The two-pass algorithm of the port's identify kernel
(``csrc/identify_topk.cu``), spelled out in plain PyTorch in
``sdtk_tpu_torch/ops/topk_fused.py``: the window max with the profile's
inverse norm applied after it (pass A), the top min(k, 512) of each
512-row tile (pass B), and the merge of the survivors.  Held against the
plain version and against the JAX package's ``identify_topk_pallas``
(interpret mode on the CPU) on the same numpy inputs.

Survivor sets must be identical, and sorted scores agree to 1e-5 (f32
products summed in another order, the inverse norm applied later).  Pass
B with the merge is exact: on any m, ties and -inf included, it returns
what one stable sort of m returns."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdtk_tpu.ops.research import topk_pallas
from sdtk_tpu_torch.ops import topk, topk_fused

TILE = topk_fused.TILE


def _inputs(w, n, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((w, d)).astype(np.float32),
            rng.standard_normal((n, d)).astype(np.float32))


def _same(got, want):
    gs, gi = (np.asarray(x) for x in got)
    ws, wi = (np.asarray(x) for x in want)
    assert gs.shape == ws.shape
    assert set(gi.tolist()) == set(wi.tolist())
    np.testing.assert_allclose(np.sort(gs), np.sort(ws), rtol=0, atol=1e-5)
    assert np.all(np.diff(gs) <= 0)


@pytest.mark.parametrize("k", [1, 64, TILE - 1, TILE, 700])
@pytest.mark.parametrize("n", [1, TILE - 1, TILE, TILE + 1, 8193])
def test_two_pass_matches_plain_and_pallas(n, k):
    q, p = _inputs(5, n, 32, n + k)
    p[n // 2] = p[0]  # a tie, across a tile boundary from 1025 rows on
    tq, tp = torch.from_numpy(q), torch.from_numpy(p)
    got = topk_fused.identify_topk_tiles_plain(tq, tp, k)
    assert got[0].shape == (min(k, n),) and got[1].dtype == torch.int64
    _same(got, topk.identify_topk_plain(tq, tp, k))
    _same(got, topk_pallas.identify_topk_pallas(jnp.asarray(q), jnp.asarray(p), k=k,
                                                interpret=True))


@pytest.mark.parametrize("n", [1, TILE - 1, TILE + 1, 3 * TILE + 7])
def test_window_max_applies_the_norm_after_the_max(n):
    """Pass A equals the max of the normalized product, the windows of
    negative cosines included, for f32 and bf16 profiles."""
    q, p = _inputs(9, n, 48, n)
    q[3] = -q[3]
    tq = torch.from_numpy(q)
    for tp in (torch.from_numpy(p), torch.from_numpy(p).bfloat16()):
        want = (topk_fused.rsqrt_normalize(tq) @ topk_fused.rsqrt_normalize(tp).T).amax(0)
        got = topk_fused.window_max_plain(tq, tp)
        assert got.shape == (n,) and got.dtype == torch.float32
        assert float((got - want).abs().max()) <= 1e-6


@pytest.mark.parametrize("k", [1, 3, 64, TILE, 700])
@pytest.mark.parametrize("n", [1, TILE - 1, TILE, TILE + 1, 2 * TILE + 300])
def test_tile_select_and_merge_equal_one_sort(n, k):
    """Ties within and across tiles, real rows at -inf and negative scores:
    pass B's survivors, merged, are exactly the stable top-k of m, and a
    real row at -inf still comes before every padded row."""
    rng = np.random.default_rng(n * 31 + k)
    m = rng.integers(-4, 5, n).astype(np.float32) / 4  # many equal scores
    m[rng.uniform(size=n) < 0.2] = -np.inf
    tm = torch.from_numpy(m)
    s, rows = topk_fused.tile_select_plain(tm, k)
    tiles, kc = -(-n // TILE), min(k, TILE)
    assert s.shape == rows.shape == (tiles, kc)
    assert bool((s[:, :-1] >= s[:, 1:]).all())
    top, pos = topk.select_topk(s.reshape(-1), min(k, n))
    want_s, want_i = topk.select_topk(tm, k)
    assert torch.equal(rows.reshape(-1)[pos], want_i)
    assert torch.equal(top, want_s)
    assert int(rows.reshape(-1)[pos].max()) < n


def test_two_pass_zero_and_negative_rows():
    """A zero profile row scores 0; anti-aligned rows keep their negative
    scores and every returned row is real."""
    rng = np.random.default_rng(3)
    base = rng.standard_normal(192).astype(np.float32)
    p = np.tile(-base, (TILE + 130, 1)) + 0.01 * rng.standard_normal((TILE + 130, 192))
    p = p.astype(np.float32)
    p[7] = 0.0
    q = np.tile(base, (3, 1)) + 0.01 * rng.standard_normal((3, 192)).astype(np.float32)
    s, i = topk_fused.identify_topk_tiles_plain(torch.from_numpy(q), torch.from_numpy(p), 4)
    assert i.tolist()[0] == 7 and float(s[0]) == 0.0
    assert bool((s[1:] < -0.9).all()) and int(i.max()) < TILE + 130


def _tf32(x: np.ndarray) -> np.ndarray:
    """Round f32 to TF32 (10 mantissa bits, to nearest, ties away from zero),
    as ``cvt.rna.tf32.f32`` does."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


@pytest.mark.parametrize("d", [192, 512])
def test_three_tf32_products_are_f32_accurate(d):
    """The kernel's 3xTF32 product: each operand split once into big =
    tf32(x) and small = tf32(x - big), then small·big + big·small + big·big
    summed in f32.  On 10 000 pairs of normalized rows it stays within 2e-6
    of the f64 cosine; one TF32 product alone does not."""
    rng = np.random.default_rng(d)
    a, b = (rng.standard_normal((10_000, d)).astype(np.float32) for _ in range(2))
    a /= np.linalg.norm(a, axis=1, keepdims=True)
    b /= np.linalg.norm(b, axis=1, keepdims=True)
    ab, bb = _tf32(a), _tf32(b)
    as_, bs = _tf32(a - ab), _tf32(b - bb)
    assert np.all(_tf32(ab) == ab) and np.all(np.abs(as_) <= np.abs(a) * 2.0 ** -10)
    three = ((as_ * bb + ab * bs).sum(axis=1, dtype=np.float32)
             + (ab * bb).sum(axis=1, dtype=np.float32))
    exact = (a.astype(np.float64) * b.astype(np.float64)).sum(axis=1)
    assert np.abs(three - exact).max() <= 2e-6
    assert np.abs((ab * bb).sum(axis=1, dtype=np.float32) - exact).max() > 2e-6


def test_bf16_values_are_tf32_already():
    """bf16 profiles widen to f32 values that TF32 holds exactly, so their
    small half is zero and the kernel runs two products, not three."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(10_000).astype(np.float32))
    wide = x.bfloat16().float().numpy()
    assert np.array_equal(_tf32(wide), wide)
