"""The arithmetic of the port's cosine kernel (``csrc/cosine.cu``), spelled
out in NumPy: 32-row query chunks against 32-row profile tiles, the columns
cut into groups of 16 that four warps take in turn (in slabs of 8 groups
when D > 224), each value split into TF32 halves, small·big + big·small +
big·big summed in f32, the four warps' partial products summed, and both
inverse norms, rsqrt(Σx² + 1e-24), applied after the product.  Held
against the plain version (``ops/cosine.py:cosine_plain``) and against the
JAX package's ``cosine_pallas`` (interpret mode on the CPU) on the same
numpy inputs, zero rows on both sides included.

Tolerance 1e-5: the three TF32 products are f32-accurate (within ~2e-6 of
the f64 cosine, last test), and the sums run in another order than in
either reference."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdtk_tpu.ops import cosine as jcos
from sdtk_tpu_torch.ops import cosine

QC = BR = 32          # query rows per chunk; profile rows per tile (one block)
WARPS = 4             # warp w takes column groups w, w + 4, ...
GW = 16               # columns per group
RESIDENT_GROUPS = 14  # D <= 224: one slab, the tile resident
SLAB_GROUPS = 8       # wider rows: slabs of 128 columns


def _tf32(x: np.ndarray) -> np.ndarray:
    """Round f32 to TF32 (10 mantissa bits, to nearest, ties away from zero),
    as ``cvt.rna.tf32.f32`` does."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _pad(x: np.ndarray, rows: int, cols: int) -> np.ndarray:
    out = np.zeros((rows, cols), np.float32)
    out[: x.shape[0], : x.shape[1]] = x
    return out


def cosine_tiles(q: np.ndarray, p: np.ndarray) -> np.ndarray:
    """(Q, D) × (N, D) → (Q, N) f32, as the kernel computes it."""
    nq, d = q.shape
    n = p.shape[0]
    groups = -(-d // GW)
    sg = groups if groups <= RESIDENT_GROUPS else SLAB_GROUPS
    qp = _pad(q, -(-nq // QC) * QC, groups * GW)  # zeros past Q and D
    pp = _pad(p, -(-n // BR) * BR, groups * GW)   # zeros past N and D
    out = np.zeros((qp.shape[0], pp.shape[0]), np.float32)
    for r0 in range(0, pp.shape[0], BR):  # one block
        tile = pp[r0 : r0 + BR]
        inv_p = 1 / np.sqrt((tile * tile).sum(axis=1, dtype=np.float32) + np.float32(1e-24))
        for c0 in range(0, qp.shape[0], QC):  # its query chunks, in turn
            chunk = qp[c0 : c0 + QC]
            partial = np.zeros((WARPS, QC, BR), np.float32)
            for s0 in range(0, groups, sg):  # slabs
                for gl in range(min(sg, groups - s0)):
                    cols = slice((s0 + gl) * GW, (s0 + gl + 1) * GW)
                    a, b = chunk[:, cols], tile[:, cols]
                    ab, bb = _tf32(a), _tf32(b)
                    as_, bs = _tf32(a - ab), _tf32(b - bb)
                    acc = partial[gl % WARPS]
                    acc += as_ @ bb.T
                    acc += ab @ bs.T
                    acc += ab @ bb.T
            inv_q = 1 / np.sqrt((chunk * chunk).sum(axis=1, dtype=np.float32) + np.float32(1e-24))
            total = partial[0] + partial[1] + partial[2] + partial[3]
            out[c0 : c0 + QC, r0 : r0 + BR] = total * inv_q[:, None] * inv_p[None, :]
    return out[:nq, :n]


def _inputs(nq: int, n: int, d: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((nq, d)).astype(np.float32)
    p = rng.standard_normal((n, d)).astype(np.float32)
    q[nq // 2] = 0.0  # a zero row on both sides scores exactly 0
    p[n // 2] = 0.0
    return q, p


# Each Q, N and D of the kernel's branches: a query chunk padded (1, 29),
# whole (32, 64), with a row past it (33, 65) and seven chunks (199); one
# row, a tile less one row, ragged 4 093; D unaligned (7), inside a resident
# tile (100, 192) and in 128-column slabs (512).
SHAPES = [
    (1, 1, 7), (1, 31, 100), (29, 4093, 192), (29, 31, 512), (32, 1, 192), (32, 300, 7),
    (33, 4093, 100), (33, 65, 512), (64, 31, 7), (64, 257, 192), (65, 100, 192),
    (65, 4093, 7), (199, 31, 192), (199, 4093, 100), (199, 64, 512), (29, 4093, 512),
]


@pytest.mark.parametrize("nq,n,d", SHAPES)
def test_tiles_match_plain(nq, n, d):
    q, p = _inputs(nq, n, d, nq * 7 + n + d)
    got = cosine_tiles(q, p)
    want = cosine.cosine_plain(torch.from_numpy(q), torch.from_numpy(p)).numpy()
    assert got.shape == (nq, n) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert not got[nq // 2].any() and not got[:, n // 2].any()


@pytest.mark.parametrize("nq,n,d", [(1, 31, 100), (29, 4093, 192), (33, 65, 512), (65, 100, 192),
                                    (199, 64, 512), (64, 31, 7)])
def test_tiles_match_pallas(nq, n, d):
    q, p = _inputs(nq, n, d, nq + n * 3 + d)
    want = np.asarray(jcos.cosine_pallas(jnp.asarray(q), jnp.asarray(p)))
    np.testing.assert_allclose(cosine_tiles(q, p), want, rtol=0, atol=1e-5)


def test_norms_after_the_product_equal_normalized_rows():
    """Scaling the product of the raw rows by inv_q · inv_p gives the
    product of the normalized rows, also for rows far from unit norm."""
    rng = np.random.default_rng(11)
    q = (rng.standard_normal((29, 192)) * np.logspace(-3, 3, 29)[:, None]).astype(np.float32)
    p = (rng.standard_normal((300, 192)) * np.logspace(3, -3, 300)[:, None]).astype(np.float32)
    want = cosine.cosine_plain(torch.from_numpy(q), torch.from_numpy(p)).numpy()
    np.testing.assert_allclose(cosine_tiles(q, p), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("d", [192, 512])
def test_three_tf32_products_of_raw_rows_are_f32_accurate(d):
    """The split of the raw (not normalized) rows: 3xTF32 then the norms
    stays within 2e-6 of the f64 cosine on 10 000 pairs; one TF32 product
    alone does not."""
    rng = np.random.default_rng(d + 1)
    a, b = (rng.standard_normal((10_000, d)).astype(np.float32) * 7 for _ in range(2))
    ab, bb = _tf32(a), _tf32(b)
    as_, bs = _tf32(a - ab), _tf32(b - bb)
    inv = (1 / np.linalg.norm(a, axis=1)) * (1 / np.linalg.norm(b, axis=1))
    three = ((as_ * bb + ab * bs).sum(axis=1, dtype=np.float32)
             + (ab * bb).sum(axis=1, dtype=np.float32)) * inv.astype(np.float32)
    exact = (a.astype(np.float64) * b.astype(np.float64)).sum(axis=1) * inv
    assert np.abs(three - exact).max() <= 2e-6
    one = (ab * bb).sum(axis=1, dtype=np.float32) * inv.astype(np.float32)
    assert np.abs(one - exact).max() > 2e-6
