"""The port's fused identify scoring (sdtk_tpu_torch/ops/topk_fused.py,
ops/topk.py) against the JAX package's: the plain version of the fused
kernel and the dispatcher against ``identify_topk_pallas`` (interpret mode
on the CPU) and ``identify_topk_xla``.

Survivor sets must be identical: identify thresholds the returned scores,
so a missed row is a wrong answer.  Sorted scores agree to 1e-5 (f32
products summed in another order)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdtk_tpu.ops import topk as jtopk
from sdtk_tpu.ops.research import topk_pallas
from sdtk_tpu_torch.ops import topk, topk_fused


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


# the cases of tests/test_topk.py
CASES = [(5, 300, 192, 7), (64, 5000, 192, 64), (1, 100, 192, 3), (12, 2049, 192, 10),
         (200, 4096, 64, 16), (9, 17, 192, 17)]


@pytest.mark.parametrize("w,n,d,k", CASES)
def test_fused_plain_matches_pallas_and_xla(w, n, d, k):
    q, p = _inputs(w, n, d, w * 1000 + n + k)
    got = topk_fused.identify_topk_fused(torch.from_numpy(q), torch.from_numpy(p), k)
    _same(got, topk_pallas.identify_topk_pallas(jnp.asarray(q), jnp.asarray(p), k=k,
                                                interpret=True))
    _same(got, jtopk.identify_topk_xla(jnp.asarray(q), jnp.asarray(p), k=k))


@pytest.mark.parametrize("w,n,d,k", CASES)
def test_dispatcher_matches_jax_dispatcher(w, n, d, k):
    q, p = _inputs(w, n, d, w * 1000 + n + k)
    got = topk.identify_topk(q, p, k=k, device="cpu")
    assert got[0].dtype == np.float32
    _same(got, jtopk.identify_topk(q, p, k=k))


def test_bf16_profiles():
    q, p = _inputs(6, 512, 192, 11)
    got = topk_fused.identify_topk_fused(torch.from_numpy(q), torch.from_numpy(p).bfloat16(), 8)
    _same(got, topk_pallas.identify_topk_pallas(jnp.asarray(q), jnp.asarray(p, jnp.bfloat16),
                                                k=8, interpret=True))


@pytest.mark.parametrize("k,n", [(178, 400), (topk_fused.TILE, 1100),
                                 (topk_fused.TILE + 90, 1100), (700, 300)])
def test_k_above_kernel_cap(k, n):
    """k above the JAX kernel's cap of 128, and above the port's tile of
    512 rows, where every row of a tile survives into the merge."""
    q, p = _inputs(4, n, 192, 5)
    got = topk_fused.identify_topk_fused(torch.from_numpy(q), torch.from_numpy(p), k)
    assert got[0].shape == (min(k, n),)
    _same(got, topk_pallas.identify_topk_pallas(jnp.asarray(q), jnp.asarray(p), k=k,
                                                interpret=True))
    _same(topk.identify_topk(q, p, k=k, device="cpu"), jtopk.identify_topk(q, p, k=k))


@pytest.mark.parametrize("w", [1, 5, 8, 9, 33])
def test_window_bucket_invariance(w):
    """Bucketing W to a power of two by repeating row 0 changes nothing."""
    q, p = _inputs(w, 700, 192, 40 + w)
    got = topk.identify_topk(q, p, k=9, device="cpu")
    _same(got, topk.identify_topk_plain(torch.from_numpy(q), torch.from_numpy(p), 9))
    np.testing.assert_array_equal(got[1], np.asarray(jtopk.identify_topk(q, p, k=9)[1]))
    b = topk.bucket_windows(torch.from_numpy(q))
    assert b.shape[0] == max(8, 1 << (w - 1).bit_length())
    assert torch.equal(b[:w], torch.from_numpy(q)) and bool((b[w:] == b[0]).all())


def test_assume_normalized_and_ties():
    """Pre-normalized profiles give the same result with
    ``assume_normalized``; equal scores come back lower row first, as
    ``lax.top_k`` returns them."""
    q, p = _inputs(3, 50, 16, 3)
    p /= np.linalg.norm(p, axis=1, keepdims=True)
    p[[4, 9, 30]] = p[20]  # four rows with one score
    tq, tp = torch.from_numpy(q), torch.from_numpy(p)
    s, i = topk.identify_topk_plain(tq, tp, 50, assume_normalized=True)
    ws, wi = jtopk.identify_topk_xla(jnp.asarray(q), jnp.asarray(p), k=50,
                                     assume_normalized=True)
    np.testing.assert_allclose(s.numpy(), np.asarray(ws), rtol=0, atol=1e-5)
    ties = [int(r) for r in i if int(r) in (4, 9, 20, 30)]
    assert ties == [4, 9, 20, 30]
    assert ties == [int(r) for r in np.asarray(wi) if int(r) in (4, 9, 20, 30)]


def test_negative_scores_not_displaced():
    """Anti-aligned geometry: every score is deeply negative and every
    returned row is real."""
    rng = np.random.default_rng(3)
    base = rng.standard_normal(192).astype(np.float32)
    p = np.tile(-base, (130, 1)) + 0.01 * rng.standard_normal((130, 192)).astype(np.float32)
    q = np.tile(base, (3, 1)) + 0.01 * rng.standard_normal((3, 192)).astype(np.float32)
    s, i = topk.identify_topk(q, p, k=4, device="cpu")
    assert np.all(s < -0.9) and np.all(i < 130)
