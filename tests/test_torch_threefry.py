"""The port's NumPy ``jax.random.normal(PRNGKey(0), (n, m), float32)``
(sdtk_tpu_torch/utils/threefry.py), the default start of its subspace
eigensolver, against JAX's own draw: bit for bit at every shape (a
partitionable threefry2x32 and XLA's CPU float32 erfinv and log1p, whose
fused multiply-adds the port rounds once through float64)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdtk_tpu.cluster.spectral import topk_eigvecs_subspace as jax_subspace
from sdtk_tpu_torch.cluster.spectral import normalized_laplacian, topk_eigvecs_subspace
from sdtk_tpu_torch.utils import threefry


def test_jax_uses_the_partitionable_layout():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("shape", [(16, 10), (17, 17), (64, 17), (1000, 17), (4096, 9),
                                   (8192, 16), (8192, 17), (3, 5, 7)])
def test_normal_equals_jax_bit_for_bit(shape):
    got = threefry.normal(0, shape)
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(0), shape, jnp.float32))
    assert got.dtype == np.float32 and got.shape == shape
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("seed", [0, 1, 42, 2**31 - 1])
def test_bits_equal_jax(seed):
    want = np.asarray(jax.random.bits(jax.random.PRNGKey(seed), (33, 7), jnp.uint32))
    np.testing.assert_array_equal(threefry.random_bits(seed, (33, 7)), want)


def test_normal_over_the_whole_float32_range():
    """Two million draws reach both erfinv branches (|u| near 1, w ≥ 5)
    and both log1p branches: still bit for bit."""
    shape = (2_000_000,)
    got = threefry.normal(0, shape)
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(0), shape, jnp.float32))
    assert np.abs(want).max() > 4.5
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_default_subspace_start_is_jax_start():
    """Without ``start`` the solver starts from JAX's
    draw: the same eigenvalues (1e-5) and eigenvectors (1e-4, up to each
    column's sign) as JAX's solver on a Laplacian with two near-zero
    eigenvalues, and exactly what an explicit JAX start gives."""
    rng = np.random.default_rng(3)
    centers = rng.standard_normal((2, 24))
    emb = np.concatenate([c + 0.3 * rng.standard_normal((40, 24)) for c in centers])
    emb = (emb / np.linalg.norm(emb, axis=1, keepdims=True)).astype(np.float32)
    aff = np.clip(emb @ emb.T, 0, None)
    lap = normalized_laplacian(torch.from_numpy(aff))
    w, v = topk_eigvecs_subspace(lap, 5)
    start = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (80, 13), jnp.float32))
    w2, v2 = topk_eigvecs_subspace(lap, 5, start=start)
    np.testing.assert_array_equal(w.numpy(), w2.numpy())
    np.testing.assert_array_equal(v.numpy(), v2.numpy())
    jw, jv = (np.asarray(a) for a in jax_subspace(jnp.asarray(lap.numpy()), 5))
    np.testing.assert_allclose(w.numpy(), jw, rtol=0, atol=1e-5)
    signs = np.sign((v.numpy() * jv).sum(axis=0))
    np.testing.assert_allclose(v.numpy() * signs, jv, rtol=0, atol=1e-4)
