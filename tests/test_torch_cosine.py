"""The port's cosine scoring (sdtk_tpu_torch/ops/cosine.py) against the
JAX package's: the plain version of the cosine kernel against
``cosine_pallas`` (interpret mode on the CPU), both ``score_rows`` routes
and ``asnorm``."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdtk_tpu.ops import cosine as jcos
from sdtk_tpu_torch.ops import cosine


def _rows(n: int, d: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


# Both sides normalize with rsqrt(Σx² + 1e-24) and sum f32 products in
# another order: a few f32 ulps of a cosine, far under 1e-5.
@pytest.mark.parametrize("q,n,d,zero_rows", [
    (4, 6, 16, False),
    (5, 300, 192, True),
    (129, 257, 192, False),
])
def test_cosine_plain_matches_pallas(q, n, d, zero_rows):
    a, b = _rows(q, d, q), _rows(n, d, n)
    if zero_rows:
        a[2] = 0.0
        b[7] = 0.0
    want = np.asarray(jcos.cosine_pallas(jnp.asarray(a), jnp.asarray(b)))
    got = cosine.cosine(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.float32 and got.shape == (q, n)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    if zero_rows:
        assert not got[2].any() and not got[:, 7].any()


def test_cosine_accepts_bf16_and_counts_no_cpu_launch():
    a, b = _rows(3, 32, 0), _rows(9, 32, 1)
    before = cosine.cosine.launches
    got = cosine.cosine(torch.from_numpy(a).bfloat16(), torch.from_numpy(b))
    want = np.asarray(jcos.cosine_pallas(jnp.asarray(a, jnp.bfloat16), jnp.asarray(b)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    assert cosine.cosine.launches == before  # the CPU runs the plain version


def test_score_rows_numpy_route_matches_jax():
    """Q·N·D < 2^24 NumPy inputs score in NumPy in both packages."""
    a, b = _rows(4, 16, 2), _rows(6, 16, 3)
    np.testing.assert_array_equal(cosine.score_rows(a, b), jcos.score_rows(a, b))
    assert cosine.score_rows(a, b[:0]).shape == (4, 0)


def test_score_rows_device_route_matches_jax():
    """At Q·N·D >= 2^24 the port scores on the device (the plain version on
    a CPU device), the JAX package through its jitted XLA dot."""
    a, b = _rows(40, 192, 4), _rows(2200, 192, 5)
    assert a.shape[0] * b.shape[0] * b.shape[1] >= cosine.NUMPY_MAX_WORK
    want = jcos.score_rows(a, b)
    got = cosine.score_rows(a, b, device="cpu")
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # tensors score on their own device, whatever their size
    small = cosine.score_rows(torch.from_numpy(a[:2]), torch.from_numpy(b[:3]))
    np.testing.assert_allclose(small, jcos.score_rows(a[:2], b[:3]), rtol=0, atol=1e-5)


def test_score_rows_device_route_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a, b = _rows(40, 192, 4), _rows(2200, 192, 5)
    with pytest.raises(RuntimeError, match="CUDA"):
        cosine.score_rows(a, b)


def test_asnorm_matches_jax():
    rng = np.random.default_rng(6)
    raw = rng.uniform(-1, 1, (7, 11)).astype(np.float32)
    qc = rng.uniform(-1, 1, (7, 80)).astype(np.float32)
    pc = rng.uniform(-1, 1, (11, 80)).astype(np.float32)
    for k in (64, 3):
        np.testing.assert_allclose(cosine.asnorm(raw, qc, pc, top_k=k),
                                   jcos.asnorm(raw, qc, pc, top_k=k), rtol=0, atol=1e-6)

