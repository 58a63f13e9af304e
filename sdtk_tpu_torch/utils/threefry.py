"""``jax.random.normal(jax.random.PRNGKey(seed), shape, float32)`` in NumPy.

The JAX package's eigensolvers start subspace iteration from that draw
(``sdtk_tpu/cluster/spectral.py:topk_eigvecs_subspace``).  Where two
Laplacian eigenvalues sit near zero, a solver converges to the eigenvectors
only up to a rotation that depends on its start, so the port starts from the
same matrix.  The steps are JAX's:

- threefry2x32 (20 rounds) of the key over a 64-bit counter, in the
  partitionable layout (``jax_threefry_partitionable``, on by default since
  JAX 0.5): element i hashes the pair (i >> 32, i & 0xffffffff) and keeps
  the XOR of the two output words;
- 23 random mantissa bits under the exponent of 1.0, minus 1, scaled onto
  [nextafter(-1, 0), 1);
- √2 · erfinv, with XLA's float32 erfinv (M. Giles' polynomial in
  w = −log1p(−x²)), whose log1p is XLA's CPU one: a Cephes rational below
  √2 − 1, else Cephes' float32 log of 1 + x.

XLA's CPU code fuses a product into the sum that follows it; ``_fma``
rounds such a pair once, through float64.
"""

from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_W_LT_5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
           -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_W_GE_5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
           -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def _rotl(v: np.ndarray, r: int) -> np.ndarray:
    return (v << np.uint32(r)) | (v >> np.uint32(32 - r))


def threefry2x32(key: tuple[int, int], x0: np.ndarray, x1: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The threefry2x32 hash of the counter words (x0, x1) under ``key``."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x0 = x0.astype(np.uint32) + ks[0]
    x1 = x1.astype(np.uint32) + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def random_bits(seed: int, shape: tuple[int, ...]) -> np.ndarray:
    """``jax.random.bits(PRNGKey(seed), shape, uint32)``, partitionable layout."""
    n = int(np.prod(shape, dtype=np.int64))
    count = np.arange(n, dtype=np.uint64)
    key = ((seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF)
    with np.errstate(over="ignore"):
        b0, b1 = threefry2x32(key, (count >> np.uint64(32)).astype(np.uint32),
                              (count & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    return (b0 ^ b1).reshape(shape)


_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1, 1.4249322787e-1,
          -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1, 6.5787325942061044846969e0,
              2.9911919328553073277375e1, 6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1, 2.2176239823732856465394e2,
              3.0909872225312059774938e2, 2.1642788614495947685003e2, 6.0118660497603843919306e1)


def _fma(a, b, c) -> np.ndarray:
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64) + np.asarray(c, np.float64)).astype(np.float32)


def _log_f32(v: np.ndarray) -> np.ndarray:
    """XLA's CPU float32 log (Cephes ``logf``) of positive normal ``v``."""
    f = np.float32
    bits = np.maximum(v, f(1.17549435e-38)).view(np.int32)
    x = ((bits & ~0x7F800000) | f(0.5).view(np.int32)).view(np.float32)
    e = ((bits >> 23) - 0x7F).astype(np.float32) + f(1.0)
    small = x < f(0.707106781186547524)
    e = e - np.where(small, f(1.0), f(0.0))
    x = (x - f(1.0)) + np.where(small, x, f(0.0))
    x2 = x * x
    x3 = x2 * x
    p = [f(c) for c in _LOG_P]
    y, y1, y2 = _fma(x, p[0], p[1]), _fma(x, p[3], p[4]), _fma(x, p[6], p[7])
    y, y1, y2 = _fma(y, x, p[2]), _fma(y1, x, p[5]), _fma(y2, x, p[8])
    y = _fma(_fma(y, x3, y1), x3, y2)
    y = _fma(y, x3, f(-2.12194440e-4) * e)
    x = _fma(-x2, f(0.5), x) + y
    return _fma(f(0.693359375), e, x)


def _log1p_f32(x: np.ndarray) -> np.ndarray:
    """XLA's CPU float32 log1p."""
    num = np.zeros_like(x)
    den = np.zeros_like(x)
    for a, b in zip(_LOG1P_NUM, _LOG1P_DEN):
        num, den = _fma(num, x, np.float32(a)), _fma(den, x, np.float32(b))
    x2 = x * x
    small = x + _fma(np.float32(-0.5), x2, (x * x2) * (num / den))
    return np.where(np.abs(x) < np.float32(0.41421356237309504880), small, _log_f32(x + np.float32(1.0)))


def _erfinv_f32(x: np.ndarray) -> np.ndarray:
    one = np.float32(1.0)
    w = -_log1p_f32(x * -x)
    lt = w < np.float32(5.0)
    w = np.where(lt, w - np.float32(2.5), np.sqrt(w) - np.float32(3.0))
    p = np.where(lt, np.float32(_W_LT_5[0]), np.float32(_W_GE_5[0]))
    for a, b in zip(_W_LT_5[1:], _W_GE_5[1:]):
        p = _fma(p, w, np.where(lt, np.float32(a), np.float32(b)))
    return np.where(np.abs(x) == one, x * np.float32(np.inf), p * x).astype(np.float32)


def normal(seed: int, shape: tuple[int, ...]) -> np.ndarray:
    """``jax.random.normal(jax.random.PRNGKey(seed), shape, jnp.float32)``."""
    bits = random_bits(seed, tuple(shape))
    floats = ((bits >> np.uint32(9)) | np.float32(1.0).view(np.uint32)).view(np.float32) - np.float32(1.0)
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0), dtype=np.float32)
    u = np.maximum(lo, floats * (np.float32(1.0) - lo) + lo)
    return (np.float32(np.sqrt(2)) * _erfinv_f32(u)).astype(np.float32)
