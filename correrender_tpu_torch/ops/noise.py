"""The KSG estimators' tie-break noise, bit for bit as the JAX package
draws it.

Counterpart of ``correrender_tpu/ops/mi_ksg.py:36-64``. The JAX package
adds ``uniform(key(seed), (n,)) · 1e-5`` to each series before KSG, with
one fixed seed per axis (the reference's xorshift seeds,
MutualInformation.cpp:410-411). The vector is a function of ``n`` only,
the same for every voxel. :func:`uniform_like_jax` reproduces
``jax.random.uniform(jax.random.key(seed), (n,), float32)`` (the default
``threefry2x32`` generator, partitionable mode) in numpy:

* key ``(0, seed)``; counters ``hi = 0``, ``lo = arange(n)``;
* Threefry-2x32, 20 rounds: rotations ``(13, 15, 26, 6)`` then
  ``(17, 29, 16, 24)``, key schedule ``k0, k1, k0 ^ k1 ^ 0x1BD11BDA``,
  a key injection after every 4 rounds adding ``group + 1`` to the
  second word;
* ``bits = out0 ^ out1``; ``u = f32((bits >> 9) | 0x3F800000) − 1``.

The diagrams draw from the same generator: a shape is counted in
row-major order, :func:`fold_in_like_jax` is ``jax.random.fold_in`` (the
hash of the counter pair ``(0, data)`` under the key), and
:func:`normal_like_jax` is ``jax.random.normal``: ``√2 · erfinv(v)`` of a
uniform ``v`` on ``(nextafter(−1, 0), 1)``, with ``erfinv`` and its
``log1p`` evaluated in the float32 operations, and the fused
multiply-adds, of XLA's CPU code for them. Every draw is made on the
host; callers move the result to their device, so a card and the CPU
get the same values.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

#: Noise amplitude and count epsilon of the float path
#: (MutualInformation.cpp:162-165).
NOISE_AMPLITUDE = 1e-5
COUNT_EPSILON = 1e-6

#: Seeds of the reference-series (x) and query-series (y) noise.
SEED_REF = 617406168
SEED_QUERY = 864730169

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(v: np.ndarray, r: int) -> np.ndarray:
    return (v << np.uint32(r)) | (v >> np.uint32(32 - r))


def _key(key) -> tuple:
    """A seed (an int, ``jax.random.key(seed)``) or a ``(k0, k1)`` pair
    as two uint32 words."""
    if isinstance(key, (tuple, list)):
        return np.uint32(key[0]), np.uint32(key[1])
    return np.uint32(0), np.uint32(key)


def threefry2x32(key, x0: np.ndarray, x1: np.ndarray):
    """Threefry-2x32 (20 rounds) of the counter words ``(x0, x1)``."""
    k0, k1 = _key(key)
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x0 = np.asarray(x0, np.uint32) + ks[0]
    x1 = np.asarray(x1, np.uint32) + ks[1]
    for group in range(5):
        for r in _ROTATIONS[group % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(group + 1) % 3]
        x1 = x1 + ks[(group + 2) % 3] + np.uint32(group + 1)
    return x0, x1


def fold_in_like_jax(key, data: int) -> tuple:
    """``jax.random.fold_in(key, data)`` as a ``(k0, k1)`` pair."""
    o0, o1 = threefry2x32(key, np.zeros(1, np.uint32),
                          np.full(1, data, np.uint32))
    return int(o0[0]), int(o1[0])


def _shape(shape) -> tuple:
    return (int(shape),) if np.ndim(shape) == 0 else tuple(
        int(v) for v in shape)


def uniform_like_jax(key, shape) -> np.ndarray:
    """``jax.random.uniform(key, shape, float32)``; ``key`` is a seed or
    a ``(k0, k1)`` pair (e.g. from :func:`fold_in_like_jax`)."""
    shape = _shape(shape)
    n = int(np.prod(shape))
    o0, o1 = threefry2x32(key, np.zeros(n, np.uint32),
                          np.arange(n, dtype=np.uint32))
    bits = o0 ^ o1
    u = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(
        np.float32) - np.float32(1.0)
    return u.reshape(shape)


def _fma32(a, b, c) -> np.ndarray:
    """float32 ``a·b + c`` rounded once (a fused multiply-add): the
    product is exact in float64, the sum is rounded to odd there, and
    the final rounding to float32 is then the single correct one."""
    a, b, c = (np.asarray(v, np.float32).astype(np.float64)
               for v in (a, b, c))
    p = a * b
    s = p + c
    bv = s - p
    err = (p - (s - bv)) + (c - bv)
    even = (s.view(np.int64) & 1) == 0
    s = np.where((err != 0) & even,
                 np.nextafter(s, np.where(err > 0, np.inf, -np.inf)), s)
    return s.astype(np.float32)


def _f32(bits: int) -> np.float32:
    return np.array([bits], np.uint32).view(np.float32)[0]


# XLA's CPU log1p in float32: Cephes' rational form below sqrt(2) − 1,
# else a polynomial log of 1 + x; erfinv: Giles' two polynomials.
_LOG_C = [_f32(b) for b in (
    0x3D9021BB, 0xBDEBD1B8, 0xBDFE5D4F, 0x3E11E9BF, 0x3E4CCEAC,
    0xBE7FFFFC, 0x3DEF251A, 0xBE2AAE50, 0x3EAAAAAA)]
_LOG1P_NUM = [_f32(b) for b in (
    0x383DE04B, 0x3EFF40C5, 0x40D284FA, 0x41EF4B9C, 0x4273CC76,
    0x426473AD, 0x41A05101)]
_LOG1P_DEN = [_f32(b) for b in (
    0x3F800000, 0x417101AD, 0x42A6185B, 0x435DC32D, 0x439A8CA3,
    0x43586D8A, 0x42707982)]
_ERFINV_LO = np.array([
    2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
    0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
    1.50140941], np.float32)
_ERFINV_HI = np.array([
    -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
    0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
    2.83297682], np.float32)


def _log1p_xla(x: np.ndarray) -> np.ndarray:
    f32 = np.float32
    x = np.asarray(x, f32)
    # log(1 + x): the exponent and a mantissa in [sqrt(1/2), sqrt(2)).
    v = x + f32(1)
    tiny = _f32(0x00800000)
    b = np.where(v > tiny, v, tiny).astype(f32).view(np.uint32)
    e = ((b >> np.uint32(23)).astype(np.int32) - 127).astype(f32) + f32(1)
    m = ((b & np.uint32(0x7FFFFF)) | np.uint32(0x3F000000)).view(f32)
    low = m < _f32(0x3F3504F3)
    t = (m - f32(1)) + np.where(low, m, f32(0)).astype(f32)
    e = e - np.where(low, f32(1), f32(0)).astype(f32)
    t2 = t * t
    t3 = t2 * t
    c = _LOG_C
    q0 = _fma32(_fma32(t, c[0], c[1]), t, c[6])
    q1 = _fma32(_fma32(t, c[2], c[3]), t, c[7])
    q2 = _fma32(_fma32(t, c[4], c[5]), t, c[8])
    r = _fma32(_fma32(q0, t3, q1), t3, q2)
    s = _fma32(r, t3, e * _f32(0xB95E8083))
    u = _fma32(t2, f32(-0.5), t) + s
    large = _fma32(e, _f32(0x3F318000), u)
    large = np.where(v <= 0, f32(np.nan), large)
    large = np.where(v == 0, f32(-np.inf), large)
    large = np.where(v == np.inf, f32(np.inf), large)
    # Small |x|: x − x²/2 + x³·P(x)/Q(x).
    num = np.full_like(x, _LOG1P_NUM[0])
    for coef in _LOG1P_NUM[1:]:
        num = _fma32(num, x, coef)
    den = np.full_like(x, _LOG1P_DEN[0])
    for coef in _LOG1P_DEN[1:]:
        den = _fma32(den, x, coef)
    x2 = x * x
    small = x + _fma32(x2, f32(-0.5), (x * x2) * (num / den))
    return np.where(np.abs(x) < _f32(0x3ED413CD), small,
                    large).astype(f32)


def _erfinv_xla(x: np.ndarray) -> np.ndarray:
    f32 = np.float32
    w = -_log1p_xla(-(x * x))
    lt = w < f32(5)
    w = np.where(lt, w - f32(2.5), np.sqrt(w) - f32(3)).astype(f32)
    p = np.where(lt, _ERFINV_LO[0], _ERFINV_HI[0]).astype(f32)
    for lo_c, hi_c in zip(_ERFINV_LO[1:], _ERFINV_HI[1:]):
        p = _fma32(p, w, np.where(lt, lo_c, hi_c))
    out = p * x
    return np.where(np.abs(x) == 1, x * np.finfo(f32).max, out).astype(f32)


def normal_like_jax(key, shape, scale: float = 1.0) -> np.ndarray:
    """``scale · jax.random.normal(key, shape, float32)`` as XLA computes
    it on the CPU: under ``jit`` it folds ``scale`` into the constant √2
    (one float32 product) before the multiply."""
    f32 = np.float32
    lo = np.nextafter(f32(-1), f32(0))
    v = np.maximum(lo, uniform_like_jax(key, shape) * f32(2) + lo)
    return ((f32(scale) * f32(np.sqrt(2))) * _erfinv_xla(v)).astype(f32)


@functools.lru_cache(maxsize=None)
def _noise_pair(n: int, device: torch.device):
    return tuple(torch.from_numpy(uniform_like_jax(s, n)).to(device)
                 for s in (SEED_REF, SEED_QUERY))


def tie_break_noise(n: int, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``(n,)`` float32 uniforms ``(nx, ny)`` for the x and y series,
    cached per ``(n, device)``."""
    return _noise_pair(int(n), torch.device(device or "cpu"))


def scaled_noise(n: int, device, noise=None):
    """``(nx·1e-5, ny·1e-5)`` in float32 on ``device``, each product
    rounded once: the amounts added to the x and y series. ``noise`` is
    a caller's own ``(nx, ny)``; by default the JAX package's draw."""
    nx, ny = noise if noise is not None else tie_break_noise(n, device)
    return tuple(
        torch.as_tensor(u, dtype=torch.float32, device=device)
        * NOISE_AMPLITUDE for u in (nx, ny))
