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


def uniform_like_jax(seed: int, n: int) -> np.ndarray:
    """``jax.random.uniform(jax.random.key(seed), (n,), float32)``."""
    k0, k1 = np.uint32(0), np.uint32(seed)
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x0 = np.zeros(n, np.uint32) + ks[0]
    x1 = np.arange(n, dtype=np.uint32) + ks[1]
    for group in range(5):
        for r in _ROTATIONS[group % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(group + 1) % 3]
        x1 = x1 + ks[(group + 2) % 3] + np.uint32(group + 1)
    bits = x0 ^ x1
    return ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(
        np.float32) - np.float32(1.0)


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
