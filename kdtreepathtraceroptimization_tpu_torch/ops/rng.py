"""Counter-based RNG: the JAX package's streams, bit for bit.

Every sample is ``mix(lane, slot, key)`` with the lowbias32 avalanche
(the JAX package's ``ops/rng.py``; the reference seeds per pixel and
bounce, pathtrace.cu:62-66). The key of one (iteration, bounce) pair is
``fold_in(fold_in(PRNGKey(seed), iteration), depth)`` in JAX's threefry
PRNG. Keys are two 32-bit words, computed here in Python integers on the
host (they are per call, not per ray); the per-ray hash runs on tensors
in int64 masked to 32 bits, with every 32-bit multiply split so that no
product leaves int64's range.
"""

from __future__ import annotations

import struct
from typing import Tuple

import torch

_M32 = 0xFFFFFFFF

Key = Tuple[int, int]


def prng_key(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)`` as (word0, word1): (0, seed) for a
    32-bit seed, as JAX builds it with 64-bit types off."""
    return (0, int(seed) & _M32)


def _rotl32(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _M32


def _threefry2x32(key: Key, x0: int, x1: int) -> Key:
    """Threefry-2x32 (20 rounds) of one counter pair, as jax.random does."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    rotations = ((13, 15, 26, 6), (17, 29, 16, 24))
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in rotations[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl32(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return (x0, x1)


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in`` for the threefry PRNG."""
    return _threefry2x32(key, 0, int(data) & _M32)


def uniform_scalar(key: Key) -> float:
    """``jax.random.uniform(key, ())``: one float32 in [0, 1) as a Python
    float, bit for bit. JAX's threefry bits (partitionable, its default) of
    a scalar are the xor of the two words threefry-2x32 makes of the
    counter pair (0, 0); their top 23 bits are the mantissa of a float in
    [1, 2), less 1 (exact)."""
    y0, y1 = _threefry2x32(key, 0, 0)
    bits = ((y0 ^ y1) >> 9) | 0x3F800000
    return struct.unpack("<f", struct.pack("<I", bits))[0] - 1.0


def bounce_key(base_key: Key, iteration, depth) -> Key:
    """Key for one (iteration, bounce) pair. ``depth`` 0 = camera rays,
    1.. = bounce index."""
    return fold_in(fold_in(base_key, iteration), depth)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 ``x`` in [0, 2**32): the constant is
    split into 16-bit halves so each partial product stays below 2**48."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """lowbias32 integer avalanche on int64 holding uint32 values."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x


def _to_unit(x: torch.Tensor) -> torch.Tensor:
    """Top 24 bits -> [0, 1) float32 (exact)."""
    return (x >> 8).to(torch.float32) * (1.0 / 16777216.0)


def uniform_cols(key: Key, n_rays: int, n_samples: int,
                 lane: torch.Tensor = None, device=None):
    """A tuple of ``n_samples`` [n_rays] U(0,1) float32 columns.

    ``lane``: optional [n_rays] integer stream index (the pixel index, so
    each pixel keeps one stream wherever its ray sits); default the
    array position on ``device``.
    """
    k0, k1 = key
    if lane is None:
        lane = torch.arange(n_rays, dtype=torch.int64, device=device)
    else:
        lane = lane.to(torch.int64) & _M32
    base = (_mul32(lane, 0x9E3779B1) + k0) & _M32
    cols = []
    for slot in range(n_samples):
        x = _mix32((base + ((slot * 0x85EBCA77) & _M32)) & _M32)
        x = _mix32(x ^ k1)
        cols.append(_to_unit(x))
    return tuple(cols)


def uniforms(key: Key, n_rays: int, n_samples: int,
             lane: torch.Tensor = None, device=None) -> torch.Tensor:
    """``uniform_cols`` as one [n_rays, n_samples] block."""
    return torch.stack(uniform_cols(key, n_rays, n_samples, lane, device), dim=1)
