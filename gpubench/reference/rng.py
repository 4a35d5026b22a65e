"""The renderer's random streams, frozen.

A copy of the port's ``ops/rng.py`` arithmetic (itself the JAX package's
streams bit for bit): a key of one (iteration, bounce) pair is
``fold_in(fold_in((0, seed), iteration), depth)`` under threefry-2x32, and
every sample is the lowbias32 mix of (pixel, slot, key). The reference has
to draw the same numbers as the program to follow the same paths, so this
file changes only with the program's definition of its streams.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF


def prng_key(seed: int):
    return (0, int(seed) & _M32)


def _rotl32(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _M32


def _threefry2x32(key, x0: int, x1: int):
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


def fold_in(key, data: int):
    return _threefry2x32(key, 0, int(data) & _M32)


def bounce_key(base_key, iteration: int, depth: int):
    """Key of one (iteration, bounce); depth 0 draws the camera rays."""
    return fold_in(fold_in(base_key, iteration), depth)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x


def uniform_cols(key, lane: torch.Tensor, n_samples: int):
    """``n_samples`` columns of U(0, 1) float32, one row per ``lane``
    (the pixel index)."""
    k0, k1 = key
    lane = lane.to(torch.int64) & _M32
    base = (_mul32(lane, 0x9E3779B1) + k0) & _M32
    cols = []
    for slot in range(n_samples):
        x = _mix32((base + ((slot * 0x85EBCA77) & _M32)) & _M32)
        x = _mix32(x ^ k1)
        cols.append((x >> 8).to(torch.float32) * (1.0 / 16777216.0))
    return cols
