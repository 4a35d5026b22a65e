"""Moller-Trumbore as a product: the ray features and the shared epilogue.

From the JAX package's ``ops/mxu_bf.py``: with the ray feature row
``R = [o, d, o x d, 1]`` and a per-triangle weight matrix ``W [10, 4T]``
(columns grouped as the a / t_num / u_num / v_num blocks), ``R @ W``
gives every quantity the triangle test needs, and the test itself is a
handful of comparisons (``_epilogue``). The cluster table stores ``W``
per block (``ops/cluster.py``); the walk kernel evaluates the same
product and epilogue per ray (``csrc/walk.cu``).
"""

from __future__ import annotations

import torch

from kdtreepathtraceroptimization_tpu_torch.ops import vecmath as vm
from kdtreepathtraceroptimization_tpu_torch.ops.intersect import BIG

# glm::intersectRayTriangle backface-cull epsilon (intersect.inl, used
# by the reference at every leaf, e.g. pathtrace.cu:1130).
_CULL_EPS = 1.19e-7


def ray_features(origin: torch.Tensor, direction: torch.Tensor) -> torch.Tensor:
    """[N, 10] ray feature matrix R = [o, d, o x d, 1]."""
    m = vm.cross(origin, direction)
    one = torch.ones((origin.shape[0], 1), dtype=origin.dtype,
                     device=origin.device)
    return torch.cat([origin, direction, m, one], dim=1)


def _epilogue(prod: torch.Tensor, tb: int, t_best: torch.Tensor) -> torch.Tensor:
    """[RT, 4*TB] products -> masked t [RT, TB]: BIG where the triangle is
    missed, back-facing, or no nearer than ``t_best`` ([RT] or [RT, 1])."""
    if t_best.ndim == 1:
        t_best = t_best[:, None]
    a = prod[:, 0 * tb:1 * tb]
    tn = prod[:, 1 * tb:2 * tb]
    un = prod[:, 2 * tb:3 * tb]
    vn = prod[:, 3 * tb:4 * tb]
    ok = (
        (a > _CULL_EPS)
        & (un >= 0.0)
        & (vn >= 0.0)
        & (un + vn <= a)
        & (tn >= 0.0)
    )
    t = torch.where(ok, tn / a, BIG)
    return torch.where(t < t_best, t, BIG)
