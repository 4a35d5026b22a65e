"""Vector math on channel-split tensors — the glm replacement.

The JAX package's ``ops/vecmath.py`` carries every wavefront vector as
``V3 = (x, y, z)`` of [N] arrays; the port keeps that layout so each
expression reads, and rounds, as the JAX one does: the same operations
in the same order. [N, 3] rows appear only at module boundaries
(intersector tables, the film).

A V3 channel may be a tensor or a Python float (a geom constant);
arithmetic between the two broadcasts.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

BIG = 1e38  # this module's miss distance; intersection code uses intersect.BIG


class V3(NamedTuple):
    """Channel-split 3-vector batch: three same-shaped tensors."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    def __add__(self, o):
        if isinstance(o, V3):
            return V3(self.x + o.x, self.y + o.y, self.z + o.z)
        return V3(self.x + o, self.y + o, self.z + o)

    def __sub__(self, o):
        if isinstance(o, V3):
            return V3(self.x - o.x, self.y - o.y, self.z - o.z)
        return V3(self.x - o, self.y - o, self.z - o)

    def __mul__(self, o):
        if isinstance(o, V3):
            return V3(self.x * o.x, self.y * o.y, self.z * o.z)
        return V3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    def __neg__(self):
        return V3(-self.x, -self.y, -self.z)


def v3_from_rows(a: torch.Tensor) -> V3:
    """[..., 3] tensor -> V3 of [...] channels."""
    return V3(a[..., 0], a[..., 1], a[..., 2])


def v3_to_rows(v: V3) -> torch.Tensor:
    """V3 -> [..., 3] tensor (module-boundary conversion)."""
    return torch.stack([v.x, v.y, v.z], dim=-1)


def as_rows(x) -> torch.Tensor:
    """Accept V3 or [..., 3] rows; return [..., 3] rows."""
    return v3_to_rows(x) if isinstance(x, V3) else x


def v3_zeros(n: int, device) -> V3:
    z = torch.zeros((n,), dtype=torch.float32, device=device)
    return V3(z, z, z)


def dotv(a: V3, b: V3):
    return a.x * b.x + a.y * b.y + a.z * b.z


def crossv(a: V3, b: V3) -> V3:
    return V3(
        a.y * b.z - a.z * b.y,
        a.z * b.x - a.x * b.z,
        a.x * b.y - a.y * b.x,
    )


def normv(a: V3):
    return torch.sqrt(dotv(a, a))


def safe_normv(a: V3, eps: float = 1e-12):
    return torch.sqrt(dotv(a, a) + eps)


def normalizev(a: V3, eps: float = 1e-12) -> V3:
    # sqrt + per-channel divide, as the JAX package does (not rsqrt).
    n = torch.sqrt(torch.clamp_min(dotv(a, a), eps))
    return V3(a.x / n, a.y / n, a.z / n)


def wherev(cond, a: V3, b: V3) -> V3:
    return V3(
        torch.where(cond, a.x, b.x),
        torch.where(cond, a.y, b.y),
        torch.where(cond, a.z, b.z),
    )


def reflectv(incident: V3, n: V3) -> V3:
    d = dotv(n, incident)
    return incident - n * (2.0 * d)


def refractv(incident: V3, n: V3, eta) -> V3:
    """glm::refract: zero vector on total internal reflection."""
    cosi = dotv(n, incident)
    k = 1.0 - eta * eta * (1.0 - cosi * cosi)
    tir = k < 0.0
    k_safe = torch.clamp_min(k, 1e-12)
    out = incident * eta - n * (eta * cosi + torch.sqrt(k_safe))
    zero = torch.zeros_like(out.x)
    return wherev(tir, V3(zero, zero, zero), out)


def rotate_about_axisv(v: V3, axis: V3, angle) -> V3:
    """Rodrigues rotation; the last term keeps the JAX package's
    association ``(axis * dot) * (1 - c)``."""
    axis = normalizev(axis)
    c = torch.cos(angle)
    s = torch.sin(angle)
    return v * c + crossv(axis, v) * s + axis * dotv(axis, v) * (1.0 - c)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row cross product over the last axis, in ``jnp.cross``'s order."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


# --------------------------------------------------------------------------
# Host-side (numpy) transform construction — reference: utilities.cpp:65-72
# --------------------------------------------------------------------------


def _rot_x(deg: float) -> np.ndarray:
    r = np.deg2rad(deg)
    c, s = np.cos(r), np.sin(r)
    return np.array([[1, 0, 0, 0], [0, c, -s, 0], [0, s, c, 0], [0, 0, 0, 1]], np.float64)


def _rot_y(deg: float) -> np.ndarray:
    r = np.deg2rad(deg)
    c, s = np.cos(r), np.sin(r)
    return np.array([[c, 0, s, 0], [0, 1, 0, 0], [-s, 0, c, 0], [0, 0, 0, 1]], np.float64)


def _rot_z(deg: float) -> np.ndarray:
    r = np.deg2rad(deg)
    c, s = np.cos(r), np.sin(r)
    return np.array([[c, -s, 0, 0], [s, c, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]], np.float64)


def build_transformation_matrix(translation, rotation_deg, scale) -> np.ndarray:
    """T @ Rx @ Ry @ Rz @ S, matching utilityCore::buildTransformationMatrix
    (reference: utilities.cpp:65-72)."""
    t = np.eye(4)
    t[:3, 3] = translation
    s = np.diag([scale[0], scale[1], scale[2], 1.0])
    r = _rot_x(rotation_deg[0]) @ _rot_y(rotation_deg[1]) @ _rot_z(rotation_deg[2])
    return (t @ r @ s).astype(np.float32)
