"""Direction sampling helpers (reference: src/interactions.h:9-83).

The channel-split (``*_v``) helpers of the JAX package's
``ops/sampling.py``, on V3 of [N] tensors, consuming pre-drawn uniform
columns. Integer powers are written as products in the order
``jax.lax.integer_pow`` multiplies them.
"""

from __future__ import annotations

import torch

from kdtreepathtraceroptimization_tpu_torch.ops import vecmath as vm
from kdtreepathtraceroptimization_tpu_torch.ops.vecmath import V3

SQRT_ONE_THIRD = 0.5773502691896258
PI = 3.141592653589793
TWO_PI = 6.283185307179586


def cosine_hemisphere_v(normal: V3, u1, u2) -> V3:
    """Cosine-weighted hemisphere sample around ``normal``
    (calculateRandomDirectionInHemisphere, interactions.h:9-41)."""
    up = torch.sqrt(u1)  # cos(theta)
    over = torch.sqrt(vm.maximum(1.0 - up * up, 0.0))  # sin(theta)
    around = u2 * TWO_PI

    # not_normal = first of ex/ey/ez whose |normal| component < 1/sqrt(3)
    ax = torch.abs(normal.x)
    ay = torch.abs(normal.y)
    use_x = ax < SQRT_ONE_THIRD
    use_y = ~use_x & (ay < SQRT_ONE_THIRD)
    one = torch.ones_like(normal.x)
    zero = torch.zeros_like(normal.x)
    not_normal = V3(
        torch.where(use_x, one, zero),
        torch.where(use_y, one, zero),
        torch.where(use_x | use_y, zero, one),
    )

    p1 = vm.normalizev(vm.crossv(normal, not_normal))
    p2 = vm.normalizev(vm.crossv(normal, p1))

    c1 = torch.cos(around) * over
    c2 = torch.sin(around) * over
    return normal * up + p1 * c1 + p2 * c2


def rand_spherical_vec_v(angle: float, u1, u2) -> V3:
    """Random direction in a cone near (0,0,-1) of aperture ``angle``
    (randSphericalVec, interactions.h:67-83)."""
    theta = TWO_PI * u1
    phi = torch.arccos(vm.clip(angle * PI * u2 - 1.0, -1.0, 1.0))
    sp = torch.sin(phi)
    return V3(torch.cos(theta) * sp, torch.sin(theta) * sp, torch.cos(phi))


def rotate_cone_sample_v(direction: V3, v: V3) -> V3:
    """Rotate a near -z cone sample ``v`` so the cone axis lands on
    ``direction`` (interactions.h:213-217, 259-266); degenerate when
    ``direction`` is parallel to z."""
    cosang = vm.clip(-direction.z, -1.0 + 1e-6, 1.0 - 1e-6)
    angle = torch.arccos(cosang)
    # cross((0,0,-1), dir) = (dir.y, -dir.x, 0)
    axis = V3(direction.y, -direction.x, torch.zeros_like(direction.x))
    axis_len = vm.normv(axis)
    degenerate = axis_len < 1e-6
    one = torch.ones_like(direction.x)
    zero = torch.zeros_like(direction.x)
    safe_axis = vm.wherev(degenerate, V3(one, zero, zero), axis)
    rotated = vm.rotate_about_axisv(v, safe_axis, angle)
    flipped = vm.wherev(direction.z > 0, -v, v)
    return vm.wherev(degenerate, flipped, rotated)


def uniform_sphere_v(u1, u2) -> V3:
    """Uniform direction on the sphere (the DoF rotation axis,
    pathtrace.cu:364-371)."""
    u = torch.cos(PI * u1)
    s = torch.sqrt(vm.maximum(1.0 - u * u, 0.0))
    theta = TWO_PI * u2
    return V3(s * torch.cos(theta), s * torch.sin(theta), u)


def schlick_fresnel_v(incident: V3, normal: V3, ior):
    """Schlick 5th-power Fresnel approximation (getFresnelVal,
    interactions.h:126-133)."""
    r = (1.0 - ior) / (1.0 + ior)
    r0 = r * r
    c = 1.0 - vm.clip(-vm.dotv(normal, incident), -1.0, 1.0)
    c2 = c * c
    return r0 + (1.0 - r0) * (c * (c2 * c2))
