"""Throughput shading — the wavefront form of shadeMaterial.

The JAX package's ``ops/shade.py`` in PyTorch (reference:
src/pathtrace.cu:2304-2369): light hits multiply in emittance and
terminate; surface hits multiply the albedo (plus the reference's
additive specular/SSS terms); misses zero the path.
"""

from __future__ import annotations

from typing import Tuple

import torch

from kdtreepathtraceroptimization_tpu_torch.ops import vecmath as vm
from kdtreepathtraceroptimization_tpu_torch.ops.bsdf import MaterialLanes
from kdtreepathtraceroptimization_tpu_torch.ops.vecmath import V3


def shade(
    color: V3,  # V3 of [N] current throughput
    remaining_bounces: torch.Tensor,  # [N] int32
    hit_t: torch.Tensor,  # [N] f32, BIG = miss
    mat: MaterialLanes,
    sdepth: torch.Tensor,  # [N] f32 (pre-scatter sdepth of the arriving ray)
    enable_sss: bool,
    big: float = 1e30,
) -> Tuple[V3, torch.Tensor]:
    """Returns (new_color, new_remaining_bounces), with the reference's
    additive specular blend (``color *= albedo + k*specular``) and the
    sdepth^2 SSS attenuation (pathtrace.cu:2339-2346)."""
    active = remaining_bounces > 0
    is_hit = hit_t < big

    is_light = mat.emittance > 0.0

    # Light hit: color *= albedo * emittance, terminate.
    light_color = color * mat.color * mat.emittance

    # Surface hit: additive blend factor by material class.
    sd = vm.clip(sdepth, 0.0, 1.0)
    sss_amount = sd * sd
    t3 = mat.transmittance
    has_sss = (t3.x > 0.0) | (t3.y > 0.0) | (t3.z > 0.0)

    factor = mat.color
    factor = vm.wherev(
        mat.has_reflective > 0.0,
        mat.color + mat.specular_color * mat.has_reflective,
        factor,
    )
    factor = vm.wherev(
        mat.has_refractive > 0.0,
        mat.color + mat.specular_color * mat.has_refractive,
        factor,
    )
    if enable_sss:
        factor = vm.wherev(
            has_sss,
            mat.color
            + mat.specular_color * mat.has_refractive
            + mat.transmittance * sss_amount,
            factor,
        )
    surface_color = color * factor

    zero = torch.zeros_like(hit_t)
    new_color = vm.wherev(
        is_hit,
        vm.wherev(is_light, light_color, surface_color),
        V3(zero, zero, zero),
    )
    new_bounces = torch.where(
        is_hit,
        torch.where(is_light, 0, remaining_bounces - 1),
        0,
    ).to(remaining_bounces.dtype)

    # Inactive lanes keep their state.
    return (
        vm.wherev(active, new_color, color),
        torch.where(active, new_bounces, remaining_bounces),
    )
