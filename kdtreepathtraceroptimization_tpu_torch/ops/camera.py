"""Camera ray generation — pinhole + antialiasing + depth of field.

The JAX package's ``generate_rays`` in PyTorch (reference:
src/pathtrace.cu:315-397): one ray per pixel, pixel index = x + y*W,
directions built with ``+right`` (no mirror at save time).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from kdtreepathtraceroptimization_tpu_torch.config import RenderConfig
from kdtreepathtraceroptimization_tpu_torch.ops import sampling, vecmath as vm
from kdtreepathtraceroptimization_tpu_torch.ops.rng import Key, uniform_cols
from kdtreepathtraceroptimization_tpu_torch.ops.vecmath import V3
from kdtreepathtraceroptimization_tpu_torch.scene.structs import Camera


class RaySoA(NamedTuple):
    """Wavefront path state (reference: sceneStructs.h:15-24, 66-74);
    vector fields are V3 of [N] tensors."""

    origin: V3
    direction: V3
    color: V3  # throughput
    is_inside: torch.Tensor  # [N] bool
    sdepth: torch.Tensor  # [N] f32 subsurface depth
    pixel_index: torch.Tensor  # [N] int32
    remaining_bounces: torch.Tensor  # [N] int32


def generate_rays(camera: Camera, config: RenderConfig, key: Key,
                  trace_depth: int, device) -> RaySoA:
    """One camera ray per pixel of ``camera`` (host numpy), on ``device``."""
    res_x = int(camera.resolution[0])
    res_y = int(camera.resolution[1])
    n = res_x * res_y

    idx = torch.arange(n, dtype=torch.int32, device=device)
    x = (idx % res_x).to(torch.float32)
    y = (idx // res_x).to(torch.float32)

    view = vm.v3_splat(camera.view)
    up = vm.v3_splat(camera.up)
    right = vm.v3_splat(camera.right)
    px, py = (float(v) for v in np.asarray(camera.pixel_length))

    sx = px * (x - res_x * 0.5)
    sy = py * (y - res_y * 0.5)
    direction = vm.normalizev(view + right * sx - up * sy)

    # Slots 3-5 feed only depth of field; each slot's stream does not
    # depend on how many are drawn.
    u = uniform_cols(key, n, 6 if config.dof_angle > 0.0 else 3,
                     device=device)

    if config.antialias:
        # "cheap jitter" (pathtrace.cu:341-350): a random positive-octant
        # unit vector scaled by the jitter scale.
        j = vm.normalizev(V3(u[0], u[1], u[2]))
        direction = vm.normalizev(direction + j * config.aa_jitter_scale)

    position = np.asarray(camera.position)
    origin = V3(*(torch.full((n,), float(position[a]), dtype=torch.float32,
                             device=device) for a in range(3)))

    if config.dof_angle > 0.0:
        # Depth of field (pathtrace.cu:364-393): rotate the direction by a
        # random small angle and pivot the origin about the focal point.
        axis = sampling.uniform_sphere_v(u[3], u[4])
        rand_angle = u[5] * np.pi * config.dof_angle
        randrot = vm.normalizev(
            vm.rotate_about_axisv(direction, axis, rand_angle))
        origin = (origin + direction * config.focal_length
                  - randrot * config.focal_length)
        direction = randrot

    one = torch.ones((n,), dtype=torch.float32, device=device)
    return RaySoA(
        origin=origin,
        direction=direction,
        color=V3(one, one, one),
        is_inside=torch.zeros((n,), dtype=torch.bool, device=device),
        sdepth=torch.zeros((n,), dtype=torch.float32, device=device),
        pixel_index=idx,
        remaining_bounces=torch.full((n,), trace_depth, dtype=torch.int32,
                                     device=device),
    )
