"""Camera ray generation — pinhole + antialiasing + depth of field.

The JAX package's ``ops/camera.py`` in PyTorch (reference:
src/pathtrace.cu:315-397): one ray per pixel, pixel index = x + y*W,
directions built with ``+right`` (no mirror at save time). A camera's
fields are host numpy (the parser's) or tensors (``derive_camera``'s);
rays are differentiable in the tensor fields.
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
from kdtreepathtraceroptimization_tpu_torch.utils.device import resolve_device


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


def _f32(a, device) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.float32, device=device)


def _normalize(a: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return a / torch.sqrt(torch.clamp_min(torch.sum(a * a, dim=-1, keepdim=True), eps))


def derive_camera(resolution, fov_y_deg, position, look_at, up,
                  device=None) -> Camera:
    """The camera from (fov, eye, look_at, up) as tensors on ``device``
    (the CUDA device by default), differentiable in all four; the scene
    parser's camera set-up (reference: scene.cpp:217-234, with the basis
    fix of main.cpp:1118-1123). ``resolution`` is concrete: it fixes
    shapes."""
    device = resolve_device(device)
    resolution = np.asarray(resolution, np.int32)
    position, look_at, up, fov_y = (
        _f32(a, device) for a in (position, look_at, up, fov_y_deg))

    yscaled = torch.tan(torch.deg2rad(fov_y))
    xscaled = yscaled * int(resolution[0]) / int(resolution[1])
    fov_x = torch.rad2deg(torch.arctan(xscaled))
    pixel_length = torch.stack([2.0 * xscaled / int(resolution[0]),
                                2.0 * yscaled / int(resolution[1])])

    view = _normalize(look_at - position)
    right = _normalize(vm.cross(view, up))
    up_ortho = _normalize(vm.cross(right, view))
    return Camera(resolution=resolution, position=position, look_at=look_at,
                  view=view, up=up_ortho, right=right,
                  fov=torch.stack([fov_x, fov_y]), pixel_length=pixel_length)


def look_from(camera: Camera, eye, look_at=None, up=None, device=None) -> Camera:
    """Move the camera, keeping resolution and fov."""
    return derive_camera(
        camera.resolution, camera.fov[1], eye,
        camera.look_at if look_at is None else look_at,
        camera.up if up is None else up, device=device)


def _spherical_state(camera: Camera, device=None):
    """(radius, theta, phi) of the eye around look_at, theta from +y."""
    device = resolve_device(device)
    offset = _f32(camera.position, device) - _f32(camera.look_at, device)
    r = torch.sqrt(torch.sum(offset * offset) + 1e-12)
    theta = torch.arccos(torch.clamp(offset[1] / r, -1.0, 1.0))
    phi = torch.arctan2(offset[0], offset[2])
    return r, theta, phi


def orbit_camera(camera: Camera, d_phi: float = 0.0, d_theta: float = 0.0,
                 d_zoom: float = 0.0, device=None) -> Camera:
    """Spherical orbit and zoom about look_at (the reference's mouse
    controller, main.cpp:1110-1137, 1307-1343); theta stays off the
    poles."""
    device = resolve_device(device)
    r, theta, phi = _spherical_state(camera, device)
    r = torch.clamp_min(r + d_zoom, 1e-3)
    theta = torch.clamp(theta + d_theta, 1e-3, np.pi - 1e-3)
    phi = phi + d_phi
    eye = _f32(camera.look_at, device) + r * torch.stack(
        [torch.sin(theta) * torch.sin(phi), torch.cos(theta),
         torch.sin(theta) * torch.cos(phi)])
    return look_from(camera, eye, up=_f32([0.0, 1.0, 0.0], device), device=device)


def pan_camera(camera: Camera, dx: float = 0.0, dy: float = 0.0,
               device=None) -> Camera:
    """Translate eye and look_at in the view plane (right-mouse pan,
    main.cpp:1329-1343)."""
    device = resolve_device(device)
    shift = _f32(camera.right, device) * dx + _f32(camera.up, device) * dy
    return look_from(camera, _f32(camera.position, device) + shift,
                     look_at=_f32(camera.look_at, device) + shift, device=device)


def generate_rays(camera: Camera, config: RenderConfig, key: Key,
                  trace_depth: int, device) -> RaySoA:
    """One camera ray per pixel of ``camera`` on ``device``; differentiable
    in position, view, up, right and pixel_length where they are tensors."""
    res_x = int(camera.resolution[0])
    res_y = int(camera.resolution[1])
    n = res_x * res_y

    idx = torch.arange(n, dtype=torch.int32, device=device)
    x = (idx % res_x).to(torch.float32)
    y = (idx // res_x).to(torch.float32)

    view = V3(*_f32(camera.view, device))
    up = V3(*_f32(camera.up, device))
    right = V3(*_f32(camera.right, device))
    px, py = _f32(camera.pixel_length, device)

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

    origin = V3(*(p.expand(n) for p in _f32(camera.position, device)))

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
