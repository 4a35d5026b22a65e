"""Wavefront reorderings: stream compaction and the material sort.

The JAX package's ``ops/compaction.py`` (reference: the ``thrust::
remove_if`` of finished paths, pathtrace.cu:2591-2597, and the sort by
material id, pathtrace.cu:2600-2606). The wavefront keeps its length:
compaction moves the live rays to the front, the material sort groups the
rays by the material they just hit, and ``pixel_index`` rides along so the
film gathers each path into its own pixel (the reference keeps
``pixelIndex`` in its PathSegment for the same reason,
sceneStructs.h:66-74). Every sort is stable, as the JAX package's
``lax.sort(..., is_stable=True)``, so both give the same permutation; the
index ops carry the autograd graph.
"""

from __future__ import annotations

from typing import Tuple

import torch

from kdtreepathtraceroptimization_tpu_torch.ops.camera import RaySoA
from kdtreepathtraceroptimization_tpu_torch.ops.vecmath import V3

# The sort key of finished rays: after every material id.
DEAD_KEY = 0x7FFFFFFF


def _sort_rays_by_key(rays: RaySoA, key: torch.Tensor) -> Tuple[RaySoA, torch.Tensor]:
    """The wavefront reordered by ``key`` (stable), and the permutation
    (the original lane of each new lane)."""
    perm = torch.sort(key, stable=True)[1]

    def take(a):
        return a[perm]

    out = RaySoA(
        origin=V3(*map(take, rays.origin)),
        direction=V3(*map(take, rays.direction)),
        color=V3(*map(take, rays.color)),
        is_inside=take(rays.is_inside),
        sdepth=take(rays.sdepth),
        pixel_index=take(rays.pixel_index),
        remaining_bounces=take(rays.remaining_bounces),
    )
    return out, perm.to(torch.int32)


def compact_rays(rays: RaySoA) -> Tuple[RaySoA, torch.Tensor]:
    """A stable partition of the live rays (``remaining_bounces > 0``) to
    the front (thrust::remove_if on remainingBounces == 0,
    pathtrace.cu:103-110) -> (rays, the number alive, a 0-d tensor)."""
    alive = rays.remaining_bounces > 0
    out, _ = _sort_rays_by_key(rays, (~alive).to(torch.int32))
    return out, alive.sum(dtype=torch.int32)


def sort_rays_by_material(rays: RaySoA, material_id: torch.Tensor
                          ) -> Tuple[RaySoA, torch.Tensor]:
    """The rays grouped by the material they just hit, finished rays last
    (thrust::sort by materialIdHit, pathtrace.cu:123-131, 2600-2606) ->
    (rays, permutation), so a caller can permute the matching hits the
    same way."""
    key = torch.where(rays.remaining_bounces > 0, material_id.to(torch.int32), DEAD_KEY)
    return _sort_rays_by_key(rays, key)


def sort_rays_by_octant(rays: RaySoA) -> RaySoA:
    """The rays grouped by their direction's octant, finished rays last:
    rays of one octant walk the KD tree in a similar near/far order."""
    d = rays.direction
    octant = ((d.x >= 0).to(torch.int32) + 2 * (d.y >= 0).to(torch.int32)
              + 4 * (d.z >= 0).to(torch.int32))
    key = torch.where(rays.remaining_bounces > 0, octant, 8)
    return _sort_rays_by_key(rays, key)[0]
