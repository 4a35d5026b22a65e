"""Triangle hits: re-evaluating the winner and expanding it to a full Hit.

The JAX package's ``ops/mesh.py`` hit expansion in PyTorch. The
intersectors only pick each ray's triangle; ``tri_hit_to_hit`` gathers the
winner's record (vertices, normals, material) into per-field channel
arrays with kernel 3 (``csrc/gather_cols.cu``), recomputes t/u/v with one
Moller-Trumbore, interpolates the normal and offsets the hit point
(reference: pathtrace.cu:981-1007).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from kdtreepathtraceroptimization_tpu_torch.ops import vecmath as vm
from kdtreepathtraceroptimization_tpu_torch.ops.intersect import BIG, Hit, miss_hit
from kdtreepathtraceroptimization_tpu_torch.utils.cuda_build import CudaKernel, check_tensor

GATHER_COLS = CudaKernel(
    "gather_cols", "gather_cols",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
     ctypes.c_int])


class TriHit(NamedTuple):
    """Best triangle hit per ray."""

    t: torch.Tensor  # [N] f32 (BIG = miss)
    tri: torch.Tensor  # [N] int32 triangle index (-1 = miss)
    u: torch.Tensor  # [N]
    v: torch.Tensor  # [N]


def refine_tri_hit(origin, direction, tri_idx, mesh):
    """Recompute (t, u, v) for already-selected triangles ([N, 3] rows)."""
    tri = torch.clamp_min(tri_idx, 0).long()
    return _refine_tri_hit_verts(origin, direction, mesh.v0[tri],
                                 mesh.v1[tri], mesh.v2[tri])


def _refine_tri_hit_verts(origin, direction, v0, v1, v2):
    """refine_tri_hit on pre-gathered per-lane vertices ([N, 3] rows)."""
    e1 = v1 - v0
    e2 = v2 - v0
    p = vm.cross(direction, e2)
    a = torch.sum(e1 * p, dim=-1)
    # |det| is clamped to 1e-6 (silhouette-grazing hits only).
    safe = torch.abs(a) > 1e-12
    a_clamped = torch.where(a >= 0, 1.0, -1.0) * torch.clamp_min(torch.abs(a), 1e-6)
    f = 1.0 / torch.where(safe, a_clamped, 1.0)
    s = origin - v0
    u = f * torch.sum(s * p, dim=-1)
    q = vm.cross(s, e1)
    v = f * torch.sum(direction * q, dim=-1)
    t = f * torch.sum(e2 * q, dim=-1)
    return t, u, v


def _refine_tri_hit_verts_v(origin: vm.V3, direction: vm.V3,
                            v0: vm.V3, v1: vm.V3, v2: vm.V3):
    """Channel-split twin of _refine_tri_hit_verts (same math/clamps)."""
    e1 = v1 - v0
    e2 = v2 - v0
    p = vm.crossv(direction, e2)
    a = vm.dotv(e1, p)
    safe = torch.abs(a) > 1e-12
    a_clamped = torch.where(a >= 0, 1.0, -1.0) * torch.clamp_min(torch.abs(a), 1e-6)
    f = 1.0 / torch.where(safe, a_clamped, 1.0)
    s = origin - v0
    u = f * vm.dotv(s, p)
    q = vm.crossv(s, e1)
    v = f * vm.dotv(direction, q)
    t = f * vm.dotv(e2, q)
    return t, u, v


def _gather_cols_ref(packed, tri):
    """Plain gather-to-columns: ``packed[tri].T`` ([C, n])."""
    return packed[tri.long()].T


def gather_cols(packed, tri):
    """Rows ``packed[tri]`` as channel arrays [C, n] (kernel 3).

    ``tri`` [n] int32 must index rows of ``packed`` [T, C]."""
    if packed.device.type == "cpu":
        return _gather_cols_ref(packed, tri)
    if packed.device.type != "cuda":
        raise ValueError(f"gather_cols runs on CUDA or CPU tensors, not {packed.device}")
    device = packed.device
    nt, c = packed.shape
    n = tri.shape[0]
    check_tensor(packed, "packed", torch.float32, (nt, c), device)
    check_tensor(tri, "tri", torch.int32, (n,), device)
    out = torch.empty((c, n), dtype=torch.float32, device=device)
    if n:
        GATHER_COLS.launch(device, packed.data_ptr(), tri.data_ptr(),
                           out.data_ptr(), n, c)
    return out


def pack_tris(mesh) -> torch.Tensor:
    """The per-triangle record [T, 19] f32 of a mesh of tensors: v0 v1 v2
    n0 n1 n2 material. A scene constant, built once with the cluster
    table (``ClusterMesh.packed``)."""
    return torch.cat(
        [mesh.v0, mesh.v1, mesh.v2, mesh.n0, mesh.n1, mesh.n2,
         mesh.material_id.to(torch.float32)[:, None]],
        dim=1,
    ).contiguous()


def tri_hit_to_hit(origin, direction, tri_hit: TriHit, packed) -> Hit:
    """Expand a TriHit into a full Hit record: the winner's row of
    ``packed`` [T, 19] (``pack_tris``) gathered into 19 channel arrays,
    t/u/v recomputed from the winning triangle, the normal interpolated
    and the point offset by +normal*1e-4. Miss lanes read row 0 and are
    masked; a mesh without triangles yields misses only.

    ``origin``/``direction``: V3 of [N] or [N, 3].
    """
    if not isinstance(origin, vm.V3):
        origin = vm.v3_from_rows(origin)
    if not isinstance(direction, vm.V3):
        direction = vm.v3_from_rows(direction)
    n = origin.x.shape[0]
    if packed.shape[0] == 0:
        return miss_hit(n, origin.x.device)
    is_hit = tri_hit.tri >= 0
    tri = torch.clamp_min(tri_hit.tri, 0)
    cols = gather_cols(packed, tri)

    def col3(j):
        return vm.V3(cols[j], cols[j + 1], cols[j + 2])

    v0, v1, v2 = col3(0), col3(3), col3(6)
    n0, n1, n2 = col3(9), col3(12), col3(15)
    mat_id = cols[18].to(torch.int32)

    t, u, v = _refine_tri_hit_verts_v(origin, direction, v0, v1, v2)
    t = torch.where(is_hit, t, BIG)

    w = 1.0 - u - v
    normal = vm.normalizev(n0 * w + n1 * u + n2 * v)
    point = origin + direction * t + normal * 1e-4
    zero = torch.zeros_like(t)
    zv = vm.V3(zero, zero, zero)
    return Hit(
        t=t,
        point=vm.wherev(is_hit, point, zv),
        normal=vm.wherev(is_hit, normal, zv),
        material_id=torch.where(is_hit, mat_id, -1),
        outside=torch.ones((n,), dtype=torch.bool, device=t.device),
    )
