"""Triangle hits: brute force, re-evaluating the winner, the full Hit.

The JAX package's ``ops/mesh.py`` in PyTorch: the brute-force
intersector ``intersect_mesh_brute`` (plain PyTorch, no kernel) and the
hit expansion. The
intersectors only pick each ray's triangle; ``tri_hit_to_hit`` gathers the
winner's record (vertices, normals, material) into per-field channel
arrays with kernel 3 (``csrc/gather_cols.cu``), recomputes t/u/v with one
Moller-Trumbore, interpolates the normal and offsets the hit point
(reference: pathtrace.cu:981-1007).

The choice of triangle carries no gradient; t/u/v, the normal and the
point do, through the gathered row. The gather is an autograd function
whose backward is kernel 4 (``csrc/scatter_cols.cu``), a scatter-add of
the column cotangents into the [T, 19] record, from where they reach the
mesh's vertex and normal tables.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from kdtreepathtraceroptimization_tpu_torch.ops import vecmath as vm
from kdtreepathtraceroptimization_tpu_torch.ops.intersect import (
    BIG,
    Hit,
    intersect_aabb,
    miss_hit,
    moller_trumbore,
)
from kdtreepathtraceroptimization_tpu_torch.utils.cuda_build import CudaKernel, check_tensor

GATHER_COLS = CudaKernel(
    "gather_cols", "gather_cols",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
     ctypes.c_int])
SCATTER_COLS = CudaKernel(
    "scatter_cols", "scatter_cols",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
     ctypes.c_int])


class TriHit(NamedTuple):
    """Best triangle hit per ray."""

    t: torch.Tensor  # [N] f32 (BIG = miss)
    tri: torch.Tensor  # [N] int32 triangle index (-1 = miss)
    u: torch.Tensor  # [N]
    v: torch.Tensor  # [N]


# Elements of the [rays, triangles] tests the brute force makes at once.
_BRUTE_CHUNK_ELEMS = 1 << 22


def intersect_mesh_brute(origin, direction, mesh, chunk: int = 512,
                         use_bbox: bool = True, t_max=None) -> TriHit:
    """Nearest triangle hit by testing every triangle, ``chunk`` triangles
    at a time with the running best carried across chunks (strict ``<``,
    the first minimum within a chunk); rays go a bounded number at a time.

    ``use_bbox`` is the reference's per-shape AABB cull (pathtrace.cu:
    497-507, 0.01 pad): rays that miss every shape's padded box test no
    triangle.
    """
    origin = vm.as_rows(origin)
    direction = vm.as_rows(direction)
    n = origin.shape[0]
    device = origin.device
    pad = (-mesh.v0.shape[0]) % chunk
    z = torch.zeros((pad, 3), dtype=torch.float32, device=device)
    v0, v1, v2 = (torch.cat([v, z]) for v in (mesh.v0, mesh.v1, mesh.v2))
    if use_bbox:
        hit_any, _ = intersect_aabb(origin[:, None, :], direction[:, None, :],
                                    (mesh.shape_bbox_min - 0.01)[None],
                                    (mesh.shape_bbox_max + 0.01)[None])
        ray_mask = hit_any.any(dim=1)
    else:
        ray_mask = torch.ones((n,), dtype=torch.bool, device=device)

    best_t = (torch.full((n,), BIG, dtype=torch.float32, device=device)
              if t_max is None else t_max.clone())
    best = [best_t, torch.full((n,), -1, dtype=torch.int32, device=device),
            torch.zeros((n,), dtype=torch.float32, device=device),
            torch.zeros((n,), dtype=torch.float32, device=device)]
    rows = max(1, _BRUTE_CHUNK_ELEMS // chunk)
    for r0 in range(0, n, rows):
        o, d, m = origin[r0:r0 + rows], direction[r0:r0 + rows], ray_mask[r0:r0 + rows]
        bt, bi, bu, bv = (b[r0:r0 + rows] for b in best)
        for start in range(0, v0.shape[0], chunk):
            sl = slice(start, start + chunk)
            t, u, v = moller_trumbore(o, d, v0[sl], v1[sl], v2[sl])
            t = torch.where(m[:, None], t, BIG)
            loc = torch.argmin(t, dim=1)[:, None]
            lt = torch.gather(t, 1, loc)[:, 0]
            better = lt < bt
            bu.copy_(torch.where(better, torch.gather(u, 1, loc)[:, 0], bu))
            bv.copy_(torch.where(better, torch.gather(v, 1, loc)[:, 0], bv))
            bi.copy_(torch.where(better, (start + loc[:, 0]).to(torch.int32), bi))
            bt.copy_(torch.where(better, lt, bt))
    return TriHit(*best)


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


def _gather_cols(packed, tri):
    """Kernel 3 on CUDA tensors, the plain version on CPU tensors."""
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


def _scatter_cols_ref(ct, tri, nt):
    """Plain adjoint of the gather: ``grad[tri[i], c] += ct[c, i]`` ([T, C])."""
    out = torch.zeros((nt, ct.shape[0]), dtype=ct.dtype, device=ct.device)
    return out.index_add_(0, tri.long(), ct.T)


def scatter_cols(ct, tri, nt: int):
    """The row cotangents [T, C] of ``gather_cols`` from its column
    cotangents ``ct`` [C, n] (kernel 4): ``grad[tri[i], c] += ct[c, i]``.

    ``tri`` [n] int32 must index rows of a [``nt``, C] table."""
    if ct.device.type == "cpu":
        return _scatter_cols_ref(ct, tri, nt)
    if ct.device.type != "cuda":
        raise ValueError(f"scatter_cols runs on CUDA or CPU tensors, not {ct.device}")
    device = ct.device
    c, n = ct.shape
    check_tensor(ct, "ct", torch.float32, (c, n), device)
    check_tensor(tri, "tri", torch.int32, (n,), device)
    out = torch.zeros((nt, c), dtype=torch.float32, device=device)
    if n:
        SCATTER_COLS.launch(device, ct.data_ptr(), tri.data_ptr(),
                            out.data_ptr(), n, c)
    return out


class _GatherCols(torch.autograd.Function):
    """``packed[tri].T`` with kernel 3 forward and kernel 4 backward."""

    @staticmethod
    def forward(ctx, packed, tri):
        ctx.save_for_backward(tri)
        ctx.nt = packed.shape[0]
        return _gather_cols(packed, tri)

    @staticmethod
    def backward(ctx, ct):
        (tri,) = ctx.saved_tensors
        return scatter_cols(ct.contiguous(), tri, ctx.nt), None


def gather_cols(packed, tri):
    """Rows ``packed[tri]`` as channel arrays [C, n] (kernel 3), with
    gradients to ``packed`` through ``scatter_cols`` (kernel 4).

    ``tri`` [n] int32 must index rows of ``packed`` [T, C]."""
    return _GatherCols.apply(packed, tri)


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
