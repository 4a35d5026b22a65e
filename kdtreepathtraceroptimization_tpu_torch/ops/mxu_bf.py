"""Moller-Trumbore as a product, and the brute force built on it.

From the JAX package's ``ops/mxu_bf.py``: with the ray feature row
``R = [o, d, o x d, 1]`` and a per-triangle weight matrix ``W [10, 4T]``
(columns grouped as the a / t_num / u_num / v_num blocks), ``R @ W``
gives every quantity the triangle test needs, and the test itself is a
handful of comparisons (``_epilogue``). The cluster table stores ``W``
per block (``ops/cluster.py``); the walk, pair and brute-force kernels
evaluate the same product and epilogue per ray (``csrc/walk.cu``,
``csrc/mt_block.cuh``).

The brute force tests every ray against every triangle: the plain
version ``intersect_brute_mxu_ref`` one triangle block at a time with a
matrix product, the kernel wrapper ``intersect_brute_mxu`` with kernel 8
(``csrc/mxu_bf.cu``), which keeps each ray's running best in registers.
"""

from __future__ import annotations

import ctypes

import torch

from kdtreepathtraceroptimization_tpu_torch.ops import vecmath as vm
from kdtreepathtraceroptimization_tpu_torch.ops.intersect import BIG
from kdtreepathtraceroptimization_tpu_torch.ops.mesh import TriHit
from kdtreepathtraceroptimization_tpu_torch.utils.cuda_build import MAX_SMEM, CudaKernel

_P = ctypes.c_void_p
_I = ctypes.c_int

BF = CudaKernel("mxu_bf", "mxu_bf", [_P, _P, _P, _P, _P, _I, _I, _I, _I])

# glm::intersectRayTriangle backface-cull epsilon (intersect.inl, used
# by the reference at every leaf, e.g. pathtrace.cu:1130).
_CULL_EPS = 1.19e-7
# Elements of the [rays, 4B] product the plain brute force makes at once.
_REF_CHUNK_ELEMS = 1 << 26


def ray_features(origin: torch.Tensor, direction: torch.Tensor) -> torch.Tensor:
    """[N, 10] ray feature matrix R = [o, d, o x d, 1]."""
    m = vm.cross(origin, direction)
    one = torch.ones((origin.shape[0], 1), dtype=origin.dtype,
                     device=origin.device)
    return torch.cat([origin, direction, m, one], dim=1)


def _scene_center(v0, v1, v2):
    """Bounding-box centre of the triangles. Rays and triangles are both
    moved by it before R and W are built: the products' numerators are
    not translation invariant, and far-off coordinates would lose bits to
    cancellation."""
    lo = torch.minimum(v0.amin(0), torch.minimum(v1.amin(0), v2.amin(0)))
    hi = torch.maximum(v0.amax(0), torch.maximum(v1.amax(0), v2.amax(0)))
    return 0.5 * (lo + hi)


def tri_weights(v0, v1, v2) -> torch.Tensor:
    """[10, 4T] triangle weight matrix; columns = [a | t | u | v] blocks.
    Degenerate (all-equal-vertex) triangles give a = 0 and never win."""
    e1 = v1 - v0
    e2 = v2 - v0
    n = vm.cross(e1, e2)
    c = torch.sum(v0 * n, dim=1)
    e2xv0 = vm.cross(e2, v0)
    v0xe1 = vm.cross(v0, e1)
    t = v0.shape[0]
    z3 = torch.zeros((t, 3), dtype=torch.float32, device=v0.device)
    z1 = torch.zeros((t, 1), dtype=torch.float32, device=v0.device)
    w_a = torch.cat([z3, -n, z3, z1], dim=1)
    w_t = torch.cat([n, z3, z3, -c[:, None]], dim=1)
    w_u = torch.cat([z3, -e2xv0, e2, z1], dim=1)
    w_v = torch.cat([z3, -v0xe1, -e1, z1], dim=1)
    return torch.cat([w_a, w_t, w_u, w_v], dim=0).T


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


def _centered(origin, v0, v1, v2, tri_block: int):
    """Rays and triangles moved to the triangles' centre, the triangles
    padded with degenerate ones to a multiple of ``tri_block``."""
    v0, v1, v2 = (v.to(torch.float32) for v in (v0, v1, v2))
    center = _scene_center(v0, v1, v2)
    pad = (-v0.shape[0]) % tri_block
    z = torch.zeros((pad, 3), dtype=torch.float32, device=v0.device)
    vs = [torch.cat([v - center, z]) for v in (v0, v1, v2)]
    return origin.to(torch.float32) - center, vs


def _block_weights(vs, tri_block: int) -> torch.Tensor:
    """[T'/B, 10, 4B]: each block's weight columns, [a | t | u | v]."""
    nb = vs[0].shape[0] // tri_block
    return (tri_weights(*vs).reshape(10, 4, nb, tri_block)
            .permute(2, 0, 1, 3).reshape(nb, 10, 4 * tri_block))


def intersect_brute_mxu_ref(origin, direction, v0, v1, v2, t_max=None,
                            block: int = 2048) -> TriHit:
    """Plain brute force: per triangle block one product and the epilogue,
    the first minimum within a block and strict ``<`` across blocks; a
    bounded number of rays at a time."""
    n = origin.shape[0]
    origin, vs = _centered(origin, v0, v1, v2, block)
    w = _block_weights(vs, block)
    r = ray_features(origin, direction.to(torch.float32))
    bt = (torch.full((n,), BIG, dtype=torch.float32, device=r.device)
          if t_max is None else t_max.clone())
    btri = torch.full((n,), -1, dtype=torch.int32, device=r.device)
    rows = max(1, _REF_CHUNK_ELEMS // (4 * block))
    for r0 in range(0, n, rows):
        rc = r[r0:r0 + rows]
        bc = bt[r0:r0 + rows]
        ic = btri[r0:r0 + rows]
        for i in range(w.shape[0]):
            t = _epilogue(rc @ w[i], block, bc)
            loc = torch.argmin(t, dim=1)
            lt = torch.gather(t, 1, loc[:, None])[:, 0]
            better = lt < bc
            bc.copy_(torch.where(better, lt, bc))
            ic.copy_(torch.where(better, (i * block + loc).to(torch.int32), ic))
    bt = torch.where(btri >= 0, bt, BIG)
    zero = torch.zeros((n,), dtype=torch.float32, device=r.device)
    return TriHit(t=bt, tri=btri, u=zero, v=zero)


def intersect_brute_mxu(origin, direction, v0, v1, v2, t_max=None,
                        ray_tile: int = 1024, tri_block: int = 512) -> TriHit:
    """Brute force with kernel 8: every ray tile against every triangle
    block. Rays are padded to ``ray_tile`` with dead ones (d = 0, so every
    a = 0) and triangles to ``tri_block`` with degenerate ones. CPU tensors
    take the plain version at the same block size."""
    if origin.device.type == "cpu":
        return intersect_brute_mxu_ref(origin, direction, v0, v1, v2, t_max,
                                       block=tri_block)
    if origin.device.type != "cuda":
        raise ValueError(f"intersect_brute_mxu runs on CUDA or CPU tensors, not {origin.device}")
    device = origin.device
    rpt = BF.call_int("mxu_bf_rays_per_thread")
    if (ray_tile % rpt or ray_tile // rpt > 1024
            or 40 * tri_block * 4 > MAX_SMEM):
        raise ValueError(f"intersect_brute_mxu: bad ray tile {ray_tile} / "
                         f"triangle block {tri_block}")
    n = origin.shape[0]
    npad = (-n) % ray_tile
    origin, vs = _centered(origin, v0, v1, v2, tri_block)
    z3 = torch.zeros((npad, 3), dtype=torch.float32, device=device)
    origin = torch.cat([origin, z3])
    direction = torch.cat([direction.to(torch.float32), z3])
    r = torch.cat([ray_features(origin, direction),
                   torch.zeros((n + npad, 6), dtype=torch.float32, device=device)],
                  dim=1)
    w = _block_weights(vs, tri_block)
    nb = w.shape[0]
    # Feature rows 10-15 are zero: [16, 4B] blocks, the cluster table's layout.
    w = torch.cat([w, torch.zeros((nb, 6, 4 * tri_block), dtype=torch.float32,
                                  device=device)], dim=1)
    t0 = torch.full((n + npad,), BIG, dtype=torch.float32, device=device)
    if t_max is not None:
        t0[:n] = t_max
    bt = torch.empty((n + npad,), dtype=torch.float32, device=device)
    btri = torch.empty((n + npad,), dtype=torch.int32, device=device)
    if n:
        BF.launch(device, r.data_ptr(), w.data_ptr(), t0.data_ptr(),
                  bt.data_ptr(), btri.data_ptr(), n + npad, nb, ray_tile, tri_block)
    bt, btri = bt[:n], btri[:n]
    bt = torch.where(btri >= 0, bt, BIG)
    zero = torch.zeros((n,), dtype=torch.float32, device=device)
    return TriHit(t=bt, tri=btri, u=zero, v=zero)


def intersect_mesh_mxu(origin, direction, mesh, t_max=None) -> TriHit:
    """The brute force over a mesh's triangles (``intersect_brute_mxu``:
    kernel 8 on CUDA tensors, the plain version on CPU tensors). The
    winner's t/u/v are re-derived by ``mesh.tri_hit_to_hit``."""
    return intersect_brute_mxu(vm.as_rows(origin), vm.as_rows(direction),
                               mesh.v0, mesh.v1, mesh.v2, t_max=t_max)
