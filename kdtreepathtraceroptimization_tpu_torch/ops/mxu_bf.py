"""Moller-Trumbore as a product, and the brute force built on it.

From the JAX package's ``ops/mxu_bf.py``: with the ray feature row
``R = [o, d, o x d, 1]`` and a per-triangle weight matrix ``W [10, 4T]``
(columns grouped as the a / t_num / u_num / v_num blocks), ``R @ W``
gives every quantity the triangle test needs, and the test itself is a
handful of comparisons (``_epilogue``). The cluster table stores ``W``
per block (``ops/cluster.py``); the walk, pair and brute-force kernels
evaluate the same product and epilogue per ray (``csrc/round_walk.cuh``,
``csrc/mt_block.cuh``).

Only 19 of a triangle's 40 weights can be non-zero, and a's three are
the negation of three of t_num's (``SPARSE_ORDER``,
``check_sparse_pattern``): the walk, cluster-rounds, kernel-7 pair and
brute-force kernels stage a triangle's 16 distinct weights (the brute
force's from ``sparse_weights``) and run only the non-zero multiply-adds,
with the same results (``csrc/mt_block.cuh``).

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

BF = CudaKernel("mxu_bf", "mxu_bf", [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I])

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


# The (quantity, feature row) of a triangle's 16 distinct weights, in the
# order the sparse kernels stage them (csrc/mt_block.cuh); quantities 0-3
# are a, t_num, u_num, v_num. a's own weights, rows 3-5, are the negation
# of t_num's rows 0-2.
SPARSE_ORDER = ((1, 0), (1, 1), (1, 2), (1, 9),
                *((2, f) for f in range(3, 9)), *((3, f) for f in range(3, 9)))
_NONZERO = ((0, 3), (0, 4), (0, 5)) + SPARSE_ORDER


def check_sparse_pattern(w: torch.Tensor) -> None:
    """Raise ValueError unless the weight blocks ``w`` [K, F >= 10, 4B]
    (``_block_weights``, the cluster table) have the weight tables' zero
    pattern: non-zero only in the 19 places ``_NONZERO`` lists, and a's
    rows 3-5 equal to -(t_num's rows 0-2) (bit for bit but the sign of a
    zero). The sparse kernels' precondition."""
    k, f, cols = w.shape
    w4 = w.reshape(k, f, 4, cols // 4)
    allowed = torch.zeros((f, 4), dtype=torch.bool, device=w.device)
    for q, row in _NONZERO:
        allowed[row, q] = True
    stray = int((w4[:, ~allowed, :] != 0).sum())
    if stray:
        raise ValueError(f"{stray} weights outside the 19 non-zero places")
    if not torch.equal(w4[:, 3:6, 0, :], -w4[:, 0:3, 1, :]):
        raise ValueError("a's rows 3-5 are not -(t_num's rows 0-2)")


def sparse_weights(w: torch.Tensor) -> torch.Tensor:
    """[K, F, 4B] weight blocks -> [K, B, 16]: each triangle's 16 distinct
    weights in ``SPARSE_ORDER``, contiguous."""
    k, f, cols = w.shape
    w4 = w.reshape(k, f, 4, cols // 4)
    return torch.stack([w4[:, row, q, :] for q, row in SPARSE_ORDER], dim=-1).contiguous()


def live_first(direction: torch.Tensor):
    """(perm, inv) [n]: ``perm`` lists the rays with a direction first and
    those with d = 0 (which never hit) after them, each in order; ``inv``
    undoes it (``x[perm][inv]`` is ``x``)."""
    dead = (direction == 0).all(dim=1)
    perm = torch.sort(dead.to(torch.uint8), stable=True).indices
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.shape[0], device=perm.device)
    return perm, inv


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
    block. Rays with d = 0 (they never hit) are sorted to the back, where
    whole tiles of them skip the tests; rays are padded to ``ray_tile``
    with such rays and triangles to ``tri_block`` with degenerate ones.
    CPU tensors take the plain version at the same block size."""
    if origin.device.type == "cpu":
        return intersect_brute_mxu_ref(origin, direction, v0, v1, v2, t_max,
                                       block=tri_block)
    if origin.device.type != "cuda":
        raise ValueError(f"intersect_brute_mxu runs on CUDA or CPU tensors, not {origin.device}")
    device = origin.device
    rpt = BF.call_int("mxu_bf_rays_per_thread")
    if (ray_tile <= 0 or ray_tile % rpt or ray_tile > BF.call_int("mxu_bf_max_tile")
            or tri_block <= 0 or BF.call_int("mxu_bf_smem_bytes", tri_block) > MAX_SMEM):
        raise ValueError(f"intersect_brute_mxu: bad ray tile {ray_tile} / "
                         f"triangle block {tri_block}")
    n = origin.shape[0]
    ntri = v0.shape[0]
    npad = (-n) % ray_tile
    origin, vs = _centered(origin, v0, v1, v2, tri_block)
    direction = direction.to(torch.float32)
    t0 = (torch.full((n,), BIG, dtype=torch.float32, device=device) if t_max is None
          else t_max.to(torch.float32))
    perm, inv = live_first(direction)
    z3 = torch.zeros((npad, 3), dtype=torch.float32, device=device)
    origin = torch.cat([origin[perm], z3])
    direction = torch.cat([direction[perm], z3])
    t0 = torch.cat([t0[perm], torch.full((npad,), BIG, dtype=torch.float32, device=device)])
    r = torch.cat([ray_features(origin, direction),
                   torch.zeros((n + npad, 6), dtype=torch.float32, device=device)],
                  dim=1)
    ws = sparse_weights(_block_weights(vs, tri_block))
    nb = ws.shape[0]
    bt = torch.empty((n + npad,), dtype=torch.float32, device=device)
    btri = torch.empty((n + npad,), dtype=torch.int32, device=device)
    if n:
        BF.launch(device, r.data_ptr(), ws.data_ptr(), t0.data_ptr(), bt.data_ptr(),
                  btri.data_ptr(), n + npad, ntri, nb, ray_tile, tri_block)
    bt, btri = bt[:n][inv], btri[:n][inv]
    bt = torch.where(btri >= 0, bt, BIG)
    zero = torch.zeros((n,), dtype=torch.float32, device=device)
    return TriHit(t=bt, tri=btri, u=zero, v=zero)


def intersect_mesh_mxu(origin, direction, mesh, t_max=None) -> TriHit:
    """The brute force over a mesh's triangles (``intersect_brute_mxu``:
    kernel 8 on CUDA tensors, the plain version on CPU tensors). The
    winner's t/u/v are re-derived by ``mesh.tri_hit_to_hit``."""
    return intersect_brute_mxu(vm.as_rows(origin), vm.as_rows(direction),
                               mesh.v0, mesh.v1, mesh.v2, t_max=t_max)
