"""Exact entry-ordered block walk: the cluster-walk intersector.

The JAX package's ``ops/walk.py`` in PyTorch, with its two TPU kernels
ported to CUDA (``csrc/slab_cull.cu``, ``csrc/walk.cu``). Per call:

  1. coherence sort: direction octant + origin morton
     (``traverse._coherence_key``), stable, with the rank/permutation helpers
     of ``ops/binned.py``; dead rays and rays that miss the mesh's root box
     sort to the back;
  2. slab cull (kernel 1): [tiles, K] tile-min conservative AABB entry
     bounds into every block;
  3. full select: each tile's feasible blocks in entry order, plus count;
  4. walk (kernel 2): per tile, the blocks in that order with a running
     nearest hit, each ray taking part while its own box entry lies below
     its best t, and the tile stopping once no live ray can beat the next
     entry bound;
  5. un-sort the results.

The result equals brute force over the mesh: every block a hit could lie
in is walked unless a nearer hit already rules it out.

Each kernel's wrapper runs the plain PyTorch version on CPU tensors and
the CUDA kernel on CUDA tensors; there is no other fallback.
"""

from __future__ import annotations

import ctypes

import torch

from kdtreepathtraceroptimization_tpu_torch.ops import cluster as cl
from kdtreepathtraceroptimization_tpu_torch.ops import vecmath as vm
from kdtreepathtraceroptimization_tpu_torch.ops.binned import _apply_perm, _bin_rank
from kdtreepathtraceroptimization_tpu_torch.ops.intersect import BIG
from kdtreepathtraceroptimization_tpu_torch.ops.mesh import TriHit
from kdtreepathtraceroptimization_tpu_torch.ops.traverse import _coherence_key
from kdtreepathtraceroptimization_tpu_torch.utils.cuda_build import MAX_SMEM, CudaKernel, check_tensor

_P = ctypes.c_void_p
_I = ctypes.c_int

SLAB_CULL = CudaKernel("slab_cull", "slab_cull", [_P, _P, _P, _P, _I, _I, _I, _I])
WALK = CudaKernel("walk", "walk", [_P] * 13 + [_I] * 4)

# Blocks a group of kernel 1's two-level cull (csrc/slab_cull.cu kGroup).
SLAB_GROUP = 16
# Elements of [rays, blocks] entries the plain slab cull makes at once.
_REF_CHUNK_ELEMS = 1 << 26


def _ray16(o, d, t0, act):
    """[n, 16] cull features: o d t0 act invd o*invd 0 0.

    invd is sign-preserving and clamped to 1e7 (axis-parallel rays): the
    slab test then under-reports only entries far beyond any scene t,
    and the slack in ``_slab_entry_math`` absorbs the rounding.
    """
    s = torch.where(d >= 0.0, 1.0, -1.0)
    invd = s / torch.clamp_min(torch.abs(d), 1e-7)
    z = torch.zeros((o.shape[0], 2), dtype=torch.float32, device=o.device)
    return torch.cat(
        [o, d, t0[:, None], act[:, None], invd, o * invd, z], dim=1)


def _slab_entry_math(x, slab, blk, kp):
    """[sub, 16] features + [8, K] slab table (rows lo_xyz hi_xyz) ->
    entry [sub, K]: the conservative ray parameter at which the ray can
    first be inside block k's AABB, BIG where infeasible."""
    t0 = x[:, 6:7]
    act = x[:, 7:8] > 0.0
    tmin = torch.full((x.shape[0], kp), -BIG, dtype=torch.float32,
                      device=x.device)
    tmax = torch.full((x.shape[0], kp), BIG, dtype=torch.float32,
                      device=x.device)
    for a in range(3):
        invd = x[:, 8 + a:9 + a]
        oinv = x[:, 11 + a:12 + a]
        tlo = slab[a:a + 1, :] * invd - oinv
        thi = slab[3 + a:4 + a, :] * invd - oinv
        tmin = torch.maximum(tmin, torch.minimum(tlo, thi))
        tmax = torch.minimum(tmax, torch.maximum(tlo, thi))
    slack = 1e-6 * torch.abs(tmin) + 1e-5
    tmin = tmin - slack
    tmax = tmax + slack
    entry = torch.clamp_min(tmin, 0.0)
    feasible = (
        (tmax >= entry)
        & (tmax > 0.0)
        & (entry < t0)
        & act
        & (blk[5:6, :] >= 0.0)  # r2 >= 0: real (non-sentinel) block
    )
    return torch.where(feasible, entry, BIG)


def _group_slab(slab, blk, G: int):
    """The union boxes the extraction kernel builds over each aligned group
    of G blocks -> [8, ceil(kp / G)] rows lo_xyz hi_xyz, 1 where the group
    has a real member (blk row 5 >= 0) and -1 where it has none, 0. A box
    holds each real member's lo and hi on every axis; a ragged last group
    takes the blocks there are. The plain form of the groups of kernels 1
    and 5, for the tests and chip_smoke.py: the main path does not call
    it."""
    kp = slab.shape[1]
    ng = -(-kp // G)
    real = blk[5] >= 0.0
    lo = torch.where(real, torch.minimum(slab[0:3], slab[3:6]), BIG)
    hi = torch.where(real, torch.maximum(slab[0:3], slab[3:6]), -BIG)
    pad = ng * G - kp
    if pad:
        lo = torch.cat([lo, lo.new_full((3, pad), BIG)], dim=1)
        hi = torch.cat([hi, hi.new_full((3, pad), -BIG)], dim=1)
        real = torch.cat([real, real.new_zeros((pad,))])
    out = torch.zeros((8, ng), dtype=torch.float32, device=slab.device)
    out[0:3] = lo.reshape(3, ng, G).amin(dim=2)
    out[3:6] = hi.reshape(3, ng, G).amax(dim=2)
    out[6] = torch.where(real.reshape(ng, G).any(dim=1), 1.0, -1.0)
    return out


def _group_entry(x, gslab):
    """[n, 16] _ray16 records x [8, ng] group boxes (``_group_slab``) ->
    [n, ng]: where the group test of kernels 1 and 5 passes, the group's
    widened entry, else BIG. The kernels run a group's member tests for a
    ray only where this is below BIG (for some ray of the warp). Its
    widening S = slack(max(|tmin|, |tmax| * 1.00001 + 1e-4)) bounds the
    slack of every member the exact test can pass (csrc/slab_group.cuh
    has the argument), so every block with a finite ``_slab_entry_math``
    entry lies in a group with a finite entry here. The same float32
    operations as the kernel's, unfused."""
    t0 = x[:, 6:7]
    act = x[:, 7:8] > 0.0
    shape = (x.shape[0], gslab.shape[1])
    tmin = torch.full(shape, -BIG, dtype=torch.float32, device=x.device)
    tmax = torch.full(shape, BIG, dtype=torch.float32, device=x.device)
    for a in range(3):
        invd = x[:, 8 + a:9 + a]
        oinv = x[:, 11 + a:12 + a]
        tlo = gslab[a:a + 1, :] * invd - oinv
        thi = gslab[3 + a:4 + a, :] * invd - oinv
        tmin = torch.maximum(tmin, torch.minimum(tlo, thi))
        tmax = torch.minimum(tmax, torch.maximum(tlo, thi))
    bnd = torch.maximum(torch.abs(tmin), torch.abs(tmax) * 1.00001 + 1e-4)
    s = 1e-6 * bnd + 1e-5
    t_in = torch.clamp_min(tmin - s, 0.0)
    t_out = tmax + s
    ok = (t_out >= t_in) & (t_out > 0.0) & (t_in < t0) & act & (gslab[6:7, :] > 0.0)
    return torch.where(ok, t_in, BIG)


def _slab_cull_ref(x, slab, blk, tile: int):
    """Plain slab cull: [n/tile, K] tile-min entries, a chunk of tiles at
    a time."""
    n = x.shape[0]
    kp = blk.shape[1]
    rows = max(tile, _REF_CHUNK_ELEMS // kp // tile * tile)
    out = [
        _slab_entry_math(x[i:i + rows], slab, blk, kp)
        .reshape(-1, tile, kp).amin(dim=1)
        for i in range(0, n, rows)
    ]
    return torch.cat(out) if out else x.new_empty((0, kp))


def _slab_cull_grouped(x, slab, blk, tile: int, G: int = SLAB_GROUP):
    """Kernel 1's skip in plain form: the tile min of ``_slab_entry_math``
    over only the (ray, block) tests the kernel runs. Per tile it takes the
    live rays in order, 32 to a warp, and a warp tests the members of an
    aligned group of ``G`` blocks only if the group test
    (``_group_entry`` on ``_group_slab``'s union boxes) passes
    for one of its rays. Equal to ``_slab_cull_ref`` wherever every
    feasible (ray, block) lies in a group that passes for the ray: the
    premise the tests and chip_smoke.py hold. For tests and chip_smoke.py;
    the main path does not call it."""
    gslab = _group_slab(slab, blk, G)
    kp = blk.shape[1]
    return cl._grouped_tile_min(x, x[:, 7] > 0.0, kp, lambda xs: _slab_entry_math(xs, slab, blk, kp),
                                lambda xs: _group_entry(xs, gslab), tile, G)


def slab_cull(x, slab, blk, tile: int):
    """[n/tile, K] tile-min conservative AABB entry bounds (kernel 1)."""
    if x.device.type == "cpu":
        return _slab_cull_ref(x, slab, blk, tile)
    if x.device.type != "cuda":
        raise ValueError(f"slab_cull runs on CUDA or CPU tensors, not {x.device}")
    device = x.device
    n = x.shape[0]
    kp = blk.shape[1]
    if tile <= 0 or n % tile or SLAB_CULL.call_int("slab_cull_smem_bytes", tile) > MAX_SMEM:
        raise ValueError(f"slab_cull: bad tile {tile} for {n} rays")
    check_tensor(x, "x", torch.float32, (n, 16), device)
    check_tensor(slab, "slab", torch.float32, (8, kp), device)
    check_tensor(blk, "blk", torch.float32, (8, kp), device)
    out = torch.empty((n // tile, kp), dtype=torch.float32, device=device)
    if n:
        SLAB_CULL.launch(device, x.data_ptr(), slab.data_ptr(), blk.data_ptr(),
                         out.data_ptr(), n, kp, tile, MAX_SMEM)
    return out


def vmem_tile_cap(kp: int, budget_bytes: int = 1 << 21) -> int:
    """Largest pow-2 ray tile whose [tile, kp] f32 entry table stays under
    ``budget_bytes`` — the JAX package's tile rule, kept so that tiles,
    and the order of ties across blocks, match it."""
    t = 8
    while t * 2 * kp * 4 <= budget_bytes:
        t *= 2
    return t


def _full_select(tile_entry):
    """Entry-ordered FULL per-tile block lists: ``cluster._select`` over all
    K rounds -> sel [G, K] i32, lb [G, K] f32 (BIG past the feasible
    ones), and nsel [G, 1] i32, the feasible count."""
    sel, lb, _ = cl._select(tile_entry, tile_entry.shape[1])
    return sel, lb, (lb < BIG).sum(dim=1, dtype=torch.int32)[:, None]


# The box test of the walk and the rounds widens each block's box by
# BOX_MARGIN_REL of its largest extent plus BOX_MARGIN_ABS
# (csrc/round_walk.cuh box_margin): far above the rounding of the test, so
# that every accepted hit in the block lies inside the widened box.
BOX_MARGIN_REL = 1e-3
BOX_MARGIN_ABS = 1e-4


def _box_entry(o, d, slab):
    """[n] rays x [K] boxes -> [n, K]: the least t >= 0 at which each ray
    meets each block's box widened by the margin, inf where it never does.
    The plain form of the per-ray skip of the walk and the rounds
    (csrc/round_walk.cuh meets_box(..., t) is ``_box_entry(...) <= t``),
    in the same float32 operations: an axis with d = 0 is a containment
    test, the others slabs through 1 / d; fmax and fmin pass over a NaN as
    fmaxf and fminf do."""
    lo, hi = slab[0:3], slab[3:6]
    m = BOX_MARGIN_REL * (hi - lo).amax(dim=0) + BOX_MARGIN_ABS
    n = o.shape[0]
    t_in = torch.zeros((n, lo.shape[1]), dtype=torch.float32, device=o.device)
    t_out = torch.full_like(t_in, torch.inf)
    inside = torch.ones_like(t_in, dtype=torch.bool)
    for a in range(3):
        l, h = lo[a] - m, hi[a] + m
        oa, da = o[:, a:a + 1], d[:, a:a + 1]
        still = da == 0.0
        inv = torch.where(still, 0.0, 1.0 / da)
        t1, t2 = (l - oa) * inv, (h - oa) * inv
        inside &= ~still | ((oa >= l) & (oa <= h))
        t_in = torch.where(still, t_in, torch.fmax(t_in, torch.fmin(t1, t2)))
        t_out = torch.where(still, t_out, torch.fmin(t_out, torch.fmax(t1, t2)))
    return torch.where(inside & (t_in <= t_out), t_in, torch.inf)


def _walk_ref(sel, lb, r, t0, act, w, tile: int, block: int):
    """Plain walk: the round loop over every listed round, each tile
    skipping the rounds no live ray of it can still improve in, which
    is where the kernel stops (blocks come in entry order)."""
    return cl._cluster_ref(sel, lb, r, t0, act, w, tile, block, sel.shape[1])


def walk(sel, lb, nsel, r, t0, act, cm: "cl.ClusterMesh", tile: int, rounds=None):
    """Per-tile entry-ordered block walk (kernel 2) over the cluster table
    ``cm`` -> (bt [n], btri [n]): each ray's nearest t below its t0 and
    that triangle's id (-1 = none).

    The kernel tests only each block's real slots (``cm.real``), and a ray
    only against the blocks whose box (``cm.slab``) it enters before its
    best t. Unless None, ``rounds`` [n / tile, 2] int32 gains, per tile,
    the rounds its thread blocks ran and the (32-ray group, real slot)
    tests they ran (kernel only: a measurement, which the render passes
    as None)."""
    if r.device.type == "cpu":
        return _walk_ref(sel, lb, r, t0, act, cm.w, tile, cm.block)
    if r.device.type != "cuda":
        raise ValueError(f"walk runs on CUDA or CPU tensors, not {r.device}")
    device = r.device
    n = r.shape[0]
    g = n // tile
    kp, block = cm.n_blocks, cm.block
    if (tile <= 0 or block <= 0 or n % tile
            or WALK.call_int("walk_smem_bytes", block) > MAX_SMEM):
        raise ValueError(f"walk: bad tile {tile} / block {block} for {n} rays")
    check_tensor(sel, "sel", torch.int32, (g, kp), device)
    check_tensor(lb, "lb", torch.float32, (g, kp), device)
    check_tensor(nsel, "nsel", torch.int32, (g, 1), device)
    check_tensor(r, "r", torch.float32, (n, 16), device)
    check_tensor(t0, "t0", torch.float32, (n,), device)
    check_tensor(act, "act", torch.float32, (n,), device)
    check_tensor(cm.w, "w", torch.float32, (kp, 16, 4 * block), device)
    check_tensor(cm.real, "real", torch.int32, (kp,), device)
    check_tensor(cm.slab, "slab", torch.float32, (8, kp), device)
    if rounds is not None:
        check_tensor(rounds, "rounds", torch.int32, (g, 2), device)
    bt = torch.empty((n,), dtype=torch.float32, device=device)
    btri = torch.empty((n,), dtype=torch.int32, device=device)
    if n:
        # longest feasible list first: the short ones fill the last wave
        order = torch.sort(nsel[:, 0], descending=True, stable=True).indices.to(torch.int32)
        WALK.launch(device, sel.data_ptr(), lb.data_ptr(), nsel.data_ptr(), order.data_ptr(),
                    r.data_ptr(), t0.data_ptr(), act.data_ptr(), cm.w.data_ptr(),
                    cm.real.data_ptr(), cm.slab.data_ptr(), bt.data_ptr(), btri.data_ptr(),
                    None if rounds is None else rounds.data_ptr(), n, kp, tile, block)
    return bt, btri


# ---------------------------------------------------------------------------
# public entry
# ---------------------------------------------------------------------------


def intersect_mesh_walk(origin, direction, cm: "cl.ClusterMesh", config,
                        t_init=None, active=None) -> TriHit:
    """Nearest hit over the cluster mesh; exact (brute-equal) results.

    ``t_init`` bounds the cull and the per-ray running min (analytic geoms
    first); ``active`` lanes cull nothing and sort to the back.
    """
    if config.binned_shards != 1:
        raise NotImplementedError(
            "binned_shards != 1 (a sort local to each chip's shard) is not "
            "ported: the port runs on one device")
    origin = vm.as_rows(origin)
    direction = vm.as_rows(direction)
    n = origin.shape[0]
    tile = min(config.cluster_tile, vmem_tile_cap(cm.slab.shape[1]))
    origin, direction, t0, act = cl._pad_rays(origin, direction, cm, tile, t_init, active)

    key = _coherence_key(origin, direction, act, cm.root_min, cm.root_max)
    rank, perm = _bin_rank(key)

    direction = torch.where(act[:, None], direction, 0.0)
    x = _ray16(origin, direction, t0, act.to(torch.float32))
    x = _apply_perm(x, perm)
    t0s = x[:, 6].contiguous()
    acts = x[:, 7].contiguous()

    tile_entry = slab_cull(x, cm.slab, cm.blk, tile)
    sel, lb, nsel = _full_select(tile_entry)

    r = cl._ray_rows(x)
    bt, btri = walk(sel, lb, nsel, r, t0s, acts, cm, tile)

    bt = _apply_perm(bt, rank)[:n]
    btri = _apply_perm(btri, rank)[:n]
    bt = torch.where(btri >= 0, bt, BIG)
    zero = torch.zeros((n,), dtype=torch.float32, device=bt.device)
    return TriHit(t=bt, tri=btri, u=zero, v=zero)
