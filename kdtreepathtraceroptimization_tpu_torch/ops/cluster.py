"""Cluster table and the cluster-rounds intersector.

The JAX package's ``ops/cluster.py`` in PyTorch, with its three TPU kernels
ported to CUDA (``csrc/cluster_cull.cu``, ``csrc/cluster_rounds.cu``,
``csrc/cluster_sweep.cu``). The host build is numpy, so its arrays equal
the JAX build bit for bit: it
splits the triangles into median-split KD leaves of ``block`` triangles
(padding leaves with degenerate copies that never win), keeps each block's
Moller-Trumbore weights ``[16, 4B]`` (``ops/mxu_bf``), bounding sphere and
AABB, and pads the block axis to a multiple of 128 with never-feasible
sentinel blocks. Hit triangle ids index ``ClusterMesh.tris`` directly.

The intersector (``intersect_mesh_cluster``), per call:

  1. coherence sort (``cluster_sort``): direction octant + origin morton,
     stable; dead rays and rays that miss the mesh's root box go last;
  2. sphere cull (kernel 9): [tiles, K] tile-min conservative entry bounds
     into every block's bounding sphere;
  3. select: each tile's first R = ``cluster_rounds`` feasible blocks in
     entry order, and the entry bound of the first block left out;
  4. rounds (kernel 10): per tile, the R blocks in order with a running
     nearest hit; a round runs only while some live ray can still beat
     its entry bound;
  5. repair (kernel 11): a ray whose best t exceeds its tile's first
     unselected entry bound is flagged; if any ray is, each flagged ray
     sweeps every real triangle, bounded by its best t. The flag count is
     one host read;
  6. un-sort the results.

The result equals brute force over the mesh. The plain round loop
``_cluster_ref`` is also the walk kernel's plain version (``ops/walk.py``).
Each kernel's wrapper runs the plain PyTorch version on CPU tensors and
the CUDA kernel on CUDA tensors; there is no other fallback.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from kdtreepathtraceroptimization_tpu_torch.ops import mxu_bf
from kdtreepathtraceroptimization_tpu_torch.ops import vecmath as vm
from kdtreepathtraceroptimization_tpu_torch.ops.intersect import BIG
from kdtreepathtraceroptimization_tpu_torch.ops.mesh import TriHit, pack_tris
from kdtreepathtraceroptimization_tpu_torch.ops.traverse import _coherence_key
from kdtreepathtraceroptimization_tpu_torch.scene.structs import MeshSoA
from kdtreepathtraceroptimization_tpu_torch.utils.cuda_build import MAX_SMEM, CudaKernel, check_tensor
from kdtreepathtraceroptimization_tpu_torch.utils.device import resolve_device, to_tensor

_P = ctypes.c_void_p
_I = ctypes.c_int

CULL = CudaKernel("cluster_cull", "cluster_cull", [_P, _P, _P, _P, _I, _I, _I, _I])
ROUNDS = CudaKernel("cluster_rounds", "cluster_rounds", [_P] * 13 + [_I] * 5)
SWEEP = CudaKernel("cluster_sweep", "cluster_sweep",
                   [_P, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I])

# Blocks a group of kernel 9's two-level cull (csrc/cluster_cull.cu kGroup).
CULL_GROUP = 8
# Elements of [rays, blocks] entries the plain cull makes at once.
_REF_ENTRY_ELEMS = 1 << 26


class ClusterMesh(NamedTuple):
    """Blocked triangle table + per-block bounds (tensors on the device)."""

    w: torch.Tensor        # [Kpad, 16, 4B] f32 MT weight blocks (centered)
    blk: torch.Tensor      # [8, Kpad] f32 rows: cx cy cz radius |c|^2 r2 0 0
    cull_w: torch.Tensor   # [8, 2*Kpad] f32 sphere-cull weights (d.c | o.c)
    slab: torch.Tensor     # [8, Kpad] f32 AABB rows lo_xyz hi_xyz 0 0
    center_shift: torch.Tensor  # [3] f32 shift applied to tris/rays
    root_min: torch.Tensor  # [3] f32 sphere-union lower corner (centered)
    root_max: torch.Tensor  # [3] f32 sphere-union upper corner (centered)
    tris: MeshSoA          # block-ordered padded mesh
    block: int             # B, triangles per block
    n_real_blocks: int     # K before lane padding
    packed: torch.Tensor   # [T, 19] f32 rows of tris (ops.mesh.pack_tris)
    real: torch.Tensor     # [Kpad] i32 leading slots of each block that can hit (real_slots)

    @property
    def n_blocks(self) -> int:
        return int(self.blk.shape[1])


def _morton3(x: np.ndarray) -> np.ndarray:
    """[N, 3] float -> 63-bit Morton codes (21 bits/axis)."""
    lo = x.min(axis=0)
    hi = x.max(axis=0)
    span = np.maximum(hi - lo, 1e-12)
    q = np.clip(((x - lo) / span * ((1 << 21) - 1)), 0, (1 << 21) - 1)
    q = q.astype(np.uint64)

    def spread(v):
        v &= np.uint64(0x1FFFFF)
        v = (v | (v << np.uint64(32))) & np.uint64(0x1F00000000FFFF)
        v = (v | (v << np.uint64(16))) & np.uint64(0x1F0000FF0000FF)
        v = (v | (v << np.uint64(8))) & np.uint64(0x100F00F00F00F00F)
        v = (v | (v << np.uint64(4))) & np.uint64(0x10C30C30C30C30C3)
        v = (v | (v << np.uint64(2))) & np.uint64(0x1249249249249249)
        return v

    return (
        spread(q[:, 0]) | (spread(q[:, 1]) << np.uint64(1))
        | (spread(q[:, 2]) << np.uint64(2))
    )


def _kd_leaf_order(v0, v1, v2, cap: int) -> np.ndarray:
    """Median-split KD partition into leaves of <= cap triangles, split on
    the widest centroid axis. Returns [n_leaves, cap] triangle indices,
    each leaf padded to cap by repeating its last member."""
    cent = (v0 + v1 + v2) / 3.0
    out = []

    def rec(idx):
        if idx.size <= cap:
            out.append(np.concatenate(
                [idx, np.full(cap - idx.size, idx[-1], np.int64)]))
            return
        c = cent[idx]
        ax = int(np.argmax(c.max(0) - c.min(0)))
        med = np.argsort(c[:, ax], kind="stable")
        half = idx.size // 2
        rec(idx[med[:half]])
        rec(idx[med[half:]])

    rec(np.arange(v0.shape[0], dtype=np.int64))
    return np.stack(out)


def build_cluster_mesh(mesh: MeshSoA, block: int = 256, method: str = "kd",
                       device=None) -> ClusterMesh:
    """Host build of the cluster table from a numpy ``mesh``; returns its
    tensors on ``device`` (the CUDA device by default).

    ``method``: "kd" (default) = median-split spatial leaves with tight,
    nearly disjoint AABBs; "morton" = Z-order chunks.
    """
    device = resolve_device(device)
    v0 = np.asarray(mesh.v0, np.float32)
    v1 = np.asarray(mesh.v1, np.float32)
    v2 = np.asarray(mesh.v2, np.float32)
    t_count = v0.shape[0]

    if method == "kd":
        leaf = _kd_leaf_order(v0, v1, v2, block)  # [K, block]
        idx = leaf.reshape(-1)
        # a slot is padding iff it repeats the slot before it
        real = np.ones(idx.shape[0], bool)
        real[1:] = idx[1:] != idx[:-1]
    else:
        cent = (v0 + v1 + v2) / 3.0
        order = np.argsort(_morton3(cent), kind="stable")
        pad = (-t_count) % block
        idx = np.concatenate([order, np.full(pad, order[-1], np.int64)])
        real = np.ones(idx.shape[0], bool)
        real[t_count:] = False

    # Padding slots duplicate a real triangle with all-equal vertices
    # (MT determinant 0 -> culled, never wins).
    dv0 = v0[idx].copy()
    dv1 = v1[idx].copy()
    dv2 = v2[idx].copy()
    dv1[~real] = dv0[~real]
    dv2[~real] = dv0[~real]

    tris = MeshSoA(
        v0=dv0, v1=dv1, v2=dv2,
        n0=np.asarray(mesh.n0)[idx], n1=np.asarray(mesh.n1)[idx],
        n2=np.asarray(mesh.n2)[idx],
        material_id=np.asarray(mesh.material_id)[idx],
        shape_id=np.asarray(mesh.shape_id)[idx],
        shape_bbox_min=mesh.shape_bbox_min,
        shape_bbox_max=mesh.shape_bbox_max,
    )

    center_shift = 0.5 * (
        np.minimum(dv0.min(0), np.minimum(dv1.min(0), dv2.min(0)))
        + np.maximum(dv0.max(0), np.maximum(dv1.max(0), dv2.max(0)))
    ).astype(np.float32)
    cv0, cv1, cv2 = dv0 - center_shift, dv1 - center_shift, dv2 - center_shift

    k = cv0.shape[0] // block
    b0 = cv0.reshape(k, block, 3)
    b1 = cv1.reshape(k, block, 3)
    b2 = cv2.reshape(k, block, 3)
    lo = np.minimum(b0.min(1), np.minimum(b1.min(1), b2.min(1)))
    hi = np.maximum(b0.max(1), np.maximum(b1.max(1), b2.max(1)))
    centers = (0.5 * (lo + hi)).astype(np.float32)
    radii = (0.5 * np.linalg.norm(hi - lo, axis=1) + 1e-5).astype(np.float32)

    # MT weights (mxu_bf form): columns [a | t | u | v] per block.
    e1 = cv1 - cv0
    e2 = cv2 - cv0
    nrm = np.cross(e1, e2)
    c = np.sum(cv0 * nrm, axis=1)
    e2xv0 = np.cross(e2, cv0)
    v0xe1 = np.cross(cv0, e1)
    tq = cv0.shape[0]
    z3 = np.zeros((tq, 3), np.float32)
    z1 = np.zeros((tq, 1), np.float32)
    one = np.ones((tq, 1), np.float32)
    w_a = np.concatenate([z3, -nrm, z3, z1], axis=1)
    w_t = np.concatenate([nrm, z3, z3, -c[:, None] * one], axis=1)
    w_u = np.concatenate([z3, -e2xv0, e2, z1], axis=1)
    w_v = np.concatenate([z3, -v0xe1, -e1, z1], axis=1)
    w = np.concatenate([w_a, w_t, w_u, w_v], axis=0).T.astype(np.float32)
    w = (
        w.reshape(10, 4, k, block)
        .transpose(2, 0, 1, 3)
        .reshape(k, 10, 4 * block)
    )
    # Feature rows 10-15 are zero: [16, 4B] blocks.
    w = np.concatenate([w, np.zeros((k, 6, 4 * block), np.float32)], axis=1)

    # Pad the block axis with never-feasible sentinels (r2 = -1) and zero
    # weights (determinant 0 -> never hit if ever streamed).
    kpad = (-k) % 128
    if kpad:
        w = np.concatenate(
            [w, np.zeros((kpad, 16, 4 * block), np.float32)], axis=0
        )
    kp = k + kpad
    blk = np.zeros((8, kp), np.float32)
    blk[0:3, :k] = centers.T
    blk[3, :k] = radii
    blk[4, :k] = np.sum(centers * centers, axis=1)
    blk[5, :k] = radii * radii
    blk[5, k:] = -1.0  # sentinel: never feasible
    cull_w = np.zeros((8, 2 * kp), np.float32)
    cull_w[3:6, :k] = centers.T      # d . c
    cull_w[0:3, kp:kp + k] = centers.T  # o . c

    # AABB slab table (walk slab cull): rows 0-2 = lo, 3-5 = hi; sentinel
    # columns stay 0 and are rejected by blk row 5 (r2 = -1).
    slab = np.zeros((8, kp), np.float32)
    slab[0:3, :k] = lo.T
    slab[3:6, :k] = hi.T

    root_min = (centers - radii[:, None]).min(0)
    root_max = (centers + radii[:, None]).max(0)

    tris = MeshSoA(*(to_tensor(a, device) for a in tris))
    return ClusterMesh(
        w=to_tensor(w, device),
        blk=to_tensor(blk, device),
        cull_w=to_tensor(cull_w, device),
        slab=to_tensor(slab, device),
        center_shift=to_tensor(center_shift, device),
        root_min=to_tensor(root_min, device),
        root_max=to_tensor(root_max, device),
        tris=tris,
        block=block,
        n_real_blocks=k,
        packed=pack_tris(tris),
        real=real_slots(tris, block, kp),
    )


def real_slots(tris: MeshSoA, block: int, n_blocks: int):
    """[n_blocks] i32: one past block k's last slot that is not a padding
    copy (v1 = v2 = v0: determinant 0, never hit). The build pads a leaf at
    its end, so the slots before real[k] are the block's triangles; the
    lane-padding blocks have none."""
    pad = (tris.v1 == tris.v0).all(dim=1) & (tris.v2 == tris.v0).all(dim=1)
    k = pad.shape[0] // block
    slot = torch.arange(1, block + 1, dtype=torch.int32, device=pad.device)
    real = torch.where(pad.reshape(k, block), 0, slot).amax(dim=1).to(torch.int32)
    return torch.cat([real, real.new_zeros(n_blocks - k)])


# Largest [tiles, tile, 4B] product the plain round loop makes at once
# (elements); bounds its memory at full size.
_REF_CHUNK_ELEMS = 1 << 28


def _cluster_ref(sel, lb, r, t0, act, w, tile: int, block: int,
                 rounds: int):
    """Plain round loop: tile g tests the blocks ``sel[g, :rounds]`` in
    order, one batched product per round over the tiles that run it,
    keeping the running min (first argmin within a block, strict ``<``
    across rounds).

    With ``lb``, round rr runs for tile g only while some live ray (act >
    0) of the tile has a best t above lb[g, rr], as the kernels decide
    (the JAX ``_cluster_ref`` runs every round: a skipped round cannot
    improve the tile, as blocks come in entry order). ``lb=None`` runs
    every round for every tile (the sweep). The product never exceeds
    ``_REF_CHUNK_ELEMS`` elements at once.
    """
    n = r.shape[0]
    g = n // tile
    rt = r.reshape(g, tile, 16)
    bt = t0.reshape(g, tile).clone()
    btri = torch.full_like(bt, -1, dtype=torch.int32)
    every = torch.arange(g, device=r.device)
    live_rays = None if lb is None else act.reshape(g, tile) > 0
    chunk = max(1, _REF_CHUNK_ELEMS // (tile * 4 * block))
    for rr in range(rounds):
        tiles = every
        if lb is not None:
            tiles = every[(live_rays & (bt > lb[:, rr:rr + 1])).any(dim=1)]
        for c0 in range(0, tiles.shape[0], chunk):
            ti = tiles[c0:c0 + chunk]
            ks = sel[ti, rr].long()
            cur = bt[ti]
            prod = torch.bmm(rt[ti], w[ks])  # [tiles, tile, 4B]
            t = mxu_bf._epilogue(
                prod.reshape(-1, 4 * block), block, cur.reshape(-1)
            ).reshape(-1, tile, block)
            loc = torch.argmin(t, dim=2)
            lt = torch.gather(t, 2, loc[..., None])[..., 0]
            better = lt < cur
            tri_idx = (ks[:, None] * block + loc).to(torch.int32)
            bt[ti] = torch.where(better, lt, cur)
            btri[ti] = torch.where(better, tri_idx, btri[ti])
    return bt.reshape(n), btri.reshape(n)


# ---------------------------------------------------------------------------
# sphere cull (kernel 9)
# ---------------------------------------------------------------------------


def _entry_math(o, d, t0, act, radius, cc, r2, p1, p2):
    """Conservative entry bound per (ray, block) pair, BIG where the pair is
    infeasible (sphere missed or entirely behind, beyond the ray's bound,
    dead lane, sentinel block).

    entry = max(t_ca - radius, 0), t_ca = d.c - o.d the ray parameter of
    the closest approach to the block's centre; ``p1`` = d.c and ``p2`` =
    o.c. Every product is rounded on its own and three-term dot products
    are summed left to right, as the CUDA kernels do."""
    od = o[:, 0:1] * d[:, 0:1] + o[:, 1:2] * d[:, 1:2] + o[:, 2:3] * d[:, 2:3]
    oo = o[:, 0:1] * o[:, 0:1] + o[:, 1:2] * o[:, 1:2] + o[:, 2:3] * o[:, 2:3]
    t_ca = p1 - od
    dline2 = cc - 2.0 * p2 + oo - t_ca * t_ca
    entry = torch.clamp_min(t_ca - radius, 0.0)
    feasible = (
        (dline2 <= r2)
        & (t_ca + radius > 0.0)
        & (entry < t0)
        & act
        & (r2 >= 0.0)
    )
    return torch.where(feasible, entry, BIG)


def _entries(x, cull_w, blk):
    """[n, 8] ray records (o d t0 act) -> [n, K] entry bounds.

    The TPU takes (d.c | o.c) as ``x @ cull_w``, whose other five terms
    are exactly zero; here each half is its three non-zero terms."""
    kp = blk.shape[1]
    p1 = (x[:, 3:4] * cull_w[3:4, :kp] + x[:, 4:5] * cull_w[4:5, :kp]
          + x[:, 5:6] * cull_w[5:6, :kp])
    p2 = (x[:, 0:1] * cull_w[0:1, kp:] + x[:, 1:2] * cull_w[1:2, kp:]
          + x[:, 2:3] * cull_w[2:3, kp:])
    return _entry_math(x[:, 0:3], x[:, 3:6], x[:, 6:7], x[:, 7:8] > 0.0,
                       blk[3:4, :], blk[4:5, :], blk[5:6, :], p1, p2)


def _cull_ref(x, cull_w, blk, tile: int):
    """Plain sphere cull: [n/tile, K] tile-min entries, a chunk of tiles
    at a time."""
    n = x.shape[0]
    kp = blk.shape[1]
    rows = max(tile, _REF_ENTRY_ELEMS // kp // tile * tile)
    out = [_entries(x[i:i + rows], cull_w, blk).reshape(-1, tile, kp).amin(dim=1)
           for i in range(0, n, rows)]
    return torch.cat(out) if out else x.new_empty((0, kp))


# The unit roundoff of float32, 2^-24: the group test's margins are
# multiples of it (csrc/cluster_entry.cuh).
_U = 2.0 ** -24
# The group sphere's f64 bounds are scaled up by this before they are
# rounded up to float32 (csrc/cluster_entry.cuh group_sphere).
_GROUP_UP = 1.0 + 2.0 ** -30


def _f32_up(v):
    """float64 -> the least float32 >= v (``__double2float_ru``)."""
    r = v.to(torch.float32)
    return torch.where(r.to(torch.float64) < v, torch.nextafter(r, torch.full_like(r, torch.inf)), r)


def _group_sphere(cull_w, blk, G: int):
    """The bounding spheres kernel 9 builds over each aligned group of G
    blocks -> [8, ceil(kp / G)] rows C_xyz, R, |C|^2, CR >= |C| + R, 1
    where the group has a real member (blk row 5 >= 0) and -1 where it has
    none, 0. C is the centre of the box around the real members' spheres
    (centres from cull_w's d.c half, radius max(radius, sqrt(r2))), R >=
    |c_k - C| + radius_k over them, both bounds computed in float64 and
    rounded up to float32; an empty group is all zeros but its -1. The same
    operations as csrc/cluster_entry.cuh group_sphere. For the tests and
    chip_smoke.py: the main path does not call it."""
    kp = blk.shape[1]
    ng = -(-kp // G)
    pad = ng * G - kp
    c = cull_w[3:6, :kp].to(torch.float64)
    real = blk[5] >= 0.0
    rb = torch.maximum(blk[3].to(torch.float64), torch.sqrt(blk[5].to(torch.float64).clamp_min(0.0)))
    if pad:
        c = torch.cat([c, c.new_zeros((3, pad))], dim=1)
        rb = torch.cat([rb, rb.new_zeros((pad,))])
        real = torch.cat([real, real.new_zeros((pad,))])
    lo = torch.where(real, c - rb, 1e300).reshape(3, ng, G).amin(dim=2)
    hi = torch.where(real, c + rb, -1e300).reshape(3, ng, G).amax(dim=2)
    nonempty = real.reshape(ng, G).any(dim=1)
    cen = torch.where(nonempty, 0.5 * (lo + hi), 0.0).to(torch.float32)  # [3, ng]
    dv = c - cen.to(torch.float64).repeat_interleave(G, dim=1)
    reach = torch.sqrt(dv[0] * dv[0] + dv[1] * dv[1] + dv[2] * dv[2]) + rb
    rmax = torch.where(real, reach, 0.0).reshape(ng, G).amax(dim=1)
    radius = _f32_up(rmax * _GROUP_UP)
    c64 = cen.to(torch.float64)
    norm = torch.sqrt(c64[0] * c64[0] + c64[1] * c64[1] + c64[2] * c64[2])
    out = torch.zeros((8, ng), dtype=torch.float32, device=blk.device)
    out[0:3] = cen
    out[3] = torch.where(nonempty, radius, 0.0)
    out[4] = torch.where(nonempty, cen[0] * cen[0] + cen[1] * cen[1] + cen[2] * cen[2], 0.0)
    out[5] = torch.where(nonempty, _f32_up((norm + radius.to(torch.float64)) * _GROUP_UP), 0.0)
    out[6] = torch.where(nonempty, 1.0, -1.0)
    return out


def _group_sphere_entry(x, gsph):
    """[n, 8] ray records (o d t0 act) x [8, ng] group spheres
    (``_group_sphere``) -> [n, ng]: where kernel 9's group test passes, the
    group's widened entry bound, else BIG. The test is ``_entry_math`` on
    (C, R) widened by margins that grow with |o| + |C| + R and with how far
    |d| is from 1; csrc/cluster_entry.cuh argues that every block with an
    entry below BIG lies in a group whose entry here is below BIG and no
    later. The same float32 operations as the kernel's, unfused."""
    o, d = x[:, 0:3], x[:, 3:6]
    t0, act = x[:, 6:7], x[:, 7:8] > 0.0

    def dot(a, b):
        return a[:, 0:1] * b[0:1] + a[:, 1:2] * b[1:2] + a[:, 2:3] * b[2:3]

    od = o[:, 0:1] * d[:, 0:1] + o[:, 1:2] * d[:, 1:2] + o[:, 2:3] * d[:, 2:3]
    oo = o[:, 0:1] * o[:, 0:1] + o[:, 1:2] * o[:, 1:2] + o[:, 2:3] * o[:, 2:3]
    dd = d[:, 0:1] * d[:, 0:1] + d[:, 1:2] * d[:, 1:2] + d[:, 2:3] * d[:, 2:3]
    m = torch.clamp_min(dd, 1.0)
    db = torch.abs(dd - 1.0) + (4 * _U) * m
    w2 = 2.01 * torch.sqrt((17 * _U) * m + db)
    mu = 2.0 * (db + (16 * _U) * m)
    on = torch.sqrt(oo) * 1.000001
    cen, radius, cc, reach, flag = gsph[0:3], gsph[3:4], gsph[4:5], gsph[5:6], gsph[6:7]
    t_ca = dot(d, cen) - od
    dline2 = cc - 2.0 * dot(o, cen) + oo - t_ca * t_ca
    scale = on + reach
    wide = radius + w2 * scale
    margin = mu * scale
    entry = torch.clamp_min(t_ca - radius - margin, 0.0)
    ok = ((flag > 0.0) & (dline2 <= wide * wide) & (t_ca + radius + margin > 0.0)
          & (entry < t0) & act)
    return torch.where(ok, entry, BIG)


def _warp_meets(live, meets, tile: int):
    """The warps of kernels 1 and 9 on whole ray tiles: per tile the
    ``live`` rays [rows] in order, 32 to a warp. -> (slot [rows], each
    ray's warp; met [tiles * ceil(tile / 32), ng] int32, the live rays of
    each warp for which ``meets`` [rows, ng] holds)."""
    warps = -(-tile // 32)
    lt = live.reshape(-1, tile)
    warp = (torch.cumsum(lt, dim=1) - 1).clamp_min(0) // 32
    slot = (torch.arange(lt.shape[0], device=live.device)[:, None] * warps + warp).reshape(-1)
    met = torch.zeros((lt.shape[0] * warps, meets.shape[1]), dtype=torch.int32,
                      device=live.device)
    met.index_add_(0, slot[live], meets[live].to(torch.int32))
    return slot, met


def _grouped_tile_min(x, live, kp: int, entries, group_entries, tile: int, G: int):
    """The tile-min loop of kernels 1 and 9 in plain form: [n/tile, kp]
    tile mins of ``entries(x)`` [n, kp] over only the tests the kernel runs.
    Per tile the kernel takes the ``live`` rays in order, 32 to a warp, and
    a warp tests the members of an aligned group of G blocks only if
    ``group_entries(x)`` [n, ceil(kp / G)] is below BIG for one of its
    rays; dead rays add nothing. A chunk of tiles at a time."""
    group_of = torch.arange(kp, device=x.device) // G
    rows = max(tile, _REF_ENTRY_ELEMS // kp // tile * tile)
    out = []
    for i in range(0, x.shape[0], rows):
        xs, ls = x[i:i + rows], live[i:i + rows]
        slot, met = _warp_meets(ls, group_entries(xs) < BIG, tile)
        tested = (met[slot] > 0)[:, group_of] & ls[:, None]
        out.append(torch.where(tested, entries(xs), BIG).reshape(-1, tile, kp).amin(dim=1))
    return torch.cat(out) if out else x.new_empty((0, kp))


def _cull_grouped(x, cull_w, blk, tile: int, G: int = CULL_GROUP):
    """Kernel 9's skip in plain form: the tile min of the entry bounds over
    only the (ray, block) tests the kernel runs (``_grouped_tile_min`` with
    ``_group_sphere_entry`` on ``_group_sphere``'s spheres). Equal to
    ``_cull_ref`` wherever every feasible (ray, block) lies in a group that
    passes for the ray: the premise the tests and chip_smoke.py hold. For
    tests and chip_smoke.py; the main path does not call it."""
    gsph = _group_sphere(cull_w, blk, G)
    return _grouped_tile_min(x, x[:, 7] > 0.0, blk.shape[1],
                             lambda xs: _entries(xs, cull_w, blk),
                             lambda xs: _group_sphere_entry(xs, gsph), tile, G)


def cull(x, cull_w, blk, tile: int):
    """[n/tile, K] tile-min conservative bounding-sphere entry bounds
    (kernel 9) of the [n, 8] ray records ``x`` (o d t0 act)."""
    if x.device.type == "cpu":
        return _cull_ref(x, cull_w, blk, tile)
    if x.device.type != "cuda":
        raise ValueError(f"cull runs on CUDA or CPU tensors, not {x.device}")
    device = x.device
    n = x.shape[0]
    kp = blk.shape[1]
    if tile <= 0 or n % tile or CULL.call_int("cluster_cull_smem_bytes", tile) > MAX_SMEM:
        raise ValueError(f"cull: bad tile {tile} for {n} rays")
    check_tensor(x, "x", torch.float32, (n, 8), device)
    check_tensor(cull_w, "cull_w", torch.float32, (8, 2 * kp), device)
    check_tensor(blk, "blk", torch.float32, (8, kp), device)
    out = torch.empty((n // tile, kp), dtype=torch.float32, device=device)
    if n:
        CULL.launch(device, x.data_ptr(), cull_w.data_ptr(), blk.data_ptr(),
                    out.data_ptr(), n, kp, tile, MAX_SMEM)
    return out


def _select(tile_entry, rounds: int):
    """Entry-ordered per-tile block lists, padded by repetition.

    -> (sel [G, R] i32, lb [G, R] f32, lb_over [G] f32), R = min(rounds,
    K). Rounds past a tile's feasible count repeat its last feasible
    block id with lb = BIG, so they never run. ``lb_over`` is the entry
    bound of the first feasible block left out (BIG when none was): the
    exactness flag's threshold. The sort is stable, as ``jnp.argsort``."""
    g, kp = tile_entry.shape
    rounds = min(rounds, kp)
    sorted_e, order = torch.sort(tile_entry, dim=1, stable=True)
    count = (sorted_e < BIG).sum(dim=1).to(torch.int32)
    sel = order[:, :rounds].to(torch.int32)
    lb = sorted_e[:, :rounds]
    jj = torch.arange(rounds, dtype=torch.int32, device=tile_entry.device)[None, :]
    last = torch.clamp(count - 1, 0, rounds - 1)[:, None].long()
    last_sel = torch.gather(sel, 1, last)
    live = jj < count[:, None]
    sel = torch.where(live, sel, last_sel)
    lb = torch.where(live, lb, BIG)
    if rounds < kp:
        lb_over = torch.where(count > rounds, sorted_e[:, rounds], BIG)
    else:
        lb_over = torch.full((g,), BIG, dtype=torch.float32, device=tile_entry.device)
    return sel, lb, lb_over


# ---------------------------------------------------------------------------
# rounds (kernel 10) and the repair sweep (kernel 11)
# ---------------------------------------------------------------------------


def cluster_rounds(sel, lb, r, t0, act, cm: ClusterMesh, tile: int, rounds=None):
    """Per-tile budgeted rounds (kernel 10) over the cluster table ``cm``
    -> (bt [n], btri [n]): each ray's nearest t below its t0 over the
    blocks ``sel`` lists for its tile, and that triangle's id (-1 = none).
    Round rr of tile g runs only while some live ray's best t exceeds
    lb[g, rr].

    ``sel`` and ``lb`` [n / tile, R] are ``_select``'s: each tile's list in
    entry order, ``lb`` ascending and BIG past its feasible blocks. The
    kernel runs the walk's round loop (``csrc/round_walk.cuh``): it tests
    only each block's real slots (``cm.real``), a ray only against the
    blocks whose box (``cm.slab``) it enters before its best t, and stops a
    tile at the first round none of its live rays wants. Unless None,
    ``rounds`` [n / tile, 2] int32 gains, per tile, the rounds its thread
    blocks ran and the (32-ray group, real slot) tests they ran (kernel
    only: a measurement, which the render passes as None)."""
    if r.device.type == "cpu":
        return _cluster_ref(sel, lb, r, t0, act, cm.w, tile, cm.block, sel.shape[1])
    if r.device.type != "cuda":
        raise ValueError(f"cluster_rounds runs on CUDA or CPU tensors, not {r.device}")
    device = r.device
    n = r.shape[0]
    kp, block = cm.n_blocks, cm.block
    if (tile <= 0 or block <= 0 or n % tile
            or ROUNDS.call_int("cluster_rounds_smem_bytes", block) > MAX_SMEM):
        raise ValueError(f"cluster_rounds: bad tile {tile} / block {block} for {n} rays")
    g, nr = n // tile, sel.shape[1]
    check_tensor(sel, "sel", torch.int32, (g, nr), device)
    check_tensor(lb, "lb", torch.float32, (g, nr), device)
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
        # each tile's list length (lb is BIG past it), and the tiles in
        # the walk's launch order: longest list first
        nsel = (lb < BIG).sum(dim=1, dtype=torch.int32)
        order = torch.sort(nsel, descending=True, stable=True).indices.to(torch.int32)
        ROUNDS.launch(device, sel.data_ptr(), lb.data_ptr(), nsel.data_ptr(), order.data_ptr(),
                      r.data_ptr(), t0.data_ptr(), act.data_ptr(), cm.w.data_ptr(),
                      cm.real.data_ptr(), cm.slab.data_ptr(), bt.data_ptr(), btri.data_ptr(),
                      None if rounds is None else rounds.data_ptr(), n, nr, kp, tile, block)
    return bt, btri


def _sweep_ref(rows, r, bt, btri, w, tile: int, block: int, kreal: int):
    """Plain sweep: the listed rays gathered into tiles of ``tile`` (the
    last padded by repeating the last row), the round loop over blocks 0
    .. kreal-1 with no bound but each ray's bt, and its hits written back
    to copies of (bt, btri)."""
    bt_out, btri_out = bt.clone(), btri.clone()
    m = rows.shape[0]
    if m == 0:
        return bt_out, btri_out
    idx = rows.long()
    idx = torch.cat([idx, idx[-1:].expand((-m) % tile)])
    g = idx.shape[0] // tile
    all_sel = torch.arange(kreal, dtype=torch.int32, device=r.device).expand(g, kreal)
    bt2, btri2 = _cluster_ref(all_sel, None, r[idx], bt[idx], None, w, tile, block, kreal)
    keep = btri2 >= 0
    bt_out[idx[keep]] = bt2[keep]
    btri_out[idx[keep]] = btri2[keep]
    return bt_out, btri_out


def sweep(rows, r, bt, btri, cm: ClusterMesh, tile: int, slices=None):
    """Exactness repair (kernel 11) -> (bt, btri) [n]: each ray that
    ``rows`` [m] (int32, distinct) lists against every real triangle of
    blocks 0 .. kreal-1, bounded by its own bt; its nearest hit replaces
    (bt, btri) where one was found, every other entry is kept. No act
    mask: dead lanes have d = 0 and never hit.

    ``tile`` is the plain version's: the CPU's batched product sums in an
    order that depends on it. ``slices`` splits the kernel's block axis
    (None: as many as fill the card, 1 when the rays alone do)."""
    if r.device.type == "cpu":
        return _sweep_ref(rows, r, bt, btri, cm.w, tile, cm.block, cm.n_real_blocks)
    if r.device.type != "cuda":
        raise ValueError(f"sweep runs on CUDA or CPU tensors, not {r.device}")
    device = r.device
    n, m = r.shape[0], rows.shape[0]
    kp, block, kreal = cm.n_blocks, cm.block, cm.n_real_blocks
    check_tensor(rows, "rows", torch.int32, (m,), device)
    check_tensor(r, "r", torch.float32, (n, 16), device)
    check_tensor(bt, "bt", torch.float32, (n,), device)
    check_tensor(btri, "btri", torch.int32, (n,), device)
    check_tensor(cm.w, "w", torch.float32, (kp, 16, 4 * block), device)
    check_tensor(cm.real, "real", torch.int32, (kp,), device)
    if not 0 <= kreal <= kp or m > n or block % 4:
        raise ValueError(f"sweep: {m} rows of {n} rays, {kreal} real blocks of {kp} "
                         f"(block {block}, a multiple of 4)")
    bt_out, btri_out = bt.clone(), btri.clone()
    if m and kreal:
        if slices is None:
            with torch.cuda.device(device):  # the card whose SMs the rule counts
                slices = SWEEP.call_int("cluster_sweep_slices", m, kreal)
        if slices < 1:
            raise ValueError(f"sweep: {slices} slices")
        key = torch.empty((m,), dtype=torch.int64, device=device) if slices > 1 else None
        SWEEP.launch(device, rows.data_ptr(), m, r.data_ptr(), bt.data_ptr(), cm.w.data_ptr(),
                     cm.real.data_ptr(), bt_out.data_ptr(), btri_out.data_ptr(),
                     None if key is None else key.data_ptr(), kreal, block, slices)
    return bt_out, btri_out


def flagged_rows(flagged, count: int):
    """[count] int32 positions of the ``count`` set entries of ``flagged``,
    in order, without a host read."""
    return torch.nonzero_static(flagged, size=count)[:, 0].to(torch.int32)


# ---------------------------------------------------------------------------
# public entry
# ---------------------------------------------------------------------------


def _pad_rays(origin, direction, cm: ClusterMesh, tile: int, t_init, active):
    """Centre the rays on the table, default t0 (BIG) and act (all live),
    and pad to a multiple of ``tile`` with dead rays (t0 = 0)."""
    n = origin.shape[0]
    device = origin.device
    origin = origin.to(torch.float32) - cm.center_shift
    direction = direction.to(torch.float32)
    t0 = (torch.full((n,), BIG, dtype=torch.float32, device=device)
          if t_init is None else t_init)
    act = (torch.ones((n,), dtype=torch.bool, device=device)
           if active is None else active)
    pad = (-n) % tile
    if pad:
        z3 = torch.zeros((pad, 3), dtype=torch.float32, device=device)
        origin = torch.cat([origin, z3])
        direction = torch.cat([direction, z3])
        t0 = torch.cat([t0, torch.zeros((pad,), dtype=torch.float32, device=device)])
        act = torch.cat([act, torch.zeros((pad,), dtype=torch.bool, device=device)])
    return origin, direction, t0, act


def _ray_rows(x):
    """[n, 16] Moller-Trumbore feature rows [o, d, o x d, 1, 0 x 6] of the
    [n, 8] ray records ``x``."""
    r = mxu_bf.ray_features(x[:, 0:3], x[:, 3:6])
    return torch.cat([r, r.new_zeros((x.shape[0], 6))], dim=1)


def intersect_mesh_cluster(origin, direction, cm: ClusterMesh, config,
                           t_init=None, active=None, collect_stats: bool = False):
    """Nearest hit over the cluster mesh; exact (brute-equal) results.

    ``t_init`` bounds the search (analytic geoms first); ``active`` lanes
    cull nothing and can never flag. With ``collect_stats`` the call also
    returns how many rays flagged and whether the sweep ran.
    """
    origin = vm.as_rows(origin)
    direction = vm.as_rows(direction)
    n = origin.shape[0]
    tile = config.cluster_tile
    origin, direction, t0, act = _pad_rays(origin, direction, cm, tile, t_init, active)

    perm = None
    if config.cluster_sort:
        key = _coherence_key(origin, direction, act, cm.root_min, cm.root_max)
        _, perm = torch.sort(key, stable=True)
        origin, direction, t0, act = (a[perm] for a in (origin, direction, t0, act))

    # Dead lanes leave the MT itself, not only the cull: direction 0 ->
    # every determinant 0 -> never a hit, like the pad rays.
    direction = torch.where(act[:, None], direction, 0.0)
    actf = act.to(torch.float32)
    x = torch.cat([origin, direction, t0[:, None], actf[:, None]], dim=1)  # [npad, 8]

    tile_entry = cull(x, cm.cull_w, cm.blk, tile)
    sel, lb, lb_over = _select(tile_entry, config.cluster_rounds)
    r = _ray_rows(x)
    bt, btri = cluster_rounds(sel, lb, r, t0, actf, cm, tile)

    # Exactness repair: a ray that its tile's first unselected block could
    # still beat reruns against every real triangle, bounded by its best t.
    flagged = act & (lb_over.repeat_interleave(tile) < bt)
    nflag = int(flagged.sum())
    if nflag:
        bt, btri = sweep(flagged_rows(flagged, nflag), r, bt, btri, cm, tile)

    if perm is not None:  # un-sort
        bt = torch.empty_like(bt).index_copy_(0, perm, bt)
        btri = torch.empty_like(btri).index_copy_(0, perm, btri)
    bt, btri = bt[:n], btri[:n]
    bt = torch.where(btri >= 0, bt, BIG)
    zero = torch.zeros((n,), dtype=torch.float32, device=bt.device)
    hit = TriHit(t=bt, tri=btri, u=zero, v=zero)
    if collect_stats:
        return hit, {"tiles": sel.shape[0], "rounds": sel.shape[1], "flagged": nflag,
                     "repair": "sweep" if nflag else "none"}
    return hit
