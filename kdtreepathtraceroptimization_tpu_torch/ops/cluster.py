"""Cluster table: spatial blocks of triangles with their MT weights.

The host half of the JAX package's ``ops/cluster.py``, in numpy so its
arrays equal the JAX build bit for bit, plus the plain round loop
``_cluster_ref`` that is the walk kernel's plain version
(``ops/walk.py``).

The build splits the triangles into median-split KD leaves of ``block``
triangles (padding leaves with degenerate copies that never win), keeps
each block's Moller-Trumbore weights ``[16, 4B]`` (``ops/mxu_bf``),
bounding sphere and AABB, and pads the block axis to a multiple of 128
with never-feasible sentinel blocks. Hit triangle ids index
``ClusterMesh.tris`` directly.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from kdtreepathtraceroptimization_tpu_torch.ops import mxu_bf
from kdtreepathtraceroptimization_tpu_torch.ops.mesh import pack_tris
from kdtreepathtraceroptimization_tpu_torch.scene.structs import MeshSoA
from kdtreepathtraceroptimization_tpu_torch.utils.device import resolve_device, to_tensor


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
    )


# Largest [tiles, tile, 4B] product the plain round loop materializes at
# once (elements); bounds its memory at full size.
_REF_CHUNK_ELEMS = 1 << 28


def _cluster_ref(sel, lb, r, t0, act, w, tile: int, block: int,
                 rounds: int):
    """Plain round loop (the JAX ``_cluster_ref``): for each tile, test the
    blocks ``sel[:, :rounds]`` in order with one batched product each,
    keeping the running min (first argmin within a block, strict ``<``
    across rounds).

    Rounds at or past a tile's feasible count re-test its repeated last
    block, which cannot change the running min; so each chunk of tiles
    stops at the largest count ``lb`` shows among them (at least one
    round). ``lb=None`` walks all ``rounds``. Tiles are processed in
    chunks so the product never exceeds ``_REF_CHUNK_ELEMS`` elements.
    """
    n = r.shape[0]
    g = n // tile
    rt = r.reshape(g, tile, 16)
    t0 = t0.reshape(g, tile)
    bt_out = []
    btri_out = []
    chunk = max(1, _REF_CHUNK_ELEMS // (tile * 4 * block))
    for g0 in range(0, g, chunk):
        g1 = min(g, g0 + chunk)
        sel_c = sel[g0:g1]
        n_rounds = rounds
        if lb is not None:
            live = int((lb[g0:g1, :rounds] < mxu_bf.BIG).sum(dim=1).max())
            n_rounds = max(1, live)
        bt = t0[g0:g1].clone()
        btri = torch.full_like(bt, -1, dtype=torch.int32)
        for rr in range(n_rounds):
            ks = sel_c[:, rr].long()
            prod = torch.bmm(rt[g0:g1], w[ks])  # [G, tile, 4B]
            t = mxu_bf._epilogue(
                prod.reshape(-1, 4 * block), block, bt.reshape(-1)
            ).reshape(g1 - g0, tile, block)
            loc = torch.argmin(t, dim=2)
            lt = torch.gather(t, 2, loc[..., None])[..., 0]
            better = lt < bt
            tri_idx = (sel_c[:, rr][:, None] * block + loc).to(torch.int32)
            bt = torch.where(better, lt, bt)
            btri = torch.where(better, tri_idx, btri)
        bt_out.append(bt)
        btri_out.append(btri)
    return torch.cat(bt_out).reshape(n), torch.cat(btri_out).reshape(n)
