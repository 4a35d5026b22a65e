"""Pair-list intersection: work scheduled per (ray, block) pair.

The JAX package's ``ops/pairs.py`` in PyTorch, for one device, with its
three TPU kernels ported to CUDA (``csrc/pair_extract.cu``,
``csrc/pair_runs.cu`` and, with ``pair_bdiag``, ``csrc/pair_bdiag.cu``).
A tile-shared walk (``ops/walk.py``) pays per
ray tile for the union of its rays' feasible blocks; this intersector
pays per ray for its own nearest few:

  1. extract (kernel 5): per ray, its F nearest-entry feasible blocks, the
     feasible count, ``lb_over`` (a lower bound on the entry of every
     block not in the list) and the ray's Moller-Trumbore feature record;
  2. group: one stable sort of the pairs' block ids puts each block's
     pairs side by side; one row gather fetches their feature records;
  3. test (kernel 6): per tile of sorted pairs, each same-block run
     against that block's triangles, nearest (t | loc) packed in one int;
     with ``pair_bdiag``, kernel 7 computes the same on supertiles of
     ``pair_bdiag_tile`` pairs, several runs at once;
  4. reduce: a scatter through the sort's permutation restores slot order
     and each ray keeps its nearest slot;
  5. prove: a ray is exact once its best t <= lb_over. Unproven rays get
     a deeper window (slots F..F2, pass 2); the rest take the exhaustive
     walk (pass 3, ``ops/walk.py``'s kernels). Exact by construction.

Each pass's loop count is a number the host reads: at most four reads
per call (the pass-1 and pass-2 set sizes, whether any ray is left for
pass 3, and how many).
Each kernel's wrapper runs the plain PyTorch version on CPU tensors and
the CUDA kernel on CUDA tensors; there is no other fallback.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from kdtreepathtraceroptimization_tpu_torch.ops import cluster as cl
from kdtreepathtraceroptimization_tpu_torch.ops import mxu_bf
from kdtreepathtraceroptimization_tpu_torch.ops import vecmath as vm
from kdtreepathtraceroptimization_tpu_torch.ops import walk as wk
from kdtreepathtraceroptimization_tpu_torch.ops.intersect import BIG
from kdtreepathtraceroptimization_tpu_torch.ops.mesh import TriHit
from kdtreepathtraceroptimization_tpu_torch.utils.cuda_build import MAX_SMEM, CudaKernel, check_tensor

_P = ctypes.c_void_p
_I = ctypes.c_int

EXTRACT = CudaKernel("pair_extract", "pair_extract", [_P] * 7 + [_I] * 4)
PAIR_RUNS = CudaKernel("pair_runs", "pair_runs", [_P] * 5 + [_I] * 5)
PAIR_BDIAG = CudaKernel("pair_bdiag", "pair_bdiag", [_P] * 5 + [_I] * 5)

# Second-pass window depth and the pass-2 / pass-3 buffer sizes (the JAX
# package's tuning on the cornell + dragon diffuse wave).
F2 = 12
REPAIR_LANES = 65536
WALK_LANES = 2048

# Block-id bits in the low mantissa of the (entry | block id) key: 8192
# blocks. The truncation only lowers an entry, so the ordering can only
# promote a block and lb_over stays a lower bound. Scenes past the cap
# take bigger blocks or skip the table (scene/parser.py).
_IDX_BITS = 13
MAX_CLUSTER_BLOCKS = 1 << _IDX_BITS
_IDX_MASK = (1 << _IDX_BITS) - 1
_BIG_KEY = int(np.float32(BIG).view(np.int32)) & ~_IDX_MASK
_DEAD_KEY = 0x7FFFFFFF

# In-block triangle bits in the low mantissa of the (t | loc) key: blocks
# of up to 1024 triangles. The truncation lowers t by < 2^-13 relative.
_LOC_BITS = 10
_LOC_MASK = (1 << _LOC_BITS) - 1
_PBIG = int(np.float32(BIG).view(np.int32)) & ~_LOC_MASK

# Elements of [rays, blocks] keys the plain extraction makes at once, and
# pair rows the plain pair test multiplies at once.
_REF_CHUNK_ELEMS = 1 << 26
_REF_PAIR_ROWS = 1 << 14


# ---------------------------------------------------------------------------
# 1. extraction (kernel 5)
# ---------------------------------------------------------------------------


def _extract_math(x, slab, blk, kp: int, F: int):
    """[sub, 16] features + [8, K] slab table -> the top-F entry-ordered
    feasible block ids [sub, F] (kp where exhausted), lb_over [sub, 1] (a
    truncated (F+1)-th smallest entry; BIG when none) and the feasible
    count [sub] (int32).

    Each (entry, block id) pair is one int32 key: non-negative floats
    order as their bit patterns, and the id in the low bits makes keys
    unique, so F rounds of min-and-remove pick the F nearest blocks with
    ties to the smaller id."""
    entry = wk._slab_entry_math(x, slab, blk, kp)
    count = (entry < BIG).sum(dim=1, dtype=torch.int32)
    cols = torch.arange(kp, dtype=torch.int32, device=x.device)
    key = (entry.view(torch.int32) & ~_IDX_MASK) | cols
    ids = []
    for _ in range(F):
        m = key.amin(dim=1, keepdim=True)
        ids.append(torch.where(m < _BIG_KEY, m & _IDX_MASK, kp))
        key = torch.where(key == m, _DEAD_KEY, key)
    m = key.amin(dim=1, keepdim=True)
    lb_over = torch.where(m < _BIG_KEY, (m & ~_IDX_MASK).view(torch.float32), BIG)
    return torch.cat(ids, dim=1), lb_over, count


def _feat16(od):
    """[p, 8] (o, d, t0, act) -> [p, 16] MT features [o d oxd 1 0..] * act."""
    one = od[:, 7:8]
    z = torch.zeros((od.shape[0], 6), dtype=od.dtype, device=od.device)
    return torch.cat([od[:, 0:6], vm.cross(od[:, 0:3], od[:, 3:6]), one, z],
                     dim=1) * one


def _feat16t(od):
    """_feat16 with the pair test's bound t0 in column 10: rows 10-15 of
    every weight block are zero, so the product is unchanged and the
    kernel reads its bound from the same record."""
    f = _feat16(od)
    f[:, 10] = od[:, 6]
    return f


def _extract_ref(x, slab, blk, F: int):
    """Plain extraction, a chunk of rays at a time -> (ids [n, F] i32,
    lbov [n] f32, cnt [n] i32, feat [n, 16] f32)."""
    n = x.shape[0]
    kp = blk.shape[1]
    rows = max(1, _REF_CHUNK_ELEMS // kp)
    parts = [_extract_math(x[i:i + rows], slab, blk, kp, F)
             for i in range(0, n, rows)]
    if not parts:
        parts = [_extract_math(x, slab, blk, kp, F)]
    ids, lbov, cnt = (torch.cat(p) for p in zip(*parts))
    return ids, lbov.reshape(-1), cnt, _feat16t(x[:, :8])


def extract(x, slab, blk, F: int, split: bool = False):
    """Per ray: its F nearest-entry feasible blocks and the rest of the
    extraction record (kernel 5; ``_extract_ref`` has the layout). With
    ``split`` (for calls whose live rays are few and come first, as pass
    2's) the kernel takes each ray with several lanes, each a share of the
    blocks; the results are the same. Pass 1's calls, most of whose rays
    are live, run faster without it (csrc/pair_extract.cu has the times)."""
    kp = blk.shape[1]
    if kp > MAX_CLUSTER_BLOCKS:
        raise ValueError(f"{kp} cluster blocks exceed the {MAX_CLUSTER_BLOCKS}-block cap")
    if x.device.type == "cpu":
        return _extract_ref(x, slab, blk, F)
    if x.device.type != "cuda":
        raise ValueError(f"extract runs on CUDA or CPU tensors, not {x.device}")
    device = x.device
    n = x.shape[0]
    if not 1 <= F <= EXTRACT.call_int("pair_extract_max_slots"):
        raise ValueError(f"extract: {F} slots is outside the kernel's range")
    check_tensor(x, "x", torch.float32, (n, 16), device)
    check_tensor(slab, "slab", torch.float32, (8, kp), device)
    check_tensor(blk, "blk", torch.float32, (8, kp), device)
    if x.data_ptr() % 16:
        raise ValueError("extract: x must be 16-byte aligned (float4 row loads)")
    ids = torch.empty((n, F), dtype=torch.int32, device=device)
    lbov = torch.empty((n,), dtype=torch.float32, device=device)
    cnt = torch.empty((n,), dtype=torch.int32, device=device)
    feat = torch.empty((n, 16), dtype=torch.float32, device=device)
    if n:
        EXTRACT.launch(device, x.data_ptr(), slab.data_ptr(), blk.data_ptr(),
                       ids.data_ptr(), lbov.data_ptr(), cnt.data_ptr(),
                       feat.data_ptr(), n, kp, F, int(split))
    return ids, lbov, cnt, feat


# ---------------------------------------------------------------------------
# 2-4. one pair pass: group, test (kernel 6), reduce
# ---------------------------------------------------------------------------


def _pack_tl(t, loc):
    """(t >= 0 f32, loc < 1024 i32) -> one i32 that orders as t does, loc
    in its low 10 bits (t truncated by < 2^-13 relative)."""
    return (t.view(torch.int32) & ~_LOC_MASK) | loc


def _unpack_tl(p):
    """packed i32 -> (t f32, exactly BIG for a miss; loc i32)."""
    t = (p & ~_LOC_MASK).view(torch.float32)
    return torch.where(p >= _PBIG, BIG, t), p & _LOC_MASK


def _pair_runs_ref(blk_s, feat, w, block: int, kreal: int):
    """Plain pair test: for each pair of a real block, the min over the
    block's triangles of _pack_tl(t, loc) (_PBIG for a miss or a sentinel
    block). One product per run of equal block ids, a bounded number of
    rows at a time."""
    out = torch.full(blk_s.shape, _PBIG, dtype=torch.int32, device=feat.device)
    cols = torch.arange(block, dtype=torch.int32, device=feat.device)
    blocks, counts = torch.unique_consecutive(blk_s, return_counts=True)
    start = 0
    for b, c in zip(blocks.tolist(), counts.tolist()):
        if b < kreal:
            for r0 in range(start, start + c, _REF_PAIR_ROWS):
                r1 = min(start + c, r0 + _REF_PAIR_ROWS)
                f = feat[r0:r1]
                t = mxu_bf._epilogue(f @ w[b], block, f[:, 10])
                out[r0:r1] = _pack_tl(t, cols).amin(dim=1)
        start += c
    return out


def pair_runs(blk_s, feat, cm: "cl.ClusterMesh", ptile: int, kreal: int):
    """Packed nearest (t | loc) per pair (kernel 6).

    blk_s [P] i32: each pair's block id, ascending, so sentinel ids
    (>= kreal) come last; feat [P, 16]: each pair's _feat16t record (its
    bound t0 in column 10); ``cm``: the cluster table, whose weight blocks
    ``cm.w`` [kp, 16, 4B] the kernel reads. P must be a multiple of
    ``ptile`` (at most 1024), the pairs of one tile, which thread blocks
    take in parts. The kernel stages only each block's real slots
    (``cm.real``) and runs the sparse test on them, which rests on the
    table's zero pattern (``mxu_bf.check_sparse_pattern``); it runs kernel
    7's part loop (``csrc/pair_part.cuh``), so the two give the same keys
    on the same pairs. The signature is ``pair_bdiag``'s."""
    w, block = cm.w, cm.block
    if feat.device.type == "cpu":
        return _pair_runs_ref(blk_s, feat, w, block, kreal)
    if feat.device.type != "cuda":
        raise ValueError(f"pair_runs runs on CUDA or CPU tensors, not {feat.device}")
    device = feat.device
    p = blk_s.shape[0]
    kp = w.shape[0]
    if p % ptile or not 0 < ptile <= 1024 or block > 1 << _LOC_BITS:
        raise ValueError(f"pair_runs: bad tile {ptile} / block {block} for {p} pairs")
    slots = PAIR_RUNS.call_int("pair_runs_slots", block, MAX_SMEM)
    if slots < 1:
        raise ValueError(f"pair_runs: a block of {block} triangles does not fit in shared memory")
    check_tensor(blk_s, "blk_s", torch.int32, (p,), device)
    check_tensor(feat, "feat", torch.float32, (p, 16), device)
    check_tensor(w, "w", torch.float32, (kp, 16, 4 * block), device)
    check_tensor(cm.real, "real", torch.int32, (kp,), device)
    out = torch.empty((p,), dtype=torch.int32, device=device)
    if p:
        PAIR_RUNS.launch(device, blk_s.data_ptr(), feat.data_ptr(), w.data_ptr(),
                         cm.real.data_ptr(), out.data_ptr(), p, ptile, block, min(kreal, kp),
                         slots)
    return out


def pair_bdiag(blk_s, feat, cm: "cl.ClusterMesh", ptile: int, kreal: int):
    """Packed nearest (t | loc) per pair on supertiles (kernel 7): the
    function of ``pair_runs`` (its plain version is ``_pair_runs_ref``),
    with its signature. ``ptile`` pairs (at most 1024, a multiple of 32)
    make a supertile, taken by thread blocks of 256 pairs that each test
    several same-block runs at once. The kernel stages only each block's
    real slots (``cm.real``) and runs the sparse test on them, which rests
    on the table's zero pattern (``mxu_bf.check_sparse_pattern``). P must
    be a multiple of ``ptile``."""
    w, block = cm.w, cm.block
    if feat.device.type == "cpu":
        return _pair_runs_ref(blk_s, feat, w, block, kreal)
    if feat.device.type != "cuda":
        raise ValueError(f"pair_bdiag runs on CUDA or CPU tensors, not {feat.device}")
    device = feat.device
    p = blk_s.shape[0]
    kp = w.shape[0]
    if p % ptile or not 0 < ptile <= 1024 or ptile % 32 or block > 1 << _LOC_BITS:
        raise ValueError(f"pair_bdiag: bad tile {ptile} / block {block} for {p} pairs")
    slots = PAIR_BDIAG.call_int("pair_bdiag_slots", block, MAX_SMEM)
    if slots < 1:
        raise ValueError(f"pair_bdiag: a block of {block} triangles does not fit in shared memory")
    check_tensor(blk_s, "blk_s", torch.int32, (p,), device)
    check_tensor(feat, "feat", torch.float32, (p, 16), device)
    check_tensor(w, "w", torch.float32, (kp, 16, 4 * block), device)
    check_tensor(cm.real, "real", torch.int32, (kp,), device)
    out = torch.empty((p,), dtype=torch.int32, device=device)
    if p:
        PAIR_BDIAG.launch(device, blk_s.data_ptr(), feat.data_ptr(), w.data_ptr(),
                          cm.real.data_ptr(), out.data_ptr(), p, ptile, block, min(kreal, kp),
                          slots)
    return out


def _pair_pass(ids, feat, cm: "cl.ClusterMesh", ptile: int, kreal: int,
               bdiag: bool = False):
    """Test every (ray, block) pair in ``ids`` [n, F] (kp = empty slot);
    return each ray's nearest (t [n], tri [n]) over them (BIG / -1 for
    none). ``feat`` [n, 16] holds the rays' _feat16t records; ``bdiag``
    takes kernel 7 for the pair test in place of kernel 6."""
    n, F = ids.shape
    kp = cm.n_blocks
    p = n * F
    pp = -(-p // ptile) * ptile
    flat = ids.reshape(p)
    if pp != p:
        flat = torch.cat([flat, torch.full((pp - p,), kp, dtype=torch.int32,
                                           device=ids.device)])
    # A stable sort by block id: the order of JAX's (id << bits | index)
    # keys, with the permutation at hand.
    blk_s, src = torch.sort(flat, stable=True)
    featp = feat[torch.clamp_max(src // F, n - 1)]
    runner = pair_bdiag if bdiag else pair_runs
    packed = runner(blk_s, featp, cm, ptile, kreal)
    slots = torch.empty_like(packed)
    slots[src] = packed
    t_p, loc_p = _unpack_tl(slots[:p].reshape(n, F))

    # Winner select, one slot column at a time: the nearest truncated t,
    # the first slot among equals.
    t_best = t_p[:, 0]
    for f in range(1, F):
        t_best = torch.minimum(t_best, t_p[:, f])
    taken = torch.zeros_like(t_best, dtype=torch.bool)
    blk_best = torch.zeros_like(ids[:, 0])
    loc_best = torch.zeros_like(loc_p[:, 0])
    for f in range(F):
        is_f = (t_p[:, f] == t_best) & ~taken
        blk_best = torch.where(is_f, ids[:, f], blk_best)
        loc_best = torch.where(is_f, loc_p[:, f], loc_best)
        taken = taken | is_f
    tri = torch.where(t_best < BIG, blk_best * cm.block + loc_best, -1)
    return t_best, tri


# ---------------------------------------------------------------------------
# compaction helpers (the JAX package's single-shard branches)
# ---------------------------------------------------------------------------


def _compact_all(todo):
    """Flagged-first stable permutation of [ns] rays, and the flagged
    count (read on the host: it sets the pass's round count)."""
    _, pos = torch.sort((~todo).to(torch.int32), stable=True)
    return pos, int(todo.sum())


def _pad_positions(pos, total: int):
    """Pad the permutation to ``total`` with unique out-of-range
    positions ns, ns + 1, ...: slices never run short, and the scatter
    drops them."""
    ns = pos.shape[0]
    if total == ns:
        return pos
    return torch.cat([pos, torch.arange(ns, total, dtype=pos.dtype, device=pos.device)])


def _take_rows(a, pos):
    """Rows ``a[pos]``; out-of-range (pad) positions read the last row, as
    a JAX gather clamps them."""
    return a[torch.clamp_max(pos, a.shape[0] - 1)]


def _scatter_slice(pos_pad, k: int, m: int, updates, olds):
    """Write round k's updates to positions pos_pad[k*m:(k+1)*m] of the
    olds; pad positions (>= ns, all below ns + m) land in a tail that is
    cut off, as JAX's mode="drop" scatter drops them."""
    pos = pos_pad[k * m:(k + 1) * m]
    out = []
    for old, upd in zip(olds, updates):
        ns = old.shape[0]
        ext = torch.cat([old, old.new_empty((m,))])
        ext.index_copy_(0, pos, upd)
        out.append(ext[:ns])
    return out


# ---------------------------------------------------------------------------
# public entry
# ---------------------------------------------------------------------------


def intersect_mesh_pairs(origin, direction, cm: "cl.ClusterMesh", config,
                         t_init=None, active=None, max_passes: int = 3,
                         collect_stats: bool = False):
    """Nearest hit over the cluster mesh; exact (brute-equal) results.

    ``t_init`` bounds every ray's search (analytic geoms first); ``active``
    lanes take no part. ``max_passes`` < 3 cuts the proof chain short, for
    measurement only: results are then exact only for proven rays. With
    ``collect_stats`` the call also returns its executed rounds and stage
    sizes.
    """
    if config.binned_shards != 1:
        raise NotImplementedError(
            "binned_shards != 1 (shard-local pair grouping) is not ported: "
            "the port runs on one device")
    origin = vm.as_rows(origin)
    direction = vm.as_rows(direction)
    n = origin.shape[0]
    device = origin.device
    tile = config.cluster_tile
    F = config.pair_slots
    bdiag = bool(config.pair_bdiag)
    # The supertile is the pair tile of the whole call, chunk sizes too.
    ptile = config.pair_bdiag_tile if bdiag else config.pair_tile
    kp = cm.n_blocks
    kreal = cm.n_real_blocks

    origin, direction, t0, act = cl._pad_rays(origin, direction, cm, tile, t_init, active)
    ns = origin.shape[0]

    direction = torch.where(act[:, None], direction, 0.0)
    x = wk._ray16(origin, direction, t0, act.to(torch.float32))

    # pass 1: the top-F pairs of every ray (and its feature record)
    ids, lbov, cnt, feat = extract(x, cm.slab, cm.blk, F)

    # Narrowing: only rays with a feasible block make pairs. They are
    # compacted into a buffer of about ns / pair_narrow_div lanes, looped
    # when more rays than that are mesh-active (primary bounces).
    ndiv = max(1, config.pair_narrow_div)
    m1 = min(ns, max(ptile, -(-ns // ndiv // ptile) * ptile))
    bt = t0.clone()
    btri = torch.full((ns,), -1, dtype=torch.int32, device=device)
    pos1, nr1 = _compact_all(act & (cnt > 0))
    pos1p = _pad_positions(pos1, -(-ns // m1) * m1)
    iota1 = torch.arange(m1, device=device)
    k1 = -(-nr1 // m1)
    for k in range(k1):
        pos = pos1p[k * m1:(k + 1) * m1]
        live = iota1 < nr1 - k * m1
        ids_c = torch.where(live[:, None], _take_rows(ids, pos), kp)
        ft_c = _take_rows(feat, pos) * live.to(torch.float32)[:, None]
        t1, tri1 = _pair_pass(ids_c, ft_c, cm, ptile, kreal, bdiag)
        bt_pos = _take_rows(bt, pos)
        upd = live & (t1 <= bt_pos)
        bt, btri = _scatter_slice(
            pos1p, k, m1,
            [torch.where(upd, t1, bt_pos), torch.where(upd, tri1, _take_rows(btri, pos))],
            [bt, btri])

    # Proof: no untested block's entry is below lb_over, so a ray whose
    # best t is <= lb_over is done.
    unproven = act & (lbov < bt) & (cnt > F)

    # pass 2: the window of slots F..F2 for the unproven rays, in rounds of
    # m2; rays still unproven after it gather in ``hard`` for pass 3.
    m2 = min(max(ptile, REPAIR_LANES), ns)
    k2 = nr2 = nr3 = 0
    if max_passes >= 2 and F < F2:
        pos2, nr2 = _compact_all(unproven)
        pos2p = _pad_positions(pos2, -(-ns // m2) * m2)
        iota2 = torch.arange(m2, device=device)
        hard = torch.zeros((ns,), dtype=torch.bool, device=device)
        k2 = -(-nr2 // m2)
        for k in range(k2):
            pos = pos2p[k * m2:(k + 1) * m2]
            live = iota2 < nr2 - k * m2
            livef = live.to(torch.float32)
            # The original t0 keeps the first F ids equal to pass 1's, so
            # slots F..F2 continue exactly where pass 1 stopped.
            x2 = _take_rows(x, pos)
            x2[:, 7] *= livef
            x2[:, 3:6] *= livef[:, None]
            ids2, lbov2, cnt2, ft2 = extract(x2, cm.slab, cm.blk, F2, split=True)
            bt2g = torch.where(live, _take_rows(bt, pos), 0.0)
            ft2[:, 10] = bt2g  # the window's bound: the current best
            t2, tri2 = _pair_pass(ids2[:, F:], ft2, cm, ptile, kreal, bdiag)
            upd = live & (t2 < bt2g)
            still = live & (lbov2 < torch.where(upd, t2, bt2g)) & (cnt2 > F2)
            bt, btri, hard = _scatter_slice(
                pos2p, k, m2,
                [torch.where(upd, t2, _take_rows(bt, pos)),
                 torch.where(upd, tri2, _take_rows(btri, pos)),
                 still | _take_rows(hard, pos)],
                [bt, btri, hard])
        unproven = hard

    # pass 3: the exhaustive walk over what is left, in rounds of m3. It
    # covers each ray's whole feasible list, so every round proves its rays.
    m3 = min(max(256, WALK_LANES), ns)
    tile3 = min(tile, m3, wk.vmem_tile_cap(kp))
    k3 = 0
    if max_passes >= 3 and bool(unproven.any()):  # most waves: nothing left
        pos3, nr3 = _compact_all(unproven)
        pos3p = _pad_positions(pos3, -(-ns // m3) * m3)
        iota3 = torch.arange(m3, device=device)
        k3 = -(-nr3 // m3)
        for k in range(k3):
            pos = pos3p[k * m3:(k + 1) * m3]
            live = iota3 < nr3 - k * m3
            livef = live.to(torch.float32)
            x3 = _take_rows(x, pos)
            x3[:, 6] = torch.where(live, _take_rows(bt, pos), 0.0)
            x3[:, 7] *= livef
            x3[:, 3:6] *= livef[:, None]
            te = wk.slab_cull(x3, cm.slab, cm.blk, tile3)
            sel, lb, nsel = wk._full_select(te)
            r3 = mxu_bf.ray_features(x3[:, 0:3], x3[:, 3:6]) * livef[:, None]
            r3 = torch.cat([r3, torch.zeros((m3, 6), dtype=torch.float32, device=device)],
                           dim=1)
            t3, tri3 = wk.walk(sel, lb, nsel, r3, x3[:, 6].contiguous(),
                               x3[:, 7].contiguous(), cm, tile3)
            upd = live & (tri3 >= 0)
            bt, btri = _scatter_slice(
                pos3p, k, m3,
                [torch.where(upd, t3, _take_rows(bt, pos)),
                 torch.where(upd, tri3, _take_rows(btri, pos))],
                [bt, btri])

    bt, btri = bt[:n], btri[:n]
    bt = torch.where(btri >= 0, bt, BIG)
    zero = torch.zeros((n,), dtype=torch.float32, device=device)
    hit = TriHit(t=bt, tri=btri, u=zero, v=zero)
    if collect_stats:
        stats = {
            "mesh_active": nr1, "unproven_after_pass1": nr2, "pass3_rays": nr3,
            "n1_rounds": k1, "p2_rounds": k2, "p3_rounds": k3,
            "m1": m1, "m2": m2, "m3": m3, "pair_slots": F,
            "pair_rows": k1 * m1 * F + k2 * m2 * (F2 - F) + k3 * m3,
        }
        return hit, stats
    return hit
