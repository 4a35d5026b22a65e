"""Binned cluster intersection: per-bounce ray binning by nearest feasible
block.

The JAX package's ``ops/binned.py`` in PyTorch, with its
TPU kernel ported to CUDA (``csrc/binned_argmin.cu``, which skips aligned
groups of blocks whose bounding sphere cannot beat a ray's best entry).
Rays are binned by the id of the feasible block of least bounding-sphere
entry bound, the block an entry-ordered walk visits first: rays that share
it walk nearly the same lists, so a tile's union of blocks stays near one
ray's. Rays with no feasible block (dead lanes, rays that miss the mesh)
share one last bin whose tiles skip every round.

Per call:

  1. argmin cull (kernel 12): each ray's bin;
  2. bin: a stable sort of the bins and its inverse permutation;
  3. tile cull, select, rounds: ``ops/cluster.py``'s kernels 9 and 10 on
     the binned order, R = ``binned_rounds``;
  4. repair: flagged rays (their tile's first unselected block could beat
     them) are compacted into ``REPAIR_LANES`` lanes and rerun through the
     same pipeline with every feasible block (R = K), which cannot flag
     again; more flagged rays than that take the sweep (kernel 11) of
     every real triangle.
     The flag count is one host read;
  5. un-bin the results.

The result equals brute force over the mesh. Each kernel's wrapper runs
the plain PyTorch version on CPU tensors and the CUDA kernel on CUDA
tensors; there is no other fallback.

With ``binned_shards`` = S > 1 the sorts and the repair's compaction run
row by row on the [S, n / S] ray view (the JAX package's shard-local
form). The tiles then change, and with them whether the rounds (the
19-FMA sparse test) or the sweep (the dense 40-FMA test) resolves a ray,
so a ray's t may differ from S = 1's in its last bits; ids agree but where
two triangles tie that closely.
"""

from __future__ import annotations

import ctypes

import torch

from kdtreepathtraceroptimization_tpu_torch.ops import cluster as cl
from kdtreepathtraceroptimization_tpu_torch.ops import vecmath as vm
from kdtreepathtraceroptimization_tpu_torch.ops.intersect import BIG
from kdtreepathtraceroptimization_tpu_torch.ops.mesh import TriHit
from kdtreepathtraceroptimization_tpu_torch.utils.cuda_build import CudaKernel, check_tensor

_P = ctypes.c_void_p
_I = ctypes.c_int

ARGMIN = CudaKernel("binned_argmin", "binned_argmin", [_P, _P, _P, _P, _P, _I, _I])

# Lanes of the compacted repair pass (four tiles of 1024); a larger
# flagged population takes the sweep.
REPAIR_LANES = 4096


# ---------------------------------------------------------------------------
# 1. argmin cull (kernel 12)
# ---------------------------------------------------------------------------


def _argmin_ref(x, cull_w, blk):
    """Plain argmin cull: per ray, the first block of least entry bound,
    kp when none is feasible; a chunk of rays at a time."""
    kp = blk.shape[1]
    rows = max(1, cl._REF_ENTRY_ELEMS // kp)
    out = []
    for i in range(0, x.shape[0], rows):
        entry = cl._entries(x[i:i + rows], cull_w, blk)
        best, am = torch.min(entry, dim=1)
        out.append(torch.where(best < BIG, am.to(torch.int32), kp))
    return torch.cat(out) if out else torch.empty((0,), dtype=torch.int32, device=x.device)


def _argmin_grouped(x, cull_w, blk, G: int = cl.CULL_GROUP):
    """Kernel 12's skip in plain form: per ray, the groups of G blocks in
    index order, a group's members tested only where the group's widened
    entry (``cluster._group_sphere_entry`` on ``cluster._group_sphere``'s
    spheres) lies below the ray's best entry so far, strict ``<`` within
    and across groups. Equal to ``_argmin_ref`` wherever no feasible block
    lies in a group whose entry is later than the block's: the premise the
    tests and chip_smoke.py hold. For tests and chip_smoke.py; the main
    path does not call it."""
    n, kp = x.shape[0], blk.shape[1]
    ng = -(-kp // G)
    gsph = cl._group_sphere(cull_w, blk, G)
    rows = max(1, cl._REF_ENTRY_ELEMS // kp)
    out = []
    for i in range(0, n, rows):
        xs = x[i:i + rows]
        entry = cl._entries(xs, cull_w, blk)
        group = cl._group_sphere_entry(xs, gsph)
        best = torch.full((xs.shape[0],), BIG, dtype=torch.float32, device=x.device)
        bins = torch.full((xs.shape[0],), kp, dtype=torch.int32, device=x.device)
        for q in range(ng):
            need = group[:, q] < best
            m, am = torch.min(torch.where(need[:, None], entry[:, q * G:(q + 1) * G], BIG), dim=1)
            better = m < best
            best = torch.where(better, m, best)
            bins = torch.where(better, (q * G + am).to(torch.int32), bins)
        out.append(bins)
    return torch.cat(out) if out else torch.empty((0,), dtype=torch.int32, device=x.device)


def argmin_bins(x, cull_w, blk):
    """[n] i32 bin of each [n, 8] ray record ``x`` (o d t0 act): the
    feasible block of least entry bound (the first on ties), else kp
    (kernel 12)."""
    if x.device.type == "cpu":
        return _argmin_ref(x, cull_w, blk)
    if x.device.type != "cuda":
        raise ValueError(f"argmin_bins runs on CUDA or CPU tensors, not {x.device}")
    device = x.device
    n = x.shape[0]
    kp = blk.shape[1]
    check_tensor(x, "x", torch.float32, (n, 8), device)
    check_tensor(cull_w, "cull_w", torch.float32, (8, 2 * kp), device)
    check_tensor(blk, "blk", torch.float32, (8, kp), device)
    bins = torch.empty((n,), dtype=torch.int32, device=device)
    if n:
        # the group spheres and the block table as float4s, which the
        # launch's first kernel builds
        scratch = torch.empty((ARGMIN.call_int("binned_argmin_scratch_floats", kp),),
                              dtype=torch.float32, device=device)
        ARGMIN.launch(device, x.data_ptr(), cull_w.data_ptr(), blk.data_ptr(),
                      scratch.data_ptr(), bins.data_ptr(), n, kp)
    return bins


# ---------------------------------------------------------------------------
# 2. binning permutation
# ---------------------------------------------------------------------------


def _bin_rank(bins, shards: int = 1):
    """Stable sort rank: perm gathers rays into key order, rank = perm^-1.

    ``shards`` > 1 sorts each row of the [shards, n / shards] view on its
    own (the JAX package's shard-local sort): no ray leaves its row. perm
    and rank stay flat indices into [n]."""
    n = bins.shape[0]
    m = n // shards
    _, perm = torch.sort(bins.reshape(shards, m), dim=1, stable=True)
    perm = (perm + torch.arange(shards, device=bins.device)[:, None] * m).reshape(n)
    iota = torch.arange(n, device=bins.device)
    rank = torch.empty_like(perm).scatter_(0, perm, iota)
    return rank, perm


def _apply_perm(a, perm):
    """Gather rows of a [n, ...] by perm [n]."""
    return a.index_select(0, perm)


# ---------------------------------------------------------------------------
# 3. one pass: bin, cull, select, rounds
# ---------------------------------------------------------------------------


def _binned_pass(x, cm: "cl.ClusterMesh", tile: int, rounds: int, shards: int = 1):
    """One binned pass over the [n, 8] records ``x`` (n a multiple of
    ``tile * shards``) -> (bt, btri, flagged), each [n] in the order of
    ``x``; the binning sorts each of the ``shards`` rows on its own."""
    bins = argmin_bins(x, cm.cull_w, cm.blk)
    rank, perm = _bin_rank(bins, shards)
    x = _apply_perm(x, perm)
    t0s = x[:, 6].contiguous()
    acts = x[:, 7].contiguous()

    tile_entry = cl.cull(x, cm.cull_w, cm.blk, tile)
    sel, lb, lb_over = cl._select(tile_entry, rounds)
    bt, btri = cl.cluster_rounds(sel, lb, cl._ray_rows(x), t0s, acts, cm, tile)
    flagged = (acts > 0) & (lb_over.repeat_interleave(tile) < bt)
    return _apply_perm(bt, rank), _apply_perm(btri, rank), _apply_perm(flagged, rank)


# ---------------------------------------------------------------------------
# public entry
# ---------------------------------------------------------------------------


def intersect_mesh_binned(origin, direction, cm: "cl.ClusterMesh", config,
                          t_init=None, active=None, collect_stats: bool = False):
    """Nearest hit over the cluster mesh in binned order; exact
    (brute-equal) results.

    Same contract as ``cluster.intersect_mesh_cluster``. With
    ``collect_stats`` the call also returns how many rays flagged and
    which repair ran ("none", "compact" or "sweep")."""
    origin = vm.as_rows(origin)
    direction = vm.as_rows(direction)
    n = origin.shape[0]
    tile = config.cluster_tile
    kp = cm.n_blocks
    origin, direction, t0, act = cl._pad_rays(origin, direction, cm, tile, t_init, active)
    npad = origin.shape[0]
    # binned_shards = S > 1: every sort and the repair's compaction run
    # row by row on the [S, npad / S] view, where the rows are whole tiles
    # (else S = 1, as JAX does)
    shards = max(1, config.binned_shards)
    if npad % (tile * shards):
        shards = 1
    ns = npad // shards

    # Dead lanes: zero direction -> every MT determinant 0 -> never a hit
    # (their cull is masked by act too).
    direction = torch.where(act[:, None], direction, 0.0)
    x = torch.cat([origin, direction, t0[:, None], act.to(torch.float32)[:, None]], dim=1)

    bt, btri, flagged = _binned_pass(x, cm, tile, config.binned_rounds, shards)

    # Exactness repair. A flagged ray's tile had more feasible blocks than
    # its rounds: compact each row's flagged rays, bound them by their best
    # t, and rerun them with every feasible block of their tile (R = K).
    mr = min(REPAIR_LANES, ns)
    counts = flagged.reshape(shards, ns).sum(dim=1)
    counts_h = counts.tolist()  # one host read
    count = sum(counts_h)
    repair = "none"
    if 0 < max(counts_h) <= mr:
        repair = "compact"
        # flagged first in each row
        _, pos = torch.sort((~flagged).to(torch.int32).reshape(shards, ns), dim=1, stable=True)
        pos = (pos[:, :mr] + torch.arange(shards, device=x.device)[:, None] * ns).reshape(-1)
        live = (torch.arange(mr, device=x.device)[None, :] < counts[:, None]).reshape(-1)
        livef = live.to(torch.float32)
        x2 = x[pos]
        bt_g = bt[pos]
        x2[:, 6] = torch.where(live, bt_g, 0.0)
        x2[:, 7] *= livef
        x2[:, 3:6] *= livef[:, None]
        bt2, btri2, _ = _binned_pass(x2, cm, min(tile, mr), kp, shards)
        upd = live & (btri2 >= 0)
        bt = bt.index_copy(0, pos, torch.where(upd, bt2, bt_g))
        btri = btri.index_copy(0, pos, torch.where(upd, btri2, btri[pos]))
    elif count:
        # More flagged rays in a row than the buffer: the bounded sweep of
        # each flagged ray over every real triangle.
        repair = "sweep"
        bt, btri = cl.sweep(cl.flagged_rows(flagged, count), cl._ray_rows(x), bt, btri, cm,
                            tile)

    bt, btri = bt[:n], btri[:n]
    bt = torch.where(btri >= 0, bt, BIG)
    zero = torch.zeros((n,), dtype=torch.float32, device=bt.device)
    hit = TriHit(t=bt, tri=btri, u=zero, v=zero)
    if collect_stats:
        return hit, {"flagged": count, "repair": repair}
    return hit
