"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Builds the port's six CUDA kernels from ``kdtreepathtraceroptimization_tpu_
torch/csrc`` (one nvcc per source, in parallel) and drives its three mesh
render paths on Cornell + an 81,920-triangle icosphere at 800x800:

1. the card (nvidia-smi name and power limit), torch/CUDA versions, and
   the kernels' build (time, registers and shared memory per kernel);
2. each kernel against its plain PyTorch version, on the inputs a main
   path hands it at its second bounce: slab cull, walk and gather-to-
   columns from the walk path (slab cull and gather bit for bit, walk ids
   on >= 99.99% of rays with t within 1e-5 relative); pass 1's and pass
   2's extraction (bit for bit) and pass 1's pair test (loc on >= 99.99%
   of real pairs, t within 2^-12 relative) from the pair path; the brute
   force on a 16,384-ray slice of that bounce (ids on >= 99.99%, t within
   1e-5 relative). Each with its time, its plain version's, one library
   call's where one computes the same function, and its bound;
3. the pair list against the brute-force kernel on every ray of that
   bounce (640,000 rays x 131,072 triangle slots): ids on >= 99.99% of
   rays, t within 2^-12 relative (the pair list reports t truncated by
   its packed key, by < 2^-13);
4. golden parity: ``cornell_64``, ``mesh_pairs_48`` in its own (pair)
   config and in walk config, against the JAX package's goldens;
5. the main paths, each with every launch count zeroed just before and
   read just after: the pair path (the default config) and the walk path
   at depth 8, each with ms/iteration, rays/s, peak memory and a profile;
   a short ``enable_kd=False`` render through the brute-force kernel.
   Every kernel must launch on some path, and every image must be finite
   and non-black.

The second-to-last line is the kernels' JSON record, the last
``{"ok": true, "device": {...}}``. Any failed check exits non-zero before
those lines; so does a machine without CUDA, or a directory without the
port.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from kdtreepathtraceroptimization_tpu_torch.config import RenderConfig
from kdtreepathtraceroptimization_tpu_torch.ops import mesh as tmesh
from kdtreepathtraceroptimization_tpu_torch.ops import mxu_bf as tmxu
from kdtreepathtraceroptimization_tpu_torch.ops import pairs as tpairs
from kdtreepathtraceroptimization_tpu_torch.ops import walk as twalk
from kdtreepathtraceroptimization_tpu_torch.ops.rng import prng_key
from kdtreepathtraceroptimization_tpu_torch.render import integrator as tint
from kdtreepathtraceroptimization_tpu_torch.render.integrator import (
    make_render_block_fn,
    render,
)
from kdtreepathtraceroptimization_tpu_torch.utils.device import use_full_f32
from kdtreepathtraceroptimization_tpu_torch.scene.parser import load_scene, with_resolution
from kdtreepathtraceroptimization_tpu_torch.utils import cuda_build
from kdtreepathtraceroptimization_tpu_torch.utils.procmesh import icosphere, write_obj

REPO = os.path.dirname(os.path.abspath(__file__))
CORNELL = os.path.join(REPO, "scenes", "cornell.txt")
GOLDENS = os.path.join(REPO, "tests", "goldens")
WORK = os.path.join(REPO, "build", "chip_smoke")
WALK = dict(cluster=True, cluster_walk=True, cluster_pairs=False)
PAIRS = dict(cluster=True, cluster_pairs=True)  # the default config

# Published H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM
# bandwidth and float32 outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# Float32 operations per (ray, block) pair of the slab cull: per axis 2
# multiplies, 2 subtracts, 4 min/max; then abs, multiply, 3 add/subtract
# for the slack, one max and 4 compares, one min into the tile bound.
SLAB_OPS_PER_PAIR = 3 * 8 + 10
# Float32 operations per (ray, triangle) test of the walk, the pair test
# and the brute force: 4 ten-term dot products (40 FMAs = 80) and the
# epilogue's 5 compares, 1 add, 1 divide and 1 compare against the running
# best (the pair test packs and takes a min in its place).
MT_OPS_PER_TEST = 80 + 8
# Float32 operations per (live ray, real block) pair of the extraction:
# the slab entry of the slab cull without its tile min (per axis 2
# multiplies, 2 subtracts, 4 min/max; abs, multiply, add for the slack;
# subtract, add, max; 3 compares), and per feasible pair 2 more to build
# its key and compare it with the kept ones.
EXTRACT_OPS_PER_PAIR = 3 * 8 + 9
EXTRACT_OPS_PER_FEASIBLE = 2
# Rays of the bounce the brute force's kernel is held against its plain
# version on (the plain version makes a [rays, 4B] product per block).
BRUTE_SLICE = 16384
# The mesh_pairs_48 pixels whose paths branch in the golden itself: it was
# rendered under jit, whose fused multiply-adds move their first hit by an
# ulp (tests/test_torch_pairs.py shows it).
JIT_BRANCHED_PIXELS = (490, 518)

KERNELS = (
    ("slab_cull", twalk.SLAB_CULL, "kdtreepathtraceroptimization_tpu_torch/csrc/slab_cull.cu",
     "kdtreepathtraceroptimization_tpu/ops/walk.py:109"),
    ("walk", twalk.WALK, "kdtreepathtraceroptimization_tpu_torch/csrc/walk.cu",
     "kdtreepathtraceroptimization_tpu/ops/walk.py:186"),
    ("gather_cols", tmesh.GATHER_COLS, "kdtreepathtraceroptimization_tpu_torch/csrc/gather_cols.cu",
     "kdtreepathtraceroptimization_tpu/ops/mesh.py:170"),
    ("pair_extract", tpairs.EXTRACT, "kdtreepathtraceroptimization_tpu_torch/csrc/pair_extract.cu",
     "kdtreepathtraceroptimization_tpu/ops/pairs.py:149"),
    ("pair_runs", tpairs.PAIR_RUNS, "kdtreepathtraceroptimization_tpu_torch/csrc/pair_runs.cu",
     "kdtreepathtraceroptimization_tpu/ops/pairs.py:351"),
    ("mxu_bf", tmxu.BF, "kdtreepathtraceroptimization_tpu_torch/csrc/mxu_bf.cu",
     "kdtreepathtraceroptimization_tpu/ops/mxu_bf.py:187"),
)
# The path whose launch count each kernel's record reports.
RECORD_PATH = {"slab_cull": "walk", "walk": "walk", "gather_cols": "pairs",
               "pair_extract": "pairs", "pair_runs": "pairs", "mxu_bf": "brute"}


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_ms(fn, reps: int) -> float:
    """Median device time of ``fn()`` in ms over ``reps`` runs (CUDA events),
    after one warm-up run."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def mesh_scene(subdiv: int, radius: float, res: int, device):
    os.makedirs(WORK, exist_ok=True)
    verts, faces = icosphere(subdiv, radius=radius, center=(0.0, 3.0, 0.0))
    path = os.path.join(WORK, f"icosphere{subdiv}_r{radius}.obj")
    write_obj(path, verts, faces)
    return with_resolution(load_scene(CORNELL, obj_path=path, device=device),
                           res, res)


class Recorder:
    """Keeps a copy of the arguments one function receives on the
    ``index``-th of its calls that ``match(args, kwargs)`` accepts, while
    the block runs; restores the function on exit."""

    def __init__(self, module, name: str, index: int, match=None):
        self.module, self.name, self.index = module, name, index
        self.match = match or (lambda args, kwargs: True)
        self.calls = 0
        self.args = self.kwargs = None

    def __enter__(self):
        self.real = getattr(self.module, self.name)

        def copy(a):
            return a.clone() if isinstance(a, torch.Tensor) else a

        def wrapped(*args, **kwargs):
            if self.match(args, kwargs):
                if self.calls == self.index:
                    self.args = [copy(a) for a in args]
                    self.kwargs = {k: copy(v) for k, v in kwargs.items()}
                self.calls += 1
            return self.real(*args, **kwargs)

        setattr(self.module, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)


def real_tris_per_block(cm) -> torch.Tensor:
    """[kp] real triangles in each cluster block. The build pads a leaf
    to the block size with degenerate copies (v1 = v2 = v0) that never
    win (ops/cluster.py), and the lane-padding blocks past
    ``n_real_blocks`` hold none; a kernel's least work skips both."""
    t = cm.tris
    pad = (t.v1 == t.v0).all(dim=1) & (t.v2 == t.v0).all(dim=1)
    real = (~pad).reshape(cm.n_real_blocks, cm.block).sum(dim=1)
    return torch.cat([real, real.new_zeros(cm.n_blocks - cm.n_real_blocks)])


def bound(nbytes: float, ops: float) -> dict:
    """The least time for ``nbytes`` of traffic and ``ops`` f32 operations."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOP_PER_S
    return dict(bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="operations" if t_ops > t_bytes else "bytes")


def phase_kernels(scene, config, device) -> dict:
    """Kernel vs plain version on the main path's inputs at bounce 1."""
    n = int(scene.camera.resolution[0]) * int(scene.camera.resolution[1])
    step = make_render_block_fn(scene, config, 1, device=device)
    with Recorder(twalk, "slab_cull", 1) as rs, Recorder(twalk, "walk", 1) as rw, \
            Recorder(tmesh, "gather_cols", 1) as rg:
        step(torch.zeros((n, 3), device=device), prng_key(0), 1)
    sync(device)
    results = {}

    # -- slab cull: bit-equal ------------------------------------------
    x, slab, blk, tile = rs.args
    got = twalk.slab_cull(x, slab, blk, tile)
    want = twalk._slab_cull_ref(x, slab, blk, tile)
    sync(device)
    if not torch.equal(got, want):
        bad = (got != want).sum().item()
        raise AssertionError(f"slab_cull differs from its plain version in {bad} entries")
    k_real = int((blk[5] >= 0).sum())
    rays = x.shape[0]
    live_rays = int((x[:, 7] > 0).sum())  # dead rays add nothing to a tile's min
    slab_bytes = (x.numel() + slab.numel() + blk.numel() + got.numel()) * 4
    slab_ops = live_rays * k_real * SLAB_OPS_PER_PAIR
    results["slab_cull"] = dict(
        max_abs_err=0.0,
        ms=time_ms(lambda: twalk.slab_cull(x, slab, blk, tile), 20),
        plain_ms=time_ms(lambda: twalk._slab_cull_ref(x, slab, blk, tile), 3),
        library_ms=None, **bound(slab_bytes, slab_ops),
        shape=f"x [{rays},16] ({live_rays} live), slab/blk [8,{blk.shape[1]}] "
              f"({k_real} real blocks), tile {tile}",
    )
    log(f"[kernels] slab_cull == plain bit for bit; {results['slab_cull']['shape']}")

    # -- walk: ids on >= 99.99% of rays, t within 1e-5 where they differ --
    sel, lb, nsel, r, t0, act, w, wtile, block = rw.args
    bt_k, btri_k = twalk.walk(sel, lb, nsel, r, t0, act, w, wtile, block)
    bt_p, btri_p = twalk._walk_ref(sel, lb, r, t0, act, w, wtile, block)
    sync(device)
    same = btri_k == btri_p
    frac = same.float().mean().item()
    rel = ((bt_k - bt_p).abs() / bt_p.abs().clamp_min(1e-30))
    hits = int((btri_p >= 0).sum())
    log(f"[kernels] walk: {hits} of {rays} rays hit; ids equal on {frac:.6%}; "
        f"max |dt|/t {rel.max().item():.3g} (where ids differ: "
        f"{rel[~same].max().item() if (~same).any() else 0.0:.3g})")
    if frac < 0.9999:
        raise AssertionError(f"walk ids equal on only {frac:.6%} of rays")
    if (~same).any() and rel[~same].max().item() > 1e-5:
        raise AssertionError("walk: t differs by more than 1e-5 where ids differ")
    if rel[same].max().item() > 1e-5:
        raise AssertionError("walk: t differs by more than 1e-5 relative")
    # The least work this data needs: a tile must test every listed block
    # whose entry bound lies below some live ray's final t, for each of
    # its live rays and each real triangle of the block.
    g = r.shape[0] // wtile
    live = act.reshape(g, wtile) > 0
    worst = torch.where(live, bt_p.reshape(g, wtile), torch.zeros_like(t0).reshape(g, wtile)).amax(dim=1)
    need = (lb < worst[:, None]) & (torch.arange(lb.shape[1], device=lb.device)[None] < nsel)
    needed = int(need.sum())
    tris_of = real_tris_per_block(scene.cmesh)[sel.long().clamp(0, lb.shape[1] - 1)]
    walk_tests = int((need * live.sum(dim=1, keepdim=True) * tris_of).sum())
    walk_ops = walk_tests * MT_OPS_PER_TEST
    walk_bytes = sum(a.numel() * 4 for a in (sel, lb, nsel, r, t0, act, w, bt_k, btri_k))
    results["walk"] = dict(
        max_abs_err=(bt_k - bt_p)[same].abs().max().item(),
        ms=time_ms(lambda: twalk.walk(sel, lb, nsel, r, t0, act, w, wtile, block), 10),
        plain_ms=time_ms(lambda: twalk._walk_ref(sel, lb, r, t0, act, w, wtile, block), 3),
        library_ms=None, **bound(walk_bytes, walk_ops),
        shape=f"{g} tiles of {wtile} rays, {needed} needed (tile, block) rounds "
              f"of {block} slots, {walk_tests} needed (live ray, real triangle) tests, "
              f"feasible lists of mean {nsel.float().mean().item():.1f}",
        ids_equal=frac,
    )
    log(f"[kernels] walk: {results['walk']['shape']}")

    # -- gather-to-columns: bit-equal ------------------------------------
    packed, tri = rg.args
    got = tmesh.gather_cols(packed, tri)
    want = tmesh._gather_cols_ref(packed, tri)
    sync(device)
    if not torch.equal(got, want):
        raise AssertionError("gather_cols differs from packed[tri].T")
    gbytes = (2 * got.numel() + tri.numel()) * 4
    results["gather_cols"] = dict(
        max_abs_err=0.0,
        ms=time_ms(lambda: tmesh.gather_cols(packed, tri), 20),
        plain_ms=time_ms(lambda: tmesh._gather_cols_ref(packed, tri), 10),
        **bound(gbytes, 0),
        # one PyTorch call for the same [C, n] result: index_select on the
        # table's transposed view
        library_ms=time_ms(lambda: torch.index_select(packed.T, 1, tri.long()), 20),
        shape=f"packed [{packed.shape[0]},{packed.shape[1]}], tri [{tri.shape[0]}]",
    )
    log(f"[kernels] gather_cols == packed[tri].T bit for bit; {results['gather_cols']['shape']}")
    for name, res in results.items():
        lib = "n/a" if res["library_ms"] is None else f"{res['library_ms']:.4f}"
        log(f"[kernels] {name}: kernel {res['ms']:.4f} ms, plain {res['plain_ms']:.4f} ms, "
            f"library {lib} ms, bound {res['bound_ms']:.4f} ms ({res['bound_by']})")
    return results


def phase_pairs(scene, device):
    """Kernels 5, 6 and 8 against their plain versions on the pair path's
    second bounce, and the pair list against the brute force on all of
    its rays. Returns (kernel results, the bounce's collect_stats)."""
    use_full_f32()
    n = int(scene.camera.resolution[0]) * int(scene.camera.resolution[1])
    step = make_render_block_fn(scene, RenderConfig(trace_depth=8, antialias=True, **PAIRS),
                                1, device=device)
    with Recorder(tint, "intersect_mesh_pairs", 1) as rp:
        step(torch.zeros((n, 3), device=device), prng_key(0), 1)
    sync(device)
    args, kwargs = rp.args, rp.kwargs
    with Recorder(tpairs, "extract", 0, match=lambda a, kw: a[3] == tpairs.F2) as r2, \
            Recorder(tpairs, "extract", 0, match=lambda a, kw: a[3] != tpairs.F2) as r1, \
            Recorder(tpairs, "pair_runs", 0) as rr:
        hit_p, stats = tpairs.intersect_mesh_pairs(*args, **kwargs, collect_stats=True)
    sync(device)
    log(f"[pairs] bounce 1 stats: {stats}")
    results = {}

    # -- extraction, passes 1 and 2: bit-equal ----------------------------
    for label, rec in (("pass 1", r1), ("pass 2", r2)):
        if rec.args is None:
            log(f"[kernels] pair_extract {label}: not reached at this bounce")
            continue
        x, slab, blk, F = rec.args
        got = tpairs.extract(x, slab, blk, F)
        want = tpairs._extract_ref(x, slab, blk, F)
        sync(device)
        for name, a, b in zip(("ids", "lbov", "cnt", "feat"), got, want):
            if not torch.equal(a, b):
                raise AssertionError(f"pair_extract {label}: {name} differs from the plain "
                                     f"version in {int((a != b).sum())} entries")
        live = int((x[:, 7] > 0).sum())
        k_real = int((blk[5] >= 0).sum())
        feasible = int(want[2].sum())
        nbytes = (x.numel() + slab.numel() + blk.numel()
                  + sum(t.numel() for t in got)) * 4
        ops = live * k_real * EXTRACT_OPS_PER_PAIR + feasible * EXTRACT_OPS_PER_FEASIBLE
        res = dict(
            max_abs_err=0.0,
            ms=time_ms(lambda: tpairs.extract(x, slab, blk, F), 20),
            plain_ms=time_ms(lambda: tpairs._extract_ref(x, slab, blk, F), 3),
            library_ms=None, **bound(nbytes, ops),
            shape=f"x [{x.shape[0]},16] ({live} live), kp {blk.shape[1]} ({k_real} real), "
                  f"F {F}, {feasible} feasible pairs")
        log(f"[kernels] pair_extract {label} == plain bit for bit; {res['shape']}; "
            f"kernel {res['ms']:.4f} ms, plain {res['plain_ms']:.4f} ms, "
            f"bound {res['bound_ms']:.4f} ms ({res['bound_by']})")
        results.setdefault("pair_extract", res)

    # -- pair test, pass 1 round 1: loc on >= 99.99% of real pairs --------
    # The kernel's 10-term FMA chains and the plain version's matmul may
    # round a sum differently: a t one ulp apart can move across a 2^-13
    # truncation step or an edge test, so loc may differ on a near-tie and
    # t by up to one truncation step.
    blk_s, featp, w, block, ptile, kreal = rr.args
    got = tpairs.pair_runs(blk_s, featp, w, block, ptile, kreal)
    want = tpairs._pair_runs_ref(blk_s, featp, w, block, kreal)
    sync(device)
    real = blk_s < kreal
    tg, lg = tpairs._unpack_tl(got)
    tw, lw = tpairs._unpack_tl(want)
    n_real = int(real.sum())
    loc_eq = (lg == lw)[real].float().mean().item()
    both = real & (tg < 1e30) & (tw < 1e30)
    rel = ((tg - tw).abs() / tw.abs().clamp_min(1e-30))[both]
    rel_max = rel.max().item() if rel.numel() else 0.0
    log(f"[kernels] pair_runs: {n_real} real of {blk_s.shape[0]} pairs, "
        f"{int(both.sum())} hit; loc equal on {loc_eq:.6%}; max |dt|/t {rel_max:.3g}; "
        f"packed equal on {(got == want)[real].float().mean().item():.6%}")
    if (got[~real] != tpairs._PBIG).any():
        raise AssertionError("pair_runs: a sentinel pair was not left at _PBIG")
    if loc_eq < 0.9999 or rel_max > 2.0 ** -12:
        raise AssertionError("pair_runs differs from its plain version beyond its tolerance")
    blocks_used = int(torch.unique(blk_s[real]).numel())
    nbytes = blk_s.numel() * 4 + featp.numel() * 4 + got.numel() * 4 + blocks_used * 16 * 4 * block * 4
    # each real pair against the real triangles of its block
    pair_tests = int(real_tris_per_block(args[2])[blk_s[real].long()].sum())
    results["pair_runs"] = dict(
        max_abs_err=(tg - tw)[both].abs().max().item() if int(both.sum()) else 0.0,
        ms=time_ms(lambda: tpairs.pair_runs(blk_s, featp, w, block, ptile, kreal), 20),
        plain_ms=time_ms(lambda: tpairs._pair_runs_ref(blk_s, featp, w, block, kreal), 3),
        library_ms=None, **bound(nbytes, pair_tests * MT_OPS_PER_TEST),
        shape=f"{blk_s.shape[0]} pairs ({n_real} real, {blocks_used} blocks) in tiles of {ptile}, "
              f"blocks of {block} slots, {pair_tests} (real pair, real triangle) tests")
    r = results["pair_runs"]
    log(f"[kernels] pair_runs: {r['shape']}; kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
        f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")

    # -- the pair list against the brute-force kernel, every ray ----------
    origin, direction, cm = args[0], args[1], args[2]
    t_init, active = kwargs["t_init"], kwargs["active"]
    d_live = torch.where(active[:, None], direction, 0.0)  # dead rays never hit
    tris = cm.tris
    hb = tmxu.intersect_brute_mxu(origin, d_live, tris.v0, tris.v1, tris.v2, t_max=t_init)
    sync(device)
    frac = (hit_p.tri == hb.tri).float().mean().item()
    both = (hb.tri >= 0) & (hit_p.tri >= 0)
    rel = ((hit_p.t - hb.t).abs() / hb.t.abs().clamp_min(1e-30))[both]
    log(f"[pairs] pair list vs brute-force kernel on all {origin.shape[0]} rays of bounce 1 "
        f"x {tris.v0.shape[0]} triangle slots: {int((hb.tri >= 0).sum())} hits; ids equal on "
        f"{frac:.6%}; max |dt|/t {rel.max().item() if rel.numel() else 0.0:.3g} where both hit "
        f"(bound 2^-12)")
    if frac < 0.9999 or (rel.numel() and rel.max().item() > 2.0 ** -12):
        raise AssertionError("the pair list differs from the brute force on this bounce")

    # -- brute force: kernel against plain on a slice; timed at full size --
    mesh = scene.mesh
    idx = torch.arange(0, origin.shape[0], origin.shape[0] // BRUTE_SLICE,
                       device=device)[:BRUTE_SLICE]
    o_s, d_s, t_s = origin[idx], d_live[idx], t_init[idx]
    got = tmxu.intersect_brute_mxu(o_s, d_s, mesh.v0, mesh.v1, mesh.v2, t_max=t_s)
    want = tmxu.intersect_brute_mxu_ref(o_s, d_s, mesh.v0, mesh.v1, mesh.v2, t_max=t_s, block=512)
    sync(device)
    same = got.tri == want.tri
    frac = same.float().mean().item()
    both = (got.tri >= 0) & (want.tri >= 0)
    rel = ((got.t - want.t).abs() / want.t.abs().clamp_min(1e-30))[both]
    log(f"[kernels] mxu_bf on {BRUTE_SLICE} rays of bounce 1 x {mesh.v0.shape[0]} triangles: "
        f"{int((want.tri >= 0).sum())} hits; ids equal on {frac:.6%}; max |dt|/t "
        f"{rel.max().item():.3g} where both hit")
    if frac < 0.9999 or rel.max().item() > 1e-5:
        raise AssertionError("mxu_bf differs from its plain version beyond its tolerance")

    def brute():
        return tmxu.intersect_brute_mxu(origin, d_live, mesh.v0, mesh.v1, mesh.v2, t_max=t_init)

    def brute_plain():
        return tmxu.intersect_brute_mxu_ref(origin, d_live, mesh.v0, mesh.v1, mesh.v2,
                                            t_max=t_init, block=512)

    t = time.perf_counter()
    brute_plain()
    sync(device)
    plain_ms = (time.perf_counter() - t) * 1e3
    nrays = origin.shape[0]
    live_rays = int(active.sum())  # dead rays (d = 0) never hit
    nbytes = nrays * (16 + 1 + 2) * 4 + mesh.v0.shape[0] * 16 * 4 * 4
    results["mxu_bf"] = dict(
        max_abs_err=(got.t - want.t)[same & (want.tri >= 0)].abs().max().item(),
        ms=time_ms(brute, 3), plain_ms=plain_ms, library_ms=None,
        **bound(nbytes, live_rays * mesh.v0.shape[0] * MT_OPS_PER_TEST),
        shape=f"{nrays} rays ({live_rays} live) x {mesh.v0.shape[0]} triangles in blocks of 512")
    r = results["mxu_bf"]
    log(f"[kernels] mxu_bf: {r['shape']}; kernel {r['ms']:.2f} ms, plain {r['plain_ms']:.2f} ms "
        f"(one call), bound {r['bound_ms']:.2f} ms ({r['bound_by']})")
    log("[kernels] library_ms is null for pair_extract, pair_runs and mxu_bf: no one PyTorch "
        "call computes a masked first-minimum (or top-F selection) over each ray's own blocks")
    return results, stats


def phase_goldens(device):
    """The JAX package's committed goldens, rendered by the port."""
    scene = with_resolution(load_scene(CORNELL, device=device), 64, 64)
    img = render(scene, RenderConfig(trace_depth=8, antialias=True), spp=8,
                 seed=0, device=device)
    d = np.abs(img.cpu().numpy() - np.load(os.path.join(GOLDENS, "cornell_64.npy")))
    log(f"[golden] cornell_64: max |d| {d.max():.3g}, mean |d| {d.mean():.3g} "
        f"(bound: per pixel 2e-3)")
    if d.max() > 2e-3:
        raise AssertionError("cornell_64 differs from its golden beyond atol 2e-3")

    scene = mesh_scene(4, 2.0, 48, device)
    golden = np.load(os.path.join(GOLDENS, "mesh_pairs_48.npy"))
    img = render(scene, RenderConfig(trace_depth=4, cluster_tile=256, **PAIRS),
                 spp=8, seed=0, device=device)
    d = np.abs(img.cpu().numpy() - golden)
    off = np.flatnonzero((d > 2e-3).any(axis=-1))
    log(f"[golden] mesh_pairs_48 (its own pair config): max |d| {d.max():.3g}, mean |d| "
        f"{d.mean():.3g}; {off.size} of {d.shape[0] * d.shape[1]} pixels beyond atol 2e-3 "
        f"({', '.join(str(i) for i in off)}) (bound: no pixel but {JIT_BRANCHED_PIXELS}, "
        f"mean 2e-4: the golden's jit fused multiply-adds, which branches those two)")
    if not set(off.tolist()) <= set(JIT_BRANCHED_PIXELS) or d.mean() > 2e-4:
        raise AssertionError("mesh_pairs_48 differs from its golden beyond its bound")
    img = render(scene, RenderConfig(trace_depth=4, cluster_tile=256, **WALK),
                 spp=8, seed=0, device=device)
    d = np.abs(img.cpu().numpy() - golden)
    log(f"[golden] mesh_pairs_48 (walk config): max |d| {d.max():.3g}, "
        f"mean |d| {d.mean():.3g} (bound: mean 1e-2)")
    if d.mean() > 1e-2:
        raise AssertionError("mesh_pairs_48 (walk) differs from its golden beyond mean 1e-2")


def phase_main_path(name, scene, config, device, expect, block: int = 2,
                    timed_calls: int = 3, profile: bool = True) -> dict:
    """One render path at full size; every launch count is zeroed just
    before it and read just after. ``expect`` names the kernels that
    must launch on it."""
    res = int(scene.camera.resolution[0])
    n = res * res
    step = make_render_block_fn(scene, config, block, device=device)
    key = prng_key(0)
    for _, kernel, _, _ in KERNELS:
        kernel.launches = 0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    # index -1 records nothing: it only counts the pair path's set-size reads
    with Recorder(tpairs, "_compact_all", -1) as reads:
        film = step(torch.zeros((n, 3), device=device), key, 1)  # warm-up
        sync(device)
        per_iter = []
        it = 1 + block
        for _ in range(timed_calls):
            t = time.perf_counter()
            film = step(film, key, it)
            sync(device)
            per_iter.append((time.perf_counter() - t) * 1e3 / block)
            it += block
    launches = {kname: kernel.launches for kname, kernel, _, _ in KERNELS}
    img = film / (it - 1)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    ms = statistics.median(per_iter)
    depth = config.effective_depth
    iters = (1 + timed_calls) * block
    log(f"[main:{name}] {res}x{res}, depth {depth}, {int(scene.mesh.v0.shape[0])} triangles: "
        f"{ms:.2f} ms/iteration (median of {timed_calls} calls x {block} iterations: "
        f"{', '.join(f'{v:.2f}' for v in per_iter)}), "
        f"{n * depth / (ms / 1e3):.4g} rays/s, peak memory {peak / 2**20:.1f} MiB")
    log(f"[main:{name}] launches over {iters} iterations: {launches}")
    if name == "pairs":
        # each _compact_all reads a set size on the host; each bounce also
        # reads whether any ray is left for pass 3
        log(f"[main:{name}] host reads per iteration: "
            f"{(reads.calls + depth * iters) / iters:.1f}")
    missing = [k for k in expect if launches[k] == 0]
    if missing:
        raise AssertionError(f"{missing} not launched on the {name} path: {launches}")
    if not torch.isfinite(img).all():
        raise AssertionError(f"the {name} image has non-finite values")
    if not img.mean().item() > 0:
        raise AssertionError(f"the {name} image is black")
    log(f"[main:{name}] image mean {img.mean().item():.4f}")
    if profile:
        phase_profile(name, step, film, key, it, block, device)
    return launches


def phase_profile(name, step, film, key, it, block, device) -> None:
    """Where one main-path call's device time goes (torch.profiler), and
    the device's idle share over its wall time. A profiler that cannot
    start or sees no device time prints "not measured"; the render it
    wraps is checked like any other and fails the run if it fails."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    try:
        prof.start()
    except RuntimeError as exc:
        log(f"[profile:{name}] not measured: the profiler did not start: {exc}")
        return
    try:
        t = time.perf_counter()
        out = step(film, key, it)
        sync(device)
        wall_ms = (time.perf_counter() - t) * 1e3
    finally:
        prof.stop()
    if not torch.isfinite(out).all():
        raise AssertionError("the profiled main-path call gave non-finite values")
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.device_time_total for e in kernels) / 1e3
    if busy_ms <= 0:
        log(f"[profile:{name}] not measured: the profiler recorded no device time")
        return
    ours = [k + "_kernel" for k, _, _, _ in KERNELS]
    groups = {k: 0.0 for k, _, _, _ in KERNELS}
    groups["other"] = 0.0
    launches = 0
    for e in kernels:
        launches += e.count
        kname = next((g for g in ours if g in e.key), None)
        groups[kname[:-len("_kernel")] if kname else "other"] += e.device_time_total / 1e3
    log(f"[profile:{name}] {block} iterations under the profiler: wall {wall_ms:.1f} ms, "
        f"device busy {busy_ms:.1f} ms (idle share {1 - busy_ms / wall_ms:.3f}), "
        f"{launches} kernel launches")
    log(f"[profile:{name}] device ms per iteration: " + ", ".join(
        f"{g} {v / block:.2f}" for g, v in groups.items()))
    for e in sorted(kernels, key=lambda e: -e.device_time_total)[:12]:
        log(f"[profile:{name}]   {e.device_time_total / 1e3 / block:9.3f} ms/iter "
            f"{e.count // block:6d} launches/iter  {e.key[:90]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    card = card_line()
    log(f"[card] {card}")
    log(f"[card] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, python {sys.version.split()[0]}")
    t = time.perf_counter()
    logs = cuda_build.build_all()
    log(f"[build] {len(logs)} kernels built in {time.perf_counter() - t:.1f} s "
        f"(nvcc {' '.join(cuda_build.NVCC_FLAGS)})")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "Compiling entry" in line:
                log(f"[build] {name}: {line.strip()}")

    device = torch.device("cuda", torch.cuda.current_device())
    scene = mesh_scene(6, 2.5, 800, device)
    walk_config = RenderConfig(trace_depth=8, antialias=True, **WALK)
    results = phase_kernels(scene, walk_config, device)
    pair_results, _ = phase_pairs(scene, device)
    results.update(pair_results)
    phase_goldens(device)
    paths = {
        "pairs": phase_main_path("pairs", scene, RenderConfig(trace_depth=8, antialias=True),
                                 device, ("pair_extract", "pair_runs", "gather_cols")),
        "walk": phase_main_path("walk", scene, walk_config, device,
                                ("slab_cull", "walk", "gather_cols")),
        "brute": phase_main_path("brute", scene,
                                 RenderConfig(trace_depth=2, antialias=True, enable_kd=False,
                                              cluster_auto=False),
                                 device, ("mxu_bf", "gather_cols"), block=1,
                                 timed_calls=1, profile=False),
    }
    unused = [k for k, _, _, _ in KERNELS if not any(p[k] for p in paths.values())]
    if unused:
        raise AssertionError(f"kernels launched on no path: {unused}")

    record = {"kernels": [
        dict(name=name, route="cuda", source=source, replaces=replaces,
             launches=paths[RECORD_PATH[name]][name],
             **{k: results[name][k] for k in ("max_abs_err", "ms", "plain_ms",
                                              "bound_ms", "bound_by", "library_ms")})
        for name, _, source, replaces in KERNELS
    ]}
    log(f"[card] {card}")
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
