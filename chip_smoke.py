"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py [--shapes [NAMES]] [--launches] [--big]

Builds the port's thirteen CUDA kernels (thirteen sources: one for each TPU
kernel, and the analytic geoms' nearest hit) from ``kdtreepathtraceroptimization_tpu_torch/csrc`` (one nvcc per
source, in parallel) and the native KD builder (g++), and drives its mesh render
paths (pair list with either pair kernel, walk, cluster rounds, binned,
KD walks, brute force), its wavefront extras, its command line and its
gradient path on Cornell + an 81,920-triangle icosphere at 800x800:

1. the card (nvidia-smi name and power limit), torch/CUDA versions, and
   the kernels' build (time, registers, spills and shared memory per
   kernel); ``[sass]``: kernel 5 with the SASS digest of SASS_DIGESTS
   (its group math is shared with kernel 1 and must not change);
2. each kernel against its plain PyTorch version, on the inputs a main
   path hands it at its second bounce: slab cull, walk and gather-to-
   columns from the walk path (the slab cull, kernel 1, bit for bit,
   also on the pair path's first pass-3 call where one fires, with its
   group premise on every ray and the group and member tests its
   two-level cull runs; the gather bit for bit, the
   gather's time against ``index_select`` and twice its bound, walk ids
   on >= 99.99% of rays with t within 1e-5 relative and, as its skips
   are exact, t and ids equal to the plain version's on every ray, on a
   padded table and with all-dead tiles, and its executed (tile, block)
   rounds beside the needed ones, its time beside its earlier figure);
   pass 1's and pass 2's extraction (bit for bit; its group premise on
   every ray, for groups of 4, 8 and 16 blocks, with the group and member
   tests the two-level cull runs and the groups each warp met) and pass
   1's and pass 2's pair test (loc on >= 99.99% of real pairs, t within
   2^-12 relative) from the pair path;
   the brute force on a 16,384-ray slice of that bounce, rays with d = 0
   among them (ids on >= 99.99%, t within 1e-5 relative), timed on the
   full bounce with the dead rays' d = 0 (as the oracle calls pass them)
   and with their directions kept (as the brute route does). Each with
   its time, its plain version's, one library call's where one computes
   the same function, and its bound. The weight
   tables of the walk, the brute force, kernel 7 and the rounds must have
   the zero pattern their sparse test rests on
   (``mxu_bf.check_sparse_pattern``);
3. the pair list against the brute-force kernel on every ray of that
   bounce (640,000 rays x 131,072 triangle slots): ids on >= 99.99% of
   rays, t within 2^-12 relative (the pair list reports t truncated by
   its packed key, by < 2^-13); ``[bdiag]``: kernel 7 on the pairs the
   ``pair_bdiag`` path's second bounce hands it (1024-pair supertiles)
   against kernel 6 on the same pairs (packed keys bit for bit) and its
   plain version (kernel 6's tolerance), its runs per supertile and per
   thread block and the rounds those take, and that path's pair list
   against the brute-force kernel on every ray;
4. ``[cluster]``: kernels 9-12 against their plain versions on the inputs
   the cluster-rounds and binned paths hand them at their second bounce
   (sphere cull and argmin bins bit for bit, the sphere cull also on the
   cluster paths' bounce 0, with its group premise on every ray and
   the group and member tests its two-level cull runs; the rounds on the calls of
   both paths ids on >= 99.99% of rays with t within 1e-5 relative and,
   as its skips are exact, t and ids equal to the plain version's on
   every ray, with its rounds and tests beside the needed ones and its
   time also with its tiles launched in index order; the sweep ids on
   >= 99.99% of rays with t within 1e-5 relative on the first
   16,384 of its flagged rows, in both launch shapes: one pass and the
   block axis split, which must also agree bit for bit on all its flagged
   rows; timed on them against the bound of that work, in each launch
   shape, and in its full-width form, every ray listed), and both
   intersectors against the brute-force kernel on every ray of that
   bounce (ids on >= 99.99%, t within 1e-5 relative), with the
   flagged-ray count and the repair;
3b. ``[launches]``: each launch of kernels 5 and 6 over one iteration of
   the pair path, with its bounce, pass, round, rays or pairs, and device
   time (``--launches`` runs only this, after the build: it uses only
   entry points every tree of the port has, so it can time an earlier
   tree's kernels);
3c. ``[big]``: the pair path on a million-triangle mesh, as the
   benchmark's ``cornell-ico1310k`` renders it (``--big`` runs only
   this, after the build): Cornell + ``icosphere(8)`` (1,310,720
   triangles, which the cluster build puts in 4,096 blocks of 512) at
   2048x2048, depth 8, AA, the default config (route ``pairs``). On its
   second bounce's pair call: kernel 5 on pass 1's and pass 2's calls (in
   both forms) and kernel 3 bit for bit, kernel 1 bit for bit on pass 3's
   first call (with its group premise), kernel 6 on pass 1's and pass
   2's first calls (its tolerance above), kernel 2 on pass 3's first walk
   and, as pass 3's rays mostly miss, on 2,048 mesh-active rays of the
   bounce whose lists are built as pass 3 builds them, a tenth of which
   at least must hit (ids equal on every ray, t within 1e-5 relative),
   each against its
   plain version, and the pair list against the brute-force kernel on
   every ray of the bounce (its tolerance above); then the path with
   every launch count zeroed just before it and read just after
   (kernels 5, 6, 1, 2, 3 and 13 must launch, kernel 13 once a bounce;
   kernels 7-12 must not);
4a. ``[geoms]``: kernel 13 (the analytic geoms' nearest hit) against
   its plain version on the rays the pair path hands ``intersect_geoms``
   at bounces 0 (the camera's, their origin one value on every lane) and
   1, at 800x800 and at 2048x2048: every field bit for bit, with the
   kernel's and the plain version's ms and the bytes bound (57 B a lane);
4b. ``[shapes]``, only with ``--shapes`` (the measurement that chose the
   launch-shape constants of kernels 2, 8, 10, 7, 6, 5, 1, 9 and 12;
   ``--shapes slab_cull,cluster_cull`` times only those): the walk, the
   brute force, the rounds, kernels 7, 6, 5, 1, 9 and 12 built with other
   launch shapes (rays a thread, threads, thread blocks an SM holds; for
   the walk and the rounds, the triangle loop's unroll; for kernel 6, the
   rounds above which a part reads its weights directly; for kernels 5, 1,
   9 and 12, their blocks a group;
   for kernel 5, its split form's lanes a ray) and timed on
   the same inputs (kernel 6 also on pass 2's call and bounce 0's
   heaviest launch, kernel 5 on pass 2's and in its split form on pass
   1's, kernel 1 on pass 3's, kernel 9 and 12 on the binned path's), each equal
   to the sources' own shape bit for bit;
5. golden parity: the cases of ``tools/goldens.CASES``: ``cornell_64``,
   ``cornell_spec_64`` (every pixel but the ten its jit render branched),
   ``mesh_pairs_48`` in its own (pair) config and in walk, cluster-rounds
   and binned config, ``mesh_kd_48`` (the KD walk in the default config),
   against the JAX package's goldens;
5b. ``[kd]``: the native and numpy KD builds of the 81,920-triangle mesh
   (seconds, tree statistics), and the KD walk (``cluster_auto=False``)
   against the brute-force kernel on every ray of the second bounce, as
   source-mesh triangle ids (>= 99.99%) with t within 1e-4 relative (the
   JAX package's KD-vs-brute bound: the walk's Moller-Trumbore and kernel
   8's determinant form round differently at grazing hits);
5c. ``[kdwalks]``: the other KD walks (the fat-row short-stack walk,
   packets of 32, and the thin-table skip-link, short-stack and push-down
   walks) on every ray of the kd path's second bounce (320 triangles) and
   of the kd_big path's (81,920), against the brute-force kernel as
   source-mesh ids on >= 99.99% of the rays the step bound did not cut,
   t within 1e-4 relative (the thin walks on kd_big printed, not held),
   with ms, steps, host reads, cut lanes and peak memory; then each
   renders the kd scene at 800x800, depth 8 (3 iterations, or 1 where one
   takes over 2 s), finite and non-black, with its largest difference
   from the default walk's image of the same iterations;
6. the main paths, each with every launch count zeroed just before and
   read just after: the pair path (the default config), the walk, the
   cluster-rounds and the binned paths at depth 8, the pair path with
   ``pair_bdiag`` (its image equal to the default pair path's), each with
   ms/iteration, rays/s, peak memory and a profile (a path slower than
   2 s an iteration is timed as one call of one iteration), and for the
   last two the flagged rays and the repair of every bounce (the pair
   path must launch kernel 13 once a bounce); a short
   cluster-rounds render with 4 rounds at depth 2 (profiled), so that the
   sweep launches on a render whether or not 64 rounds ever flag; a short
   ``enable_kd=False`` render through the brute-force kernel; the KD
   walk in the default config on a 320-triangle icosphere at depth 8, and
   with ``cluster_auto=False`` on the 81,920 triangles at depth 2 (one
   call), each with its steps and host reads per bounce. Every kernel
   must launch on some path, and every image must be finite and
   non-black;
6b. ``[extras]``: on the default pair path at 800x800, depth 8,
   ``compaction`` and ``material_sort`` (``partial_gather`` off) give the
   default film bit for bit over iterations 1-2, each with its ms an
   iteration; the ray cache's iteration 1 is the uncached one bit for bit;
   ``render_kd_boxes`` on the 81,920-triangle tree (ms, peak memory,
   finite and non-black);
6c. ``[cli]``: the port's ``cli.main`` in this process on
   ``scenes/cornell.txt`` and the icosphere(6) OBJ in a temporary
   directory, at 800x800, depth 8, AA on: ``--benchmark --hdr`` (its JSON
   line, its PNG read back), ``--save-every 2`` then ``--resume`` to 4
   spp (the film equal to an uninterrupted 4-spp film bit for bit),
   ``--compaction --material-sort``, ``--ray-cache``, the KD route's
   ``--short-stack`` walk at depth 2, ``--viz-kd`` and ``--print-kd-stats
   --live 1 --profile DIR``; each run exits 0, with its wall seconds;
6d. ``[interactive]``: ``cli --interactive`` as a child at 800x800, depth
   8, AA on, its stdin a pipe holding the keys LEFT, A, S, q: exit 0, the
   PNGs of iterations 2 and 3, the last byte-equal to an in-process render
   of the orbited camera (iteration 1 with AA on, 2-3 with it off); its
   wall seconds;
6e. ``[parallel]`` (``parallel/``): on a NCCL group of world 1,
   ``render_distributed`` at 2 spp bit-equal to ``render``, and two
   sharded training steps bit-equal to ``make_train_step``'s (loss, every
   gradient, the materials after Adam; one ``all_reduce`` a step); a
   forward step issues no collective; the four slabs of a notional world
   of 4, each rendered by ``make_render_fn(pixels=)`` on this card, with
   ms a slab, concatenate to the full film bit for bit; ``binned_shards``
   = 4 on the recorded bounce-1 calls of the pair, walk and binned paths
   against S = 1 (pairs and walk bit for bit; binned ids >= 99.99%, t
   within 1e-5 relative), with ms, and the binned path's depth-8
   iteration at S = 4 against S = 1 (max |d| printed);
6f. ``[tools]``: ``tools/benchmarks`` over its seven modes at 800x800,
   depth 8, subdivisions 2 and 4 (2 iterations, 1 repeat) into JSON, every
   mode timed, ``tools/charts``' SVG of it (a line a mode), and
   ``tools/scaling`` at 800x800, depth 8, on the 81,920-triangle mesh:
   its one-card row (ms an iteration, rays/s, collectives of a forward
   and a training step) and its measured-work rows at S = 1, 2, 4, 8;
7. ``[train]``: 12 steps of ``make_train_step`` on the pair path at depth
   8 from halved material colours towards the port's render of the true
   ones, with every loss, ms/step, the forward/backward split and peak
   memory; the losses must be finite and fall;
8. ``[geomgrad]``: one reverse pass of that render MSE with respect to the
   materials and the cluster table's vertex and normal tables, with the
   icosphere subsurface (the radiance of the other materials does not
   depend on the geometry); the scatter-add kernel (kernel 4, the
   gather's backward) against its plain version on one bounce's captured
   cotangents and on a full-width depth AOV's, per entry within 1e-5 of
   the sum of |contributions| (float atomics add in any order); the
   vertex and normal gradients finite and not all zero;
9. ``[gradcheck]``: the JAX package's two finite-difference checks of the
   pair path (tests/test_grad.py:244-264 and 275-310) on the card, at the
   ``mesh_pairs_48`` scene;
10. ``[edgegrad]``: one forward and one backward of ``make_render_geo``
   (``ops/edgegrad.py``) on the KD walk's 320-triangle scene at 800x800,
   depth 8, with the icosphere subsurface, 4 samples an edge and 256
   secondary viewpoints, under a column-ramp-weighted mean: forward,
   interior-backward and boundary ms, peak memory, silhouette edges and
   alive samples of both boundary terms and the launches (kernels 3 and 4
   must launch; the gradients finite, the boundary part non-zero); then
   tests/test_edgegrad.py's occluder check (vertex, 32x32, finite
   differences at 8 x 8 supersampling, within 0.25);
11. ``[fault]``: ``utils/fault.run_isolated`` on three children, one that
   asks the card for 1 TiB (classified ``oom``), one that sleeps past a
   10 s timeout (``hang``) and a clean one (``ok``).

The second-to-last line is the kernels' JSON record, the last
``{"ok": true, "device": {...}}``. Any failed check exits non-zero before
those lines; so does a machine without CUDA, or a directory without the
port.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import hashlib
import io
import json
import os
import re
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from kdtreepathtraceroptimization_tpu_torch import make_train_step, render_loss
from kdtreepathtraceroptimization_tpu_torch.accel import kdtree as tkd
from kdtreepathtraceroptimization_tpu_torch.accel.kdtools import tree_stats
from kdtreepathtraceroptimization_tpu_torch.accel.native import GXX_FLAGS, load_native
from kdtreepathtraceroptimization_tpu_torch.config import RenderConfig
from kdtreepathtraceroptimization_tpu_torch.convert import materials_to_torch, with_tris
from kdtreepathtraceroptimization_tpu_torch.ops import binned as tbinned
from kdtreepathtraceroptimization_tpu_torch.ops import cluster as tcl
from kdtreepathtraceroptimization_tpu_torch.ops import edgegrad as tedge
from kdtreepathtraceroptimization_tpu_torch.ops import intersect as tisect
from kdtreepathtraceroptimization_tpu_torch.ops import mesh as tmesh
from kdtreepathtraceroptimization_tpu_torch.ops import mxu_bf as tmxu
from kdtreepathtraceroptimization_tpu_torch.ops import pairs as tpairs
from kdtreepathtraceroptimization_tpu_torch.ops import traverse as ttrav
from kdtreepathtraceroptimization_tpu_torch.ops import walk as twalk
from kdtreepathtraceroptimization_tpu_torch.ops.camera import generate_rays
from kdtreepathtraceroptimization_tpu_torch.ops.intersect import BIG
from kdtreepathtraceroptimization_tpu_torch.ops.kdviz import render_kd_boxes
from kdtreepathtraceroptimization_tpu_torch.ops.rng import bounce_key, prng_key
from kdtreepathtraceroptimization_tpu_torch.ops.vecmath import v3_to_rows
from kdtreepathtraceroptimization_tpu_torch.parallel import multihost as tmultihost
from kdtreepathtraceroptimization_tpu_torch.parallel import sharding as tsh
from kdtreepathtraceroptimization_tpu_torch.render import integrator as tint
from kdtreepathtraceroptimization_tpu_torch.render.film import tonemap_srgb_u8
from kdtreepathtraceroptimization_tpu_torch.render.interactive import apply_key
from kdtreepathtraceroptimization_tpu_torch.render.integrator import (
    make_render_block_fn,
    render,
)
from kdtreepathtraceroptimization_tpu_torch.utils.device import use_full_f32
from kdtreepathtraceroptimization_tpu_torch.scene.parser import (
    load_scene,
    replace_camera,
    with_resolution,
)
from kdtreepathtraceroptimization_tpu_torch.tools import benchmarks as tbench
from kdtreepathtraceroptimization_tpu_torch.tools import charts as tcharts
from kdtreepathtraceroptimization_tpu_torch.tools import goldens as tgoldens
from kdtreepathtraceroptimization_tpu_torch.tools import scaling as tscaling
from kdtreepathtraceroptimization_tpu_torch.utils import cuda_build
from kdtreepathtraceroptimization_tpu_torch.utils.fault import run_isolated
from kdtreepathtraceroptimization_tpu_torch.utils.image import read_png
from kdtreepathtraceroptimization_tpu_torch.utils.procmesh import icosphere, write_obj

REPO = os.path.dirname(os.path.abspath(__file__))
CORNELL = os.path.join(REPO, "scenes", "cornell.txt")
GOLDENS = os.path.join(REPO, "tests", "goldens")
WORK = os.path.join(REPO, "build", "chip_smoke")
WALK = dict(cluster=True, cluster_walk=True, cluster_pairs=False)
PAIRS = dict(cluster=True, cluster_pairs=True)  # the default config
CLUSTER = dict(cluster=True, cluster_pairs=False)  # cluster rounds
BINNED = dict(cluster=True, cluster_pairs=False, cluster_binned=True)
BDIAG = dict(cluster=True, cluster_pairs=True, pair_bdiag=True)  # kernel 7's pair path
KD = dict(cluster_auto=False)  # no cluster intersector: the KD walk on any mesh

# Published H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM
# bandwidth and float32 outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# Float32 operations per (ray, block) pair of the slab cull: per axis 2
# multiplies, 2 subtracts, 4 min/max; then abs, multiply, 3 add/subtract
# for the slack, one max and 4 compares, one min into the tile bound.
SLAB_OPS_PER_PAIR = 3 * 8 + 10
# Float32 operations per (ray, triangle) test of the walk, the pair tests,
# the rounds, the sweep and the brute force: the function needs the 19
# non-zero multiply-adds of the four ten-term dot products (the other 21
# weights of every table are zero and a's three are -(three of t_num's):
# csrc/mt_block.cuh), 19 FMAs = 38, and the epilogue's 5 compares, 1 add,
# 1 divide and 1 compare against the running best (the pair test packs and
# takes a min in its place). Kernels that still multiply all 40 weights do
# more work than this bound counts.
MT_OPS_PER_TEST = 2 * 19 + 8
# Bytes the Moller-Trumbore kernels' bounds count: a triangle's 16
# distinct weights, a ray's 10 features [o, d, o x d, 1] (the tables and
# feature rows the kernels read are wider: zero weights, padding slots and
# columns, which the function does not need).
TRI_BYTES = 16 * 4
RAY_FEATURE_BYTES = 10 * 4
# Float32 operations per (live ray, real block) pair of the extraction:
# the slab entry of the slab cull without its tile min (per axis 2
# multiplies, 2 subtracts, 4 min/max; abs, multiply, add for the slack;
# subtract, add, max; 3 compares), and per feasible pair 2 more to build
# its key and compare it with the kept ones.
EXTRACT_OPS_PER_PAIR = 3 * 8 + 9
EXTRACT_OPS_PER_FEASIBLE = 2
# Float32 operations of one (live ray, non-empty group) test of kernel 5's
# two-level cull: the slab parameters (per axis 2 multiplies, 2 subtracts,
# 4 min/max), the bound on its members' slack (2 abs, 2 multiplies, 2
# adds, max), its entry and exit (subtract, max, add) and 3 compares.
EXTRACT_OPS_PER_GROUP = 3 * 8 + 7 + 3 + 3
# Group sizes whose premise chip_smoke.py checks on kernel 5's calls (the
# blocks a group [shapes] times).
EXTRACT_GROUPS = (4, 8, 16)
# Float32 operations of one (live ray, non-empty group) test of kernel 1's
# two-level cull: kernel 5's group test (csrc/slab_group.cuh meets_group).
SLAB_OPS_PER_GROUP = EXTRACT_OPS_PER_GROUP
# Float32 operations per (live ray, real block) pair of the sphere cull
# and the argmin bins: two three-term dot products (3 multiplies, 2 adds
# each), t_ca (1), dline2 (2 multiplies, 3 add/subtract), the entry
# (subtract, max), 4 compares and 1 add of the feasibility test, and one
# min (or compare) into the tile bound or the ray's bin.
CULL_OPS_PER_PAIR = 5 + 5 + 1 + 5 + 2 + 5 + 1
# Float32 operations of one (live ray, non-empty group) test of kernel 9's
# two-level cull (csrc/cluster_entry.cuh group_bound): the two dot products
# (10), t_ca (1) and dline2 (5) on the group's sphere, the scale and the
# widened radius and margin (add; multiply, add; multiply; multiply), the
# widened entry (2 subtracts, max) and the tests (compare; 2 adds and a
# compare; compare; the group's flag). Each ray's margin factors (about 12
# operations, once a ray) are left out.
CULL_OPS_PER_GROUP = 10 + 1 + 5 + 1 + 2 + 1 + 1 + 3 + 1 + 3 + 1 + 1
# Float32 operations of one geom's test on one lane (csrc/geoms_hit.cu):
# the origin's inverse transform (9 multiplies, 9 adds), the direction's
# (9, 6) and its normalising (a dot product 5, max, square root, 3
# divides); the cube's slabs (per axis abs, divide, 2 subtracts, 2
# multiplies, min, max) and its 4 min/max (the sphere's quadratic takes
# fewer); the object-space point (3 multiplies, 3 adds), its forward
# transform (18), the normal's (15) and its normalising (10); the world
# distance (3 subtracts, a dot product 5, add, square root). Compares and
# selects are left out.
GEOM_OPS = 18 + 15 + 10 + 3 * 8 + 4 + 6 + 18 + 15 + 10 + 10
# Bytes a lane of kernel 13 moves: it reads its ray's six float32
# channels and writes t, point, normal, material id (4 B a value) and
# outside (1 B).
GEOM_LANE_BYTES = 6 * 4 + (1 + 3 + 3 + 1) * 4 + 1
# The SASS digests (sass_digest) of kernels this tree must build as commit
# 2e5ed33 (before kernel 1 took kernel 5's group math) did, taken from that
# commit's sources built with cuda_build.NVCC_FLAGS by the nvcc of
# SASS_NVCC on the H100 machine: kernel 5, whose group math moved into
# csrc/slab_group.cuh. A change that alters it on purpose records its new
# digest here. (Kernel 12's digest went when kernel 12 took the group
# spheres of csrc/cluster_entry.cuh itself: its check against its plain
# version, bit for bit, with the group premise, holds it.)
SASS_DIGESTS = {"pair_extract": "0deace8772a58502"}
SASS_NVCC = "release 12.9, V12.9.86"
# A main path whose first iteration takes longer than this (ms) is timed
# as one call of one iteration.
SLOW_ITERATION_MS = 2000.0
# Rays of the bounce the brute force's kernel is held against its plain
# version on (the plain version makes a [rays, 4B] product per block).
BRUTE_SLICE = 16384
# The mesh_pairs_48 pixels whose paths branch in the golden itself: it was
# rendered under jit, whose fused multiply-adds move their first hit by an
# ulp (tests/test_torch_pairs.py shows it).
JIT_BRANCHED_PIXELS = (490, 518)
# The same for cornell_spec_64 (SSS, no AA): its paths branch at these
# pixels, in mirror pairs; the port equals eager JAX there on the CPU
# (tests/test_torch_render.py).
SPEC_JIT_BRANCHED_PIXELS = (845, 883, 1105, 1135, 3025, 3055, 3277, 3315, 3907, 3965)

KERNELS = (
    ("slab_cull", twalk.SLAB_CULL, "kdtreepathtraceroptimization_tpu_torch/csrc/slab_cull.cu",
     "kdtreepathtraceroptimization_tpu/ops/walk.py:109"),
    ("walk", twalk.WALK, "kdtreepathtraceroptimization_tpu_torch/csrc/walk.cu",
     "kdtreepathtraceroptimization_tpu/ops/walk.py:186"),
    ("gather_cols", tmesh.GATHER_COLS, "kdtreepathtraceroptimization_tpu_torch/csrc/gather_cols.cu",
     "kdtreepathtraceroptimization_tpu/ops/mesh.py:170"),
    ("scatter_cols", tmesh.SCATTER_COLS, "kdtreepathtraceroptimization_tpu_torch/csrc/scatter_cols.cu",
     "kdtreepathtraceroptimization_tpu/ops/mesh.py:200"),
    ("pair_extract", tpairs.EXTRACT, "kdtreepathtraceroptimization_tpu_torch/csrc/pair_extract.cu",
     "kdtreepathtraceroptimization_tpu/ops/pairs.py:149"),
    ("pair_runs", tpairs.PAIR_RUNS, "kdtreepathtraceroptimization_tpu_torch/csrc/pair_runs.cu",
     "kdtreepathtraceroptimization_tpu/ops/pairs.py:351"),
    ("pair_bdiag", tpairs.PAIR_BDIAG, "kdtreepathtraceroptimization_tpu_torch/csrc/pair_bdiag.cu",
     "kdtreepathtraceroptimization_tpu/ops/pairs.py:447"),
    ("mxu_bf", tmxu.BF, "kdtreepathtraceroptimization_tpu_torch/csrc/mxu_bf.cu",
     "kdtreepathtraceroptimization_tpu/ops/mxu_bf.py:187"),
    ("cluster_cull", tcl.CULL, "kdtreepathtraceroptimization_tpu_torch/csrc/cluster_cull.cu",
     "kdtreepathtraceroptimization_tpu/ops/cluster.py:305"),
    ("cluster_rounds", tcl.ROUNDS, "kdtreepathtraceroptimization_tpu_torch/csrc/cluster_rounds.cu",
     "kdtreepathtraceroptimization_tpu/ops/cluster.py:396"),
    ("cluster_sweep", tcl.SWEEP, "kdtreepathtraceroptimization_tpu_torch/csrc/cluster_sweep.cu",
     "kdtreepathtraceroptimization_tpu/ops/cluster.py:432"),
    ("binned_argmin", tbinned.ARGMIN, "kdtreepathtraceroptimization_tpu_torch/csrc/binned_argmin.cu",
     "kdtreepathtraceroptimization_tpu/ops/binned.py:73"),
    ("geoms_hit", tisect.GEOMS_HIT, "kdtreepathtraceroptimization_tpu_torch/csrc/geoms_hit.cu",
     "none (jnp only)"),
)
# The path whose launch count each kernel's record reports (the sweep's:
# the cluster path's if it launched there, else the 4-round render's).
RECORD_PATH = {"slab_cull": "walk", "walk": "walk", "gather_cols": "pairs",
               "scatter_cols": "geomgrad", "pair_extract": "pairs", "pair_runs": "pairs",
               "pair_bdiag": "pairs_bdiag",
               "mxu_bf": "brute", "cluster_cull": "cluster", "cluster_rounds": "cluster",
               "cluster_sweep": "cluster", "binned_argmin": "binned", "geoms_hit": "pairs"}
# The sweep's record also gives the recorded call's listed rows and
# slices, its one-pass time, and the full-width form's time and bound.
SWEEP_EXTRA = ("rows", "slices", "one_pass_ms", "full_width_ms", "full_width_bound_ms")
# The brute force's record also gives its time on the brute route's own
# inputs (dead lanes keep their directions).
BRUTE_EXTRA = ("path_inputs_ms",)
# The pair kernels' records also give the pair path's pass-2 call (kernel 5:
# also its other form on each call).
PAIR_EXTRA = ("pass2_ms", "pass2_plain_ms", "pass2_bound_ms", "pass2_bound_by",
              "pass2_flat_bound_ms", "pass2_one_lane_ms", "split_ms")
# The records of kernels 5, 1, 9 and 12, whose bound (group_bound) counts the
# (ray, block or group) tests their groups need, also give those tests (on
# kernel 5's pass-1 call) and the flat bound, every live ray x every real
# block.
GROUP_EXTRA = ("tests_run", "flat_bound_ms")
# The culls' records also give their time and bound on the other recorded
# calls: kernel 1 on a pass-3 call of the pair path (where one fires),
# kernel 9 on the binned path's call and on the cluster paths' bounce 0
# (the cluster_r4 path's bounce-0 call).
CULL_EXTRA = ("pass3_ms", "pass3_bound_ms", "binned_ms", "binned_bound_ms", "cluster_r4_ms",
              "cluster_r4_bound_ms")
# The analytic geoms' record (kernel 13, on the pair path's bounce-1 call)
# also gives the bounce-0 call, and both calls of the pair path at
# 2048x2048 (the benchmark's frame).
GEOMS_EXTRA = ("bounce0_ms", "bounce0_plain_ms", "w2048_ms", "w2048_plain_ms",
               "w2048_bound_ms", "w2048_bounce0_ms")
# phase_big's mesh and film: icosphere(8), 1,310,720 triangles, which the
# cluster build puts in blocks of 512 (past 1,048,576 triangles), at the
# benchmark's 2048x2048.
BIG_SUBDIV = 8
BIG_RES = 2048
BIG_BLOCK = 512
# Each main path's image and its iteration count (phase_main_path).
IMAGES = {}
# Launch shapes [shapes] times for kernels 2, 8, 10, 7, 6, 5, 1, 9 and 12: the values
# of each source's SHAPE_CONSTANTS (rays a thread, threads a thread block,
# thread blocks an SM must hold under __launch_bounds__; kernels 7 and 6
# take one pair a thread, and size their weight slots for their blocks an
# SM; kernel 6's rounds above which a part reads its weights directly, 0
# for never; kernel 5's blocks a group and lanes a ray in its split form;
# the culls' and the argmin bins' threads a thread block and blocks a
# group); the first is the
# source's own. The brute force's ray tile is rays a thread x threads.
SHAPES = {"walk": ((1, 128, 6, 0), (1, 128, 6, 4), (1, 128, 6, 8), (1, 256, 4, 4),
                   (4, 256, 2, 0), (2, 256, 2, 0), (2, 256, 3, 0), (4, 128, 4, 0), (8, 128, 2, 0),
                   (2, 512, 1, 0), (1, 1024, 1, 0), (2, 128, 4, 0), (1, 256, 4, 0), (1, 64, 6, 0)),
          "mxu_bf": ((2, 512, 1), (4, 256, 2), (2, 256, 2), (2, 256, 3), (8, 128, 2),
                     (4, 128, 4), (1, 1024, 1), (2, 128, 4), (1, 512, 2)),
          "cluster_rounds": ((1, 256, 4, 8), (1, 256, 4, 0), (1, 256, 4, 4), (1, 256, 3, 8),
                             (1, 128, 6, 0), (1, 128, 6, 8), (2, 128, 4, 4), (1, 512, 2, 4),
                             (1, 1024, 1, 0)),
          "pair_bdiag": ((256, 3), (256, 2), (256, 4), (128, 4), (128, 2), (512, 1), (1024, 1)),
          "pair_runs": ((256, 3, 2), (256, 3, 0), (256, 3, 1), (256, 3, 4), (256, 2, 2),
                        (256, 4, 2), (128, 4, 2), (128, 6, 2)),
          "pair_extract": ((128, 1, 8, 4), (128, 1, 8, 2), (128, 1, 8, 8), (128, 1, 4, 4),
                           (128, 1, 16, 4), (128, 2, 8, 4), (256, 1, 8, 4)),
          "slab_cull": ((1024, 16), (1024, 8), (1024, 32), (512, 16), (256, 8)),
          "cluster_cull": ((1024, 8), (1024, 16), (1024, 4), (512, 8), (256, 8)),
          "binned_argmin": ((128, 8), (64, 8), (256, 8), (512, 8), (1024, 8), (128, 4),
                            (128, 16))}
# The constants SHAPES sets in each source, in order (kUnroll: the triangle
# loop's unroll, 0 leaving it to the compiler).
SHAPE_CONSTANTS = {"walk": ("kRpt", "kThreads", "kMinBlocks", "kUnroll"),
                   "mxu_bf": ("kRpt", "kThreads", "kMinBlocks"),
                   "cluster_rounds": ("kRpt", "kThreads", "kMinBlocks", "kUnroll"),
                   "pair_bdiag": ("kThreads", "kMinBlocks"),
                   "pair_runs": ("kThreads", "kMinBlocks", "kDirectRounds"),
                   "pair_extract": ("kThreads", "kRpt", "kGroup", "kSplitLanes"),
                   "slab_cull": ("kThreads", "kGroup"),
                   "cluster_cull": ("kThreads", "kGroup"),
                   "binned_argmin": ("kThreads", "kGroup")}
# The brute force's triangle blocks [shapes] also times (the wrapper's
# default is 512).
BRUTE_TRI_BLOCKS = (256, 1024)
# The recorded calls [shapes] times again (phase_kernels, phase_pairs,
# phase_cluster).
SHAPE_INPUTS = {}
# Pairs one thread block of kernel 7 takes (csrc/pair_bdiag.cu kThreads).
BDIAG_PART = 256
# Kernel 2 on the walk path's recorded call while csrc/walk.cu held its own
# round loop, before csrc/round_walk.cuh (two runs of one call; H100 80GB
# HBM3, 700.00 W; PERF.md section 6), ms.
WALK_OWN_LOOP_MS = (3.767, 3.761)
# The cluster table's triangle tables that the gradient phases differentiate.
TRI_FIELDS = ("v0", "v1", "v2", "n0", "n1", "n2")
# The subsurface transmittance [geomgrad] and [edgegrad] give the
# icosphere's material (tests/test_grad.py's CAMERA_SSS_SCENE material 1).
SSS_TRANSMITTANCE = (0.9, 0.7, 0.5)
# [edgegrad]: samples an edge, and the secondary term's viewpoints.
EDGE_SAMPLES = 4
EDGE_VIEWPOINTS = 256
# [edgegrad]'s occluder check (tests/test_edgegrad.py:192, vertex): the
# dark triangle in front of the back wall, its resolution, the finite
# differences' supersampling and step, the estimator's samples an edge.
OCCLUDER = ((-1.5, 3.8, 2.0), (1.5, 4.2, 2.0), (0.0, 6.2, 2.0))
OCCLUDER_RES, OCCLUDER_SS, OCCLUDER_EPS, OCCLUDER_SAMPLES = 32, 8, 0.08, 64


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


# Cycles of the sleep kernel queued ahead of each timed run (about 1 ms):
# the host enqueues the run while the card sleeps, so the events time the
# run's device work and not the host's launch latency (tens of us, which
# an idle card would wait for and which would dominate a short kernel).
SLEEP_CYCLES = 2_000_000


def time_ms(fn, reps: int) -> float:
    """Median device time of ``fn()`` in ms over ``reps`` runs (CUDA events
    around the run, a sleep kernel queued ahead of it), after one warm-up
    run."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def zero_counts() -> None:
    for _, kernel, _, _ in KERNELS:
        kernel.launches = 0


def read_counts() -> dict:
    return {name: kernel.launches for name, kernel, _, _ in KERNELS}


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


class RepairStats:
    """Keeps the ``collect_stats`` record of every call the integrator makes
    to one intersector (``intersect_mesh_cluster``, ``intersect_mesh_binned``
    or ``intersect_mesh_kd``) while the block runs; restores it on exit."""

    def __init__(self, name: str):
        self.name = name
        self.calls = []

    def __enter__(self):
        self.real = getattr(tint, self.name)

        def wrapped(*args, **kwargs):
            hit, stats = self.real(*args, **kwargs, collect_stats=True)
            # numbers only: a kept tensor (the KD walks' cut_rays) would
            # count in the path's peak memory
            self.calls.append({k: v for k, v in stats.items()
                               if not isinstance(v, torch.Tensor)})
            return hit

        setattr(tint, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(tint, self.name, self.real)

    def per_bounce(self, depth: int) -> str:
        """Flagged rays and the repair of each bounce, over the iterations."""
        out = []
        for b in range(depth):
            calls = self.calls[b::depth]
            out.append(f"bounce {b}: flagged {[c['flagged'] for c in calls]}, repair "
                       f"{sorted(set(c['repair'] for c in calls))}")
        return "; ".join(out)

    def walk_per_bounce(self, depth: int) -> str:
        """The KD walk's steps and host reads of each bounce, over the
        iterations."""
        return "; ".join(
            f"bounce {b}: steps {[c['steps'] for c in self.calls[b::depth]]}, host reads "
            f"{[c['host_reads'] for c in self.calls[b::depth]]}" for b in range(depth))


def check_hits(label, got, want):
    """A kernel's (bt, btri) against its plain version's: ids on >= 99.99%
    of rays, t within 1e-5 relative on every ray (where ids differ too: a
    near-tie). Returns (fraction of equal ids, max |dt| where equal)."""
    (bt_k, btri_k), (bt_p, btri_p) = got, want
    same = btri_k == btri_p
    frac = same.float().mean().item()
    rel = (bt_k - bt_p).abs() / bt_p.abs().clamp_min(1e-30)
    log(f"[kernels] {label}: {int((btri_p >= 0).sum())} of {btri_p.shape[0]} rays hit; ids "
        f"equal on {frac:.6%}; max |dt|/t {rel.max().item():.3g} (where ids differ: "
        f"{rel[~same].max().item() if (~same).any() else 0.0:.3g})")
    if frac < 0.9999:
        raise AssertionError(f"{label} ids equal on only {frac:.6%} of rays")
    if rel.max().item() > 1e-5:
        raise AssertionError(f"{label}: t differs by more than 1e-5 relative")
    return frac, (bt_k - bt_p)[same].abs().max().item()


def needed_rounds(cm, sel, lb, bt, act, r, tile: int):
    """The least work of a round loop (walk, rounds) on this data. A tile
    must run every listed block whose entry bound lies below some live
    ray's final t; within it, a live ray needs the block's real triangles
    only if it meets the block's box before its final t (``_box_entry``:
    the walk kernel's own test; a hit lies in its block's box). -> (needed
    (tile, block) rounds, needed (live ray, real triangle) tests counting
    every live ray of a needed round, the same at ray granularity: the
    bound's count, the real triangles of the blocks some needed test at ray
    granularity reads, each once)."""
    g = bt.shape[0] // tile
    live = act.reshape(g, tile) > 0
    worst = torch.where(live, bt.reshape(g, tile), 0.0).amax(dim=1)
    need = lb < worst[:, None]
    tris_of = cm.real[sel.long()]
    tile_tests = int((need * live.sum(dim=1, keepdim=True) * tris_of).sum())
    listed = torch.zeros((g, cm.n_blocks), dtype=torch.bool, device=bt.device)
    listed.scatter_(1, sel.long(), lb < BIG)
    real = cm.real.to(torch.float32)
    ray_tests = 0
    used = torch.zeros((cm.n_blocks,), dtype=torch.bool, device=bt.device)
    tiles = max(1, (1 << 26) // (tile * cm.n_blocks))
    for g0 in range(0, g, tiles):
        rows = slice(g0 * tile, min(g, g0 + tiles) * tile)
        entry = twalk._box_entry(r[rows, 0:3], r[rows, 3:6], cm.slab)
        hit = ((entry < bt[rows, None]) & (act[rows, None] > 0)
               & listed[g0:g0 + tiles].repeat_interleave(tile, dim=0))
        ray_tests += int((hit.to(torch.float32) @ real).sum().item())
        used |= hit.any(dim=0)
    return int(need.sum()), tile_tests, ray_tests, int(cm.real[used].sum())


def bound(nbytes: float, ops: float) -> dict:
    """The least time for ``nbytes`` of traffic and ``ops`` f32 operations."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOP_PER_S
    return dict(bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="operations" if t_ops > t_bytes else "bytes")


def group_bound(nbytes: float, grouped_ops: float, flat_ops: float) -> tuple:
    """The bound of kernels 5, 1, 9 and 12, whose skip by groups of blocks is
    exact: the lesser of the bounds of the tests their groups need
    (``grouped_ops``) and of every live ray x every real block
    (``flat_ops``), since the function may be computed either way. ->
    (bound dict, flat bound dict)."""
    grouped, flat = bound(nbytes, grouped_ops), bound(nbytes, flat_ops)
    return (grouped if grouped["bound_ms"] <= flat["bound_ms"] else flat), flat


def pair_bound(blk_s, cm, kreal) -> tuple:
    """The least time of the pair test on one call (kernels 6 and 7): each
    pair's block id read and its packed result written, the RAY_FEATURE_BYTES
    of each real pair (a sentinel pair's features are not needed), the
    TRI_BYTES of each real triangle of a block a real pair names; 46
    operations a (real pair, real triangle) test. -> (bound dict, pair
    tests, blocks named)."""
    real = blk_s < kreal
    named = blk_s[real].long()
    used = torch.unique(named)
    nbytes = (blk_s.numel() * (4 + 4) + int(real.sum()) * RAY_FEATURE_BYTES
              + int(cm.real[used].sum()) * TRI_BYTES)
    pair_tests = int(cm.real[named].sum())
    return bound(nbytes, pair_tests * MT_OPS_PER_TEST), pair_tests, int(used.numel())


def cull_groups(label, x, tile, kp, real, member, group, G: int) -> dict:
    """The two-level cull of kernel 1 or 9 on one call, in groups of
    G blocks: the premise, that every (ray, block) whose entry
    ``member(x)`` is below BIG lies in a group whose ``group(x)`` is below
    BIG (a pair outside fails the run), and the tests the kernel runs. Per
    tile the kernel takes the live rays in order, 32 to a warp; a warp runs
    a group's member tests when the group test passes for one of its rays.
    -> dict(group_tests: live rays x non-empty groups, member_tests: live
    rays x real members of the groups their warp meets, lane_tests: the
    same for all 32 lanes of such a warp, met_mean and met_max: groups met
    per warp, groups: non-empty groups)."""
    ng = -(-kp // G)
    members = torch.zeros((ng * G,), dtype=torch.float32, device=x.device)
    members[:kp] = real.float()
    members = members.reshape(ng, G).sum(dim=1)  # real members a group
    group_of = torch.arange(kp, device=x.device) // G
    live = x[:, 7] > 0
    rows = max(tile, 32768 // tile * tile)
    bad = member_tests = lane_tests = 0
    met = []
    for r0 in range(0, x.shape[0], rows):
        xs, ls = x[r0:r0 + rows], live[r0:r0 + rows]
        feasible = member(xs) < BIG
        gmeet = group(xs) < BIG
        bad += int((feasible & ~gmeet[:, group_of]).sum())
        slot, wmet = tcl._warp_meets(ls, gmeet, tile)
        wmet = (wmet > 0).float()
        wlive = torch.bincount(slot[ls], minlength=wmet.shape[0]).float()
        wtests = wmet @ members
        member_tests += int((wtests * wlive).sum())
        lane_tests += int((wtests * 32 * (wlive > 0)).sum())
        met.append(wmet.sum(dim=1)[wlive > 0])
    if bad:
        raise AssertionError(f"{label}: {bad} feasible (ray, block) pairs lie in a group of {G} "
                             f"whose group test fails")
    met = torch.cat(met)
    groups = int((members > 0).sum())
    return dict(group_tests=int(live.sum()) * groups, member_tests=member_tests,
                lane_tests=lane_tests, met_mean=met.mean().item() if met.numel() else 0.0,
                met_max=int(met.max()) if met.numel() else 0, groups=groups)


def check_tile_cull(name: str, label: str, args) -> dict:
    """Kernel 1 (``name`` "slab_cull") or 9 ("cluster_cull") on one recorded
    call: bit for bit against its plain version (an entry the kernel lost to
    BIG fails; a -0.0 of the plain version compares equal to the kernel's
    +0.0, and their count is printed); the group premise and the tests its
    two-level cull runs (cull_groups); its time, its plain version's, and
    its bound (group_bound: the tests the groups need, or the flat count
    where that is less), with the flat bound, every live ray x every real
    block, beside it as ``flat_bound_ms``."""
    x, table, blk, tile = args
    kp = blk.shape[1]
    real = blk[5] >= 0
    G = source_shape(name)[SHAPE_CONSTANTS[name].index("kGroup")]
    if name == "slab_cull":
        fn, plain = twalk.slab_cull, twalk._slab_cull_ref
        gslab = twalk._group_slab(table, blk, G)
        member = lambda xs: twalk._slab_entry_math(xs, table, blk, kp)  # noqa: E731
        group = lambda xs: twalk._group_entry(xs, gslab)  # noqa: E731
        per_pair, per_group = SLAB_OPS_PER_PAIR, SLAB_OPS_PER_GROUP
    else:
        fn, plain = tcl.cull, tcl._cull_ref
        gsph = tcl._group_sphere(table, blk, G)
        member = lambda xs: tcl._entries(xs, table, blk)  # noqa: E731
        group = lambda xs: tcl._group_sphere_entry(xs, gsph)  # noqa: E731
        per_pair, per_group = CULL_OPS_PER_PAIR, CULL_OPS_PER_GROUP
    got = fn(*args)
    want = plain(*args)
    sync(x.device)
    if not torch.equal(got, want):
        raise AssertionError(f"{name} {label} differs from its plain version in "
                             f"{int((got != want).sum())} entries")
    negzero = int(((want == 0) & torch.signbit(want)).sum())
    g = cull_groups(f"{name} {label}", x, tile, kp, real, member, group, G)
    live, k_real = int((x[:, 7] > 0).sum()), int(real.sum())
    nbytes = (x.numel() + table.numel() + blk.numel() + got.numel()) * 4
    flat_tests = live * k_real
    least, flat = group_bound(nbytes, g["group_tests"] * per_group
                              + g["member_tests"] * per_pair, flat_tests * per_pair)
    res = dict(max_abs_err=0.0, ms=time_ms(lambda: fn(*args), 20),
               plain_ms=time_ms(lambda: plain(*args), 3), library_ms=None, **least,
               flat_bound_ms=flat["bound_ms"], tests_run=g["group_tests"] + g["member_tests"],
               shape=f"x [{x.shape[0]},{x.shape[1]}] ({live} live), kp {kp} ({k_real} real, "
                     f"{g['groups']} non-empty groups of {G}), tile {tile}, "
                     f"{int((want < BIG).sum())} feasible entries")
    log(f"[kernels] {name} {label} == plain bit for bit ({negzero} -0.0 entries in the plain "
        f"version); {res['shape']}; the group premise holds on all {x.shape[0]} rays")
    log(f"[kernels] {name} {label}: kernel {res['ms']:.4f} ms, plain {res['plain_ms']:.4f} ms, "
        f"bound {res['bound_ms']:.4f} ms ({res['bound_by']}), flat "
        f"bound {flat['bound_ms']:.4f} ms ({flat['bound_by']}, every live ray x every real "
        f"block: {flat_tests} tests)")
    log(f"[kernels] {name} {label}, groups of {G}: {g['group_tests']} group tests + "
        f"{g['member_tests']} member tests = {res['tests_run']} ray tests ({g['lane_tests']} "
        f"member tests counting every lane of a warp that runs them) against {flat_tests} flat; "
        f"groups met per warp: mean {g['met_mean']:.2f}, max {g['met_max']} of {g['groups']}")
    return res


def sass_digest(lib) -> str:
    """The first 16 hex digits of the sha256 of the SASS instructions of
    every kernel in the shared library ``lib`` (``cuobjdump -sass``), in
    order, without the function names and addresses: two builds of the
    same code give the same digest, whatever the file or the hash of its
    anonymous namespace."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                         timeout=120, check=True).stdout
    instrs = re.findall(r"/\*[0-9a-f]{4,}\*/\s+([^;]*;)", out)
    if not instrs:
        raise AssertionError(f"cuobjdump shows no SASS in {lib}")
    text = "\n".join(re.sub(r"_GLOBAL__N__\w+", "", i) for i in instrs)
    return hashlib.sha256(text.encode()).hexdigest()[:16]


def nvcc_release() -> str:
    """nvcc's "release X.Y, VX.Y.Z" (the compiler the digests depend on)."""
    out = subprocess.run([cuda_build._nvcc(), "--version"], capture_output=True, text=True,
                         timeout=60, check=True).stdout
    return re.search(r"release [^\n]*", out).group(0).strip()


def phase_sass() -> None:
    """Kernel 5 (SASS_DIGESTS) as this tree builds it against its SASS as
    commit 2e5ed33 built it: its group math moved into
    csrc/slab_group.cuh since, and its code may not change. The digest
    holds for the nvcc it was taken with (SASS_NVCC): under another the
    run fails, so that a new toolchain's digest is recorded on purpose."""
    release = nvcc_release()
    if release != SASS_NVCC:
        raise AssertionError(f"[sass] nvcc {release}: SASS_DIGESTS are of nvcc {SASS_NVCC}; "
                             f"record this nvcc's digests of commit 2e5ed33's sources")
    for name, want in SASS_DIGESTS.items():
        got = sass_digest(cuda_build.library_path(name))
        log(f"[sass] {name}: digest {got}, commit 2e5ed33's {want}: "
            f"{'unchanged' if got == want else 'CHANGED'}")
        if got != want:
            raise AssertionError(f"{name}'s SASS differs from commit 2e5ed33's")


def phase_kernels(scene, config, device) -> dict:
    """Kernel vs plain version on the main path's inputs at bounce 1."""
    n = int(scene.camera.resolution[0]) * int(scene.camera.resolution[1])
    step = make_render_block_fn(scene, config, 1, device=device)
    with Recorder(twalk, "slab_cull", 1) as rs, Recorder(twalk, "walk", 1) as rw, \
            Recorder(tmesh, "gather_cols", 1) as rg:
        step(torch.zeros((n, 3), device=device), prng_key(0), 1)
    sync(device)
    results = {}

    # -- slab cull: bit-equal; the group premise ----------------------
    SHAPE_INPUTS["slab_cull"] = rs.args
    results["slab_cull"] = check_tile_cull("slab_cull", "walk path", rs.args)

    # -- walk: ids on >= 99.99% of rays, t within 1e-5 where they differ --
    sel, lb, nsel, r, t0, act, cm, wtile = rw.args
    SHAPE_INPUTS["walk"] = rw.args
    w, real, block, kreal = cm.w, cm.real, cm.block, cm.n_real_blocks
    tmxu.check_sparse_pattern(w)  # the sparse test's precondition
    padded = int((real[:kreal] < block).sum())
    g = r.shape[0] // wtile
    rounds = torch.zeros((g, 2), dtype=torch.int32, device=device)
    bt_k, btri_k = twalk.walk(sel, lb, nsel, r, t0, act, cm, wtile, rounds=rounds)
    bt_p, btri_p = twalk._walk_ref(sel, lb, r, t0, act, w, wtile, block)
    sync(device)
    frac, max_err = check_hits("walk", (bt_k, btri_k), (bt_p, btri_p))
    dead = (act.reshape(g, wtile) <= 0).all(dim=1).repeat_interleave(wtile)
    log(f"[kernels] walk: the table is padded in {padded} of {kreal} real blocks; "
        f"{int(dead.sum()) // wtile} all-dead tiles")
    if not padded or not dead.any():
        raise AssertionError("walk: the recorded call has no padded block or no all-dead tile")
    if not (torch.equal(bt_k[dead], t0[dead]) and (btri_k[dead] == -1).all()):
        raise AssertionError("walk: an all-dead tile's rays did not come back as (t0, -1)")
    differ = int(((bt_k != bt_p) | (btri_k != btri_p)).sum())
    log(f"[kernels] walk: {differ} of {r.shape[0]} rays differ from the plain version in t "
        f"or id (the skips are exact: none may)")
    if differ:
        raise AssertionError(f"walk: {differ} rays differ from the plain version")
    needed, tile_tests, walk_tests, used_tris = needed_rounds(cm, sel, lb, bt_p, act, r, wtile)
    walk_ops = walk_tests * MT_OPS_PER_TEST
    # each ray's features, t0, act and outputs; each tile's list (nsel
    # entries of sel and lb); the real triangles the needed tests read, once
    walk_bytes = (r.shape[0] * (RAY_FEATURE_BYTES + 4 * 4) + int(nsel.sum()) * 2 * 4
                  + nsel.numel() * 4 + used_tris * TRI_BYTES)
    results["walk"] = dict(
        max_abs_err=max_err,
        ms=time_ms(lambda: twalk.walk(sel, lb, nsel, r, t0, act, cm, wtile), 10),
        plain_ms=time_ms(lambda: twalk._walk_ref(sel, lb, r, t0, act, w, wtile, block), 3),
        library_ms=None, **bound(walk_bytes, walk_ops),
        shape=f"{g} tiles of {wtile} rays, {needed} needed (tile, block) rounds "
              f"of {block} slots ({int(nsel.sum())} listed; its thread blocks ran "
              f"{int(rounds[:, 0].sum())} block rounds), {walk_tests} needed (live ray, real "
              f"triangle) tests at ray granularity ({tile_tests} counting every live ray of a "
              f"needed round; the kernel ran "
              f"{32 * int(rounds[:, 1].sum())} in 32-ray groups), feasible lists of mean "
              f"{nsel.float().mean().item():.1f}",
        ids_equal=frac,
    )
    log(f"[kernels] walk: {results['walk']['shape']}")
    log(f"[kernels] walk: kernel {results['walk']['ms']:.4f} ms; with its own round loop on "
        f"this call: {', '.join(f'{v:.3f}' for v in WALK_OWN_LOOP_MS)} ms (H100 80GB HBM3, "
        f"700.00 W)")

    # -- gather-to-columns: bit-equal ------------------------------------
    packed, tri = rg.args
    got = tmesh.gather_cols(packed, tri)
    want = tmesh._gather_cols_ref(packed, tri)
    sync(device)
    if not torch.equal(got, want):
        raise AssertionError("gather_cols differs from packed[tri].T")
    # the rows this call reads (each once), its ids and its columns
    gbytes = (int(torch.unique(tri).numel()) * packed.shape[1] + tri.numel() + got.numel()) * 4
    results["gather_cols"] = dict(
        max_abs_err=0.0,
        ms=time_ms(lambda: tmesh.gather_cols(packed, tri), 20),
        plain_ms=time_ms(lambda: tmesh._gather_cols_ref(packed, tri), 10),
        **bound(gbytes, 0),
        # one PyTorch call for the same [C, n] result: index_select on the
        # table's transposed view
        library_ms=time_ms(lambda: torch.index_select(packed.T, 1, tri.long()), 20),
        shape=f"packed [{packed.shape[0]},{packed.shape[1]}], tri [{tri.shape[0]}] naming "
              f"{int(torch.unique(tri).numel())} distinct rows",
    )
    g = results["gather_cols"]
    log(f"[kernels] gather_cols == packed[tri].T bit for bit; {g['shape']}; kernel "
        f"{g['ms']:.4f} ms against index_select {g['library_ms']:.4f} ms (below: "
        f"{g['ms'] < g['library_ms']}) and twice its bound {2 * g['bound_ms']:.4f} ms (within: "
        f"{g['ms'] <= 2 * g['bound_ms']})")
    for name, res in results.items():
        lib = "n/a" if res["library_ms"] is None else f"{res['library_ms']:.4f}"
        log(f"[kernels] {name}: kernel {res['ms']:.4f} ms, plain {res['plain_ms']:.4f} ms, "
            f"library {lib} ms, bound {res['bound_ms']:.4f} ms ({res['bound_by']})")
    return results


def bounce_args(scene, config, intersector: str, device, bounce: int = 1):
    """The arguments one iteration of ``config``'s render hands the
    integrator's ``intersector`` at its second bounce (or ``bounce``)."""
    n = int(scene.camera.resolution[0]) * int(scene.camera.resolution[1])
    step = make_render_block_fn(scene, config, 1, device=device)
    with Recorder(tint, intersector, bounce) as rec:
        step(torch.zeros((n, 3), device=device), prng_key(0), 1)
    sync(device)
    return rec.args, rec.kwargs


def source_shape(name: str) -> tuple:
    """The SHAPE_CONSTANTS values csrc/<name>.cu is built with."""
    text = (cuda_build.CSRC / f"{name}.cu").read_text()
    return tuple(int(re.search(rf"constexpr int {c} = (\d+);", text).group(1))
                 for c in SHAPE_CONSTANTS[name])


def extract_groups(label, x, slab, blk, rpt: int, lanes: int) -> dict:
    """Kernel 5's two-level cull on one call: the group premise, that every
    block with a finite ``_slab_entry_math`` entry lies in a group whose
    ``_group_entry`` is finite (checked for groups of 4, 8 and 16; a block
    outside fails the run), and for each group size the tests the cull
    runs there. A warp holds 32 threads of ``rpt`` adjacent rays, or (the
    split form) 32 / ``lanes`` rays of ``lanes`` lanes, lane s taking
    groups s, s + lanes, ...; at each step it runs the member tests of its
    lanes' groups when the group test passes for one of its live rays. ->
    {G: dict(group_tests: live rays x non-empty groups, member_tests: live
    rays x real members of the groups whose member tests their warp runs,
    lane_tests: the same for every ray of such a warp, met_mean and
    met_max: the steps with member tests per warp with a live ray,
    steps)}."""
    kp = slab.shape[1]
    n = x.shape[0]
    live = x[:, 7] > 0
    real = blk[5] >= 0
    warp = 32 * rpt // lanes  # rays a warp
    rows = 32768  # rays a chunk: a multiple of every warp's
    out = {}
    for G in EXTRACT_GROUPS:
        gslab = twalk._group_slab(slab, blk, G)
        ng = gslab.shape[1]
        steps = -(-ng // lanes)
        members = torch.zeros((steps * lanes * G,), dtype=torch.float32, device=x.device)
        members[:kp] = real.float()
        members = members.reshape(steps, lanes * G).sum(dim=1)  # real members a step tests
        group_of = torch.arange(kp, device=x.device) // G
        bad = member_tests = lane_tests = 0
        met = []
        for r0 in range(0, n, rows):
            xs, ls = x[r0:r0 + rows], live[r0:r0 + rows]
            feasible = twalk._slab_entry_math(xs, slab, blk, kp) < BIG
            gmeet = twalk._group_entry(xs, gslab) < BIG
            bad += int((feasible & ~gmeet[:, group_of]).sum())
            gmeet = torch.cat([gmeet, gmeet.new_zeros((gmeet.shape[0], steps * lanes - ng))],
                              dim=1).reshape(-1, steps, lanes).any(dim=2)
            pad = -xs.shape[0] % warp
            if pad:
                gmeet = torch.cat([gmeet, gmeet.new_zeros((pad, steps))])
                ls = torch.cat([ls, ls.new_zeros((pad,))])
            wmeet = gmeet.reshape(-1, warp, steps).any(dim=1)
            wlive = ls.reshape(-1, warp).sum(dim=1)
            wtests = wmeet.float() @ members
            member_tests += int((wtests * wlive).sum())
            lane_tests += int((wtests * warp * (wlive > 0)).sum())
            met.append(wmeet.sum(dim=1)[wlive > 0])
        if bad:
            raise AssertionError(f"pair_extract {label}: {bad} feasible (ray, block) pairs lie in "
                                 f"a group of {G} whose group test fails")
        met = torch.cat(met).float()
        out[G] = dict(group_tests=int(live.sum()) * int((gslab[6] > 0).sum()),
                      member_tests=member_tests, lane_tests=lane_tests,
                      met_mean=met.mean().item() if met.numel() else 0.0,
                      met_max=int(met.max()) if met.numel() else 0, steps=steps)
    return out


def check_pair_runs(label, blk_s, featp, cm, ptile, kreal) -> dict:
    """Kernel 6 against its plain version on one recorded call: loc on
    >= 99.99% of real pairs, t within 2^-12 relative, sentinel pairs left
    at _PBIG. The kernel's 10-term FMA chains and the plain version's
    matmul may round a sum differently: a t one ulp apart can move across
    a 2^-13 truncation step or an edge test, so loc may differ on a
    near-tie and t by up to one truncation step."""
    w, block = cm.w, cm.block
    got = tpairs.pair_runs(blk_s, featp, cm, ptile, kreal)
    want = tpairs._pair_runs_ref(blk_s, featp, w, block, kreal)
    sync(blk_s.device)
    real = blk_s < kreal
    tg, lg = tpairs._unpack_tl(got)
    tw, lw = tpairs._unpack_tl(want)
    n_real = int(real.sum())
    loc_eq = (lg == lw)[real].float().mean().item() if n_real else 1.0
    both = real & (tg < 1e30) & (tw < 1e30)
    rel = ((tg - tw).abs() / tw.abs().clamp_min(1e-30))[both]
    rel_max = rel.max().item() if rel.numel() else 0.0
    log(f"[kernels] pair_runs {label}: {n_real} real of {blk_s.shape[0]} pairs, "
        f"{int(both.sum())} hit; loc equal on {loc_eq:.6%}; max |dt|/t {rel_max:.3g}; "
        f"packed equal on {(got == want)[real].float().mean().item() if n_real else 1.0:.6%}")
    if (got[~real] != tpairs._PBIG).any():
        raise AssertionError(f"pair_runs {label}: a sentinel pair was not left at _PBIG")
    if loc_eq < 0.9999 or rel_max > 2.0 ** -12:
        raise AssertionError(f"pair_runs {label} differs from its plain version beyond its "
                             f"tolerance")
    pbound, pair_tests, blocks_used = pair_bound(blk_s, cm, kreal)
    res = dict(
        max_abs_err=(tg - tw)[both].abs().max().item() if int(both.sum()) else 0.0,
        ms=time_ms(lambda: tpairs.pair_runs(blk_s, featp, cm, ptile, kreal), 20),
        plain_ms=time_ms(lambda: tpairs._pair_runs_ref(blk_s, featp, w, block, kreal), 3),
        library_ms=None, **pbound,
        shape=f"{blk_s.shape[0]} pairs ({n_real} real, {blocks_used} blocks) in tiles of "
              f"{ptile}, blocks of {block} slots, {pair_tests} (real pair, real triangle) tests")
    log(f"[kernels] pair_runs {label}: {res['shape']}; kernel {res['ms']:.4f} ms, plain "
        f"{res['plain_ms']:.4f} ms, bound {res['bound_ms']:.4f} ms ({res['bound_by']})")
    return res


def phase_pairs(scene, device):
    """Kernels 5, 6 and 8 against their plain versions on the pair path's
    second bounce, and the pair list against the brute force on all of
    its rays. Returns (kernel results, the bounce's collect_stats)."""
    use_full_f32()
    args, kwargs = bounce_args(scene, RenderConfig(trace_depth=8, antialias=True, **PAIRS),
                               "intersect_mesh_pairs", device)
    with Recorder(tpairs, "extract", 0, match=lambda a, kw: a[3] == tpairs.F2) as r2, \
            Recorder(tpairs, "extract", 0, match=lambda a, kw: a[3] != tpairs.F2) as r1, \
            Recorder(tpairs, "pair_runs", 0) as rr, Recorder(twalk, "slab_cull", 0) as r3:
        hit_p, stats = tpairs.intersect_mesh_pairs(*args, **kwargs, collect_stats=True)
    sync(device)
    log(f"[pairs] bounce 1 stats: {stats}")
    if not stats["p2_rounds"]:
        raise AssertionError("the pair path's bounce 1 ran no second pass")
    # pass 2's first pair test comes after pass 1's n1_rounds
    with Recorder(tpairs, "pair_runs", stats["n1_rounds"]) as rr2:
        tpairs.intersect_mesh_pairs(*args, **kwargs)
    sync(device)
    results = {}

    # -- extraction, passes 1 and 2: bit-equal; the group premise ---------
    threads, rpt, group, split_lanes = source_shape("pair_extract")
    log(f"[kernels] pair_extract: {threads} threads a thread block, {rpt} rays a thread "
        f"({split_lanes} lanes a ray in the split form, pass 2's), "
        + f"groups of {group} blocks")
    for label, rec in (("pass 1", r1), ("pass 2", r2)):
        x, slab, blk, F = rec.args
        split = bool(rec.kwargs.get("split", False))
        if split != (label == "pass 2"):
            raise AssertionError(f"pair_extract {label}: split is {split}")
        SHAPE_INPUTS[f"pair_extract {label}"] = (x, slab, blk, F, split)
        got = tpairs.extract(x, slab, blk, F, split)
        want = tpairs._extract_ref(x, slab, blk, F)
        sync(device)
        for name, a, b in zip(("ids", "lbov", "cnt", "feat"), got, want):
            if not torch.equal(a, b):
                raise AssertionError(f"pair_extract {label}: {name} differs from the plain "
                                     f"version in {int((a != b).sum())} entries")
        live = int((x[:, 7] > 0).sum())
        k_real = int((blk[5] >= 0).sum())
        feasible = int(want[2].sum())
        groups = extract_groups(label, x, slab, blk, 1 if split else rpt,
                                split_lanes if split else 1)
        nbytes = (x.numel() + slab.numel() + blk.numel()
                  + sum(t.numel() for t in got)) * 4
        flat_tests = live * k_real
        g = groups[group]
        least, flat = group_bound(
            nbytes, g["group_tests"] * EXTRACT_OPS_PER_GROUP
            + g["member_tests"] * EXTRACT_OPS_PER_PAIR + feasible * EXTRACT_OPS_PER_FEASIBLE,
            flat_tests * EXTRACT_OPS_PER_PAIR + feasible * EXTRACT_OPS_PER_FEASIBLE)
        res = dict(
            max_abs_err=0.0,
            ms=time_ms(lambda: tpairs.extract(x, slab, blk, F, split), 20),
            plain_ms=time_ms(lambda: tpairs._extract_ref(x, slab, blk, F), 3),
            library_ms=None, **least,
            flat_bound_ms=flat["bound_ms"], tests_run=g["group_tests"] + g["member_tests"],
            shape=f"x [{x.shape[0]},16] ({live} live), kp {blk.shape[1]} ({k_real} real), "
                  f"F {F}, {feasible} feasible pairs{', split' if split else ''}")
        # the other form on the same call, for the record
        res["other_form_ms"] = time_ms(lambda: tpairs.extract(x, slab, blk, F, not split), 20)
        log(f"[kernels] pair_extract {label} == plain bit for bit; {res['shape']}; "
            f"kernel {res['ms']:.4f} ms, plain {res['plain_ms']:.4f} ms, "
            f"bound {res['bound_ms']:.4f} ms ({res['bound_by']}, groups of {group}), "
            f"flat bound {flat['bound_ms']:.4f} ms ({flat['bound_by']}, every "
            f"live ray x every real block: {flat_tests} tests)")
        log(f"[kernels] pair_extract {label}: the group premise holds on all {x.shape[0]} rays "
            f"for groups of {', '.join(map(str, EXTRACT_GROUPS))}")
        log(f"[kernels] pair_extract {label}: the {'one-lane' if split else 'split'} form on "
            f"the same call {res['other_form_ms']:.4f} ms")
        warp = f"{32 // split_lanes} rays of {split_lanes} lanes" if split else f"{32 * rpt} rays"
        for G, g in groups.items():
            log(f"[kernels] pair_extract {label}, groups of {G} (warps of {warp}): "
                f"{g['group_tests']} group tests + {g['member_tests']} member tests = "
                f"{g['group_tests'] + g['member_tests']} ray tests ({g['lane_tests']} member "
                f"tests counting every ray of a warp that runs them) against {flat_tests} "
                f"flat; steps with member tests per warp with a live ray: mean "
                f"{g['met_mean']:.2f}, max {g['met_max']} of {g['steps']}")
        if label == "pass 1":
            res["split_ms"] = res.pop("other_form_ms")
            results["pair_extract"] = res
        else:
            results["pair_extract"].update(
                pass2_ms=res["ms"], pass2_plain_ms=res["plain_ms"],
                pass2_bound_ms=res["bound_ms"], pass2_bound_by=res["bound_by"],
                pass2_flat_bound_ms=res["flat_bound_ms"], pass2_one_lane_ms=res["other_form_ms"])

    # -- the slab cull (kernel 1) on pass 3's first call, where it fires --
    if r3.args is None:
        log("[kernels] slab_cull: pass 3 did not fire on the pair path's bounce 1")
    else:
        SHAPE_INPUTS["slab_cull pass 3"] = r3.args
        results["slab_cull pass 3"] = check_tile_cull("slab_cull", "pair path pass 3", r3.args)

    # -- pair test, pass 1 round 1 and pass 2 round 1 ---------------------
    blk_s, featp, cm, ptile, kreal = rr.args
    tmxu.check_sparse_pattern(cm.w)  # the sparse test's precondition
    SHAPE_INPUTS["pair_runs pass 1"] = rr.args
    SHAPE_INPUTS["pair_runs pass 2"] = rr2.args
    results["pair_runs"] = check_pair_runs("pass 1", *rr.args)
    res = check_pair_runs("pass 2", *rr2.args)
    results["pair_runs"].update(pass2_ms=res["ms"], pass2_plain_ms=res["plain_ms"],
                                pass2_bound_ms=res["bound_ms"], pass2_bound_by=res["bound_by"])

    # -- the pair list against the brute-force kernel, every ray ----------
    # (t within 2^-12: the pair list reports t truncated by its packed key)
    brute_check("[pairs] pair list", hit_p, args, kwargs, 2.0 ** -12)
    origin, direction = args[0], args[1]
    t_init, active = kwargs["t_init"], kwargs["active"]
    d_live = torch.where(active[:, None], direction, 0.0)  # dead rays never hit

    # -- brute force: kernel against plain on a slice; timed at full size --
    mesh = scene.mesh
    idx = torch.arange(0, origin.shape[0], origin.shape[0] // BRUTE_SLICE,
                       device=device)[:BRUTE_SLICE]
    o_s, d_s, t_s = origin[idx], d_live[idx], t_init[idx]
    with Recorder(tmxu, "sparse_weights", 0) as rsw:
        got = tmxu.intersect_brute_mxu(o_s, d_s, mesh.v0, mesh.v1, mesh.v2, t_max=t_s)
    want = tmxu.intersect_brute_mxu_ref(o_s, d_s, mesh.v0, mesh.v1, mesh.v2, t_max=t_s, block=512)
    sync(device)
    tmxu.check_sparse_pattern(rsw.args[0])  # the sparse test's precondition
    same = got.tri == want.tri
    frac = same.float().mean().item()
    both = (got.tri >= 0) & (want.tri >= 0)
    rel = ((got.t - want.t).abs() / want.t.abs().clamp_min(1e-30))[both]
    still = (d_s == 0).all(dim=1)  # d = 0: sorted to the back, where whole tiles skip
    log(f"[kernels] mxu_bf on {BRUTE_SLICE} rays of bounce 1 ({int(still.sum())} with d = 0) x "
        f"{mesh.v0.shape[0]} triangles: {int((want.tri >= 0).sum())} hits; ids equal on "
        f"{frac:.6%}; max |dt| {(got.t - want.t)[both].abs().max().item():.3g}, max |dt|/t "
        f"{rel.max().item():.3g} where both hit")
    if frac < 0.9999 or rel.max().item() > 1e-5:
        raise AssertionError("mxu_bf differs from its plain version beyond its tolerance")
    if int(still.sum()) < 1024 or (got.tri[still] != -1).any():
        raise AssertionError("mxu_bf: fewer than a tile of d = 0 rays, or one of them hit")

    def brute():
        return tmxu.intersect_brute_mxu(origin, d_live, mesh.v0, mesh.v1, mesh.v2, t_max=t_init)

    def brute_plain():
        return tmxu.intersect_brute_mxu_ref(origin, d_live, mesh.v0, mesh.v1, mesh.v2,
                                            t_max=t_init, block=512)

    SHAPE_INPUTS["mxu_bf"] = (origin, d_live, mesh.v0, mesh.v1, mesh.v2, t_init)
    t = time.perf_counter()
    brute_plain()
    sync(device)
    plain_ms = (time.perf_counter() - t) * 1e3
    nrays = origin.shape[0]
    live_rays = int(active.sum())  # dead rays (d = 0) never hit
    nbytes = nrays * (RAY_FEATURE_BYTES + 3 * 4) + mesh.v0.shape[0] * TRI_BYTES
    results["mxu_bf"] = dict(
        max_abs_err=(got.t - want.t)[same & (want.tri >= 0)].abs().max().item(),
        ms=time_ms(brute, 3), plain_ms=plain_ms, library_ms=None,
        **bound(nbytes, live_rays * mesh.v0.shape[0] * MT_OPS_PER_TEST),
        # the brute route's own call: its dead lanes keep their directions
        # (the integrator passes no active), so no tile of them skips
        path_inputs_ms=time_ms(lambda: tmxu.intersect_brute_mxu(
            origin, direction, mesh.v0, mesh.v1, mesh.v2, t_max=t_init), 3),
        shape=f"{nrays} rays ({live_rays} live) x {mesh.v0.shape[0]} triangles in blocks of 512")
    r = results["mxu_bf"]
    log(f"[kernels] mxu_bf: {r['shape']}; kernel {r['ms']:.2f} ms with the dead rays' d = 0 "
        f"(the oracle calls' inputs), {r['path_inputs_ms']:.2f} ms with their directions kept "
        f"(the brute route's), plain {r['plain_ms']:.2f} ms (one call), bound "
        f"{r['bound_ms']:.2f} ms ({r['bound_by']})")
    log("[kernels] library_ms is null for pair_extract, pair_runs and mxu_bf: no one PyTorch "
        "call computes a masked first-minimum (or top-F selection) over each ray's own blocks")
    return results, stats


def phase_big(device) -> dict:
    """[big]: kernels 5, 6, 1, 2 and 3 against their plain versions on the
    calls the million-triangle pair path makes at its second bounce, the
    pair list against the brute force on every ray of that bounce, and the
    path's launches (module docstring, 3c). Returns the path's launches."""
    use_full_f32()
    t = time.perf_counter()
    scene = mesh_scene(BIG_SUBDIV, 2.5, BIG_RES, device)
    load_s = time.perf_counter() - t
    cm = scene.cmesh
    config = RenderConfig(trace_depth=8, antialias=True)  # the default config
    route = tint.mesh_route(scene.mesh, cm, config, scene.kd)
    log(f"[big] icosphere({BIG_SUBDIV}): {int(scene.mesh.v0.shape[0])} triangles, OBJ write and "
        f"scene load {load_s:.1f} s; cluster table of {cm.n_blocks} blocks of {cm.block} "
        f"({cm.n_real_blocks} real); route {route}")
    if cm.block != BIG_BLOCK or route != "pairs":
        raise AssertionError(f"[big] the mesh took blocks of {cm.block} and route {route}")
    n = BIG_RES * BIG_RES
    step = make_render_block_fn(scene, config, 1, device=device)
    with Recorder(tint, "intersect_mesh_pairs", 1) as rp, Recorder(tmesh, "gather_cols", 1) as rg:
        step(torch.zeros((n, 3), device=device), prng_key(0), 1)
    sync(device)
    args, kwargs = rp.args, rp.kwargs
    with Recorder(tpairs, "extract", 0, match=lambda a, kw: a[3] == tpairs.F2) as r2, \
            Recorder(tpairs, "extract", 0, match=lambda a, kw: a[3] != tpairs.F2) as r1, \
            Recorder(tpairs, "pair_runs", 0) as rr, Recorder(twalk, "slab_cull", 0) as r3, \
            Recorder(twalk, "walk", 0) as rw:
        hit, stats = tpairs.intersect_mesh_pairs(*args, **kwargs, collect_stats=True)
    sync(device)
    log(f"[big] bounce 1 stats: {stats}")
    if not stats["p2_rounds"] or not stats["p3_rounds"]:
        raise AssertionError("[big] the bounce-1 pair call ran no pass 2 or no pass 3")
    # pass 2's first pair test comes after pass 1's n1_rounds
    with Recorder(tpairs, "pair_runs", stats["n1_rounds"]) as rr2:
        tpairs.intersect_mesh_pairs(*args, **kwargs)
    sync(device)

    for label, rec in (("pass 1", r1), ("pass 2", r2)):
        x, slab, blk, F = rec.args
        want = tpairs._extract_ref(x, slab, blk, F)
        for split in (False, True):
            got = tpairs.extract(x, slab, blk, F, split)
            sync(device)
            for name, a, b in zip(("ids", "lbov", "cnt", "feat"), got, want):
                if not torch.equal(a, b):
                    raise AssertionError(f"[big] pair_extract {label} (split {split}): {name} "
                                         f"differs from the plain version in "
                                         f"{int((a != b).sum())} entries")
        ms = time_ms(lambda: tpairs.extract(x, slab, blk, F, bool(rec.kwargs.get("split"))), 5)
        log(f"[big] pair_extract {label} == plain bit for bit in both forms; x [{x.shape[0]},16] "
            f"({int((x[:, 7] > 0).sum())} live), kp {blk.shape[1]} "
            f"({int((blk[5] >= 0).sum())} real), F {F}, {int(want[2].sum())} feasible pairs; "
            f"kernel {ms:.4f} ms")
    for label, rec in (("pass 1", rr), ("pass 2", rr2)):
        check_pair_runs(f"[big] {label}", *rec.args)
    check_tile_cull("slab_cull", "[big] pass 3", r3.args)

    sel, lb, nsel, r, t0, act, wcm, wtile = rw.args
    bt_k, btri_k = twalk.walk(sel, lb, nsel, r, t0, act, wcm, wtile)
    bt_p, btri_p = twalk._walk_ref(sel, lb, r, t0, act, wcm.w, wtile, wcm.block)
    sync(device)
    check_hits("[big] walk", (bt_k, btri_k), (bt_p, btri_p))
    if not torch.equal(btri_k, btri_p):
        raise AssertionError(f"[big] walk: ids differ from the plain version on "
                             f"{int((btri_k != btri_p).sum())} rays")
    log(f"[big] walk: {r.shape[0]} rays in {r.shape[0] // wtile} tiles of {wtile}, lists of "
        f"{sel.shape[1]} blocks (feasible: mean {nsel.float().mean().item():.1f}, max "
        f"{int(nsel.max())}), {int((btri_p >= 0).sum())} hits; ids equal on every ray, t "
        f"bit-equal on {int((bt_k == bt_p).sum())}; kernel "
        f"{time_ms(lambda: twalk.walk(sel, lb, nsel, r, t0, act, wcm, wtile), 5):.4f} ms")
    # Pass 3's rays are mostly misses that graze many blocks (a hit is soon
    # proven), so its walk may find nothing: walk the bounce's first 2,048
    # mesh-active rays too, their lists built as pass 3 builds them.
    x1 = r1.args[0]
    ids1 = (x1[:, 7] > 0).nonzero()[:, 0]
    ids1 = ids1[:65536][tpairs._extract_ref(x1[ids1[:65536]], *r1.args[1:])[2] > 0]
    ids1 = ids1[:min(2048, ids1.shape[0] // wtile * wtile)]
    xs = x1[ids1]
    sel, lb, nsel = twalk._full_select(twalk.slab_cull(xs, cm.slab, cm.blk, wtile))
    rs = torch.cat([tmxu.ray_features(xs[:, 0:3], xs[:, 3:6]),
                    torch.zeros((xs.shape[0], 6), device=device)], dim=1)
    t0, act = xs[:, 6].contiguous(), xs[:, 7].contiguous()
    bt_k, btri_k = twalk.walk(sel, lb, nsel, rs, t0, act, cm, wtile)
    bt_p, btri_p = twalk._walk_ref(sel, lb, rs, t0, act, cm.w, wtile, cm.block)
    sync(device)
    check_hits("[big] walk on mesh-active rays", (bt_k, btri_k), (bt_p, btri_p))
    if not torch.equal(btri_k, btri_p) or int((btri_p >= 0).sum()) < xs.shape[0] // 10:
        raise AssertionError("[big] walk on mesh-active rays: ids differ from the plain "
                             "version, or fewer than a tenth of the rays hit")
    log(f"[big] walk on {xs.shape[0]} mesh-active rays (lists: mean "
        f"{nsel.float().mean().item():.1f}, max {int(nsel.max())} blocks): "
        f"{int((btri_p >= 0).sum())} hits; ids equal on every ray, t bit-equal on "
        f"{int((bt_k == bt_p).sum())}")

    packed, tri = rg.args
    if not torch.equal(tmesh.gather_cols(packed, tri), tmesh._gather_cols_ref(packed, tri)):
        raise AssertionError("[big] gather_cols differs from packed[tri].T")
    log(f"[big] gather_cols == packed[tri].T bit for bit; packed [{packed.shape[0]},"
        f"{packed.shape[1]}], tri [{tri.shape[0]}]")

    brute_check("[big] pair list", hit, args, kwargs, 2.0 ** -12)
    del rp, rg, r1, r2, rr, rr2, r3, rw, args, kwargs, hit
    launches = phase_main_path("pairs_ico1310k", scene, config, device,
                               ("pair_extract", "pair_runs", "slab_cull", "walk", "gather_cols",
                                "geoms_hit"), block=1, timed_calls=2, profile=False,
                               absent=("pair_bdiag", "mxu_bf", "cluster_cull", "cluster_rounds",
                                       "cluster_sweep", "binned_argmin"))
    iters = IMAGES.pop("pairs_ico1310k")[1]
    if launches["geoms_hit"] != 8 * iters:
        raise AssertionError("[big] kernel 13 did not launch once a bounce")
    return launches


def ptxas_summary(text: str) -> str:
    """"registers (spill stores/loads bytes)" of each entry function in
    one source's ``nvcc -Xptxas -v`` output, in order."""
    regs = re.findall(r"Used (\d+) registers", text)
    spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", text)
    return ", ".join(f"{r} ({a}/{b})" for r, (a, b) in zip(regs, spills))


def build_shapes(names) -> dict:
    """Copies of the SHAPES sources of ``names`` with their other shapes' constants, one
    nvcc each, all at once -> {(name, shape): (build directory, ptxas
    summary)}: each directory holds the library under the
    name ``cuda_build.library_path`` gives the source's own build, so that
    a CudaKernel loads it while ``cuda_build.BUILD_DIR`` names that
    directory. The sources' own shape must be SHAPES[name][0]."""
    out_dir = os.path.join(WORK, "shapes")
    jobs = {}
    for name, shapes in SHAPES.items():
        if name not in names:
            continue
        text = (cuda_build.CSRC / f"{name}.cu").read_text()
        own = source_shape(name)
        if own != shapes[0]:
            raise AssertionError(f"{name}.cu's shape {own} is not SHAPES' first {shapes[0]}")
        for shape in shapes[1:]:
            src = text
            for const, value in zip(SHAPE_CONSTANTS[name], shape):
                src = re.sub(rf"constexpr int {const} = \d+;", f"constexpr int {const} = {value};",
                             src)
            build_dir = os.path.join(out_dir, f"{name}_{'_'.join(map(str, shape))}")
            os.makedirs(build_dir, exist_ok=True)
            src_path = os.path.join(build_dir, f"{name}.cu")
            with open(src_path, "w") as f:
                f.write(src)
            lib = os.path.join(build_dir, cuda_build.library_path(name).name)
            jobs[(name, shape)] = (build_dir, subprocess.Popen(
                [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-I", str(cuda_build.CSRC), "-o",
                 lib, src_path], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for key, (build_dir, proc) in jobs.items():
        text = proc.communicate()[0]
        if proc.returncode:
            raise AssertionError(f"nvcc failed for the {key} shape:\n{text}")
        out[key] = (build_dir, ptxas_summary(text))
    return out


@contextlib.contextmanager
def swapped(module, name: str, value):
    """``module.name`` is ``value`` while the block runs."""
    real = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, real)


def phase_shapes(own_logs: dict, names) -> None:
    """Kernels 2, 8, 10, 7, 6, 5, 1, 9 and 12 (or those of ``names``) in each of
    SHAPES, on the recorded calls of phase_kernels (the walk path's bounce
    1), phase_pairs (the brute force's full bounce; kernels 5 and 6 on the
    pair path's bounce-1 pass-1 and pass-2 calls, kernel 5 also in its
    split form on pass 1's; kernel 1 on pass 3's call where one fires),
    phase_launches (kernel 6's heaviest launch at bounce 0), phase_cluster
    (the cluster and binned paths' bounce 1; kernel 12 the binned path's)
    and phase_bdiag: device ms and registers, and the outputs
    equal to the sources' own shape's bit for bit (a ray's or a pair's
    result does not depend on the shape). The brute force also at other
    triangle blocks."""
    t = time.perf_counter()
    built = build_shapes(names)
    log(f"[shapes] {len(built)} shape builds in {time.perf_counter() - t:.1f} s")
    origin, d_live, v0, v1, v2, t_init = SHAPE_INPUTS["mxu_bf"]

    def brute(shape):
        hit = tmxu.intersect_brute_mxu(origin, d_live, v0, v1, v2, t_max=t_init,
                                       ray_tile=shape[0] * shape[1])
        return hit.t, hit.tri

    def on(fn, key):
        """fn on a recorded call's arguments, its outputs as a tuple."""
        def call(shape):
            out = fn(*SHAPE_INPUTS[key])
            return out if isinstance(out, tuple) else (out,)
        return call

    # each kernel's timed calls, each returning its outputs as a tuple of tensors
    calls = {
        "walk": (twalk, "WALK", {"walk path": on(twalk.walk, "walk")}),
        "cluster_rounds": (tcl, "ROUNDS",
                           {"cluster path": on(tcl.cluster_rounds, "cluster_rounds")}),
        "mxu_bf": (tmxu, "BF", {"pair path, full bounce": brute}),
        "pair_bdiag": (tpairs, "PAIR_BDIAG",
                       {"pair_bdiag path": on(tpairs.pair_bdiag, "pair_bdiag")}),
        "pair_runs": (tpairs, "PAIR_RUNS", {
            label: on(tpairs.pair_runs, f"pair_runs {label}")
            for label in ("pass 1", "pass 2", "bounce 0")}),
        "pair_extract": (tpairs, "EXTRACT", {
            **{label: on(tpairs.extract, f"pair_extract {label}") for label in ("pass 1", "pass 2")},
            "pass 1 split form": lambda shape: tuple(
                tpairs.extract(*SHAPE_INPUTS["pair_extract pass 1"][:4], True))}),
        "slab_cull": (twalk, "SLAB_CULL", {
            label: on(twalk.slab_cull, key) for label, key in
            (("walk path", "slab_cull"), ("pass 3", "slab_cull pass 3")) if key in SHAPE_INPUTS}),
        "cluster_cull": (tcl, "CULL", {
            "cluster path": on(tcl.cull, "cluster_cull"),
            "binned path": on(tcl.cull, "cluster_cull binned")}),
        "binned_argmin": (tbinned, "ARGMIN",
                          {"binned path": on(tbinned.argmin_bins, "binned_argmin")}),
    }
    for name, shapes in SHAPES.items():
        if name not in names:
            continue
        module, attr, fns = calls[name]
        own = getattr(module, attr)
        want = {}
        for shape in shapes:
            if shape == shapes[0]:
                kernel, regs = own, ptxas_summary(own_logs.get(name, ""))
            else:
                build_dir, regs = built[(name, shape)]
                kernel = cuda_build.CudaKernel(own.source, own.symbol, own.argtypes[:-1])
                with swapped(cuda_build, "BUILD_DIR", Path(build_dir)):
                    kernel._function()  # loads the shape's build
            times = []
            for label, call in fns.items():
                with swapped(module, attr, kernel):
                    got = call(shape)
                    ms = time_ms(lambda: call(shape), 3 if name == "mxu_bf" else 5)
                sync(origin.device)
                if label not in want:
                    want[label] = got
                elif not all(torch.equal(a, b) for a, b in zip(got, want[label])):
                    raise AssertionError(f"[shapes] {name} {shape} differs from {shapes[0]} on "
                                         f"the {label} call")
                times.append(f"{label} {ms:.4f} ms")
            consts = ", ".join(f"{c} {v}" for c, v in zip(SHAPE_CONSTANTS[name], shape))
            log(f"[shapes] {name} {consts}: {'; '.join(times)}; registers (spill stores/loads) "
                f"{regs or 'not built here'}")
    if "mxu_bf" not in names:
        return
    own_tri = brute(SHAPES["mxu_bf"][0])[1]
    for block in BRUTE_TRI_BLOCKS:
        got = tmxu.intersect_brute_mxu(origin, d_live, v0, v1, v2, t_max=t_init,
                                       tri_block=block)
        ms = time_ms(lambda: tmxu.intersect_brute_mxu(origin, d_live, v0, v1, v2, t_max=t_init,
                                                      tri_block=block), 3)
        sync(origin.device)
        log(f"[shapes] mxu_bf triangle blocks of {block}: {ms:.3f} ms; ids equal to blocks of "
            f"512 on {(got.tri == own_tri).float().mean().item():.6%}")


def brute_check(label, hit, args, kwargs, rtol: float = 1e-5) -> None:
    """An intersector's hits on every ray of one bounce against the
    brute-force kernel's on the same rays: ids on >= 99.99% of rays, t
    within ``rtol`` relative where both hit. ``label`` starts with the
    phase's tag."""
    origin, direction, cm = args[0], args[1], args[2]
    t_init, active = kwargs["t_init"], kwargs["active"]
    d_live = torch.where(active[:, None], direction, 0.0)  # dead rays never hit
    tris = cm.tris
    hb = tmxu.intersect_brute_mxu(origin, d_live, tris.v0, tris.v1, tris.v2, t_max=t_init)
    sync(origin.device)
    frac = (hit.tri == hb.tri).float().mean().item()
    both = (hb.tri >= 0) & (hit.tri >= 0)
    rel = ((hit.t - hb.t).abs() / hb.t.abs().clamp_min(1e-30))[both]
    rel_max = rel.max().item() if rel.numel() else 0.0
    log(f"{label} vs brute-force kernel on all {origin.shape[0]} rays of bounce 1 x "
        f"{tris.v0.shape[0]} triangle slots: {int((hb.tri >= 0).sum())} hits; ids equal on "
        f"{frac:.6%}; max |dt|/t {rel_max:.3g} where both hit (bound {rtol:.3g})")
    if frac < 0.9999 or rel_max > rtol:
        raise AssertionError(f"{label} differs from the brute force on this bounce")


def rounds_in_tile_order(sel, lb, r, t0, act, cm, tile):
    """Kernel 10 launched with its tiles in index order rather than the
    wrapper's longest list first (a measurement of the launch order)."""
    n, device = r.shape[0], r.device
    nsel = (lb < BIG).sum(dim=1, dtype=torch.int32)
    order = torch.arange(nsel.shape[0], dtype=torch.int32, device=device)
    bt = torch.empty((n,), dtype=torch.float32, device=device)
    btri = torch.empty((n,), dtype=torch.int32, device=device)
    tcl.ROUNDS.launch(device, sel.data_ptr(), lb.data_ptr(), nsel.data_ptr(), order.data_ptr(),
                      r.data_ptr(), t0.data_ptr(), act.data_ptr(), cm.w.data_ptr(),
                      cm.real.data_ptr(), cm.slab.data_ptr(), bt.data_ptr(), btri.data_ptr(),
                      None, n, sel.shape[1], cm.n_blocks, tile, cm.block)
    return bt, btri


def check_rounds(args, label) -> dict:
    """Kernel 10 against its plain version on one path's recorded call:
    ids on >= 99.99% of rays, t within 1e-5, and, as its skips are exact
    and its sparse chain gives the dense chain's floats, t and ids equal on
    every ray; the table's zero pattern; its rounds and tests beside the
    needed ones, and its time (also with the tiles in index order)."""
    sel, lb, r, t0, act, cm, tile = args
    tmxu.check_sparse_pattern(cm.w)  # the sparse test's precondition
    g = r.shape[0] // tile
    counts = torch.zeros((g, 2), dtype=torch.int32, device=r.device)
    got = tcl.cluster_rounds(sel, lb, r, t0, act, cm, tile, rounds=counts)
    want = tcl._cluster_ref(sel, lb, r, t0, act, cm.w, tile, cm.block, sel.shape[1])
    sync(r.device)
    frac, max_err = check_hits(f"cluster_rounds ({label})", got, want)
    differ = int(((got[0] != want[0]) | (got[1] != want[1])).sum())
    log(f"[kernels] cluster_rounds ({label}): {differ} of {r.shape[0]} rays differ from the "
        f"plain version in t or id (the skips are exact: none may)")
    if differ:
        raise AssertionError(f"cluster_rounds ({label}): {differ} rays differ from the plain "
                             f"version")
    needed, tile_tests, tests, used_tris = needed_rounds(cm, sel, lb, want[0], act, r, tile)
    listed = int((lb < BIG).sum())
    # each ray's features, t0, act and outputs; the listed entries of sel
    # and lb; the real triangles the needed tests read, once
    nbytes = r.shape[0] * (RAY_FEATURE_BYTES + 4 * 4) + listed * 2 * 4 + used_tris * TRI_BYTES
    res = dict(max_abs_err=max_err,
               ms=time_ms(lambda: tcl.cluster_rounds(sel, lb, r, t0, act, cm, tile), 10),
               plain_ms=time_ms(lambda: tcl._cluster_ref(sel, lb, r, t0, act, cm.w, tile,
                                                         cm.block, sel.shape[1]), 1),
               library_ms=None, **bound(nbytes, tests * MT_OPS_PER_TEST),
               shape=f"{g} tiles of {tile} rays, {sel.shape[1]} rounds, {needed} needed "
                     f"(tile, block) rounds of {cm.block} slots ({listed} listed; its thread "
                     f"blocks ran {int(counts[:, 0].sum())} block rounds), {tests} needed (live "
                     f"ray, real triangle) tests at ray granularity ({tile_tests} counting every "
                     f"live ray of a needed round; the kernel ran {32 * int(counts[:, 1].sum())} "
                     f"in 32-ray groups), lists of mean "
                     f"{(lb < BIG).sum(dim=1).float().mean().item():.1f}", ids_equal=frac)
    in_order = rounds_in_tile_order(sel, lb, r, t0, act, cm, tile)
    sync(r.device)
    if not (torch.equal(in_order[0], got[0]) and torch.equal(in_order[1], got[1])):
        raise AssertionError(f"cluster_rounds ({label}): the launch order changed a result")
    order_ms = time_ms(lambda: rounds_in_tile_order(sel, lb, r, t0, act, cm, tile), 10)
    log(f"[kernels] cluster_rounds ({label}): {res['shape']}")
    log(f"[kernels] cluster_rounds ({label}): kernel {res['ms']:.4f} ms (longest list first), "
        f"{order_ms:.4f} ms with the tiles in index order; bound {res['bound_ms']:.4f} ms "
        f"({res['bound_by']}), plain {res['plain_ms']:.4f} ms")
    return res


def sweep_bound(r, rows, cm) -> dict:
    """The least time of a sweep of ``rows``: each listed live ray (dead
    lanes have d = 0) against each real triangle, MT_OPS_PER_TEST
    operations a test; bytes: the listed rays' row ids, features, bounds
    and ids, the real triangles' weights, and the outputs."""
    live = int((r[rows.long(), 3:6] != 0).any(dim=1).sum())
    tris = int(cm.real.sum())
    nbytes = rows.numel() * (RAY_FEATURE_BYTES + (1 + 2 + 2) * 4) + tris * TRI_BYTES
    return dict(live=live, tris=tris, **bound(nbytes, live * tris * MT_OPS_PER_TEST))


def check_sweep(args, label) -> dict:
    """Kernel 11 on one recorded repair call (the flagged rows of a main
    path's bounce): both launch shapes, one pass (slices = 1) and the
    block axis split as the wrapper picks it, against the plain version on
    the first BRUTE_SLICE listed rows; the call's time in the wrapper's
    shape against its bound, and the one-pass shape's; the full-width form
    (every ray of the call listed) against the 212.09 ms the TPU-shaped sweep took on the
    same call (H100 80GB HBM3, 700 W; PERF.md) and its own bound. The
    plain version is timed in one call on the recorded rows."""
    rows, r, bt, btri, cm, tile = args
    n, m = r.shape[0], rows.shape[0]
    kreal = cm.n_real_blocks
    auto = tcl.SWEEP.call_int("cluster_sweep_slices", m, kreal)
    sl = rows[:BRUTE_SLICE]
    want = tcl._sweep_ref(sl, r, bt, btri, cm.w, tile, cm.block, kreal)
    frac = max_err = None
    for slices in (1, tcl.SWEEP.call_int("cluster_sweep_slices", sl.numel(), kreal), auto):
        got = tcl.sweep(sl, r, bt, btri, cm, tile, slices=slices)
        f, e = check_hits(f"cluster_sweep ({label}) on {sl.numel()} of its {m} rows, "
                          f"{slices} slices", [a[sl.long()] for a in got],
                          [a[sl.long()] for a in want])
        frac = f if frac is None else min(frac, f)
        max_err = e if max_err is None else max(max_err, e)
    one = tcl.sweep(rows, r, bt, btri, cm, tile, slices=1)
    split = tcl.sweep(rows, r, bt, btri, cm, tile)
    sync(r.device)
    if not (torch.equal(one[0], split[0]) and torch.equal(one[1], split[1])):
        raise AssertionError(f"cluster_sweep ({label}): one pass and {auto} slices differ")
    log(f"[kernels] cluster_sweep ({label}): one pass and {auto} slices equal bit for bit on "
        f"all {m} rows")
    t = time.perf_counter()
    tcl._sweep_ref(rows, r, bt, btri, cm.w, tile, cm.block, kreal)
    sync(r.device)
    plain_ms = (time.perf_counter() - t) * 1e3
    flagged = sweep_bound(r, rows, cm)
    every = torch.arange(n, dtype=torch.int32, device=r.device)
    full = sweep_bound(r, every, cm)
    res = dict(max_abs_err=max_err, ids_equal=frac, plain_ms=plain_ms, library_ms=None,
               ms=time_ms(lambda: tcl.sweep(rows, r, bt, btri, cm, tile), 5),
               one_pass_ms=time_ms(lambda: tcl.sweep(rows, r, bt, btri, cm, tile, slices=1), 5),
               bound_ms=flagged["bound_ms"], bound_by=flagged["bound_by"], rows=m,
               slices=auto,
               full_width_ms=time_ms(lambda: tcl.sweep(every, r, bt, btri, cm, tile), 3),
               full_width_bound_ms=full["bound_ms"],
               shape=f"{m} listed rows ({flagged['live']} live) of {n} rays x {kreal} blocks "
                     f"of {cm.block} slots ({flagged['tris']} real triangles)")
    log(f"[kernels] cluster_sweep ({label}): {res['shape']}; kernel {res['ms']:.3f} ms "
        f"({auto} slices; one pass {res['one_pass_ms']:.3f} ms), bound {res['bound_ms']:.3f} ms "
        f"({res['bound_by']}), plain {plain_ms:.1f} ms (one call); full width ({n} rows, "
        f"{full['live']} live): {res['full_width_ms']:.2f} ms against the TPU-shaped sweep's "
        f"212.09 ms, bound {res['full_width_bound_ms']:.2f} ms")
    return res


def argmin_groups(label, x, cull_w, blk, G: int, threads: int) -> dict:
    """Kernel 12's skip on one call, in groups of G blocks: the premise,
    that every feasible (ray, block) lies in a group whose widened entry
    (``_group_sphere_entry``) is below BIG and no later than the block's
    entry, so the winning block's group too (a pair outside fails the
    run), and the tests the kernel runs. A live ray tests every non-empty
    group, in index order, and the real members of a group whose entry
    lies below its best entry so far; a thread block takes ``threads``
    rays, its live ones in order, 32 to a warp, and a warp runs a group's
    members where one of its rays needs them. ->
    dict(group_tests: live rays x non-empty groups, member_tests: each
    live ray's own, lane_tests: the same for all 32 lanes of a warp that
    runs them, met_mean and met_max: groups a warp runs, groups: non-empty
    groups, meeting: live rays a group passes for, winners: rays with a
    feasible block)."""
    kp = blk.shape[1]
    ng = -(-kp // G)
    members = torch.zeros((ng * G,), dtype=torch.float32, device=x.device)
    members[:kp] = (blk[5] >= 0).float()
    members = members.reshape(ng, G).sum(dim=1)  # real members a group
    gsph = tcl._group_sphere(cull_w, blk, G)
    group_of = torch.arange(kp, device=x.device) // G
    live = x[:, 7] > 0
    rows = max(threads, 65536 // threads * threads)
    bad = member_tests = lane_tests = winners = meeting = 0
    met = []
    for r0 in range(0, x.shape[0], rows):
        xs, ls = x[r0:r0 + rows], live[r0:r0 + rows]
        r = xs.shape[0]
        entry = tcl._entries(xs, cull_w, blk)
        gentry = tcl._group_sphere_entry(xs, gsph)
        of = gentry[:, group_of]
        feasible = entry < BIG
        bad += int((feasible & ((of >= BIG) | (of > entry))).sum())
        winners += int(feasible.any(dim=1).sum())
        # a ray's best before group q: its least member entry over groups < q
        # (a skipped group's members are no better, so the kernel's best)
        padded = torch.full((r, ng * G), BIG, device=x.device)
        padded[:, :kp] = entry
        gmin = padded.reshape(r, ng, G).amin(dim=2)
        before = torch.cat([torch.full((r, 1), BIG, device=x.device),
                            torch.cummin(gmin, dim=1).values[:, :-1]], dim=1)
        need = (gentry < before) & ls[:, None]
        member_tests += int((need.float() @ members).sum())
        meeting += int((ls & (gentry < BIG).any(dim=1)).sum())
        fill = -r % threads  # the last thread block's rays past n
        if fill:
            ls = torch.cat([ls, ls.new_zeros((fill,))])
            need = torch.cat([need, need.new_zeros((fill, ng))])
        slot, wmet = tcl._warp_meets(ls, need, threads)
        wmet = (wmet > 0).float()
        wlive = torch.bincount(slot[ls], minlength=wmet.shape[0]).float()
        lane_tests += int(((wmet @ members) * 32 * (wlive > 0)).sum())
        met.append(wmet.sum(dim=1)[wlive > 0])
    if bad:
        raise AssertionError(f"binned_argmin {label}: {bad} feasible (ray, block) pairs lie in a "
                             f"group of {G} whose entry is BIG or later than theirs")
    met = torch.cat(met)
    groups = int((members > 0).sum())
    return dict(group_tests=int(live.sum()) * groups, member_tests=member_tests,
                lane_tests=lane_tests, met_mean=met.mean().item() if met.numel() else 0.0,
                met_max=int(met.max()) if met.numel() else 0, groups=groups, winners=winners,
                meeting=meeting)


def check_argmin(args) -> dict:
    """Kernel 12 against its plain version on one recorded call: bit for
    bit; the group premise on every ray and the tests its skip runs
    (argmin_groups); its time, its plain version's, and its bound
    (group_bound: the tests its groups need, or the flat count where that
    is less), with the flat bound, every live ray x every real block,
    beside it as ``flat_bound_ms``."""
    x, cull_w, blk = args
    got = tbinned.argmin_bins(x, cull_w, blk)
    want = tbinned._argmin_ref(x, cull_w, blk)
    sync(x.device)
    if not torch.equal(got, want):
        raise AssertionError(f"binned_argmin differs from its plain version on "
                             f"{int((got != want).sum())} rays")
    threads, G = source_shape("binned_argmin")
    g = argmin_groups("binned path", x, cull_w, blk, G, threads)
    kp = blk.shape[1]
    k_real = int((blk[5] >= 0).sum())
    live = int((x[:, 7] > 0).sum())
    nbytes = (x.numel() + cull_w.numel() + blk.numel() + got.numel()) * 4
    flat_tests = live * k_real
    least, flat = group_bound(nbytes, g["group_tests"] * CULL_OPS_PER_GROUP
                              + g["member_tests"] * CULL_OPS_PER_PAIR,
                              flat_tests * CULL_OPS_PER_PAIR)
    res = dict(max_abs_err=0.0, ms=time_ms(lambda: tbinned.argmin_bins(x, cull_w, blk), 20),
               plain_ms=time_ms(lambda: tbinned._argmin_ref(x, cull_w, blk), 3),
               library_ms=None, **least, flat_bound_ms=flat["bound_ms"],
               tests_run=g["group_tests"] + g["member_tests"],
               shape=f"x [{x.shape[0]},8] ({live} live), kp {kp} ({k_real} real, "
                     f"{g['groups']} non-empty groups of {G}); {int((want < kp).sum())} rays "
                     f"with a feasible block")
    log(f"[kernels] binned_argmin == plain bit for bit; {res['shape']}; the group premise holds "
        f"on all {x.shape[0]} rays (the {g['winners']} winning blocks among them)")
    log(f"[kernels] binned_argmin: kernel {res['ms']:.4f} ms, plain {res['plain_ms']:.4f} ms, "
        f"bound {res['bound_ms']:.4f} ms ({res['bound_by']}), flat bound "
        f"{flat['bound_ms']:.4f} ms ({flat['bound_by']}, every live ray x every real block: "
        f"{flat_tests} tests)")
    log(f"[kernels] binned_argmin, groups of {G}, {threads} threads: {g['group_tests']} group "
        f"tests + {g['member_tests']} member tests = {res['tests_run']} ray tests "
        f"({g['lane_tests']} member tests counting every lane of a warp that runs them) against "
        f"{flat_tests} flat; groups run per warp: mean {g['met_mean']:.2f}, max {g['met_max']} "
        f"of {g['groups']}; {g['meeting']} live rays meet a group")
    return res


def phase_cluster(scene, device) -> dict:
    """Kernels 9-12 against their plain versions on the inputs the
    cluster-rounds and binned paths hand them at their second bounce, and
    both intersectors against the brute-force kernel on every ray of it."""
    use_full_f32()
    results = {}
    # the cull's first call is bounce 0's: camera rays, every one live, the
    # same call as the 4-round (cluster_r4) render's bounce 0
    with Recorder(tcl, "cull", 0) as r0c:
        args, kwargs = bounce_args(scene, RenderConfig(trace_depth=8, antialias=True, **CLUSTER),
                                   "intersect_mesh_cluster", device)
    cm = args[2]
    with Recorder(tcl, "cull", 0) as rc, Recorder(tcl, "cluster_rounds", 0) as rr, \
            Recorder(tcl, "sweep", 0) as rs:
        hit, stats = tcl.intersect_mesh_cluster(*args, **kwargs, collect_stats=True)
    log(f"[cluster] cluster rounds (64), bounce 1: {stats}")
    brute_check("[cluster] cluster rounds (64)", hit, args, kwargs)
    sweep_args = rs.args
    if sweep_args is None:  # no ray flagged: the sweep's inputs from 4 rounds
        cfg4 = RenderConfig(trace_depth=8, antialias=True, cluster_rounds=4, **CLUSTER)
        with Recorder(tcl, "sweep", 0) as rs4:
            hit, stats = tcl.intersect_mesh_cluster(args[0], args[1], cm, cfg4, **kwargs,
                                                    collect_stats=True)
        log(f"[cluster] cluster rounds (4), bounce 1: {stats}")
        brute_check("[cluster] cluster rounds (4)", hit, args, kwargs)
        sweep_args = rs4.args
    SHAPE_INPUTS["cluster_cull"] = rc.args
    results["cluster_cull"] = check_tile_cull("cluster_cull", "cluster path", rc.args)
    results["cluster_rounds"] = check_rounds(rr.args, "cluster path")
    SHAPE_INPUTS["cluster_rounds"] = rr.args
    results["cluster_sweep"] = check_sweep(sweep_args, "cluster path")

    args, kwargs = bounce_args(scene, RenderConfig(trace_depth=8, antialias=True, **BINNED),
                               "intersect_mesh_binned", device)
    with Recorder(tbinned, "argmin_bins", 0) as ra, Recorder(tcl, "sweep", 0) as rbs, \
            Recorder(tcl, "cluster_rounds", 0) as rbr, Recorder(tcl, "cull", 0) as rbc:
        hit, stats = tbinned.intersect_mesh_binned(*args, **kwargs, collect_stats=True)
    log(f"[cluster] binned (32 rounds), bounce 1: {stats}")
    brute_check("[cluster] binned (32)", hit, args, kwargs)
    results["binned_argmin"] = check_argmin(ra.args)
    SHAPE_INPUTS["binned_argmin"] = ra.args
    SHAPE_INPUTS["cluster_cull binned"] = rbc.args
    for key, label, rec in (("binned", "binned path", rbc),
                            ("cluster_r4", "cluster and cluster_r4 paths, bounce 0", r0c)):
        res = check_tile_cull("cluster_cull", label, rec.args)
        results["cluster_cull"].update({f"{key}_ms": res["ms"], f"{key}_bound_ms": res["bound_ms"]})
    check_rounds(rbr.args, "binned path")
    if rbs.args is not None:
        results["cluster_sweep_binned"] = check_sweep(rbs.args, "binned path")
    for name in ("cluster_cull", "cluster_rounds", "cluster_sweep", "binned_argmin"):
        res = results[name]
        log(f"[kernels] {name}: kernel {res['ms']:.4f} ms, plain {res['plain_ms']:.4f} ms, "
            f"bound {res['bound_ms']:.4f} ms ({res['bound_by']})")
    log("[kernels] library_ms is null for cluster_cull, cluster_rounds, cluster_sweep and "
        "binned_argmin: no one PyTorch call computes a tile-min or first-argmin of a masked "
        "sphere entry bound, or a masked first-minimum over each tile's own blocks")
    return results


def geoms_calls(scene, device) -> tuple:
    """The rays one iteration of the pair path hands ``intersect_geoms``
    at bounces 0 and 1: ((origin, direction), (origin, direction))."""
    n = int(scene.camera.resolution[0]) * int(scene.camera.resolution[1])
    step = make_render_block_fn(scene, RenderConfig(trace_depth=8, antialias=True), 1,
                                device=device)
    with Recorder(tisect, "intersect_geoms", 0) as r0, \
            Recorder(tisect, "intersect_geoms", 1) as r1:
        step(torch.zeros((n, 3), device=device), prng_key(0), 1)
    sync(device)
    return tuple(tuple(r.args[:2]) for r in (r0, r1))


def check_geoms(label, origin, direction, geoms, reps: int = 20) -> dict:
    """Kernel 13 against its plain version on one call: every field bit
    for bit (torch.equal); the kernel's and the plain version's ms and
    the bytes bound."""
    got = tisect.geoms_hit(origin, direction, geoms)
    want = tisect._intersect_geoms_plain(origin, direction, geoms)
    sync(origin.x.device)
    n = origin.x.shape[0]
    for f in ("t", "material_id", "outside", "point", "normal"):
        a, b = getattr(got, f), getattr(want, f)
        pairs = zip(a, b) if f in ("point", "normal") else ((a, b),)
        if not all(torch.equal(x, y) for x, y in pairs):
            raise AssertionError(f"[geoms] {label}: kernel 13's {f} differs from the plain "
                                 f"version's")
    hit = want.t < BIG
    res = dict(max_abs_err=0.0, library_ms=None,
               ms=time_ms(lambda: tisect.geoms_hit(origin, direction, geoms), reps),
               plain_ms=time_ms(lambda: tisect._intersect_geoms_plain(origin, direction, geoms),
                                3),
               **bound(n * GEOM_LANE_BYTES, n * geoms.count * GEOM_OPS))
    log(f"[geoms] {label}: {n} lanes x {geoms.count} geoms (origin broadcast: "
        f"{origin.x.stride(0) == 0}), {int(hit.sum())} hit, {int((hit & ~want.outside).sum())} "
        f"from inside; every field bit for bit; kernel {res['ms']:.4f} ms, plain "
        f"{res['plain_ms']:.4f} ms, bound {res['bound_ms']:.4f} ms ({res['bound_by']}, "
        f"{GEOM_LANE_BYTES} B a lane)")
    return res


def phase_geoms(scene, device) -> dict:
    """Kernel 13 against its plain version on the rays the pair path hands
    ``intersect_geoms`` at bounces 0 (the camera's: their origin one value
    on every lane) and 1, at 800x800 and at 2048x2048. The 800x800
    bounce-1 call is the record's."""
    results = {}
    for res in (800, 2048):
        sc = with_resolution(scene, res, res)
        calls = geoms_calls(sc, device)
        results[res] = [check_geoms(f"{res}x{res} bounce {b}", *rays, sc.geoms)
                        for b, rays in enumerate(calls)]
        del calls
    (b0, b1), (w0, w1) = results[800], results[2048]
    return dict(b1, bounce0_ms=b0["ms"], bounce0_plain_ms=b0["plain_ms"], w2048_ms=w1["ms"],
                w2048_plain_ms=w1["plain_ms"], w2048_bound_ms=w1["bound_ms"],
                w2048_bounce0_ms=w0["ms"])


def phase_launches(scene, device) -> None:
    """Each launch of kernels 5 and 6 over one iteration of the pair path
    (the default config, depth 8, 800x800) with its call site (bounce,
    pass, round; rays and live rays, or pairs, real pairs and the blocks
    they name) and its device time: CUDA events around the launch, a sleep
    kernel queued ahead of it, so that the host's launch does not count;
    after an iteration that is not timed. Keeps the arguments of bounce
    0's heaviest pair_runs launch for [shapes]. Uses only the entry points
    every tree of the port has, so that an earlier tree can be measured
    with this script (``--launches``)."""
    use_full_f32()
    res = int(scene.camera.resolution[0])
    step = make_render_block_fn(scene, RenderConfig(trace_depth=8, antialias=True), 1,
                                device=device)
    rows = []
    site = dict(bounce=-1, pass_=1, round_=0)
    kept = {}

    def timed_launch(fn, args, kind, counts):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        out = fn(*args)
        stop.record()
        rows.append(dict(kind=kind, bounce=site["bounce"], pass_=site["pass_"],
                         round_=site["round_"], events=(start, stop), counts=counts))
        return out

    def isect(*args, **kwargs):
        site.update(bounce=site["bounce"] + 1, pass_=1, round_=0)
        return real_isect(*args, **kwargs)

    def extract(x, slab, blk, F, *rest, **kwargs):
        if F == tpairs.F2:  # pass 2's rounds come after pass 1's
            site.update(pass_=2, round_=site["round_"] if site["pass_"] == 2 else 0)
        return timed_launch(lambda *a: real_extract(*a, **kwargs), (x, slab, blk, F, *rest),
                            "pair_extract", (x.shape[0], (x[:, 7] > 0).sum()))

    def pair_runs(blk_s, featp, cm, ptile, kreal):
        real = blk_s < kreal
        counts = (blk_s.shape[0], real.sum(), torch.unique(blk_s[real]).numel())
        out = timed_launch(real_runs, (blk_s, featp, cm, ptile, kreal), "pair_runs", counts)
        if site["bounce"] == 0:
            kept[len(rows) - 1] = (blk_s.clone(), featp.clone(), cm, ptile, kreal)
        site["round_"] += 1
        return out

    real_isect, real_extract, real_runs = (tint.intersect_mesh_pairs, tpairs.extract,
                                           tpairs.pair_runs)
    # a warm-up iteration first: a kernel's first launch in a process also
    # loads its library and module
    step(torch.zeros((res * res, 3), device=device), prng_key(0), 1)
    with swapped(tint, "intersect_mesh_pairs", isect), swapped(tpairs, "extract", extract), \
            swapped(tpairs, "pair_runs", pair_runs):
        step(torch.zeros((res * res, 3), device=device), prng_key(0), 1)
    sync(device)
    totals = {"pair_extract": [0, 0.0], "pair_runs": [0, 0.0]}
    heavy, heavy_ms = None, -1.0
    for i, r in enumerate(rows):
        ms = r["events"][0].elapsed_time(r["events"][1])
        totals[r["kind"]][0] += 1
        totals[r["kind"]][1] += ms
        c = [int(v) for v in r["counts"]]
        if r["kind"] == "pair_extract":
            what = f"{c[0]} rays, {c[1]} live"
        else:
            what = f"{c[0]} pairs, {c[1]} real, {c[2]} blocks"
            if i in kept and ms > heavy_ms:
                heavy, heavy_ms = i, ms
        log(f"[launches] bounce {r['bounce']} pass {r['pass_']} round {r['round_']} "
            f"{r['kind']}: {what}: {ms:.4f} ms")
    for kind, (count, ms) in totals.items():
        log(f"[launches] {kind}: {count} launches, {ms:.3f} device ms in one iteration")
    if heavy is None:
        raise AssertionError("no pair_runs launch at bounce 0")
    SHAPE_INPUTS["pair_runs bounce 0"] = kept[heavy]
    log(f"[launches] bounce 0's heaviest pair_runs launch ({heavy_ms:.4f} ms) is kept for "
        f"[shapes]")


def phase_bdiag(scene, device) -> dict:
    """Kernel 7 on the pairs the pair_bdiag path hands it at its second
    bounce (1024-pair supertiles): bit for bit against kernel 6 on the
    same pairs, and against its plain version with kernel 6's tolerance;
    that bounce's pair list against the brute-force kernel on every ray."""
    use_full_f32()
    args, kwargs = bounce_args(scene, RenderConfig(trace_depth=8, antialias=True, **BDIAG),
                               "intersect_mesh_pairs", device)
    with Recorder(tpairs, "pair_bdiag", 0) as rb:
        hit, stats = tpairs.intersect_mesh_pairs(*args, **kwargs, collect_stats=True)
    sync(device)
    log(f"[bdiag] bounce 1 stats: {stats}")
    brute_check("[bdiag] pair list (pair_bdiag)", hit, args, kwargs, 2.0 ** -12)
    blk_s, featp, cm, ptile, kreal = rb.args
    SHAPE_INPUTS["pair_bdiag"] = rb.args
    w, block = cm.w, cm.block
    tmxu.check_sparse_pattern(w)  # the sparse test's precondition
    got = tpairs.pair_bdiag(blk_s, featp, cm, ptile, kreal)
    k6 = tpairs.pair_runs(blk_s, featp, cm, 256, kreal)
    want = tpairs._pair_runs_ref(blk_s, featp, w, block, kreal)
    sync(device)
    real = blk_s < kreal
    n_real = int(real.sum())
    if not torch.equal(got, k6):
        raise AssertionError(f"pair_bdiag differs from pair_runs on {int((got != k6).sum())} "
                             f"of {blk_s.shape[0]} pairs")
    tg, lg = tpairs._unpack_tl(got)
    tw, lw = tpairs._unpack_tl(want)
    loc_eq = (lg == lw)[real].float().mean().item()
    both = real & (tg < 1e30) & (tw < 1e30)
    rel = ((tg - tw).abs() / tw.abs().clamp_min(1e-30))[both]
    rel_max = rel.max().item() if rel.numel() else 0.0
    # runs per supertile, and per part of BDIAG_PART pairs (one thread
    # block) the rounds kernel 7 takes for them
    slots = tpairs.PAIR_BDIAG.call_int("pair_bdiag_slots", block, cuda_build.MAX_SMEM)
    tiles = blk_s.reshape(-1, ptile)
    starts = torch.ones_like(tiles, dtype=torch.bool)
    starts[:, 1:] = tiles[:, 1:] != tiles[:, :-1]
    runs = (starts & (tiles < kreal)).sum(dim=1)
    busy = runs > 0
    parts = blk_s.reshape(-1, min(ptile, BDIAG_PART))
    pstarts = torch.ones_like(parts, dtype=torch.bool)
    pstarts[:, 1:] = parts[:, 1:] != parts[:, :-1]
    pruns = (pstarts & (parts < kreal)).sum(dim=1)
    prounds = -(-pruns // slots)
    log(f"[bdiag] pair_bdiag == pair_runs bit for bit on all {blk_s.shape[0]} pairs ({n_real} "
        f"real); against the plain version: packed equal on "
        f"{(got == want)[real].float().mean().item():.6%} of real pairs, loc on {loc_eq:.6%}, "
        f"max |dt|/t {rel_max:.3g}")
    log(f"[bdiag] {int(busy.sum())} of {tiles.shape[0]} supertiles of {ptile} pairs hold real "
        f"pairs: runs per such tile mean {runs[busy].float().mean().item():.2f}, max "
        f"{int(runs.max())}; in parts of {min(ptile, BDIAG_PART)} pairs (a thread block each), "
        f"{int((pruns > 0).sum())} of {parts.shape[0]} hold real pairs, runs per such part mean "
        f"{pruns[pruns > 0].float().mean().item():.2f}, max {int(pruns.max())}; {slots} weight "
        f"slots a round, rounds per busy part mean {prounds[pruns > 0].float().mean().item():.3f}, "
        f"max {int(prounds.max())}, {int((prounds > 1).sum())} parts of several rounds")
    if (got[~real] != tpairs._PBIG).any():
        raise AssertionError("pair_bdiag: a sentinel pair was not left at _PBIG")
    if loc_eq < 0.9999 or rel_max > 2.0 ** -12:
        raise AssertionError("pair_bdiag differs from its plain version beyond its tolerance")
    pbound, pair_tests, blocks_used = pair_bound(blk_s, cm, kreal)
    res = dict(
        max_abs_err=(tg - tw)[both].abs().max().item() if int(both.sum()) else 0.0,
        ms=time_ms(lambda: tpairs.pair_bdiag(blk_s, featp, cm, ptile, kreal), 20),
        plain_ms=time_ms(lambda: tpairs._pair_runs_ref(blk_s, featp, w, block, kreal), 3),
        library_ms=None, **pbound,
        shape=f"{blk_s.shape[0]} pairs ({n_real} real, {blocks_used} blocks) in supertiles of "
              f"{ptile}, blocks of {block} slots, {pair_tests} (real pair, real triangle) tests")
    k6_ms = time_ms(lambda: tpairs.pair_runs(blk_s, featp, cm, 256, kreal), 20)
    log(f"[kernels] pair_bdiag: {res['shape']}; kernel {res['ms']:.4f} ms (pair_runs on the same "
        f"pairs in tiles of 256: {k6_ms:.4f} ms), plain {res['plain_ms']:.4f} ms, bound "
        f"{res['bound_ms']:.4f} ms ({res['bound_by']})")
    log("[kernels] library_ms is null for pair_bdiag: no one PyTorch call computes a masked "
        "first-minimum over each pair's own block")
    return res


def phase_kd(scene, device) -> tuple:
    """The KD builds of the main mesh (native and numpy, seconds and
    statistics; their arrays equal), and the KD walk against the
    brute-force kernel on every ray of the cluster_auto=False path's
    second bounce, as source-mesh triangle ids. Returns that bounce's
    recorded call (args, kwargs)."""
    mesh = scene.mesh
    host = [getattr(mesh, f).cpu().numpy() for f in ("v0", "v1", "v2", "n0", "n1", "n2",
                                                        "material_id")]
    if load_native() is None:
        raise AssertionError("[kd] the native KD builder did not build (g++ missing?)")
    builds = {}
    for backend in ("native", "numpy"):
        t = time.perf_counter()
        builds[backend] = tkd.build_kdtree(*host, leaf_size=32, inline_cap=32, backend=backend)
        log(f"[kd] {backend} KD build of {host[0].shape[0]} triangles (leaf size 32): "
            f"{time.perf_counter() - t:.3f} s")
    if not (np.array_equal(builds["native"].fat.rows, builds["numpy"].fat.rows)
            and np.array_equal(builds["native"].tris.orig_index, builds["numpy"].tris.orig_index)):
        raise AssertionError("[kd] the native and numpy KD builds differ")
    log(f"[kd] tree: {tree_stats(builds['native'])}; fat rows {builds['native'].fat.rows.shape}, "
        f"octant table {'built' if builds['native'].oct is not None else 'not built (over cap)'}")

    args, kwargs = bounce_args(scene, RenderConfig(trace_depth=8, antialias=True, **KD),
                               "intersect_mesh_kd", device)
    origin, direction, kd = args[0], args[1], args[2]
    (hit, stats), ms = timed(lambda: ttrav.intersect_mesh_kd(*args, **kwargs, collect_stats=True),
                             device)
    t_init, active = kwargs["t_init"], kwargs["active"]
    log(f"[kd] bounce 1: {origin.shape[0]} rays ({int(active.sum())} active), {ms:.1f} ms, "
        f"{stats}")
    d_live = torch.where(active[:, None], direction, 0.0)  # dead rays never hit
    hb = tmxu.intersect_brute_mxu(origin, d_live, mesh.v0, mesh.v1, mesh.v2, t_max=t_init)
    src = torch.where(hit.tri >= 0, kd.tris.orig_index[hit.tri.clamp_min(0).long()], -1)
    sync(device)
    frac = (src == hb.tri).float().mean().item()
    both = (hb.tri >= 0) & (hit.tri >= 0)
    rel = ((hit.t - hb.t).abs() / hb.t.abs().clamp_min(1e-30))[both]
    rel_max = rel.max().item() if rel.numel() else 0.0
    # t: the walk's Moller-Trumbore (a reciprocal of the determinant times
    # a dot product) and kernel 8's quotient of two dot products round
    # differently, by more where the determinant is small (grazing hits);
    # 1e-4 relative is the JAX package's own KD-vs-brute bound
    # (tests/test_kdtree.py).
    log(f"[kd] KD walk vs brute-force kernel on all {origin.shape[0]} rays of bounce 1 x "
        f"{mesh.v0.shape[0]} triangles: {int((hb.tri >= 0).sum())} hits; source ids equal on "
        f"{frac:.6%}; max |dt|/t {rel_max:.3g} where both hit, {int((rel > 1e-5).sum())} "
        f"beyond 1e-5 (bound 1e-4)")
    if frac < 0.9999 or rel_max > 1e-4:
        raise AssertionError("[kd] the KD walk differs from the brute force on this bounce")
    return args, kwargs


def phase_goldens(device):
    """The JAX package's committed goldens, rendered by the port: the cases
    of ``tools/goldens.CASES``, and the pair case's scene in the other
    exact intersectors' configs."""
    def golden(name):
        return np.load(os.path.join(GOLDENS, f"{name}.npy"))

    log(f"[golden] cases from tools/goldens.CASES: {', '.join(tgoldens.CASES)}")
    d = np.abs(tgoldens.render_case("cornell_64", device) - golden("cornell_64"))
    log(f"[golden] cornell_64: max |d| {d.max():.3g}, mean |d| {d.mean():.3g} "
        f"(bound: per pixel 2e-3)")
    if d.max() > 2e-3:
        raise AssertionError("cornell_64 differs from its golden beyond atol 2e-3")
    d = np.abs(tgoldens.render_case("cornell_spec_64", device) - golden("cornell_spec_64"))
    off = np.flatnonzero((d > 2e-3).any(axis=-1))
    log(f"[golden] cornell_spec_64: max |d| {d.max():.3g}, mean |d| {d.mean():.3g}; {off.size} "
        f"pixels beyond atol 2e-3 ({', '.join(str(i) for i in off)}) (bound: no pixel but "
        f"{SPEC_JIT_BRANCHED_PIXELS})")
    if not set(off.tolist()) <= set(SPEC_JIT_BRANCHED_PIXELS):
        raise AssertionError("cornell_spec_64 differs from its golden beyond atol 2e-3")

    make_scene, pair_config, spp = tgoldens.CASES["mesh_pairs_48"]
    scene = make_scene(device)
    pair_img = render(scene, pair_config, spp=spp, seed=0, device=device).cpu().numpy()
    d = np.abs(pair_img - golden("mesh_pairs_48"))
    off = np.flatnonzero((d > 2e-3).any(axis=-1))
    log(f"[golden] mesh_pairs_48 (its own pair config): max |d| {d.max():.3g}, mean |d| "
        f"{d.mean():.3g}; {off.size} of {d.shape[0] * d.shape[1]} pixels beyond atol 2e-3 "
        f"({', '.join(str(i) for i in off)}) (bound: no pixel but {JIT_BRANCHED_PIXELS}, "
        f"mean 2e-4: the golden's jit fused multiply-adds, which branches those two)")
    if not set(off.tolist()) <= set(JIT_BRANCHED_PIXELS) or d.mean() > 2e-4:
        raise AssertionError("mesh_pairs_48 differs from its golden beyond its bound")
    # the other exact intersectors: within the golden tests' cross-mode
    # bound (the cluster configs of tests/test_cluster.py:206-207 and
    # tests/test_golden.py:78-81)
    for label, kw in (("walk", WALK), ("cluster rounds", dict(cluster_rounds=6, **CLUSTER)),
                      ("binned", dict(binned_rounds=8, **BINNED))):
        img = render(scene, dataclasses.replace(pair_config, **kw), spp=spp, seed=0,
                     device=device).cpu().numpy()
        d = np.abs(img - golden("mesh_pairs_48"))
        log(f"[golden] mesh_pairs_48 ({label} config): max |d| {d.max():.3g}, mean |d| "
            f"{d.mean():.3g}, mean |d| against the port's pair render "
            f"{np.abs(img - pair_img).mean():.3g} (bound: mean 1e-2)")
        if d.mean() > 1e-2:
            raise AssertionError(f"mesh_pairs_48 ({label}) differs from its golden beyond "
                                 f"mean 1e-2")

    # the KD golden: icosphere-2 (320 triangles) in the default config
    make_scene, config, _ = tgoldens.CASES["mesh_kd_48"]
    scene = make_scene(device)
    route = tint.mesh_route(scene.mesh, scene.cmesh, config, scene.kd)
    d = np.abs(tgoldens.render_case("mesh_kd_48", device) - golden("mesh_kd_48"))
    off = np.flatnonzero((d > 2e-3).any(axis=-1))
    log(f"[golden] mesh_kd_48 (route {route}): max |d| {d.max():.3g}, mean |d| {d.mean():.3g}; "
        f"{off.size} pixels beyond atol 2e-3 ({', '.join(str(i) for i in off)}) (bound: no "
        f"pixel but {JIT_BRANCHED_PIXELS}, mean 2e-4)")
    if route != "kd" or not set(off.tolist()) <= set(JIT_BRANCHED_PIXELS) or d.mean() > 2e-4:
        raise AssertionError("mesh_kd_48 differs from its golden beyond its bound")


def phase_main_path(name, scene, config, device, expect, block: int = 2,
                    timed_calls: int = 3, profile: bool = True, repair: str = None,
                    absent=()) -> dict:
    """One render path at full size; every launch count is zeroed just
    before it and read just after. ``expect`` names the kernels that
    must launch on it, ``absent`` those that must not; ``repair`` names the
    integrator's intersector whose flagged rays and repair (or, for the
    KD walk, steps and host reads) of every bounce the path reports. A
    path whose warm-up takes more than SLOW_ITERATION_MS an iteration is
    timed as one call of one iteration. The image and its iteration count
    go into IMAGES[name]."""
    res = int(scene.camera.resolution[0])
    n = res * res
    step = make_render_block_fn(scene, config, block, device=device)
    key = prng_key(0)
    zero_counts()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    # index -1 records nothing: it only counts the pair path's set-size reads
    with Recorder(tpairs, "_compact_all", -1) as reads, \
            (RepairStats(repair) if repair else contextlib.nullcontext()) as stats:
        t = time.perf_counter()
        film = step(torch.zeros((n, 3), device=device), key, 1)  # warm-up
        sync(device)
        warm_ms = (time.perf_counter() - t) * 1e3 / block
        it = 1 + block
        if warm_ms > SLOW_ITERATION_MS:
            log(f"[main:{name}] warm-up {warm_ms:.1f} ms/iteration: timed as one call of one "
                f"iteration")
            block, timed_calls = 1, 1
            step = make_render_block_fn(scene, config, block, device=device)
        per_iter = []
        for _ in range(timed_calls):
            t = time.perf_counter()
            film = step(film, key, it)
            sync(device)
            per_iter.append((time.perf_counter() - t) * 1e3 / block)
            it += block
    launches = read_counts()
    img = film / (it - 1)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    ms = statistics.median(per_iter)
    depth = config.effective_depth
    iters = it - 1
    log(f"[main:{name}] {res}x{res}, depth {depth}, {int(scene.mesh.v0.shape[0])} triangles: "
        f"{ms:.2f} ms/iteration (median of {timed_calls} calls x {block} iterations: "
        f"{', '.join(f'{v:.2f}' for v in per_iter)}), "
        f"{n * depth / (ms / 1e3):.4g} rays/s, peak memory {peak / 2**20:.1f} MiB")
    log(f"[main:{name}] launches over {iters} iterations: {launches}")
    if name.startswith("pairs"):
        # each _compact_all reads a set size on the host; each bounce also
        # reads whether any ray is left for pass 3
        log(f"[main:{name}] host reads per iteration: "
            f"{(reads.calls + depth * iters) / iters:.1f}")
    if stats is not None and repair == "intersect_mesh_kd":
        reads_it = sum(c["host_reads"] for c in stats.calls) / iters
        log(f"[main:{name}] host reads per iteration: {reads_it:.1f} (the walk's loop "
            f"condition, once per {config.traversal_unroll} steps)")
        log(f"[main:{name}] over {iters} iterations, {stats.walk_per_bounce(depth)}")
    elif stats is not None:
        # each call reads its flagged-ray count on the host
        log(f"[main:{name}] host reads per iteration: {len(stats.calls) / iters:.1f}")
        log(f"[main:{name}] over {iters} iterations, {stats.per_bounce(depth)}")
    missing = [k for k in expect if launches[k] == 0]
    if missing:
        raise AssertionError(f"{missing} not launched on the {name} path: {launches}")
    stray = [k for k in absent if launches[k]]
    if stray:
        raise AssertionError(f"{stray} launched on the {name} path: {launches}")
    IMAGES[name] = (img, iters)
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


def leaf_tris(cmesh):
    """``cmesh`` with fresh leaf copies of its vertex and normal tables that
    require grad, and the leaves."""
    tris = cmesh.tris._replace(**{
        f: getattr(cmesh.tris, f).detach().clone().requires_grad_(True) for f in TRI_FIELDS})
    return with_tris(cmesh, tris), [getattr(tris, f) for f in TRI_FIELDS]


def timed(fn, device):
    """(fn(), its host time in ms up to a device synchronise)."""
    sync(device)
    t = time.perf_counter()
    out = fn()
    sync(device)
    return out, (time.perf_counter() - t) * 1e3


def phase_train(scene, device) -> dict:
    """12 training steps on the pair path at full width (the JAX package's
    exp/grad_bench.py and tests/test_grad.py:76-97): the target is the
    port's render of the true materials (spp 1, seed 1); the steps start
    from halved colours and use that render's key and iteration."""
    config = RenderConfig(trace_depth=8, antialias=True)  # the default pair path
    res = int(scene.camera.resolution[0])
    n = res * res
    target = render(scene, config, spp=1, seed=1, device=device).reshape(n, 3)
    key = prng_key(1)
    perturbed = scene._replace(materials=scene.materials._replace(
        color=np.asarray(scene.materials.color) * 0.5))
    init_state, train_step = make_train_step(perturbed, config, target, learning_rate=2e-2,
                                             device=device)
    state = init_state()
    zero_counts()
    torch.cuda.reset_peak_memory_stats(device)
    losses, step_ms = [], []
    for _ in range(12):
        (state, loss), ms = timed(lambda: train_step(state, key, 1), device)
        losses.append(loss.item())
        step_ms.append(ms)
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated(device)
    log(f"[train] {res}x{res}, depth 8, {int(scene.mesh.v0.shape[0])} triangles, pair path, "
        f"Adam lr 2e-2, 12 steps; losses: {', '.join(f'{v:.6g}' for v in losses)}")
    log(f"[train] ms/step {statistics.median(step_ms[1:4]):.2f} (median of steps 2-4; all: "
        f"{', '.join(f'{v:.1f}' for v in step_ms)}), peak memory {peak / 2**20:.1f} MiB")
    log(f"[train] launches over the 12 steps: {launches}")
    # the forward/backward split, three times, without an optimizer step
    fwd, bwd = [], []
    for _ in range(3):
        loss, ms_f = timed(lambda: render_loss(state.materials, perturbed, config, key, 1,
                                               target), device)
        _, ms_b = timed(lambda: torch.autograd.grad(loss, list(state.materials),
                                                    allow_unused=True), device)
        fwd.append(ms_f)
        bwd.append(ms_b)
    log(f"[train] forward {statistics.median(fwd):.2f} ms, backward {statistics.median(bwd):.2f} "
        f"ms (medians of 3: {', '.join(f'{a:.1f}/{b:.1f}' for a, b in zip(fwd, bwd))})")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"[train] non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"[train] the loss did not fall: {losses}")
    return launches


def check_scatter(label, ct, tri, nt) -> dict:
    """Kernel 4 against its plain version on (ct, tri): per entry within
    1e-5 of the sum of |contributions|; its time, bound and index_add_'s."""
    got = tmesh.scatter_cols(ct, tri, nt)
    want = tmesh._scatter_cols_ref(ct, tri, nt)
    scale = tmesh._scatter_cols_ref(ct.abs(), tri, nt)
    sync(ct.device)
    err = (got - want).abs()
    lanes = int((ct != 0).any(dim=0).sum())
    worst = (err / scale.clamp_min(1e-30))[scale > 0]
    log(f"[geomgrad] scatter_cols on {label}: ct [{ct.shape[0]},{ct.shape[1]}] ({lanes} lanes "
        f"with a non-zero cotangent), table [{nt},{ct.shape[0]}]; max |d| {err.max().item():.3g}, "
        f"max |d| / sum|contributions| {worst.max().item() if worst.numel() else 0.0:.3g} "
        f"(bound 1e-5)")
    if not (err <= 1e-5 * scale).all():
        raise AssertionError(f"scatter_cols differs from its plain version on {label}")
    c, n = ct.shape
    tri64 = tri.long()
    res = dict(
        max_abs_err=err.max().item(),
        ms=time_ms(lambda: tmesh.scatter_cols(ct, tri, nt), 20),
        plain_ms=time_ms(lambda: tmesh._scatter_cols_ref(ct, tri, nt), 10),
        # one PyTorch call for the same [T, C] result (into a zeroed table)
        library_ms=time_ms(lambda: torch.zeros((nt, c), device=ct.device).index_add_(
            0, tri64, ct.T), 20),
        **bound((c * n + n + nt * c) * 4, c * n))
    log(f"[geomgrad] scatter_cols on {label}: kernel {res['ms']:.4f} ms, plain "
        f"{res['plain_ms']:.4f} ms, index_add_ {res['library_ms']:.4f} ms, bound "
        f"{res['bound_ms']:.4f} ms ({res['bound_by']})")
    return res


def phase_geomgrad(scene, device):
    """One reverse pass of the render MSE with respect to the materials and
    the vertex and normal tables, at full width. Returns (kernel 4's
    result on one bounce's captured cotangents, the launch counts)."""
    config = RenderConfig(trace_depth=8, antialias=True, enable_sss=True)
    res = int(scene.camera.resolution[0])
    n = res * res
    true_scene, mesh_mat = with_sss(scene)
    target = render(true_scene, config, spp=1, seed=1, device=device).reshape(n, 3)
    mats = materials_to_torch(true_scene.materials, device, requires_grad=True)
    with torch.no_grad():
        mats.color.mul_(0.5)
    key = prng_key(1)
    zero_counts()
    torch.cuda.reset_peak_memory_stats(device)
    with Recorder(tmesh, "scatter_cols", 0) as rec:
        cm, leaves = leaf_tris(scene.cmesh)
        gscene = scene._replace(cmesh=cm)
        loss, ms_f = timed(lambda: render_loss(mats, gscene, config, key, 1, target), device)
        grads, ms_b = timed(lambda: torch.autograd.grad(loss, list(mats) + leaves,
                                                        allow_unused=True), device)
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated(device)
    log(f"[geomgrad] {res}x{res}, depth 8, SSS on the icosphere: loss {loss.item():.6g}; "
        f"forward {ms_f:.2f} ms, backward {ms_b:.2f} ms, peak memory {peak / 2**20:.1f} MiB")
    log(f"[geomgrad] launches: {launches} (kernel 4 once per bounce whose hit distance a "
        f"later bounce reads: every bounce but the last)")
    tri_grads = grads[len(mats):]
    for name, g in zip(TRI_FIELDS, tri_grads):
        if g is None or not torch.isfinite(g).all():
            raise AssertionError(f"[geomgrad] the {name} gradient is missing or not finite")
        log(f"[geomgrad] d loss / d {name}: max |g| {g.abs().max().item():.4g}, "
            f"{int((g != 0).any(dim=1).sum())} of {g.shape[0]} rows non-zero")
    if not any(g.abs().max().item() > 0 for g in tri_grads):
        raise AssertionError("[geomgrad] every vertex and normal gradient is zero")
    if not all(g is None or torch.isfinite(g).all() for g in grads[:len(mats)]):
        raise AssertionError("[geomgrad] a material gradient is not finite")
    nt = scene.cmesh.packed.shape[0]
    ct, tri, _ = rec.args
    result = check_scatter(f"the last bounce the reverse pass reaches (call 1 of "
                           f"{rec.calls})", ct, tri, nt)

    # a denser input on the same path: the depth AOV of the camera rays
    # that hit the mesh (every such lane has a non-zero cotangent)
    rays = generate_rays(scene.camera, config, bounce_key(key, 1, 0), 1, device)
    with Recorder(tmesh, "scatter_cols", 0) as rec2:
        cm, leaves = leaf_tris(scene.cmesh)
        hit = tint.intersect_scene(rays.origin, rays.direction, scene.geoms, scene.mesh,
                                   config, cmesh=cm)
        on_mesh = hit.material_id == mesh_mat
        torch.autograd.grad(torch.where(on_mesh & (hit.t < BIG), hit.t, 0.0).sum(), leaves,
                            allow_unused=True)
    ct, tri, _ = rec2.args
    check_scatter(f"the depth AOV of {int(on_mesh.sum())} camera rays on the mesh", ct, tri, nt)
    return result, launches


def phase_gradcheck(device) -> None:
    """tests/test_grad.py's pair-path finite-difference checks on the card,
    at the mesh_pairs_48 scene: the largest colour gradient (eps 3e-3,
    within 2e-2) and the three largest vertex depth-AOV gradients (eps
    1e-3, two of three within 1e-1)."""
    scene = mesh_scene(4, 2.0, 48, device)
    config = RenderConfig(trace_depth=4, cluster_tile=256, **PAIRS)
    key = prng_key(0)
    target = torch.zeros((48 * 48, 3), device=device)
    mats = materials_to_torch(scene.materials, device, requires_grad=True)
    (g,) = torch.autograd.grad(render_loss(mats, scene, config, key, 1, target), mats.color)
    i, c = divmod(int(g.abs().argmax()), 3)

    def loss_at(eps):
        m = materials_to_torch(scene.materials, device)
        m.color[i, c] += eps
        with torch.no_grad():
            return render_loss(m, scene, config, key, 1, target).item()

    fd = (loss_at(3e-3) - loss_at(-3e-3)) / 6e-3
    ad = g[i, c].item()
    log(f"[gradcheck] mesh_pairs_48 scene, material color[{i},{c}]: AD {ad:.6g}, FD {fd:.6g} "
        f"(bound 2e-2 relative)")
    if not abs(fd - ad) <= 2e-2 * max(abs(fd), abs(ad), 1e-3):
        raise AssertionError("[gradcheck] material gradient differs from finite differences")

    rays = generate_rays(scene.camera, config, bounce_key(key, 1, 0), 1, device)
    o, d = (v3_to_rows(v) for v in (rays.origin, rays.direction))
    with torch.no_grad():
        win = tpairs.intersect_mesh_pairs(o, d, scene.cmesh, config).tri
    rows, counts = torch.unique(win[win >= 0], return_counts=True)
    lane_mask = win == rows[counts.argmax()]

    def depth_loss(v0):
        cm = with_tris(scene.cmesh, scene.cmesh.tris._replace(v0=v0))
        hit = tint.intersect_scene(o, d, scene.geoms, scene.mesh, config, cmesh=cm)
        return torch.where(lane_mask & (hit.t < BIG), hit.t, 0.0).sum()

    v0 = scene.cmesh.tris.v0.detach().clone().requires_grad_(True)
    (gd,) = torch.autograd.grad(depth_loss(v0), v0)
    results = []
    for idx in gd.abs().flatten().argsort()[-3:].tolist():
        i, c = divmod(idx, 3)
        e = torch.zeros_like(v0)
        e[i, c] = 1e-3
        with torch.no_grad():
            fd = (depth_loss(v0 + e) - depth_loss(v0 - e)).item() / 2e-3
        results.append((gd[i, c].item(), fd))
    agree = sum(abs(f - a) <= 1e-1 * max(abs(f), abs(a), 1e-3) for a, f in results)
    log(f"[gradcheck] vertex depth AOV ({int(lane_mask.sum())} lanes on one triangle), (AD, FD): "
        f"{', '.join(f'({a:.6g}, {f:.6g})' for a, f in results)}; {agree} of 3 within 1e-1 "
        f"(bound: 2 of 3)")
    if agree < 2:
        raise AssertionError("[gradcheck] vertex gradients differ from finite differences")


def with_sss(scene):
    """``scene`` with SSS_TRANSMITTANCE on its mesh's one material."""
    mesh_mats = np.unique(scene.mesh.material_id.cpu().numpy())
    if mesh_mats.size != 1:
        raise AssertionError(f"the mesh has materials {mesh_mats}, expected one")
    trans = np.array(scene.materials.transmittance)
    trans[int(mesh_mats[0])] = SSS_TRANSMITTANCE
    materials = scene.materials._replace(transmittance=trans)
    return scene._replace(materials=materials), int(mesh_mats[0])


def source_verts(mesh, faces) -> torch.Tensor:
    """The [V, 3] vertex table whose ``faces`` give ``mesh``'s triangles
    (the loaded OBJ's own values, bit for bit)."""
    f = torch.as_tensor(faces, device=mesh.v0.device).long()
    verts = torch.zeros((int(f.max()) + 1, 3), device=mesh.v0.device)
    for c, v in enumerate((mesh.v0, mesh.v1, mesh.v2)):
        verts[f[:, c]] = v
    if not all(torch.equal(verts[f[:, c]], v) for c, v in enumerate((mesh.v0, mesh.v1, mesh.v2))):
        raise AssertionError("the mesh's triangles do not share the faces' vertices")
    return verts


def primal_render(scene, config, verts, faces):
    """One iteration of ``scene`` (key 0, iteration 1) on the KD table
    ``edgegrad.retris`` builds from ``verts``, without a graph."""
    device = verts.device
    f = torch.as_tensor(faces, device=device).long()
    mats = materials_to_torch(scene.materials, device)
    with torch.no_grad():
        rays = generate_rays(scene.camera, config, bounce_key(prng_key(0), 1, 0),
                             config.effective_depth, device)
        mesh_t = scene.mesh._replace(v0=verts[f[:, 0]], v1=verts[f[:, 1]], v2=verts[f[:, 2]])
        return tint.trace_rays(rays, scene.geoms, mats, mesh_t, config, prng_key(0), 1,
                               kd=tedge.retris(scene.kd, verts, f))


def phase_edgegrad(small, device) -> dict:
    """``make_render_geo`` on the kd path's scene (Cornell + icosphere(2),
    320 triangles, 800x800, depth 8, AA on), with the icosphere subsurface
    so that the interior gradient reaches the geometry (and kernel 4
    launches in its reverse pass), EDGE_SAMPLES samples an edge and the
    secondary term from EDGE_VIEWPOINTS viewpoints: one forward and one
    backward of the mean of the image weighted by a column ramp (under a
    plain mean the camera's gradient is about 0). Logs the forward, the
    interior backward and the boundary terms' ms, peak memory, the
    silhouette edges and alive samples of both terms and the launches;
    kernels 3 and 4 must launch, the gradients be finite and the boundary
    part non-zero. Then tests/test_edgegrad.py's occluder check (vertex)
    on the card: the two largest vertex components of the boundary
    gradient at 32x32 within 0.25 of finite differences of an 8 x 8
    supersampled render. Returns the launch counts of the 800x800 pass."""
    config = RenderConfig(trace_depth=8, antialias=True, enable_sss=True)
    scene, _ = with_sss(small)
    res = int(scene.camera.resolution[0])
    faces = icosphere(2, radius=2.5, center=(0.0, 3.0, 0.0))[1]
    verts0 = source_verts(scene.mesh, faces)
    terms, term_ms = {}, {}

    def timed_term(name, fn):
        """``fn`` with its stats and device-synchronised time kept."""
        def wrapped(*args, **kwargs):
            out, ms = timed(lambda: fn(*args, **kwargs, collect_stats=True), device)
            terms[name], term_ms[name] = out, ms
            return out[0] if len(out) == 2 else out[:2]
        return wrapped

    rg = tedge.make_render_geo(scene, verts0, faces, config, samples_per_edge=EDGE_SAMPLES,
                               secondary_viewpoints=EDGE_VIEWPOINTS, device=device)
    ramp = (torch.arange(res * res, device=device) % res).to(torch.float32)[:, None] / res
    verts = verts0.clone().requires_grad_(True)
    cam = torch.tensor(np.asarray(scene.camera.position, np.float32), device=device,
                       requires_grad=True)
    zero_counts()
    torch.cuda.reset_peak_memory_stats(device)
    with swapped(tedge, "boundary_image_grad", timed_term("primary", tedge.boundary_image_grad)), \
            swapped(tedge, "boundary_secondary_grad",
                    timed_term("secondary", tedge.boundary_secondary_grad)):
        img, ms_f = timed(lambda: rg(verts, cam, prng_key(0), 1), device)
        loss = torch.mean(img * ramp)
        (g_verts, g_cam), ms_b = timed(lambda: torch.autograd.grad(loss, (verts, cam)), device)
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated(device)
    d_prim_v, d_prim_c, st1 = terms["primary"]
    d_sec_v, st2 = terms["secondary"]
    boundary_ms = term_ms["primary"] + term_ms["secondary"]
    log(f"[edgegrad] {res}x{res}, depth 8, SSS on the icosphere, {int(faces.shape[0])} triangles, "
        f"{len(tedge.build_edges(faces).va)} edges, {EDGE_SAMPLES} samples an edge, "
        f"{EDGE_VIEWPOINTS} viewpoints: loss {loss.item():.6g}; forward {ms_f:.2f} ms, backward "
        f"{ms_b:.2f} ms (interior {ms_b - boundary_ms:.2f} ms, boundary {boundary_ms:.2f} ms: "
        f"primary {term_ms['primary']:.2f}, secondary {term_ms['secondary']:.2f}), peak memory "
        f"{peak / 2**20:.1f} MiB")
    log(f"[edgegrad] primary: {int(st1['silhouette'].sum())} silhouette edges, "
        f"{int(st1['framed'].sum())} samples on screen, {int(st1['alive'].sum())} alive, "
        f"{st1['probe_rays']} probe rays; secondary: {int(st2['diffuse'].sum())} diffuse "
        f"viewpoints, {int(st2['silhouette'].sum())} (viewpoint, silhouette edge) pairs, "
        f"{int(st2['framed'].sum())} samples above the horizon, {int(st2['alive'].sum())} alive, "
        f"{st2['probe_rays']} probe rays")
    log(f"[edgegrad] launches: {launches}")
    boundary_v, boundary_c = d_prim_v + d_sec_v, d_prim_c
    log(f"[edgegrad] d loss / d verts: max |g| {g_verts.abs().max().item():.4g} (boundary "
        f"{boundary_v.abs().max().item():.4g}, secondary {d_sec_v.abs().max().item():.4g}); "
        f"d loss / d cam_pos {[round(v, 8) for v in g_cam.tolist()]} (boundary "
        f"{[round(v, 8) for v in boundary_c.tolist()]})")
    missing = [k for k in ("gather_cols", "scatter_cols") if launches[k] == 0]
    if missing:
        raise AssertionError(f"[edgegrad] {missing} not launched: {launches}")
    if not (torch.isfinite(g_verts).all() and torch.isfinite(g_cam).all()):
        raise AssertionError("[edgegrad] a gradient is not finite")
    if not (boundary_v.abs().max().item() > 0 and boundary_c.abs().max().item() > 0):
        raise AssertionError("[edgegrad] the boundary term is zero")

    # the occluder check
    t = time.perf_counter()
    os.makedirs(WORK, exist_ok=True)
    path = os.path.join(WORK, "occluder.obj")
    with open(path, "w") as f:
        f.writelines(f"v {x} {y} {z}\n" for x, y, z in OCCLUDER)
        f.write("f 1 2 3\n")
    occ = load_scene(CORNELL, obj_path=path, device=device)
    color = np.array(occ.materials.color)
    color[-1] = (0.02, 0.02, 0.02)  # dark against the white back wall
    occ = occ._replace(materials=occ.materials._replace(color=color))
    lo = with_resolution(occ, OCCLUDER_RES, OCCLUDER_RES)
    hi = with_resolution(occ, OCCLUDER_RES * OCCLUDER_SS, OCCLUDER_RES * OCCLUDER_SS)
    ofaces = np.array([[0, 1, 2]], np.int32)
    ocfg = RenderConfig(trace_depth=1, antialias=False)
    overts = source_verts(lo.mesh, ofaces)
    org = tedge.make_render_geo(lo, overts, ofaces, ocfg, samples_per_edge=OCCLUDER_SAMPLES,
                                device=device)
    v = overts.clone().requires_grad_(True)
    ocam = torch.tensor(np.asarray(lo.camera.position, np.float32), device=device)
    (gv,) = torch.autograd.grad(torch.mean(org(v, ocam, prng_key(0), 1)), v)
    results = []
    for idx in gv.abs().flatten().argsort()[-2:].tolist():
        i, c = divmod(idx, 3)
        e = torch.zeros_like(overts)
        e[i, c] = OCCLUDER_EPS
        fd = (primal_render(hi, ocfg, overts + e, ofaces).mean().item()
              - primal_render(hi, ocfg, overts - e, ofaces).mean().item()) / (2 * OCCLUDER_EPS)
        results.append((i, c, gv[i, c].item(), fd))
    log(f"[edgegrad] occluder, {OCCLUDER_RES}x{OCCLUDER_RES}, {OCCLUDER_SAMPLES} samples an edge, "
        f"FD at SS {OCCLUDER_SS}, eps {OCCLUDER_EPS} (bound 0.25 of the larger): "
        + ", ".join(f"vertex[{i},{c}] AD {a:.6g} FD {f:.6g}" for i, c, a, f in results)
        + f" ({time.perf_counter() - t:.1f} s)")
    for i, c, ad, fd in results:
        if not abs(fd - ad) <= 0.25 * max(abs(fd), abs(ad)):
            raise AssertionError(f"[edgegrad] occluder vertex[{i},{c}]: AD {ad} against FD {fd}")
    return launches


# The KD walks of [kdwalks], each held against kernel 8 as [kd] holds the
# default fat-row skip-link walk: the fat-row short-stack walk (the
# reference's key L, the command line's --short-stack), packets of 32, and
# the thin-table walks (fat_rows=False).
KD_WALKS = {
    "fatrow_shortstack": dict(short_stack=True),
    "packet": dict(packet_size=32),
    "skiplink": dict(fat_rows=False),
    "shortstack": dict(fat_rows=False, short_stack=True),
    "pushdown": dict(fat_rows=False, short_stack=True, push_down_restart=True),
}
THIN_WALKS = ("skiplink", "shortstack", "pushdown")


def check_walk(label: str, walk: str, args, kwargs, mesh, base, device,
               check: bool = True) -> None:
    """One KD walk on a recorded bounce call against the brute-force
    kernel: source-mesh ids on >= 99.99% of the rays the step bound did not
    cut, t within 1e-4 + 1e-4 |t| where both hit (the JAX package's
    KD-vs-brute bound, tests/test_kdtree.py: second-bounce rays start 1e-4
    off a surface, so t can be that small); with its ms, steps, host
    reads, cut lanes and peak memory, and its t against ``base``, the
    default walk's hit on the same call. ``check=False`` prints the
    agreement without holding the walk to it."""
    origin, direction, kd = args[0], args[1], args[2]
    t_init, active = kwargs["t_init"], kwargs["active"]
    config = RenderConfig(**KD_WALKS[walk])
    torch.cuda.reset_peak_memory_stats(device)
    (hit, stats), ms = timed(lambda: ttrav.intersect_mesh_kd(
        origin, direction, kd, config, t_init=t_init, active=active, collect_stats=True), device)
    peak = torch.cuda.max_memory_allocated(device)
    # the thin walks take no active: every lane walks, as in the JAX package
    d = direction if walk in THIN_WALKS else torch.where(active[:, None], direction, 0.0)
    hb = tmxu.intersect_brute_mxu(origin, d, mesh.v0, mesh.v1, mesh.v2, t_max=t_init)
    src = torch.where(hit.tri >= 0, kd.tris.orig_index[hit.tri.clamp_min(0).long()], -1)
    uncut = ~stats["cut_rays"]
    frac = (src == hb.tri)[uncut].float().mean().item()
    both = (hb.tri >= 0) & (hit.tri >= 0) & uncut
    dt = (hit.t - hb.t).abs()[both]
    over = (dt > 1e-4 + 1e-4 * hb.t.abs()[both]).sum().item()
    over_rel = (dt > 1e-4 * hb.t.abs()[both]).sum().item()
    rel = (dt / hb.t.abs()[both].clamp_min(1e-30)).max().item() if dt.numel() else 0.0
    same = (hit.tri >= 0) & (base.tri >= 0) & active
    d_base = (hit.t - base.t).abs()[same].max().item() if same.any() else 0.0
    log(f"[kdwalks] {label} {walk}: {origin.shape[0]} rays x {mesh.v0.shape[0]} triangles, "
        f"{ms:.1f} ms, {stats['steps']} steps, {stats['host_reads']} host reads, "
        f"{stats['cut']} {'packets' if walk == 'packet' else 'lanes'} cut "
        f"({int(stats['cut_rays'].sum())} rays), peak memory {peak / 2**20:.1f} MiB; "
        f"against kernel 8: {int((hb.tri >= 0).sum())} hits, source ids equal on {frac:.6%} of "
        f"the uncut rays, max |dt| {dt.max().item() if dt.numel() else 0.0:.3g} (max |dt|/t "
        f"{rel:.3g}: {over_rel} beyond 1e-4 t), {over} beyond 1e-4 + 1e-4 t; max |dt| "
        f"against the default walk "
        f"{d_base:.3g}" + ("" if check else " (not held: printed only)"))
    if check and (frac < 0.9999 or over):
        raise AssertionError(f"[kdwalks] the {walk} walk differs from the brute force on "
                             f"{label}")


def render_iterations(scene, config, device, max_iters: int = 3):
    """Iterations 1.. of ``config`` (key 0) through make_render_block_fn,
    one a call, stopping after the first that takes more than
    SLOW_ITERATION_MS -> (films after each iteration, ms of each,
    launches, peak memory, the KD walk's per-call stats)."""
    res = int(scene.camera.resolution[0])
    step = make_render_block_fn(scene, config, 1, device=device)
    film = torch.zeros((res * res, 3), device=device)
    films, ms = [], []
    zero_counts()
    torch.cuda.reset_peak_memory_stats(device)
    with RepairStats("intersect_mesh_kd") as stats:
        for it in range(1, max_iters + 1):
            film, t = timed(lambda: step(film, prng_key(0), it), device)
            films.append(film.clone())
            ms.append(t)
            if t > SLOW_ITERATION_MS:
                break
    return films, ms, read_counts(), torch.cuda.max_memory_allocated(device), stats


def phase_kdwalks(small, big_call, mesh, device) -> dict:
    """Every other KD walk on every ray of the kd path's second bounce
    (320 triangles) and on the kd_big path's (81,920: the fat-row ones
    held, the thin ones printed), each against kernel 8; then each renders
    the kd scene at 800x800, depth 8, beside the default walk's image of
    the same iterations (3, or 1 where an iteration takes over 2 s)."""
    calls = (("kd bounce 1", bounce_args(small, RenderConfig(trace_depth=8, antialias=True),
                                         "intersect_mesh_kd", device), small.mesh),
             ("kd_big bounce 1", big_call, mesh))
    for label, (args, kwargs), tris in calls:
        base, ms = timed(lambda: ttrav.intersect_mesh_kd(*args, **kwargs), device)
        log(f"[kdwalks] {label}: the default walk (fat-row skip-link) {ms:.1f} ms")
        for walk in KD_WALKS:
            check_walk(label, walk, args, kwargs, tris, base, device,
                       check=label.startswith("kd ") or walk not in THIN_WALKS)

    launches = {}
    res = int(small.camera.resolution[0])
    base, _, _, _, _ = render_iterations(small, RenderConfig(trace_depth=8, antialias=True),
                                         device)
    for walk, kw in KD_WALKS.items():
        config = RenderConfig(trace_depth=8, antialias=True, **kw)
        films, ms, launches[walk], peak, stats = render_iterations(small, config, device)
        iters = len(films)
        img, want = films[-1] / iters, base[iters - 1] / iters
        calls = stats.calls
        log(f"[kdwalks] render {walk}: {res}x{res}, depth 8, {iters} iterations, ms "
            f"{', '.join(f'{t:.1f}' for t in ms)} (the first with its warm-up), peak memory "
            f"{peak / 2**20:.1f} MiB, host reads per iteration "
            f"{sum(c['host_reads'] for c in calls) / iters:.1f}, lanes cut "
            f"{sum(c['cut'] for c in calls)}; launches {launches[walk]}")
        log(f"[kdwalks] render {walk}: {stats.walk_per_bounce(8)}")
        log(f"[kdwalks] render {walk}: image mean {img.mean().item():.4f}, max |d| against the "
            f"default walk's {(img - want).abs().max().item():.4g}, mean |d| "
            f"{(img - want).abs().mean().item():.4g}")
        if not torch.isfinite(img).all() or not img.mean().item() > 0:
            raise AssertionError(f"[kdwalks] the {walk} image is not finite or is black")
        if not launches[walk]["gather_cols"]:
            raise AssertionError(f"[kdwalks] gather_cols not launched on the {walk} render")
    return {k: sum(v[k] for v in launches.values()) for k in launches["packet"]}


def phase_extras(scene, device) -> dict:
    """The wavefront extras on the default pair path at 800x800, depth 8:
    compaction and the material sort (partial_gather off) give the default
    film bit for bit over iterations 1-2; the ray cache gives iteration
    1's film; the KD view of the scene's tree."""
    res = int(scene.camera.resolution[0])
    key = prng_key(0)
    films, total = {}, {}
    for label, kw in (("default", {}), ("compaction", dict(compaction=True)),
                      ("material_sort", dict(material_sort=True))):
        step = make_render_block_fn(scene, RenderConfig(trace_depth=8, antialias=True, **kw), 1,
                                    device=device)
        zero_counts()
        film = torch.zeros((res * res, 3), device=device)
        film, ms1 = timed(lambda: step(film, key, 1), device)
        first = film.clone()
        film, ms2 = timed(lambda: step(film, key, 2), device)
        launches = read_counts()
        films[label] = (first, film)
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        log(f"[extras] {label}: ms per iteration {ms1:.2f} (iteration 1), {ms2:.2f} "
            f"(iteration 2); launches {launches}")
        missing = [k for k in ("pair_extract", "pair_runs", "gather_cols") if not launches[k]]
        if missing:
            raise AssertionError(f"[extras] {missing} not launched with {label}")
    for label in ("compaction", "material_sort"):
        d = (films[label][1] - films["default"][1]).abs().max().item()
        log(f"[extras] {label} film against the default's after 2 iterations: max |d| {d:.3g} "
            f"(bound: bit for bit)")
        if not torch.equal(films[label][1], films["default"][1]):
            raise AssertionError(f"[extras] the {label} film differs from the default's")

    step = tint.make_render_fn(scene, RenderConfig(trace_depth=8, antialias=True, ray_cache=True),
                               seed=0, device=device)
    film, ms = timed(lambda: step(torch.zeros((res * res, 3), device=device), key, 1), device)
    d = (film - films["default"][0]).abs().max().item()
    log(f"[extras] ray_cache: iteration 1 in {ms:.2f} ms (camera rays drawn at build), max |d| "
        f"against the uncached iteration 1: {d:.3g} (bound: bit for bit)")
    if not torch.equal(film, films["default"][0]):
        raise AssertionError("[extras] the ray cache's iteration 1 differs from the uncached one")

    rays = generate_rays(scene.camera, RenderConfig(trace_depth=8, antialias=True),
                         bounce_key(key, 1, 0), 1, device)
    render_kd_boxes(rays.origin, rays.direction, scene.kd)  # warm-up
    torch.cuda.reset_peak_memory_stats(device)
    img, ms = timed(lambda: render_kd_boxes(rays.origin, rays.direction, scene.kd), device)
    log(f"[extras] render_kd_boxes: {res}x{res} rays x {scene.kd.nodes.axis.shape[0]} nodes "
        f"(chunks of 256): {ms:.2f} ms, peak memory "
        f"{torch.cuda.max_memory_allocated(device) / 2**20:.1f} MiB, image mean "
        f"{img.mean().item():.4f}, {int((img.amax(1) > 0).sum())} rays meet a leaf box")
    if not torch.isfinite(img).all() or not img.mean().item() > 0:
        raise AssertionError("[extras] the KD view is not finite or is black")
    return total


def phase_cli(device) -> dict:
    """The port's command line in this process, on scenes/cornell.txt and
    the icosphere(6) OBJ in a temporary directory, at 800x800, depth 8,
    AA on: each run exits 0 (its wall seconds printed); the benchmark's
    JSON line and its PNG read back; a film checkpointed at 2 iterations
    and resumed to 4 equals an uninterrupted 4-iteration film bit for bit;
    the reorderings, the ray cache, the KD route's short-stack walk on
    81,920 triangles (depth 2), the KD view, the KD statistics, the live
    preview and a profiler trace."""
    from kdtreepathtraceroptimization_tpu_torch import cli

    zero_counts()
    with tempfile.TemporaryDirectory() as tmp:
        verts, faces = icosphere(6, radius=2.5, center=(0.0, 3.0, 0.0))
        obj = os.path.join(tmp, "icosphere6.obj")
        write_obj(obj, verts, faces)
        base = [CORNELL, obj, "--res", "800", "800", "--depth", "8", "--aa"]

        def run(label, sub, extra):
            work = os.path.join(tmp, sub)
            os.makedirs(work, exist_ok=True)
            out = io.StringIO()
            t = time.perf_counter()
            with contextlib.chdir(work), contextlib.redirect_stdout(out):
                rc = cli.main(base + extra)
            sync(device)
            log(f"[cli] {label} ({' '.join(extra)}): exit {rc}, {time.perf_counter() - t:.1f} s")
            if rc != 0:
                raise AssertionError(f"[cli] {label} exited with {rc}")
            return out.getvalue(), work

        out, work = run("benchmark", "bench", ["--spp", "3", "--benchmark", "--hdr"])
        bench = json.loads([line for line in out.splitlines() if line.startswith("{")][-1])
        log(f"[cli] benchmark line: {json.dumps(bench)}")
        png, = Path(work).glob("cornell.*.3samp.png")
        img = read_png(str(png))
        hdr = list(Path(work).glob("cornell.*.3samp.hdr"))
        log(f"[cli] {png.name}: {img.shape}, mean {img.mean():.2f}; {len(hdr)} .hdr")
        if img.shape != (800, 800, 3) or not img.max() > 0 or len(hdr) != 1:
            raise AssertionError("[cli] the benchmark run's PNG or HDR is wrong")

        run("checkpoint at 2", "resume", ["--spp", "2", "--save-every", "2"])
        run("resume to 4", "resume", ["--spp", "4", "--save-every", "2", "--resume",
                                      "cornell.ckpt.npz"])
        run("uninterrupted 4", "straight", ["--spp", "4", "--save-every", "4"])
        resumed = np.load(os.path.join(tmp, "resume", "cornell.ckpt.npz"))
        straight = np.load(os.path.join(tmp, "straight", "cornell.ckpt.npz"))
        d = np.abs(resumed["accum"] - straight["accum"]).max()
        log(f"[cli] resumed film (iteration {int(resumed['iteration'])}) against the "
            f"uninterrupted one ({int(straight['iteration'])}): max |d| {d:.3g} (bound: bit for "
            f"bit)")
        if not (int(resumed["iteration"]) == int(straight["iteration"]) == 4
                and np.array_equal(resumed["accum"], straight["accum"])):
            raise AssertionError("[cli] the resumed film differs from the uninterrupted one")

        run("reorderings", "reorder", ["--spp", "2", "--compaction", "--material-sort"])
        run("ray cache", "cache", ["--spp", "2", "--ray-cache"])
        run("KD short stack", "kd", ["--no-auto-intersector", "--short-stack", "--depth", "2",
                                     "--spp", "1"])
        out, work = run("KD view", "viz", ["--viz-kd"])
        viz, = Path(work).glob("cornell.kdviz.*.png")
        if not read_png(str(viz)).max() > 0:
            raise AssertionError("[cli] the KD view is black")
        out, work = run("statistics, live, profile", "stats",
                        ["--spp", "3", "--print-kd-stats", "--live", "1", "--profile", "prof"])
        kd_line = next(line for line in out.splitlines() if line.startswith("kd:"))
        trace = Path(work) / "prof" / "trace.json"
        log(f"[cli] {kd_line}; live preview {out.count('iter ')} frames, {len(out)} characters "
            f"captured; trace {trace.stat().st_size if trace.exists() else 0} bytes")
        if out.count("\x1b[2Kiter ") != 3 or not trace.exists() or trace.stat().st_size == 0:
            raise AssertionError("[cli] the live preview or the profiler trace is missing")
        if not (Path(work) / "cornell.kdboxes.txt").exists():
            raise AssertionError("[cli] --print-kd-stats wrote no box dump")
    return read_counts()


# The [interactive] phase's key script: orbit left (film reset), toggle
# AA (step rebuilt, film kept), save, quit (save).
KEY_SCRIPT = b"\x1b[DASq"
# [fault]: a child that asks the card for more memory than it has, one
# that sleeps past HANG_TIMEOUT_S, and a clean one.
HANG_TIMEOUT_S = 10.0
FAULT_CHILDREN = (
    ("oom", "import torch; torch.empty(1 << 40, dtype=torch.uint8, device='cuda')"),
    ("hang", "import time; time.sleep(60)"),
    ("ok", "import torch; torch.zeros(1, device='cuda'); torch.cuda.synchronize()"),
)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def phase_interactive(scene, device) -> dict:
    """The command line's ``--interactive`` as a child at 800x800, depth 8,
    AA on, its stdin a pipe holding KEY_SCRIPT: it exits 0 with the PNGs
    of iterations 2 (S) and 3 (q), and the last equals, byte for byte, an
    in-process render of the orbited camera (iteration 1 with AA on,
    iterations 2-3 with AA off, seed 0)."""
    obj = os.path.join(WORK, "icosphere6_r2.5.obj")  # mesh_scene's OBJ of ``scene``
    with tempfile.TemporaryDirectory() as tmp:
        cmd = [sys.executable, "-m", "kdtreepathtraceroptimization_tpu_torch.cli", CORNELL, obj,
               "--interactive", "--res", "800", "800", "--depth", "8", "--aa"]
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
        t = time.perf_counter()
        out = subprocess.run(cmd, input=KEY_SCRIPT, cwd=tmp, env=env, capture_output=True,
                             timeout=600)
        wall = time.perf_counter() - t
        text = out.stdout.decode(errors="replace")
        actions = re.findall(r"\[(orbit \w+|antialias=\w+)\]", text)
        pngs = sorted(Path(tmp).glob("cornell.*samp.png"))
        log(f"[interactive] child (--interactive, keys {KEY_SCRIPT!r}): exit {out.returncode}, "
            f"{wall:.1f} s wall, actions {actions}, wrote {[p.name for p in pngs]}")
        if out.returncode != 0:
            raise AssertionError("[interactive] the child failed:\n"
                                 + out.stderr.decode(errors="replace")[-3000:])
        if len(pngs) != 2 or not pngs[0].name.endswith(".2samp.png") \
                or not pngs[1].name.endswith(".3samp.png"):
            raise AssertionError(f"[interactive] expected the PNGs of iterations 2 and 3: {pngs}")
        final = read_png(str(pngs[1]))

    config = RenderConfig(trace_depth=8, antialias=True)
    moved = replace_camera(scene, apply_key("LEFT", scene.camera, config, device).camera)
    n = 800 * 800
    zero_counts()
    film = torch.zeros((n, 3), device=device)
    key = prng_key(0)
    film = tint.make_render_fn(moved, config, seed=0, device=device)(film, key, 1)
    step = tint.make_render_fn(moved, dataclasses.replace(config, antialias=False), seed=0,
                               device=device)
    for it in (2, 3):
        film = step(film, key, it)
    want = tonemap_srgb_u8((film.cpu().numpy() / 3).reshape(800, 800, 3))
    diff = np.abs(final.astype(int) - want.astype(int))
    log(f"[interactive] final PNG against the in-process render of the orbited camera: "
        f"{int((diff > 0).sum())} channels differ, max |d| {diff.max()} (bound: byte for byte)")
    if not np.array_equal(final, want):
        raise AssertionError("[interactive] the final PNG differs from the in-process render")
    return read_counts()


def phase_parallel(scene, device) -> dict:
    """The ray-axis split (parallel/): a NCCL group of world 1 renders 2
    spp through render_distributed bit-equal to render, and takes a
    sharded training step bit-equal to make_train_step's (loss, every
    gradient, the updated materials); a forward step issues no
    collective; the four slabs of a notional world of 4, each rendered by
    make_render_fn's slab path on this card, concatenate to the full film bit
    for bit; binned_shards = 4 on the recorded bounce-1 calls of the pair,
    walk and binned paths against S = 1 (pairs and walk bit for bit,
    binned ids >= 99.99%, t within 1e-5 relative), and the binned path's
    depth-8 iteration against S = 1's (max |d| reported)."""
    config = RenderConfig(trace_depth=8, antialias=True)
    res = int(scene.camera.resolution[0])
    n = res * res
    key = prng_key(0)
    zero_counts()
    tmultihost.initialize(f"localhost:{free_port()}", 1, 0, device=device, timeout_s=120.0)
    try:
        log(f"[parallel] process group: backend {torch.distributed.get_backend()}, world "
            f"{torch.distributed.get_world_size()}")
        img, ms_d = timed(lambda: tmultihost.render_distributed(scene, config, 2, seed=0,
                                                                device=device), device)
        ref, ms_r = timed(lambda: render(scene, config, 2, seed=0, device=device), device)
        log(f"[parallel] render_distributed (world 1, 2 spp) {ms_d:.1f} ms, render {ms_r:.1f} "
            f"ms; max |d| {(img - ref).abs().max().item():.3g} (bound: bit for bit)")
        if not torch.equal(img, ref):
            raise AssertionError("[parallel] render_distributed differs from render")

        tsh.reset_collectives()
        step = tsh.make_sharded_render_fn(scene, config, device=device)
        step(tsh.device_film(n, device=device), key, 1)
        forward = dict(tsh.COLLECTIVES)
        log(f"[parallel] collectives of one forward step: {forward} (bound: none)")
        if any(forward.values()):
            raise AssertionError("[parallel] the forward step issued a collective")

        perturbed = scene._replace(materials=scene.materials._replace(
            color=np.asarray(scene.materials.color) * 0.5))
        target = ref.reshape(n, 3)
        init_a, step_a = make_train_step(perturbed, config, target, learning_rate=2e-2,
                                         device=device)
        init_b, step_b = tsh.make_sharded_train_step(perturbed, config, target,
                                                     learning_rate=2e-2, device=device)
        sa, sb = init_a(), init_b()
        for it in (1, 2):  # step 2's ms: step 1 holds the first backward's set-up
            (sa, la), ms_a = timed(lambda: step_a(sa, key, it), device)
            tsh.reset_collectives()
            (sb, lb), ms_b = timed(lambda: step_b(sb, key, it), device)
            train = dict(tsh.COLLECTIVES)
            grads_equal = all(
                torch.equal(b.grad, torch.zeros_like(b) if a.grad is None else a.grad)
                for a, b in zip(sa.materials, sb.materials))
            params_equal = all(torch.equal(a, b) for a, b in zip(sa.materials, sb.materials))
            log(f"[parallel] sharded train step {it} (world 1) {ms_b:.1f} ms, make_train_step "
                f"{ms_a:.1f} ms; loss {lb.item():.8g} vs {la.item():.8g}; gradients equal "
                f"{grads_equal}, materials after Adam equal {params_equal}; collectives "
                f"{train} (bound: bit for bit, one all_reduce)")
            if not (torch.equal(la, lb) and grads_equal and params_equal) \
                    or train != {"all_reduce": 1, "all_gather": 0}:
                raise AssertionError("[parallel] the sharded train step differs from "
                                     "make_train_step")
    finally:
        torch.distributed.destroy_process_group()

    full = tint.make_render_fn(scene, config, seed=0, device=device)(
        torch.zeros((n, 3), device=device), key, 1)
    parts = []
    for r in range(4):
        lo, hi = tsh.slab(r, 4, n)
        step = tint.make_render_fn(scene, config, seed=0, device=device, pixels=(lo, hi))
        film, ms = timed(lambda: step(torch.zeros((hi - lo, 3), device=device), key, 1),
                         device)
        parts.append(film)
        log(f"[parallel] slab {r} of 4 (pixels {lo}-{hi}): {ms:.1f} ms")
    d = (torch.cat(parts) - full).abs().max().item()
    log(f"[parallel] four slabs against the full film (iteration 1): max |d| {d:.3g} (bound: "
        f"bit for bit)")
    if not torch.equal(torch.cat(parts), full):
        raise AssertionError("[parallel] the four slabs differ from the full film")

    for label, kw, name, fn in (
            ("pairs", {}, "intersect_mesh_pairs", tpairs.intersect_mesh_pairs),
            ("walk", WALK, "intersect_mesh_walk", twalk.intersect_mesh_walk),
            ("binned", BINNED, "intersect_mesh_binned", tbinned.intersect_mesh_binned)):
        args, kwargs = bounce_args(scene, RenderConfig(trace_depth=8, antialias=True, **kw),
                                   name, device)
        args4 = list(args)
        args4[3] = dataclasses.replace(args[3], binned_shards=4)
        for _ in range(2):  # the second call's ms: the first holds first-use set-up
            base, ms1 = timed(lambda: fn(*args, **kwargs), device)
            hit, ms4 = timed(lambda: fn(*args4, **kwargs), device)
        same = (hit.tri == base.tri).float().mean().item()
        both = (hit.tri >= 0) & (base.tri >= 0)
        rel = ((hit.t - base.t).abs() / base.t.abs().clamp_min(1e-30))[both]
        rel_max = rel.max().item() if rel.numel() else 0.0
        exact = torch.equal(hit.t, base.t) and torch.equal(hit.tri, base.tri)
        log(f"[parallel] binned_shards 4, {label} bounce 1: {ms4:.2f} ms (S = 1 {ms1:.2f} ms); "
            f"bit-equal {exact}; ids equal on {same:.6%}, {int((hit.tri != base.tri).sum())} "
            f"differ; max |dt|/t {rel_max:.3g} "
            f"(bound: {'ids >= 99.99%, t 1e-5' if label == 'binned' else 'bit for bit'})")
        if label != "binned" and not exact:
            raise AssertionError(f"[parallel] binned_shards 4 differs from S = 1 on {label}")
        if label == "binned" and (same < 0.9999 or rel_max > 1e-5):
            raise AssertionError("[parallel] binned_shards 4 differs from S = 1 on binned beyond "
                                 "its bound")

    imgs = {}
    for s in (1, 4):
        step = make_render_block_fn(
            scene, RenderConfig(trace_depth=8, antialias=True, binned_shards=s, **BINNED), 1,
            device=device)
        imgs[s], ms = timed(lambda: step(torch.zeros((n, 3), device=device), key, 1), device)
        log(f"[parallel] binned path, binned_shards {s}: iteration 1 in {ms:.1f} ms")
    d = (imgs[4] - imgs[1]).abs()
    log(f"[parallel] binned path's depth-8 iteration, S = 4 against S = 1: max |d| "
        f"{d.max().item():.4g}, mean |d| {d.mean().item():.4g}, "
        f"{int((d > 0).any(1).sum())} of {n} pixels differ")
    if not torch.isfinite(imgs[4]).all() or not imgs[4].mean().item() > 0:
        raise AssertionError("[parallel] the binned S = 4 image is not finite or is black")
    return read_counts()


def phase_tools(device) -> dict:
    """tools/benchmarks over its seven modes at 800x800, depth 8, subdiv 2
    and 4 (2 iterations, 1 repeat) into JSON, each mode on the intersector
    it names (tools/benchmarks.ROUTES), tools/charts' SVG of it, and
    tools/scaling's one-card row and measured-work rows (S = 1, 2, 4, 8)
    at 800x800, depth 8, on the 81,920-triangle icosphere."""
    zero_counts()
    with tempfile.TemporaryDirectory() as tmp:
        sweep = os.path.join(tmp, "sweep.json")
        t = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = tbench.main(["--res", "800", "--depth", "8", "--subdiv", "2", "4", "--iters",
                              "2", "--repeats", "1", "--json", sweep])
        log(f"[tools] benchmarks: exit {rc}, {time.perf_counter() - t:.1f} s")
        with open(sweep) as f:
            data = json.load(f)
        for row in data["rows"]:
            log(f"[tools] benchmarks {row['tris']} triangles, {row['res']}x{row['res']}, depth "
                f"{row['depth']}: ms/iteration " + ", ".join(
                    f"{m} {v}" for m, v in row["ms"].items()))
        timed_modes = [set(m for m, v in row["ms"].items() if v) for row in data["rows"]]
        if rc != 0 or len(data["rows"]) != 2 or any(m != set(tbench.MODES) for m in timed_modes):
            raise AssertionError(f"[tools] the benchmark sweep did not time every mode: {data}")
        strays = [(row["tris"], m, r) for row in data["rows"] for m, r in row["routes"].items()
                  if r != tbench.ROUTES[m]]
        log(f"[tools] benchmarks: every mode took its own intersector: {not strays} "
            f"({tbench.ROUTES})")
        if strays:
            raise AssertionError(f"[tools] benchmark modes took another intersector (triangles, "
                                 f"mode, route): {strays}")
        svg = os.path.join(tmp, "sweep.svg")
        with contextlib.redirect_stdout(io.StringIO()):
            rc = tcharts.main([sweep, "-o", svg])
        text = Path(svg).read_text()
        log(f"[tools] charts: exit {rc}, {len(text)} bytes of SVG, "
            f"{text.count('<path')} lines")
        if rc != 0 or not text.startswith("<svg") or text.count("<path") != len(tbench.MODES):
            raise AssertionError("[tools] the chart is wrong")
    rec = tscaling.run(res=800, subdiv=6, depth=8, iters=2, worlds=(1,), device=device)
    for row in rec["rows"]:
        log(f"[tools] scaling world {row['devices']}: {row['ms_per_iter']:.2f} ms/iteration, "
            f"{row['rays_per_sec']:.6g} rays/s, collectives {row['collectives']}")
    for row in rec["measured_work"]:
        log(f"[tools] scaling measured work S = {row['devices']}: pair rows a row "
            f"{row['per_device_pair_rows']}, rounds ({row['n1_rounds']}, {row['p2_rounds']}, "
            f"{row['p3_rounds']}), efficiency {row['measured_work_efficiency']:.4f}")
    if rec["rows"][0]["collectives"]["forward_step"] != {"all_reduce": 0, "all_gather": 0}:
        raise AssertionError("[tools] the scaling tool's forward step issued a collective")
    return read_counts()


def phase_fault() -> None:
    """utils/fault.run_isolated on FAULT_CHILDREN, each classified as
    named (a clean exit is "ok")."""
    for want, code in FAULT_CHILDREN:
        t = time.perf_counter()
        res = run_isolated(["-c", code], timeout=HANG_TIMEOUT_S if want == "hang" else 300.0)
        kind = "ok" if res["ok"] else res["failure"]["kind"]
        detail = "" if res["ok"] else f", detail {res['failure']['detail'][:1]}"
        log(f"[fault] {want} child: exit {res['returncode']}, classified {kind} in "
            f"{time.perf_counter() - t:.1f} s{detail}")
        if kind != want:
            raise AssertionError(f"[fault] the {want} child was classified {kind}:\n"
                                 f"{res['stderr'][-2000:]}")


def main() -> int:
    parser = argparse.ArgumentParser(description="Chip smoke test of the PyTorch/CUDA port.")
    parser.add_argument("--shapes", nargs="?", const=",".join(SHAPES), default="",
                        help="also time kernels 2, 8, 10, 7, 6, 5, 1, 9 and 12 (or those named, "
                             "comma "
                             "separated: " + ", ".join(SHAPES) + ") in the other launch "
                             "shapes of SHAPES")
    parser.add_argument("--launches", action="store_true",
                        help="only build the kernels and time each launch of kernels 5 and 6 "
                             "over one iteration of the pair path")
    parser.add_argument("--big", action="store_true",
                        help="only build the kernels and run the million-triangle pair path's "
                             "checks (blocks of 512, 2048x2048)")
    args = parser.parse_args()
    shape_names = [k for k in args.shapes.split(",") if k]
    unknown = [k for k in shape_names if k not in SHAPES]
    if unknown:
        parser.error(f"--shapes: no launch shapes for {unknown}")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    card = card_line()
    log(f"[card] {card}")
    log(f"[card] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, python {sys.version.split()[0]}")
    t = time.perf_counter()
    logs = cuda_build.build_all()
    log(f"[build] {len(logs)} kernel sources built in {time.perf_counter() - t:.1f} s "
        f"(nvcc {' '.join(cuda_build.NVCC_FLAGS)})")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"[build] {name}: {line.strip()}")
    log("[build] registers (spill stores/loads, bytes) per entry function: " + "; ".join(
        f"{name} {ptxas_summary(text)}" for name, text in logs.items()))
    phase_sass()
    t = time.perf_counter()
    if load_native() is None:
        raise AssertionError("the native KD builder did not build (g++ missing?)")
    log(f"[build] native KD builder loaded in {time.perf_counter() - t:.1f} s "
        f"(g++ {' '.join(GXX_FLAGS)})")

    device = torch.device("cuda", torch.cuda.current_device())
    start = time.perf_counter()

    def phase_done(name):
        log(f"[time] {name} done at {time.perf_counter() - start:.1f} s")

    if args.big:
        log(f"[big] launches over the path: {phase_big(device)}")
        log(f"[card] {card}")
        return 0
    scene = mesh_scene(6, 2.5, 800, device)
    if args.launches:
        phase_launches(scene, device)
        log(f"[card] {card}")
        return 0
    walk_config = RenderConfig(trace_depth=8, antialias=True, **WALK)
    results = phase_kernels(scene, walk_config, device)
    phase_done("kernels")
    pair_results, _ = phase_pairs(scene, device)
    pass3 = pair_results.pop("slab_cull pass 3", None)
    if pass3 is not None:
        results["slab_cull"].update(pass3_ms=pass3["ms"], pass3_bound_ms=pass3["bound_ms"])
    results.update(pair_results)
    phase_done("pairs")
    phase_launches(scene, device)
    phase_done("launches")
    results["pair_bdiag"] = phase_bdiag(scene, device)
    phase_done("bdiag")
    results.update(phase_cluster(scene, device))
    phase_done("cluster")
    results["geoms_hit"] = phase_geoms(scene, device)
    phase_done("geoms")
    if shape_names:
        phase_shapes(logs, shape_names)
        phase_done("shapes")
    SHAPE_INPUTS.clear()  # the main paths' peak memory must not count these
    phase_goldens(device)
    phase_done("goldens")
    big_call = phase_kd(scene, device)
    phase_done("kd")
    small = mesh_scene(2, 2.5, 800, device)  # 320 triangles: the default config's KD walk
    if tint.mesh_route(small.mesh, small.cmesh, RenderConfig(), small.kd) != "kd":
        raise AssertionError("the default config does not route a 320-triangle mesh to the KD walk")
    kdwalks = phase_kdwalks(small, big_call, scene.mesh, device)
    del big_call  # the main paths' peak memory must not count it
    phase_done("kdwalks")
    paths = {
        "pairs": phase_main_path("pairs", scene, RenderConfig(trace_depth=8, antialias=True),
                                 device, ("pair_extract", "pair_runs", "gather_cols",
                                          "geoms_hit")),
        "walk": phase_main_path("walk", scene, walk_config, device,
                                ("slab_cull", "walk", "gather_cols")),
        "cluster": phase_main_path("cluster", scene,
                                   RenderConfig(trace_depth=8, antialias=True, **CLUSTER),
                                   device, ("cluster_cull", "cluster_rounds", "gather_cols"),
                                   repair="intersect_mesh_cluster"),
        "binned": phase_main_path("binned", scene,
                                  RenderConfig(trace_depth=8, antialias=True, **BINNED),
                                  device, ("binned_argmin", "cluster_cull", "cluster_rounds",
                                           "gather_cols"), repair="intersect_mesh_binned"),
        # 4 rounds flag rays on every bounce, so the sweep launches on a
        # render whether or not the default 64 ever flag
        "cluster_r4": phase_main_path("cluster_r4", scene,
                                      RenderConfig(trace_depth=2, antialias=True,
                                                   cluster_rounds=4, **CLUSTER),
                                      device, ("cluster_sweep",), block=1, timed_calls=1,
                                      repair="intersect_mesh_cluster"),
        "brute": phase_main_path("brute", scene,
                                 RenderConfig(trace_depth=2, antialias=True, enable_kd=False,
                                              cluster_auto=False),
                                 device, ("mxu_bf", "gather_cols"), block=1,
                                 timed_calls=1),
        "pairs_bdiag": phase_main_path("pairs_bdiag", scene,
                                       RenderConfig(trace_depth=8, antialias=True,
                                                    pair_bdiag=True),
                                       device, ("pair_extract", "pair_bdiag", "gather_cols"),
                                       absent=("pair_runs",)),
        "kd": phase_main_path("kd", small, RenderConfig(trace_depth=8, antialias=True),
                              device, ("gather_cols",), repair="intersect_mesh_kd",
                              absent=("pair_extract", "pair_runs", "mxu_bf", "walk")),
        "kd_big": phase_main_path("kd_big", scene,
                                  RenderConfig(trace_depth=2, antialias=True, **KD), device,
                                  ("gather_cols",), block=1, timed_calls=1, profile=False,
                                  repair="intersect_mesh_kd",
                                  absent=("pair_extract", "pair_runs", "mxu_bf", "walk")),
    }
    (img_b, it_b), (img_p, it_p) = IMAGES["pairs_bdiag"], IMAGES["pairs"]
    log(f"[main:pairs] kernel 13: {paths['pairs']['geoms_hit']} launches over {it_p} iterations "
        f"(one a bounce: {8 * it_p})")
    if paths["pairs"]["geoms_hit"] != 8 * it_p:
        raise AssertionError("kernel 13 did not launch once a bounce on the pair path")
    d = (img_b - img_p).abs().max().item()
    log(f"[main:pairs_bdiag] image against the default pair path's (same seed, {it_b} and "
        f"{it_p} iterations): max |d| {d:.3g}")
    if it_b != it_p or d != 0.0:
        raise AssertionError("the pair_bdiag image differs from the default pair path's")
    phase_done("main paths")
    paths["pairs_ico1310k"] = phase_big(device)
    phase_done("big")
    paths["kdwalks"] = kdwalks
    paths["extras"] = phase_extras(scene, device)
    phase_done("extras")
    paths["cli"] = phase_cli(device)
    phase_done("cli")
    paths["interactive"] = phase_interactive(scene, device)
    phase_done("interactive")
    paths["parallel"] = phase_parallel(scene, device)
    phase_done("parallel")
    paths["tools"] = phase_tools(device)
    phase_done("tools")
    record_path = dict(RECORD_PATH)
    if not paths["cluster"]["cluster_sweep"]:
        record_path["cluster_sweep"] = "cluster_r4"
    paths["train"] = phase_train(scene, device)
    results["scatter_cols"], paths["geomgrad"] = phase_geomgrad(scene, device)
    phase_gradcheck(device)
    phase_done("gradients")
    paths["edgegrad"] = phase_edgegrad(small, device)
    phase_done("edgegrad")
    phase_fault()
    phase_done("fault")
    unused = [k for k, _, _, _ in KERNELS if not any(p[k] for p in paths.values())]
    if unused:
        raise AssertionError(f"kernels launched on no path: {unused}")

    record = {"kernels": [
        dict(name=name, route="cuda", source=source, replaces=replaces,
             launches=paths[record_path[name]][name],
             **{k: results[name][k] for k in ("max_abs_err", "ms", "plain_ms",
                                              "bound_ms", "bound_by", "library_ms")},
             **{k: results[name][k]
                for k in (SWEEP_EXTRA + BRUTE_EXTRA + PAIR_EXTRA + GROUP_EXTRA + CULL_EXTRA
                          + GEOMS_EXTRA)
                if k in results[name]})
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
