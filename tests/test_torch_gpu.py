"""The CUDA kernels against their plain versions, on the card.

Marked ``gpu``: they need a CUDA device with nvcc and skip elsewhere. On
the H100 run ``python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q``
(``--noconftest``: the suite's conftest imports JAX, which that machine lacks).
``chip_smoke.py`` checks the kernels at the main path's shapes; these
tests cover the other shapes the wrappers accept: tiles whose staging
needs more than 48 KB of shared memory, 8- to 1024-triangle blocks,
the tables of blocks of 512 and 1,024 that meshes past 1,048,576 and
2,097,152 triangles take, blocks whose weight runs are not 16-byte
aligned, tiles with empty feasible lists or only dead rays, walk tiles
of several thread blocks,
tiles whose rays finish in the first round, 1 to 16 pair slots, block
tables of 1024 to 8192 blocks (and of 301, whose last extraction group
is ragged, or with sentinel blocks among real ones), extraction calls of
pass 2's form (65,536 lanes, a live prefix) or all dead, pair tiles that
are all sentinel or split a run or are not a multiple of 32 pairs, pair
tiles and supertiles of more runs than kernels 6 and 7 stage a round,
triangle counts that are not a multiple of the brute force's block, rays
with d = 0 among the brute force's, as many rounds as blocks, a single
tile, gathers of n not a multiple of 4 or under one thread block, the
sweep in both launch shapes, and bad arguments. Tolerances: slab cull,
sphere cull, argmin bins, extraction, gather-to-columns, and the rounds'
t and ids (the round loop's skips are exact, and its sparse chain sums
the batched product's terms in their order) bit for bit; kernel 7
against kernel 6 bit for bit; walk, sweep and brute-force triangle ids
exactly and t within 1e-5 relative (their 10-term sums may round
differently from the batched product); the pair test's loc on >= 99.9% of real pairs and t within
2^-12 relative (the same rounding, seen through the 2^-13 truncation of
the packed key); the scatter-add of kernel 4 per entry within 1e-5 of
the sum of the |contributions| to it (its float
atomics add in an order that changes from run to run).
"""

import os

import numpy as np
import pytest
import torch

from kdtreepathtraceroptimization_tpu_torch.config import RenderConfig
from kdtreepathtraceroptimization_tpu_torch.ops import binned as tbinned
from kdtreepathtraceroptimization_tpu_torch.ops import cluster as tcl
from kdtreepathtraceroptimization_tpu_torch.ops import intersect as tisect
from kdtreepathtraceroptimization_tpu_torch.ops import mesh as tmesh
from kdtreepathtraceroptimization_tpu_torch.ops import mxu_bf
from kdtreepathtraceroptimization_tpu_torch.ops import pairs as tpairs
from kdtreepathtraceroptimization_tpu_torch.ops import walk as twalk
from kdtreepathtraceroptimization_tpu_torch.ops.cluster import build_cluster_mesh
from kdtreepathtraceroptimization_tpu_torch.ops.vecmath import V3
from kdtreepathtraceroptimization_tpu_torch.scene.structs import MeshSoA
from kdtreepathtraceroptimization_tpu_torch.utils import cuda_build
from kdtreepathtraceroptimization_tpu_torch.utils.procmesh import icosphere

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


def _mesh(subdiv):
    verts, faces = icosphere(subdiv, radius=2.0, center=(0.3, -0.2, 0.5))
    v = verts[faces]
    n = np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
    n /= np.linalg.norm(n, axis=1, keepdims=True) + 1e-12
    t = v.shape[0]
    return MeshSoA(v0=v[:, 0], v1=v[:, 1], v2=v[:, 2], n0=n, n1=n, n2=n,
                   material_id=np.zeros(t, np.int32), shape_id=np.zeros(t, np.int32),
                   shape_bbox_min=v.min((0, 1))[None], shape_bbox_max=v.max((0, 1))[None])


def _walk_inputs(cm, n, tile, seed, dead_frac=0.2, beams=False):
    """Sorted walk inputs for random rays, the way intersect_mesh_walk
    builds them; the last tile is all dead. With ``beams``, tile 0 is a
    narrow beam along the normal of a triangle in the middle of block 0
    (with blocks of 64 or more slots its rays hit in the first listed
    block and need no later one) and tile 1 live rays leaving the mesh
    from there (an empty list)."""
    rng = np.random.default_rng(seed)
    dev = cm.w.device
    # origins around the sphere, aimed near its centre: most rays hit
    o = rng.normal(size=(n, 3)).astype(np.float32) * 4.0
    d = (np.array([0.3, -0.2, 0.5], np.float32)
         + rng.normal(size=(n, 3)).astype(np.float32) * 1.5 - o)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    act = rng.uniform(size=n) > dead_frac
    act[-tile:] = False
    t0 = rng.uniform(2.0, 20.0, n).astype(np.float32)
    if beams:
        j = int(cm.real[0]) // 2
        v = [getattr(cm.tris, f)[j].cpu().numpy() for f in ("v0", "v1", "v2")]
        nrm = np.cross(v[1] - v[0], v[2] - v[0])
        nrm /= np.linalg.norm(nrm)
        o[:2 * tile] = ((v[0] + v[1] + v[2]) / 3 + 6.0 * nrm
                        + rng.normal(size=(2 * tile, 3)).astype(np.float32) * 1e-3)
        d[:tile] = -nrm
        d[tile:2 * tile] = nrm
        act[:2 * tile] = True
        t0[:2 * tile] = 50.0
    o, d = torch.tensor(o, device=dev), torch.tensor(d, device=dev)
    act, t0 = torch.tensor(act, device=dev), torch.tensor(t0, device=dev)
    o = o - cm.center_shift
    d = torch.where(act[:, None], d, 0.0)
    x = twalk._ray16(o, d, t0, act.float())
    tile_entry = twalk._slab_cull_ref(x, cm.slab, cm.blk, tile)
    sel, lb, nsel = twalk._full_select(tile_entry)
    r = torch.cat([mxu_bf.ray_features(x[:, 0:3], x[:, 3:6]),
                   torch.zeros((n, 6), device=dev)], dim=1)
    return x, sel, lb, nsel, r, x[:, 6].contiguous(), x[:, 7].contiguous()


@pytest.mark.parametrize("tile", [256, 1024, 4096])
def test_slab_cull_kernel_bit_equal(cuda, tile):
    cm = build_cluster_mesh(_mesh(4), block=64, device=cuda)
    x, *_ = _walk_inputs(cm, 8192, tile, seed=tile)
    got = twalk.slab_cull(x, cm.slab, cm.blk, tile)
    want = twalk._slab_cull_ref(x, cm.slab, cm.blk, tile)
    assert torch.equal(got, want)


@pytest.mark.parametrize("block, tile", [(64, 256), (256, 1024), (512, 512), (1024, 128),
                                         (256, 2048), (64, 1536), (9, 384), (8, 256)])
def test_walk_kernel_matches_plain(cuda, block, tile):
    """Padded tables (real < block), blocks of 9 (runs not 16-byte
    aligned), tiles of more rays than a thread block takes and not a
    multiple of them, a tile whose rays finish in the first round, an
    all-dead tile and one of live rays with an empty list."""
    cm = build_cluster_mesh(_mesh(5), block=block, device=cuda)
    assert (cm.real[:cm.n_real_blocks] < block).any()
    n = 8 * tile
    x, sel, lb, nsel, r, t0, act = _walk_inputs(cm, n, tile, seed=block, beams=True)
    assert int(nsel[-1]) == 0 and int(nsel[1]) == 0 and bool(act[tile:2 * tile].all())
    before = twalk.WALK.launches
    rounds = torch.zeros((n // tile, 2), dtype=torch.int32, device=cuda)
    bt_k, btri_k = twalk.walk(sel, lb, nsel, r, t0, act, cm, tile, rounds=rounds)
    bt_p, btri_p = twalk._walk_ref(sel, lb, r, t0, act, cm.w, tile, block)
    assert twalk.WALK.launches == before + 1
    assert int((btri_p >= 0).sum()) > n // 4
    assert torch.equal(btri_k, btri_p)
    torch.testing.assert_close(bt_k, bt_p, rtol=1e-5, atol=0)
    assert (btri_k[-tile:] == -1).all() and (btri_k[tile:2 * tile] == -1).all()
    # the beam: rays that hit in the first listed block need no later one
    # (leaves of 5 triangles, in blocks of 8 or 9, overlap their
    # neighbours' boxes along it)
    first = (btri_p[:tile] // block == sel[0, 0]) & (bt_p[:tile] <= lb[0, 1])
    assert int(first.sum()) == tile or block < 64
    assert not rounds[-1].any() and not rounds[1].any() and int(rounds[0, 0]) >= 1
    assert (rounds[:, 1] <= rounds[:, 0] * block * (-(-tile // 32))).all()
    again = twalk.walk(sel, lb, nsel, r, t0, act, cm, tile)
    assert torch.equal(again[1], btri_k) and torch.equal(again[0], bt_k)


@pytest.mark.parametrize("n, c", [
    (1, 19), (1000, 19), (640_000, 19), (5000, 3),
    (1001, 19), (640_003, 19),  # n % 4 != 0
    (130, 19), (200, 19),  # less than one thread block of 256
    (777, 1),
])
def test_gather_cols_kernel_bit_equal(cuda, n, c):
    g = torch.Generator(device="cpu").manual_seed(n)
    packed = torch.randn((4096, c), generator=g).to(cuda)
    tri = torch.randint(0, 4096, (n,), generator=g, dtype=torch.int32).to(cuda)
    assert torch.equal(tmesh.gather_cols(packed, tri), packed[tri.long()].T)


@pytest.mark.parametrize("n, c, nt, pattern", [
    (1000, 19, 4096, "random"),  # n not a multiple of the 256-thread block
    (640_000, 19, 131_072, "random"),  # the main path's shape
    (5000, 19, 4096, "one row"),  # every lane adds into row 7
    (5000, 19, 4096, "zeros"),  # all-zero cotangents: the kernel adds nothing
    (3001, 1, 300, "random"),  # one channel
])
def test_scatter_cols_kernel_matches_plain(cuda, n, c, nt, pattern):
    g = torch.Generator(device="cpu").manual_seed(n + c)
    ct = torch.randn((c, n), generator=g)
    ct[:, torch.rand(n, generator=g) < 0.5] = 0.0  # miss lanes
    tri = torch.randint(0, nt, (n,), generator=g, dtype=torch.int32)
    if pattern == "one row":
        tri.fill_(7)
    if pattern == "zeros":
        ct.zero_()
    ct, tri = ct.to(cuda), tri.to(cuda)
    before = tmesh.SCATTER_COLS.launches
    got = tmesh.scatter_cols(ct, tri, nt)
    want = tmesh._scatter_cols_ref(ct, tri, nt)
    assert tmesh.SCATTER_COLS.launches == before + 1
    assert got.shape == (nt, c)
    scale = tmesh._scatter_cols_ref(ct.abs(), tri, nt)  # sum of |contributions|
    assert ((got - want).abs() <= 1e-5 * scale).all()
    if pattern == "zeros":
        assert not got.any()


def test_scatter_cols_checks_its_arguments(cuda):
    ct = torch.zeros((19, 8), device=cuda)
    with pytest.raises(ValueError):
        tmesh.scatter_cols(ct, torch.zeros(8, dtype=torch.int64, device=cuda), 4)
    with pytest.raises(ValueError):
        tmesh.scatter_cols(torch.zeros((8, 19), device=cuda).T, torch.zeros(
            8, dtype=torch.int32, device=cuda), 4)
    before = tmesh.SCATTER_COLS.launches
    out = tmesh.scatter_cols(torch.zeros((19, 0), device=cuda),
                             torch.zeros(0, dtype=torch.int32, device=cuda), 4)
    assert out.shape == (4, 19) and not out.any()
    assert tmesh.SCATTER_COLS.launches == before


def test_gather_cols_gradcheck_on_cuda(cuda):
    """The autograd function on the card, kernel 3 forward and kernel 4
    backward, in float32: central differences of a copy are exact up to
    the rounding of x +- eps (atol 1e-3 at eps 1e-2); the atomics make the
    backward nondeterministic in the last bits (nondet_tol 1e-5)."""
    g = torch.Generator(device="cpu").manual_seed(0)
    packed = torch.randn((64, 19), generator=g).to(cuda).requires_grad_(True)
    tri = torch.randint(0, 64, (1000,), generator=g, dtype=torch.int32).to(cuda)
    before = tmesh.SCATTER_COLS.launches
    assert torch.autograd.gradcheck(lambda p: tmesh.gather_cols(p, tri), (packed,),
                                    eps=1e-2, atol=1e-3, rtol=1e-3, nondet_tol=1e-5,
                                    fast_mode=True)
    assert tmesh.SCATTER_COLS.launches > before


def test_wrappers_check_their_arguments(cuda):
    cm = build_cluster_mesh(_mesh(3), block=64, device=cuda)
    x, sel, lb, nsel, r, t0, act = _walk_inputs(cm, 1024, 256, seed=0)
    with pytest.raises(ValueError):
        twalk.slab_cull(x.double(), cm.slab, cm.blk, 256)
    with pytest.raises(ValueError):
        twalk.slab_cull(x, cm.slab, cm.blk, 384)  # does not divide n
    with pytest.raises(ValueError):
        twalk.walk(sel.long(), lb, nsel, r, t0, act, cm, 256)
    with pytest.raises(ValueError):
        twalk.walk(sel, lb, nsel, r.T.contiguous().T, t0, act, cm, 256)
    for real in (cm.real.long(), cm.real[:-1], cm.real.float()):
        with pytest.raises(ValueError):
            twalk.walk(sel, lb, nsel, r, t0, act, cm._replace(real=real), 256)
    with pytest.raises(ValueError):
        twalk.walk(sel, lb, nsel, r, t0, act, cm._replace(slab=cm.slab[:6]), 256)
    for rounds in (torch.zeros((4, 2), dtype=torch.int64, device=cuda),
                   torch.zeros(4, dtype=torch.int32, device=cuda)):
        with pytest.raises(ValueError):  # [tiles, 2] int32
            twalk.walk(sel, lb, nsel, r, t0, act, cm, 256, rounds=rounds)
    with pytest.raises(ValueError):  # blocks of 4096 slots need 512 KB of staging
        twalk.walk(sel, lb, nsel, r, t0, act, cm._replace(
            w=torch.zeros((cm.n_blocks, 16, 4 * 4096), device=cuda), block=4096), 256)
    with pytest.raises(ValueError):
        tmesh.gather_cols(torch.zeros((4, 19), device=cuda), torch.zeros(3, dtype=torch.int64, device=cuda))
    before = tmesh.GATHER_COLS.launches
    out = tmesh.gather_cols(torch.zeros((4, 19), device=cuda),
                            torch.zeros(0, dtype=torch.int32, device=cuda))
    assert out.shape == (19, 0) and tmesh.GATHER_COLS.launches == before


@pytest.mark.parametrize("n", [4096, 3001])
def test_walk_intersector_on_cuda_matches_cpu(cuda, n):
    """The whole intersector, kernels against plain versions; 3,001 rays
    are not a multiple of the tile."""
    mesh = _mesh(4)
    rng = np.random.default_rng(3)
    o = rng.normal(size=(n, 3)).astype(np.float32) * 4.0
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    cfg = RenderConfig(cluster_tile=256)
    hits = [twalk.intersect_mesh_walk(torch.tensor(o, device=dev), torch.tensor(d, device=dev),
                                      build_cluster_mesh(mesh, block=256, device=dev), cfg)
            for dev in (cuda, torch.device("cpu"))]
    assert torch.equal(hits[0].tri.cpu(), hits[1].tri)
    torch.testing.assert_close(hits[0].t.cpu(), hits[1].t, rtol=1e-5, atol=0)


def _pair_inputs(cm, n, seed):
    """The _ray16 record of rays around the mesh aimed near its centre,
    with dead rays (the last 256 all dead) and t0 bounds."""
    x, *_ = _walk_inputs(cm, n, 256, seed=seed)
    return x


@pytest.mark.parametrize("subdiv, block, F, form", [
    (4, 64, 1, "random"), (4, 64, 3, "random"), (5, 8, 12, "random"), (5, 8, 16, "random"),
    (6, 10, 3, "random"),
    (5, 64, 12, "pass 2"),  # 65,536 lanes, the live rays a compacted prefix
    (4, 64, 3, "dead"),  # every ray dead: every thread block skips
    (5, 64, 3, "ragged"),  # kp = 301: not a multiple of any group size
    (4, 64, 3, "sentinels"),  # sentinel blocks inside groups
])
def test_extract_kernel_bit_equal(cuda, subdiv, block, F, form):
    """Both forms of the kernel (a ray a lane, and the split form's several
    lanes a ray) on kp from 128 to 8192 (icosphere-6 in 10-triangle
    leaves: the cap); pass 2's form (65,536 lanes whose 3,000 live rays
    come first, as _compact_all leaves them); all-dead input; a table of
    301 blocks (the kernel's last group is ragged); sentinel blocks (r2 <
    0) among the real ones of a group."""
    cm = build_cluster_mesh(_mesh(subdiv), block=block, device=cuda)
    slab, blk = cm.slab, cm.blk
    if form == "pass 2":  # the live rays first, as intersect_mesh_pairs compacts them
        x = _pair_inputs(cm, 65536, seed=F)
        x = x[torch.argsort((x[:, 7] <= 0).int(), stable=True)].contiguous()
        x[3000:, 7] = 0.0
        x[3000:, 3:6] = 0.0
        assert bool((x[:3000, 7] > 0).all())
    else:
        x = _pair_inputs(cm, 8192, seed=F)
    if form == "dead":
        x[:, 7] = 0.0
    if form == "ragged":
        slab, blk = slab[:, :301].contiguous(), blk[:, :301].contiguous()
    if form == "sentinels":
        blk = blk.clone()
        blk[5, 3:cm.n_real_blocks:5] = -1.0
    before = tpairs.EXTRACT.launches
    got = [tpairs.extract(x, slab, blk, F, split) for split in (False, True)]
    want = tpairs._extract_ref(x, slab, blk, F)
    assert tpairs.EXTRACT.launches == before + 2
    if form == "dead":
        assert int(want[2].sum()) == 0 and bool((want[0] == slab.shape[1]).all())
    else:
        assert int((want[2] > F).sum()) > 0 or F == 16
    for form_got in got:  # the one-lane and the split form
        for a, b in zip(form_got, want):
            assert torch.equal(a, b)
    if subdiv == 6:
        assert cm.n_blocks == tpairs.MAX_CLUSTER_BLOCKS


def _check_packed(got, want, blk_s, kreal):
    real = blk_s < kreal
    tg, lg = tpairs._unpack_tl(got)
    tw, lw = tpairs._unpack_tl(want)
    assert (got[~real] == tpairs._PBIG).all()
    assert int((want[real] < tpairs._PBIG).sum()) > 100
    assert (lg == lw)[real].float().mean().item() >= 0.999
    both = real & (tg < 1e30) & (tw < 1e30)
    assert (((tg - tw).abs() / tw.abs().clamp_min(1e-30))[both] <= 2.0 ** -12).all()
    assert ((tg < 1e30) == (tw < 1e30))[real].float().mean().item() >= 0.999


def _k7_on(blk_s, featp, cm):
    """Kernel 7 on the same pairs, padded with sentinels to its 1024-pair
    supertiles; its keys for the given pairs."""
    p = blk_s.shape[0]
    pad = -p % 1024
    bp = torch.cat([blk_s, torch.full((pad,), cm.n_blocks, dtype=torch.int32,
                                      device=blk_s.device)])
    fp = torch.cat([featp, featp.new_zeros((pad, 16))])
    return tpairs.pair_bdiag(bp, fp, cm, 1024, cm.n_real_blocks)[:p]


@pytest.mark.parametrize("block, ptile, runs", [
    (64, 256, None), (256, 256, None), (1024, 128, None),
    (64, 200, None),  # tiles that are not a multiple of 32 pairs
    (64, 256, [12, 9, 14]),  # parts of more runs than slots: two staged rounds
    (64, 256, [20, 40, 1]),  # parts of more runs than two rounds stage: read directly
    (256, 256, [1, 1, 1]),  # one-run tiles
    (9, 256, [2, 5, 30]),  # blocks of 9 triangles: runs not 16-byte aligned
])
def test_pair_runs_kernel_matches_plain(cuda, block, ptile, runs):
    """Block-sorted pairs from a real extraction (runs that split tiles,
    and a tail of whole tiles that are all sentinel), or tiles of given
    runs (``_many_run_pairs``: parts of more runs than kernel 6 stages a
    round, which take two staged rounds, and of more than two rounds'
    runs, which read their weights directly; one-run tiles; 9-triangle
    blocks), on padded tables (real < block): against the plain version,
    and against kernel 7 on the same pairs bit for bit (both run the part
    loop of csrc/pair_part.cuh)."""
    cm = build_cluster_mesh(_mesh(5), block=block, device=cuda)
    assert (cm.real[:cm.n_real_blocks] < block).any()
    if runs is None:
        x = _pair_inputs(cm, 4096, seed=block)
        ids, _, _, feat = tpairs.extract(x, cm.slab, cm.blk, 3)
        flat = torch.cat([ids.reshape(-1),
                          torch.full((-(4096 * 3) % ptile + 4 * ptile,), cm.n_blocks,
                                     dtype=torch.int32, device=cuda)])
        blk_s, src = torch.sort(flat, stable=True)
        featp = feat[torch.clamp_max(src // 3, 4095)]
    else:
        blk_s, featp = _many_run_pairs(cm, ptile, runs, seed=block + len(runs))
    slots = tpairs.PAIR_RUNS.call_int("pair_runs_slots", block, cuda_build.MAX_SMEM)
    assert slots >= 1
    tiles = blk_s.reshape(-1, ptile)
    if runs is not None:  # the given tiles, before the half- and all-sentinel ones
        starts = torch.ones_like(tiles[:len(runs)], dtype=torch.bool)
        starts[:, 1:] = tiles[:len(runs), 1:] != tiles[:len(runs), :-1]
        per_tile = starts.sum(dim=1)
        if runs == [12, 9, 14]:
            assert slots < int(per_tile.min()) and int(per_tile.max()) <= 2 * slots
        if runs == [20, 40, 1]:
            assert int(per_tile.max()) > 2 * slots
        if runs == [1, 1, 1]:
            assert bool((per_tile == 1).all())
    before = tpairs.PAIR_RUNS.launches
    got = tpairs.pair_runs(blk_s, featp, cm, ptile, cm.n_real_blocks)
    want = tpairs._pair_runs_ref(blk_s, featp, cm.w, block, cm.n_real_blocks)
    assert tpairs.PAIR_RUNS.launches == before + 1
    # a run that goes on from one tile into the next
    assert bool(((tiles[1:, 0] == tiles[:-1, -1]) & (tiles[1:, 0] < cm.n_real_blocks)).any())
    assert bool((tiles[:, 0] >= cm.n_real_blocks).any())
    _check_packed(got, want, blk_s, cm.n_real_blocks)
    assert torch.equal(got, _k7_on(blk_s, featp, cm))


@pytest.mark.parametrize("block", [256, 512, 1024])
def test_pair_path_kernels_on_big_blocks(cuda, block):
    """Kernels 5, 6, 1, 2 and 3 on the tables of blocks of 512 and 1,024
    triangles, which meshes past 1,048,576 and 2,097,152 triangles take
    (icosphere-7, 327,680 triangles, in median-split leaves of 320 or 640
    padded to the block, as icosphere-8's 1,310,720 are in 4,096 blocks of
    512), as at 256: each against its plain version with its own test's
    checks (kernels 5, 1 and 3 bit for bit, both forms of kernel 5; kernel
    6's loc and t through the packed key's truncation; the walk's ids
    exactly and t within 1e-5). Kernels 1 and 2 take pass 3's tile at the
    table's size (``vmem_tile_cap``)."""
    cm = build_cluster_mesh(_mesh(7), block=block, device=cuda)
    kreal, kp = cm.n_real_blocks, cm.n_blocks
    assert cm.block == block and (cm.real[:kreal] < block).any()
    n = 8192
    x = _pair_inputs(cm, n, seed=block)
    want = tpairs._extract_ref(x, cm.slab, cm.blk, 3)
    for split in (False, True):
        for a, b in zip(tpairs.extract(x, cm.slab, cm.blk, 3, split), want):
            assert torch.equal(a, b)
    ids, _, cnt, feat = want
    assert int((cnt > 3).sum()) > 0
    flat = torch.cat([ids.reshape(-1), torch.full((-(n * 3) % 256 + 256,), kp,
                                                  dtype=torch.int32, device=cuda)])
    blk_s, src = torch.sort(flat, stable=True)
    featp = feat[torch.clamp_max(src // 3, n - 1)]
    got = tpairs.pair_runs(blk_s, featp, cm, 256, kreal)
    _check_packed(got, tpairs._pair_runs_ref(blk_s, featp, cm.w, block, kreal), blk_s, kreal)

    tile = twalk.vmem_tile_cap(kp)
    xw, sel, lb, nsel, r, t0, act = _walk_inputs(cm, 8 * tile, tile, seed=block + 1)
    assert torch.equal(twalk.slab_cull(xw, cm.slab, cm.blk, tile),
                       twalk._slab_cull_ref(xw, cm.slab, cm.blk, tile))
    bt_k, btri_k = twalk.walk(sel, lb, nsel, r, t0, act, cm, tile)
    bt_p, btri_p = twalk._walk_ref(sel, lb, r, t0, act, cm.w, tile, block)
    assert int((btri_p >= 0).sum()) > tile
    assert torch.equal(btri_k, btri_p)
    torch.testing.assert_close(bt_k, bt_p, rtol=1e-5, atol=0)
    tri = torch.clamp_min(btri_k, 0)
    assert torch.equal(tmesh.gather_cols(cm.packed, tri), cm.packed[tri.long()].T)


def _many_run_pairs(cm, ptile, runs_per_tile, seed):
    """Block-sorted pairs: tile k of ``ptile`` pairs holds runs_per_tile[k]
    runs of ascending block ids (each tile's last run goes on into the
    next), then a tile half real and half sentinel, then a tile of
    sentinels only; a ray per pair aimed at the centroid of a real
    triangle of its block."""
    rng = np.random.default_rng(seed)
    kreal, kp, block, dev = cm.n_real_blocks, cm.n_blocks, cm.block, cm.w.device
    tiles, b = [], 0
    for runs in runs_per_tile:
        cuts = np.sort(rng.choice(np.arange(1, ptile), runs - 1, replace=False))
        tiles.append(np.repeat(np.arange(b, b + runs),
                               np.diff(np.concatenate([[0], cuts, [ptile]]))))
        b += runs - 1
    half = ptile // 2
    tiles.append(np.concatenate([np.full(half, b), np.full(half // 2, kreal),
                                 np.full(ptile - half - half // 2, kp)]))
    tiles.append(np.full(ptile, kp))
    blk_s = np.concatenate(tiles).astype(np.int32)
    assert b < kreal
    # aim at real triangles only: a padding slot repeats a vertex, and rays
    # through a vertex tie between the triangles that share it
    t = cm.tris
    real = ((t.v1 != t.v0).any(dim=1) | (t.v2 != t.v0).any(dim=1)).reshape(-1, block)
    n_real = real.sum(dim=1).cpu().numpy()  # padding closes each block
    bb = np.minimum(blk_s, kreal - 1)
    tri = bb * block + (rng.random(blk_s.shape[0]) * n_real[bb]).astype(np.int64)
    tri_t = torch.tensor(tri, device=dev)
    cen = (t.v0[tri_t] + t.v1[tri_t] + t.v2[tri_t]) / 3.0 - cm.center_shift
    o = 4.0 * cen
    d = (cen - o) / (cen - o).norm(dim=1, keepdim=True)
    n = blk_s.shape[0]
    od = torch.cat([o, d, torch.full((n, 1), 40.0, device=dev), torch.ones((n, 1), device=dev)],
                   dim=1)
    return torch.tensor(blk_s, device=dev), tpairs._feat16t(od).contiguous()


# Pairs a thread block of kernel 7 takes (csrc/pair_bdiag.cu kThreads).
BDIAG_PART = 256


@pytest.mark.parametrize("block, ptile, runs, rounds", [
    (64, 1024, [1, 3, 8, 13], ""), (256, 1024, [1, 3, 8, 13], ""),
    (1024, 1024, [1, 3, 8, 13], "several"), (256, 256, [1, 3, 8, 13], "several"),
    (64, 64, [1, 3, 8, 13], "several"),
    (64, 256, [20, 40, 1], "several"),  # parts of more runs than 8 slots
    (256, 1024, [1, 1, 1], "one"),  # one-run tiles
    (9, 512, [2, 5, 30], "several"),  # runs not 16-byte aligned
])
def test_pair_bdiag_kernel_matches_plain_and_pair_runs(cuda, block, ptile, runs, rounds):
    """Kernel 7 with 8 (blocks of 64 and 9), 3 (256) and 1 (1024) weight
    slots a round, on tiles of up to 40 runs (parts of more runs than slots:
    several rounds, the next round's copies in flight) and of one run each,
    runs that cross tiles and parts, a half-sentinel and an all-sentinel
    tile, on padded tables (real < block): against its plain version (the
    pair-test tolerance) and against kernel 6 on the same pairs, bit for bit
    (the same hits and arithmetic per (pair, triangle): the sparse test
    gives the dense test's floats)."""
    cm = build_cluster_mesh(_mesh(5 if block < 1024 else 6), block=block, device=cuda)
    assert (cm.real[:cm.n_real_blocks] < block).any()
    runs = [min(k, ptile // 2) for k in runs]
    blk_s, featp = _many_run_pairs(cm, ptile, runs, seed=block + ptile + len(runs))
    slots = tpairs.PAIR_BDIAG.call_int("pair_bdiag_slots", block, cuda_build.MAX_SMEM)
    assert slots == {9: 8, 64: 8, 256: 2, 1024: 1}[block]
    parts = blk_s[:len(runs) * ptile].reshape(-1, min(ptile, BDIAG_PART))
    starts = torch.ones_like(parts, dtype=torch.bool)
    starts[:, 1:] = parts[:, 1:] != parts[:, :-1]
    if rounds == "several":
        assert int(starts.sum(dim=1).max()) > slots  # some part takes several rounds
    if rounds == "one":
        assert bool((starts.sum(dim=1) == 1).all())
    before = tpairs.PAIR_BDIAG.launches
    got = tpairs.pair_bdiag(blk_s, featp, cm, ptile, cm.n_real_blocks)
    assert tpairs.PAIR_BDIAG.launches == before + 1
    want = tpairs._pair_runs_ref(blk_s, featp, cm.w, block, cm.n_real_blocks)
    _check_packed(got, want, blk_s, cm.n_real_blocks)
    k6 = tpairs.pair_runs(blk_s, featp, cm, min(ptile, 256), cm.n_real_blocks)
    assert torch.equal(got, k6)


def test_pair_bdiag_checks_its_arguments(cuda):
    cm = build_cluster_mesh(_mesh(3), block=64, device=cuda)
    blk_s, featp = _many_run_pairs(cm, 256, [2], seed=0)
    for ptile in (48, 2048, 512):  # not a multiple of 32; over 1024; 768 pairs in 512s
        with pytest.raises(ValueError):
            tpairs.pair_bdiag(blk_s, featp, cm, ptile, cm.n_real_blocks)
    with pytest.raises(ValueError):
        tpairs.pair_bdiag(blk_s.long(), featp, cm, 256, cm.n_real_blocks)
    with pytest.raises(ValueError):
        tpairs.pair_bdiag(blk_s, featp.double(), cm, 256, cm.n_real_blocks)
    with pytest.raises(ValueError):  # a real-slot count short of the table
        tpairs.pair_bdiag(blk_s, featp, cm._replace(real=cm.real[:-1].contiguous()), 256,
                          cm.n_real_blocks)
    with pytest.raises(ValueError):
        tpairs.pair_bdiag(blk_s, featp, cm._replace(real=cm.real.long()), 256, cm.n_real_blocks)


def test_pair_bdiag_intersector_on_cuda_matches_cpu(cuda):
    """intersect_mesh_pairs with pair_bdiag, kernels against plain
    versions, grazing rays on 8-triangle blocks (the exhaustive walk
    runs)."""
    mesh = _mesh(4)
    rng = np.random.default_rng(2)
    c = np.array([0.3, -0.2, 0.5])
    u = rng.normal(size=(4096, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    w = rng.normal(size=(4096, 3))
    w -= (w * u).sum(1, keepdims=True) * u
    w /= np.linalg.norm(w, axis=1, keepdims=True)
    o = (c + 10.0 * u).astype(np.float32)
    d = c + w * rng.uniform(1.9, 2.05, (4096, 1)) - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    cfg = RenderConfig(cluster=True, cluster_tile=256, pair_slots=1, pair_bdiag=True)
    before = tpairs.PAIR_BDIAG.launches
    hits = [tpairs.intersect_mesh_pairs(torch.tensor(o, device=dev), torch.tensor(d, device=dev),
                                        build_cluster_mesh(mesh, block=8, device=dev), cfg,
                                        collect_stats=True)
            for dev in (cuda, torch.device("cpu"))]
    assert tpairs.PAIR_BDIAG.launches > before
    assert hits[0][1]["pass3_rays"] > 0
    assert torch.equal(hits[0][0].tri.cpu(), hits[1][0].tri)
    torch.testing.assert_close(hits[0][0].t.cpu(), hits[1][0].t, rtol=1e-5, atol=0)


@pytest.mark.parametrize("octant_rows", [True, False])
def test_kd_walk_on_cuda_matches_cpu(cuda, octant_rows):
    """The KD walk is plain PyTorch: on the card it gives the CPU's
    triangles (t within 1e-5 relative: the card's division and products
    may round otherwise)."""
    from kdtreepathtraceroptimization_tpu_torch.accel.kdtree import build_kdtree_from_mesh
    from kdtreepathtraceroptimization_tpu_torch.convert import kd_to_device
    from kdtreepathtraceroptimization_tpu_torch.ops.traverse import intersect_mesh_kd

    kd = build_kdtree_from_mesh(_mesh(4), leaf_size=8)
    rng = np.random.default_rng(3)
    o = rng.normal(size=(8192, 3)).astype(np.float32) * 5.0
    d = np.array([0.3, -0.2, 0.5], np.float32) + rng.normal(size=(8192, 3)).astype(np.float32) - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    cfg = RenderConfig(octant_rows=octant_rows)
    hits = [intersect_mesh_kd(torch.tensor(o, device=dev), torch.tensor(d, device=dev),
                              kd_to_device(kd, dev), cfg)
            for dev in (cuda, torch.device("cpu"))]
    assert int((hits[1].tri >= 0).sum()) > 2000
    assert (hits[0].tri.cpu() == hits[1].tri).float().mean().item() >= 0.999
    torch.testing.assert_close(hits[0].t.cpu(), hits[1].t, rtol=1e-5, atol=0)


@pytest.mark.parametrize("n_tris_subdiv, tri_block, ray_tile", [(3, 512, 1024), (4, 64, 256),
                                                                 (4, 1024, 512), (3, 100, 128)])
def test_brute_force_kernel_matches_plain(cuda, n_tris_subdiv, tri_block, ray_tile):
    """1,280 or 5,120 triangles (not multiples of the block: the last block
    is padded), 3,000 rays (not a multiple of the ray tile), some with a t
    bound, and 40% with d = 0 mixed among them (sorted to the back, where
    they fill whole tiles)."""
    mesh = build_cluster_mesh(_mesh(n_tris_subdiv), block=64, device=cuda).tris
    rng = np.random.default_rng(tri_block)
    o = torch.tensor(rng.normal(size=(3000, 3)).astype(np.float32) * 4.0, device=cuda)
    d = torch.tensor(np.array([0.3, -0.2, 0.5], np.float32)
                     + rng.normal(size=(3000, 3)).astype(np.float32), device=cuda) - o
    d = d / d.norm(dim=1, keepdim=True)
    dead = torch.tensor(rng.uniform(size=3000) < 0.4, device=cuda)
    d = torch.where(dead[:, None], 0.0, d)
    t_max = torch.where(torch.arange(3000, device=cuda) % 3 == 0, 4.0, 1e30)
    before = mxu_bf.BF.launches
    got = mxu_bf.intersect_brute_mxu(o, d, mesh.v0, mesh.v1, mesh.v2, t_max=t_max,
                                     ray_tile=ray_tile, tri_block=tri_block)
    want = mxu_bf.intersect_brute_mxu_ref(o, d, mesh.v0, mesh.v1, mesh.v2, t_max=t_max,
                                          block=tri_block)
    assert mxu_bf.BF.launches == before + 1
    assert int((want.tri >= 0).sum()) > 300 and (got.tri[dead] == -1).all()
    assert torch.equal(got.tri, want.tri)
    torch.testing.assert_close(got.t, want.t, rtol=1e-5, atol=0)


def test_new_wrappers_check_their_arguments(cuda):
    cm = build_cluster_mesh(_mesh(3), block=64, device=cuda)
    x = _pair_inputs(cm, 1024, seed=0)
    for F in (0, 17):
        with pytest.raises(ValueError):
            tpairs.extract(x, cm.slab, cm.blk, F)
    with pytest.raises(ValueError):
        tpairs.extract(x.double(), cm.slab, cm.blk, 3)
    with pytest.raises(ValueError):  # past the 13-bit block-id cap
        big = torch.zeros((8, 8320), device=cuda)
        tpairs.extract(x, big, big, 3)
    ids, _, _, feat = tpairs.extract(x, cm.slab, cm.blk, 1)
    blk_s = ids.reshape(-1)
    with pytest.raises(ValueError):  # 1024 pairs in tiles of 384
        tpairs.pair_runs(blk_s, feat, cm, 384, cm.n_real_blocks)
    with pytest.raises(ValueError):
        tpairs.pair_runs(blk_s.long(), feat, cm, 256, cm.n_real_blocks)
    with pytest.raises(ValueError):  # a real-slot count short of the table
        tpairs.pair_runs(blk_s, feat, cm._replace(real=cm.real[:-1].contiguous()), 256,
                         cm.n_real_blocks)
    with pytest.raises(ValueError):
        tpairs.pair_runs(blk_s, feat, cm._replace(real=cm.real.long()), 256, cm.n_real_blocks)
    v = cm.tris.v0
    with pytest.raises(ValueError):  # 81-ray tiles: not a whole number of threads
        mxu_bf.intersect_brute_mxu(x[:, :3], x[:, 3:6], v, v, v, ray_tile=81)
    with pytest.raises(ValueError):  # 2048-triangle blocks need 256 KB, double-buffered
        mxu_bf.intersect_brute_mxu(x[:, :3], x[:, 3:6], v, v, v, tri_block=2048)
    with pytest.raises(ValueError):  # more rays a tile than a thread block takes
        mxu_bf.intersect_brute_mxu(x[:, :3], x[:, 3:6], v, v, v, ray_tile=8192)


def test_geoms_hit_checks_its_arguments(cuda):
    geoms = _geoms("cornell.txt")
    o, d = (V3(*torch.tensor(a, device=cuda).T.contiguous()) for a in _geom_rays(geoms, 64, 0))
    assert torch.equal(tisect.geoms_hit(o, d, geoms).t,
                       tisect._intersect_geoms_plain(o, d, geoms).t)
    rows = torch.zeros((64, 3), device=cuda)
    for bad in (o.x.double(), o.x.cpu(), o.x[:63], o.x[None], rows[:, 0]):
        with pytest.raises(ValueError):  # dtype, device, shape, shape, stride
            tisect.geoms_hit(o._replace(x=bad), d, geoms)
    with pytest.raises(ValueError):  # one value broadcast to the wrong length
        tisect.geoms_hit(o, d._replace(z=d.z[:1].expand(63)), geoms)
    with pytest.raises(ValueError):  # CUDA rays never fall back to the plain path
        tisect.intersect_geoms(o._replace(x=o.x.double()), d, geoms)


def test_pair_intersector_on_cuda_matches_cpu(cuda):
    """The whole intersector with its three passes, kernels against plain
    versions: rays aimed at the silhouette of a 5,120-triangle sphere in
    8-triangle blocks (kp = 1024) leave rays for the exhaustive walk."""
    mesh = _mesh(4)
    rng = np.random.default_rng(1)
    c = np.array([0.3, -0.2, 0.5])
    u = rng.normal(size=(4096, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    w = rng.normal(size=(4096, 3))
    w -= (w * u).sum(1, keepdims=True) * u
    w /= np.linalg.norm(w, axis=1, keepdims=True)
    o = (c + 10.0 * u).astype(np.float32)
    d = c + w * rng.uniform(1.9, 2.05, (4096, 1)) - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    cfg = RenderConfig(cluster=True, cluster_tile=256, pair_slots=1)
    hits = [tpairs.intersect_mesh_pairs(torch.tensor(o, device=dev), torch.tensor(d, device=dev),
                                        build_cluster_mesh(mesh, block=8, device=dev), cfg,
                                        collect_stats=True)
            for dev in (cuda, torch.device("cpu"))]
    assert hits[0][1]["pass3_rays"] > 0
    assert torch.equal(hits[0][0].tri.cpu(), hits[1][0].tri)
    torch.testing.assert_close(hits[0][0].t.cpu(), hits[1][0].t, rtol=1e-5, atol=0)


# --------------------------------------------------------------------------
# kernels 9-12: the sphere cull, rounds, sweep and argmin bins
# --------------------------------------------------------------------------


def _records(cm, n, dead_tail, seed):
    """[n, 8] ray records (o d t0 act) of _walk_inputs' rays: some dead,
    the last ``dead_tail`` all dead."""
    x, *_ = _walk_inputs(cm, n, dead_tail, seed=seed)
    return x[:, :8].contiguous()


@pytest.mark.parametrize("subdiv, block, tile", [(4, 64, 256), (4, 64, 1024), (5, 8, 128),
                                                 (4, 64, 4096)])
def test_cluster_cull_kernel_bit_equal(cuda, subdiv, block, tile):
    """kp 128 and 2560; a ray tile of 4096 needs 160 KB of shared memory."""
    cm = build_cluster_mesh(_mesh(subdiv), block=block, device=cuda)
    x = _records(cm, 8192, tile, seed=tile)
    before = tcl.CULL.launches
    got = tcl.cull(x, cm.cull_w, cm.blk, tile)
    want = tcl._cull_ref(x, cm.cull_w, cm.blk, tile)
    assert tcl.CULL.launches == before + 1
    assert int((want < 1e30).sum()) > 100 and bool((want[-1] >= 1e30).all())
    assert torch.equal(got, want)


@pytest.mark.parametrize("kernel", ["slab_cull", "cluster_cull"])
@pytest.mark.parametrize("subdiv, block, n, tile, dead_frac", [
    (4, 64, 8192, 1024, 0.98),  # a few live rays a tile: idle warps share the groups
    (4, 64, 2048, 1024, 0.2),   # two tiles (a pass-3 call)
    (6, 10, 8192, 4096, 0.2),   # 8,192 blocks past one slice's shared memory
    (5, 8, 3840, 96, 0.5),      # tiles of three warps
])
def test_cull_kernels_bit_equal_on_sparse_and_wide_calls(cuda, kernel, subdiv, block, n, tile,
                                                         dead_frac):
    """Kernels 1 and 9 bit for bit against their plain versions on the
    launch shapes their tile-min loop (csrc/tile_cull.cuh) takes apart:
    few live rays, few tiles, more blocks than one slice holds, tiles that
    are not a multiple of the thread block; the last tile all dead."""
    cm = build_cluster_mesh(_mesh(subdiv), block=block, device=cuda)
    x, *_ = _walk_inputs(cm, n, tile, seed=n + tile, dead_frac=dead_frac)
    if kernel == "slab_cull":
        counter, call = twalk.SLAB_CULL, lambda: twalk.slab_cull(x, cm.slab, cm.blk, tile)
        want = twalk._slab_cull_ref(x, cm.slab, cm.blk, tile)
    else:
        x = x[:, :8].contiguous()
        counter, call = tcl.CULL, lambda: tcl.cull(x, cm.cull_w, cm.blk, tile)
        want = tcl._cull_ref(x, cm.cull_w, cm.blk, tile)
    before = counter.launches
    got = call()
    assert counter.launches == before + 1
    assert int((want < 1e30).sum()) > 10 and bool((want[-1] >= 1e30).all())
    assert torch.equal(got, want)


def _beam_records(cm, n, seed):
    """[n, 8] records of live rays from one point 8 units out, aimed within
    0.05 of one point of the sphere: they meet few of the table's groups."""
    rng = np.random.default_rng(seed)
    c = np.array([0.3, -0.2, 0.5], np.float32)
    o = np.broadcast_to(c + np.array([0.0, 0.0, 8.0], np.float32), (n, 3))
    d = c + np.array([0.0, 0.0, 2.0], np.float32) + rng.normal(size=(n, 3)) * 0.05 - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    x = np.concatenate([o, d, np.full((n, 1), 30.0), np.ones((n, 1))], axis=1)
    x = torch.tensor(x.astype(np.float32), device=cm.blk.device)
    x[:, 0:3] -= cm.center_shift
    return x


@pytest.mark.parametrize("case", ["mixed", "few_live", "all_dead", "beam"])
@pytest.mark.parametrize("subdiv, block", [(4, 64), (5, 8), (6, 10)])
def test_argmin_kernel_bit_equal(cuda, subdiv, block, case):
    """kp from 128 to 8192 (more blocks than one staged chunk of 512);
    3,000 rays, not a multiple of the thread block: some dead (mixed), 2%
    live (few_live: most warps of a thread block idle), none live
    (all_dead: every bin kp, no test), or a narrow beam (beam: most groups
    met by no ray)."""
    cm = build_cluster_mesh(_mesh(subdiv), block=block, device=cuda)
    if case == "beam":
        x = _beam_records(cm, 3000, seed=block)
    else:
        dead = {"mixed": 0.2, "few_live": 0.98, "all_dead": 1.0}[case]
        x, *_ = _walk_inputs(cm, 4096, 256, seed=block, dead_frac=dead)
        x = x[:3000, :8].contiguous()
    before = tbinned.ARGMIN.launches
    got = tbinned.argmin_bins(x, cm.cull_w, cm.blk)
    want = tbinned._argmin_ref(x, cm.cull_w, cm.blk)
    assert tbinned.ARGMIN.launches == before + 1
    hit = (want < cm.n_blocks).float().mean().item()
    if case == "all_dead":
        assert hit == 0.0
    elif case == "few_live":
        assert 0.0 < hit < 0.05
    else:
        assert 0.2 < hit <= 1.0
    if case == "beam":
        gsph = tcl._group_sphere(cm.cull_w, cm.blk, tcl.CULL_GROUP)
        met = (tcl._group_sphere_entry(x, gsph) < 1e30).any(dim=0)
        assert int((~met & (gsph[6] > 0)).sum()) >= 2  # real groups no ray meets
    assert torch.equal(got, want)
    assert torch.equal(tbinned._argmin_grouped(x, cm.cull_w, cm.blk), want)


def _round_inputs(cm, n, tile, rounds, seed, with_over=False):
    """The rounds' inputs for n rays in tiles of ``tile``; the last tile
    is all dead when there are several. With ``with_over``, also each
    tile's entry bound of the first feasible block left out (BIG when the
    list holds them all)."""
    x = _records(cm, n, tile if n > tile else 128, seed)
    sel, lb, over = tcl._select(tcl._cull_ref(x, cm.cull_w, cm.blk, tile), rounds)
    out = (sel, lb, tcl._ray_rows(x), x[:, 6].contiguous(), x[:, 7].contiguous())
    return out + (over,) if with_over else out


# Rays a thread block of kernel 10 takes (csrc/cluster_rounds.cu kPart).
ROUNDS_PART = 256


@pytest.mark.parametrize("block, tile, rounds, n_tiles", [
    (64, 256, 4, 8), (256, 1024, 64, 8), (1024, 128, 16, 8), (256, 1024, 4, 8),
    (64, 512, 1 << 20, 4),  # R = kp (select caps the rounds)
    (256, 1024, 1 << 20, 4),
    (256, 1024, 8, 1),  # one tile
    (9, 384, 8, 8),  # runs not 16-byte aligned; tiles of a part and a half
    (8, 200, 1 << 20, 4),  # tiles of less than a part
])
def test_cluster_rounds_kernel_matches_plain(cuda, block, tile, rounds, n_tiles):
    """Kernel 10 against its plain version, t and ids bit for bit (its skips
    are exact and the sparse test gives the dense test's floats): padded
    tables (real < block), R below some tiles' feasible count and R = K, an
    all-dead tile, one tile alone."""
    cm = build_cluster_mesh(_mesh(5), block=block, device=cuda)
    assert (cm.real[:cm.n_real_blocks] < block).any()
    n = n_tiles * tile
    sel, lb, r, t0, act, over = _round_inputs(cm, n, tile, rounds, seed=block + tile,
                                              with_over=True)
    if rounds > cm.n_blocks:
        assert sel.shape[1] == cm.n_blocks
    else:
        assert bool((over < 1e30).any())  # some tile has more feasible blocks than R
    if n_tiles > 1:  # the dead last tile has an empty list
        assert bool((lb[-1] >= 1e30).all())
    before = tcl.ROUNDS.launches
    counts = torch.zeros((n_tiles, 2), dtype=torch.int32, device=cuda)
    bt_k, btri_k = tcl.cluster_rounds(sel, lb, r, t0, act, cm, tile, rounds=counts)
    bt_p, btri_p = tcl._cluster_ref(sel, lb, r, t0, act, cm.w, tile, block, sel.shape[1])
    assert tcl.ROUNDS.launches == before + 1
    assert int((btri_p >= 0).sum()) > (n // 8 if rounds >= 16 else 10)
    assert torch.equal(btri_k, btri_p)
    assert torch.equal(bt_k, bt_p)
    nsel = (lb < 1e30).sum(dim=1)
    parts = -(-tile // ROUNDS_PART)
    assert (counts[:, 0] <= nsel * parts).all() and int(counts[:, 0].sum()) > 0
    if n_tiles > 1:
        assert not counts[-1].any()
    again = tcl.cluster_rounds(sel, lb, r, t0, act, cm, tile)
    assert torch.equal(again[0], bt_k) and torch.equal(again[1], btri_k)


@pytest.mark.parametrize("block, tile", [(64, 256), (256, 1024), (1024, 512)])
@pytest.mark.parametrize("listed", ["every", "some"])
def test_sweep_kernel_matches_plain(cuda, block, tile, listed):
    """Both launch shapes (one pass, and the block axis split in 5 slices
    merged by 64-bit atomics) and the shape the wrapper picks, against the
    plain version: every ray listed, or a third of them plus some dead
    lanes; blocks of 1024 stage in four chunks. The shapes agree bit for
    bit (each ray's tests are the same arithmetic)."""
    cm = build_cluster_mesh(_mesh(4), block=block, device=cuda)
    n = 4 * tile
    x = _records(cm, n, tile, seed=block)
    r, bt = tcl._ray_rows(x), x[:, 6].contiguous()
    btri = torch.full((n,), -1, dtype=torch.int32, device=cuda)
    btri[::5] = 7  # an earlier result that the sweep keeps where it finds nothing nearer
    rows = torch.arange(n, dtype=torch.int32, device=cuda)
    if listed == "some":
        rows = rows[(rows % 3 == 0) | (x[:, 7] == 0)]
    want = tcl._sweep_ref(rows, r, bt, btri, cm.w, tile, block, cm.n_real_blocks)
    assert int((want[1] >= 0).sum()) > rows.shape[0] // 4
    got = {}
    for slices in (1, 5, None):
        before = tcl.SWEEP.launches
        got[slices] = tcl.sweep(rows, r, bt, btri, cm, tile, slices=slices)
        assert tcl.SWEEP.launches == before + 1
        assert torch.equal(got[slices][1], want[1])
        torch.testing.assert_close(got[slices][0], want[0], rtol=1e-5, atol=0)
    for slices in (5, None):
        assert torch.equal(got[slices][0], got[1][0]) and torch.equal(got[slices][1], got[1][1])
    auto = tcl.SWEEP.call_int("cluster_sweep_slices", rows.shape[0], cm.n_real_blocks)
    assert auto > 1  # a few thousand rays fill far less than two waves


def test_cluster_wrappers_check_their_arguments(cuda):
    cm = build_cluster_mesh(_mesh(3), block=64, device=cuda)
    sel, lb, r, t0, act = _round_inputs(cm, 1024, 256, 4, seed=0)
    x = _records(cm, 1024, 256, seed=0)
    with pytest.raises(ValueError):
        tcl.cull(x, cm.cull_w, cm.blk, 384)  # does not divide n
    with pytest.raises(ValueError):
        tcl.cull(x, cm.cull_w, cm.blk, 8192)  # 320 KB of rays
    with pytest.raises(ValueError):
        tcl.cull(x.double(), cm.cull_w, cm.blk, 256)
    with pytest.raises(ValueError):
        tcl.cull(x, cm.cull_w[:, :-1].contiguous(), cm.blk, 256)
    with pytest.raises(ValueError):
        tcl.cluster_rounds(sel.long(), lb, r, t0, act, cm, 256)
    with pytest.raises(ValueError):  # 2048-triangle blocks need 257 KB staged
        tcl.cluster_rounds(sel, lb, r, t0, act, cm._replace(block=2048), 256)
    with pytest.raises(ValueError):  # a real-slot count short of the table
        tcl.cluster_rounds(sel, lb, r, t0, act, cm._replace(real=cm.real[:-1].contiguous()), 256)
    with pytest.raises(ValueError):  # a slab table without its hi rows
        tcl.cluster_rounds(sel, lb, r, t0, act, cm._replace(slab=cm.slab[:3].contiguous()), 256)
    with pytest.raises(ValueError):
        tcl.cluster_rounds(sel, lb, r, t0, act, cm, 384)  # does not divide n
    btri = torch.full((1024,), -1, dtype=torch.int32, device=cuda)
    rows = torch.arange(0, 1024, 3, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        tcl.sweep(rows.long(), r, t0, btri, cm, 256)
    with pytest.raises(ValueError):
        tcl.sweep(rows, r, t0, btri.float(), cm, 256)
    with pytest.raises(ValueError):
        tcl.sweep(rows, r, t0, btri, cm._replace(n_real_blocks=cm.n_blocks + 1), 256)
    with pytest.raises(ValueError):
        tcl.sweep(rows, r, t0, btri, cm._replace(real=cm.real.long()), 256)
    before = tcl.SWEEP.launches
    bt_e, btri_e = tcl.sweep(rows[:0], r, t0, btri, cm, 256)
    assert torch.equal(bt_e, t0) and torch.equal(btri_e, btri)
    assert tcl.SWEEP.launches == before
    with pytest.raises(ValueError):
        tbinned.argmin_bins(x[:, :7], cm.cull_w, cm.blk)
    before = (tcl.CULL.launches, tbinned.ARGMIN.launches)
    assert tcl.cull(x[:0], cm.cull_w, cm.blk, 256).shape == (0, cm.n_blocks)
    assert tbinned.argmin_bins(x[:0], cm.cull_w, cm.blk).shape == (0,)
    assert (tcl.CULL.launches, tbinned.ARGMIN.launches) == before


@pytest.mark.parametrize("route", ["cluster", "binned"])
def test_cluster_and_binned_intersectors_on_cuda_match_cpu(cuda, route):
    """The whole intersectors with one round, so that rays flag: the
    cluster path's sweep and binned's compacted pass run on the card."""
    mesh = _mesh(4)
    rng = np.random.default_rng(3)
    o = rng.normal(size=(8192, 3)).astype(np.float32) * 4.0
    d = np.array([0.3, -0.2, 0.5], np.float32) + rng.normal(size=(8192, 3)) - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    cfg = RenderConfig(cluster=True, cluster_pairs=False, cluster_binned=route == "binned",
                       cluster_tile=256, cluster_rounds=1, binned_rounds=1)
    fn = tcl.intersect_mesh_cluster if route == "cluster" else tbinned.intersect_mesh_binned
    hits = [fn(torch.tensor(o, device=dev), torch.tensor(d, device=dev),
               build_cluster_mesh(mesh, block=64, device=dev), cfg, collect_stats=True)
            for dev in (cuda, torch.device("cpu"))]
    assert hits[0][1]["repair"] == hits[1][1]["repair"] != "none"
    assert torch.equal(hits[0][0].tri.cpu(), hits[1][0].tri)
    torch.testing.assert_close(hits[0][0].t.cpu(), hits[1][0].t, rtol=1e-5, atol=0)


# --------------------------------------------------------------------------
# the other KD walks and the wavefront extras, on the card
# --------------------------------------------------------------------------

KD_WALKS = {
    "fatrow_shortstack": dict(short_stack=True),
    "packet": dict(packet_size=32),
    "skiplink": dict(fat_rows=False),
    "shortstack": dict(fat_rows=False, short_stack=True),
    "pushdown": dict(fat_rows=False, short_stack=True, push_down_restart=True),
}


@pytest.mark.parametrize("walk", list(KD_WALKS))
def test_kd_walks_on_cuda_match_brute_force_kernel(cuda, walk):
    """Each KD walk (plain PyTorch) on the card against kernel 8 on 8,192
    rays at a 5,120-triangle sphere in leaves of 8, a third with a t bound:
    source-mesh ids on every ray, t within 1e-4 relative (the JAX
    package's KD bound), no lane cut."""
    from kdtreepathtraceroptimization_tpu_torch.accel.kdtree import build_kdtree_from_mesh
    from kdtreepathtraceroptimization_tpu_torch.convert import kd_to_device
    from kdtreepathtraceroptimization_tpu_torch.ops.traverse import intersect_mesh_kd

    mesh = _mesh(4)
    kd = kd_to_device(build_kdtree_from_mesh(mesh, leaf_size=8), cuda)
    rng = np.random.default_rng(5)
    o = rng.normal(size=(8192, 3)).astype(np.float32) * 5.0
    d = np.array([0.3, -0.2, 0.5], np.float32) + rng.normal(size=(8192, 3)).astype(np.float32) - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    o, d = torch.tensor(o, device=cuda), torch.tensor(d, device=cuda)
    t_max = torch.where(torch.arange(8192, device=cuda) % 3 == 0, 5.0, 1e30)
    hit, stats = intersect_mesh_kd(o, d, kd, RenderConfig(**KD_WALKS[walk]), t_init=t_max,
                                   collect_stats=True)
    v = [torch.tensor(a, dtype=torch.float32, device=cuda) for a in (mesh.v0, mesh.v1, mesh.v2)]
    want = mxu_bf.intersect_brute_mxu(o, d, *v, t_max=t_max)
    src = torch.where(hit.tri >= 0, kd.tris.orig_index[hit.tri.clamp_min(0).long()], -1)
    assert stats["cut"] == 0 and int((want.tri >= 0).sum()) > 2000
    assert torch.equal(src, want.tri)
    both = want.tri >= 0
    torch.testing.assert_close(hit.t[both], want.t[both], rtol=1e-4, atol=0)


def test_reordered_and_cached_pair_renders_bit_equal_on_cuda(cuda, tmp_path):
    """On the pair path (5,120 triangles, 64x64, depth 4, 2 spp, AA on)
    compaction and the material sort give the default image bit for bit,
    and the ray cache's first iteration is the uncached one."""
    import os

    from kdtreepathtraceroptimization_tpu_torch.render.integrator import make_render_fn, render
    from kdtreepathtraceroptimization_tpu_torch.ops.rng import prng_key
    from kdtreepathtraceroptimization_tpu_torch.scene.parser import load_scene, with_resolution
    from kdtreepathtraceroptimization_tpu_torch.utils.procmesh import write_obj

    verts, faces = icosphere(4, radius=2.0, center=(0.0, 3.0, 0.0))
    obj = str(tmp_path / "ico4.obj")
    write_obj(obj, verts, faces)
    cornell = os.path.join(os.path.dirname(__file__), "..", "scenes", "cornell.txt")
    scene = with_resolution(load_scene(cornell, obj_path=obj, device=cuda), 64, 64)
    base = dict(trace_depth=4, antialias=True, cluster_tile=256)
    before = tpairs.PAIR_RUNS.launches
    want = render(scene, RenderConfig(**base), spp=2, device=cuda)
    assert tpairs.PAIR_RUNS.launches > before
    for kw in (dict(compaction=True), dict(material_sort=True)):
        assert torch.equal(render(scene, RenderConfig(**base, **kw), spp=2, device=cuda), want)
    films = [make_render_fn(scene, RenderConfig(**base, ray_cache=cache), seed=0, device=cuda)(
        torch.zeros((64 * 64, 3), device=cuda), prng_key(0), 1) for cache in (False, True)]
    assert torch.equal(films[0], films[1])


# --------------------------------------------------------------------------
# the ray-axis split and binned_shards, on the card
# --------------------------------------------------------------------------


@pytest.mark.parametrize("route", ["pairs", "walk"])
def test_slabs_bit_equal_on_cuda(cuda, tmp_path, route):
    """The slabs of worlds 1, 2, 3 and 4 (64x64, depth 4, AA on, 5,120
    triangles), each rendered on its own by make_render_fn(pixels=),
    concatenate to make_render_fn's film bit for bit: the streams are keyed
    by pixel and the intersectors exact per ray."""
    import os

    from kdtreepathtraceroptimization_tpu_torch.ops.rng import prng_key
    from kdtreepathtraceroptimization_tpu_torch.parallel import sharding
    from kdtreepathtraceroptimization_tpu_torch.render.integrator import make_render_fn
    from kdtreepathtraceroptimization_tpu_torch.scene.parser import load_scene, with_resolution
    from kdtreepathtraceroptimization_tpu_torch.utils.procmesh import write_obj

    verts, faces = icosphere(4, radius=2.0, center=(0.0, 3.0, 0.0))
    obj = str(tmp_path / "ico4.obj")
    write_obj(obj, verts, faces)
    cornell = os.path.join(os.path.dirname(__file__), "..", "scenes", "cornell.txt")
    scene = with_resolution(load_scene(cornell, obj_path=obj, device=cuda), 64, 64)
    kw = {} if route == "pairs" else dict(cluster=True, cluster_walk=True, cluster_pairs=False)
    cfg = RenderConfig(trace_depth=4, antialias=True, cluster_tile=256, **kw)
    full = make_render_fn(scene, cfg, device=cuda)(torch.zeros((4096, 3), device=cuda),
                                                   prng_key(0), 1)
    assert full.mean() > 0
    for world in (1, 2, 3, 4):
        parts = []
        for r in range(world):
            lo, hi = sharding.slab(r, world, 4096)
            parts.append(make_render_fn(scene, cfg, device=cuda, pixels=(lo, hi))(
                torch.zeros((hi - lo, 3), device=cuda), prng_key(0), 1))
        assert torch.equal(torch.cat(parts), full), world


@pytest.mark.parametrize("shards", [2, 4, 8])
@pytest.mark.parametrize("route", ["pairs", "walk", "binned"])
def test_binned_shards_on_cuda(cuda, route, shards):
    """binned_shards = S on the card against S = 1 on 16,384 rays at a
    5,120-triangle sphere in blocks of 64, a fifth of them dead, a third
    with a t bound, binned with 2 rounds (its repair runs): the pair list
    and the walk bit for bit; binned ids on >= 99.99% of rays and t within
    1e-5 relative (a ray's tile may change whether the rounds' sparse test
    or the sweep's dense one resolves it)."""
    mesh = _mesh(4)
    rng = np.random.default_rng(11)
    n = 16384
    o = rng.normal(size=(n, 3)).astype(np.float32) * 4.0
    d = np.array([0.3, -0.2, 0.5], np.float32) + rng.normal(size=(n, 3)) - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    o, d = torch.tensor(o, device=cuda), torch.tensor(d, device=cuda)
    act = torch.arange(n, device=cuda) % 5 != 0
    t0 = torch.where(torch.arange(n, device=cuda) % 3 == 0, 5.0, 1e30)
    cm = build_cluster_mesh(mesh, block=64, device=cuda)
    kw = {"pairs": dict(cluster=True, cluster_pairs=True),
          "walk": dict(cluster=True, cluster_walk=True, cluster_pairs=False),
          "binned": dict(cluster=True, cluster_pairs=False, cluster_binned=True,
                         binned_rounds=2)}[route]
    fn = {"pairs": tpairs.intersect_mesh_pairs, "walk": twalk.intersect_mesh_walk,
          "binned": tbinned.intersect_mesh_binned}[route]
    base, hit = (fn(o, d, cm, RenderConfig(cluster_tile=256, binned_shards=s, **kw),
                    t_init=t0, active=act) for s in (1, shards))
    assert int((base.tri >= 0).sum()) > 2000
    if route != "binned":
        assert torch.equal(hit.tri, base.tri) and torch.equal(hit.t, base.t)
    else:
        assert (hit.tri == base.tri).float().mean().item() >= 0.9999
        both = (hit.tri >= 0) & (base.tri >= 0)
        torch.testing.assert_close(hit.t[both], base.t[both], rtol=1e-5, atol=0)


# --------------------------------------------------------------------------
# kernel 13: the analytic geoms' nearest hit
# --------------------------------------------------------------------------

SCENES = os.path.join(os.path.dirname(__file__), "..", "scenes")
GEOM_SCENES = ["cornell.txt", "cornell_spheres.txt", "sphere.txt",
               "cornell2.txt+cornell4.txt"]  # 24 geoms: two launches


def _geoms(names):
    from kdtreepathtraceroptimization_tpu_torch.scene.parser import load_scene

    parts = [load_scene(os.path.join(SCENES, f), device="cpu").geoms for f in names.split("+")]
    return type(parts[0])(*(np.concatenate(a) for a in zip(*parts)))


def _geom_rays(geoms, n, seed):
    """[n, 3] origins and directions: a third from around the geoms, a
    third from their centres (inside a cube or a sphere), a third from 20
    units away; an eighth of the directions along an axis, an eighth with
    one component 0, a few all 0."""
    rng = np.random.default_rng(seed)
    centres = geoms.transform[:, :3, 3].astype(np.float64)
    lo, hi = centres.min(0) - 3.0, centres.max(0) + 3.0
    pick = centres[rng.integers(0, len(centres), n)]
    far = rng.normal(size=(n, 3))
    far = centres.mean(0) + 20.0 * far / np.linalg.norm(far, axis=1, keepdims=True)
    o = np.where((np.arange(n) % 3 == 0)[:, None], rng.uniform(lo, hi, (n, 3)),
                 np.where((np.arange(n) % 3 == 1)[:, None],
                          pick + rng.normal(scale=0.05, size=(n, 3)), far))
    d = rng.normal(size=(n, 3))
    k = np.arange(n) % 8
    axis = rng.integers(0, 3, n)
    d[k == 0] = 0.0
    d[k == 0, axis[k == 0]] = rng.choice([-1.0, 1.0], int((k == 0).sum()))
    d[k == 1, axis[k == 1]] = 0.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[np.arange(n) % 97 == 5] = 0.0
    return o.astype(np.float32), d.astype(np.float32)


def _hits_equal(a, b):
    for f in ("t", "material_id", "outside"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    for f in ("point", "normal"):
        for c in "xyz":
            assert torch.equal(getattr(getattr(a, f), c), getattr(getattr(b, f), c)), f + c


@pytest.mark.parametrize("n", [65536, 3001, 1])
@pytest.mark.parametrize("scene", GEOM_SCENES)
def test_geoms_hit_kernel_bit_equal(cuda, scene, n):
    """Kernel 13 against the plain version, every field bit for bit, on
    cubes and spheres, rays inside them, axis-parallel and zero
    directions, and an n that is not a multiple of the thread block."""
    geoms = _geoms(scene)
    o, d = (V3(*torch.tensor(a, device=cuda).T.contiguous()) for a in _geom_rays(geoms, n, n))
    before = tisect.GEOMS_HIT.launches
    got = tisect.intersect_geoms(o, d, geoms)
    assert tisect.GEOMS_HIT.launches - before == -(-geoms.count // tisect.MAX_GEOMS)
    want = tisect._intersect_geoms_plain(o, d, geoms)
    _hits_equal(got, want)
    if n > 1:
        hit = want.t < tisect.BIG
        assert hit.any() and (~hit).any() and (hit & ~want.outside).any()


def test_geoms_hit_kernel_bit_equal_on_camera_rays(cuda):
    """Camera rays of the Cornell box (their origin one value broadcast to
    every lane), as V3 channels and as [N, 3] rows; rays that want a
    gradient take the plain path and get the same values."""
    from kdtreepathtraceroptimization_tpu_torch.ops.camera import generate_rays
    from kdtreepathtraceroptimization_tpu_torch.ops.rng import bounce_key, prng_key
    from kdtreepathtraceroptimization_tpu_torch.scene.parser import load_scene, with_resolution

    scene = with_resolution(load_scene(os.path.join(SCENES, "cornell.txt"), device=cuda), 96, 96)
    rays = generate_rays(scene.camera, RenderConfig(antialias=True),
                         bounce_key(prng_key(0), 1, 0), 8, cuda)
    assert rays.origin.x.stride(0) == 0
    want = tisect._intersect_geoms_plain(rays.origin, rays.direction, scene.geoms)
    rows = tuple(torch.stack(list(v), dim=1) for v in (rays.origin, rays.direction))
    before = tisect.GEOMS_HIT.launches
    for o, d in ((rays.origin, rays.direction), rows):
        _hits_equal(tisect.intersect_geoms(o, d, scene.geoms), want)
    assert tisect.GEOMS_HIT.launches == before + 2
    d = V3(*(c.clone().requires_grad_(True) for c in rays.direction))
    got = tisect.intersect_geoms(rays.origin, d, scene.geoms)
    assert tisect.GEOMS_HIT.launches == before + 2 and got.t.requires_grad
    _hits_equal(tisect.Hit(*(f.detach() if isinstance(f, torch.Tensor)
                             else V3(*(c.detach() for c in f)) for f in got)), want)


def test_pair_render_bit_equal_with_geoms_kernel(cuda, tmp_path, monkeypatch):
    """One 256x256 depth-8 frame of Cornell + a 5,120-triangle icosphere on
    the pair route: the film with kernel 13 equals the film with the plain
    version; the kernel launches once a bounce."""
    from kdtreepathtraceroptimization_tpu_torch.ops.rng import prng_key
    from kdtreepathtraceroptimization_tpu_torch.render.integrator import make_render_fn, mesh_route
    from kdtreepathtraceroptimization_tpu_torch.scene.parser import load_scene, with_resolution
    from kdtreepathtraceroptimization_tpu_torch.utils.procmesh import write_obj

    verts, faces = icosphere(4, radius=2.0, center=(0.0, 3.0, 0.0))
    obj = str(tmp_path / "ico4.obj")
    write_obj(obj, verts, faces)
    scene = with_resolution(load_scene(os.path.join(SCENES, "cornell.txt"), obj_path=obj,
                                       device=cuda), 256, 256)
    cfg = RenderConfig(trace_depth=8, antialias=True, cluster_tile=256)
    assert mesh_route(scene.mesh, scene.cmesh, cfg, scene.kd) == "pairs"

    def frame():
        return make_render_fn(scene, cfg, device=cuda)(
            torch.zeros((256 * 256, 3), device=cuda), prng_key(0), 1)

    before = tisect.GEOMS_HIT.launches
    got = frame()
    assert tisect.GEOMS_HIT.launches - before == 8
    monkeypatch.setattr(tisect, "_kernel_takes", lambda channels: False)
    want = frame()
    assert tisect.GEOMS_HIT.launches - before == 8
    assert want.abs().sum() > 0 and torch.equal(got, want)
