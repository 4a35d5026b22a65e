"""The CUDA kernels against their plain versions, on the card.

Marked ``gpu``: they need a CUDA device with nvcc and skip elsewhere. On
the H100 run ``python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q``
(``--noconftest``: the suite's conftest imports JAX, which that machine lacks).
``chip_smoke.py`` checks the kernels at the main path's shapes; these
tests cover the other shapes the wrappers accept: tiles whose staging
needs more than 48 KB of shared memory, 64- to 1024-triangle blocks,
tiles with empty feasible lists or only dead rays, 1 to 16 pair slots,
block tables of 1024 to 8192 blocks, pair tiles that are all sentinel or
split a run, triangle counts that are not a multiple of the brute
force's block, and bad arguments. Tolerances: slab cull, extraction and
gather-to-columns bit for bit; walk and brute-force triangle ids exactly
and t within 1e-5 relative (their 10-term sums may round differently
from the batched product); the pair test's loc on >= 99.9% of real
pairs and t within 2^-12 relative (the same rounding, seen through the
2^-13 truncation of the packed key); the scatter-add of kernel 4 per
entry within 1e-5 of the sum of the |contributions| to it (its float
atomics add in an order that changes from run to run).
"""

import numpy as np
import pytest
import torch

from kdtreepathtraceroptimization_tpu_torch.config import RenderConfig
from kdtreepathtraceroptimization_tpu_torch.ops import mesh as tmesh
from kdtreepathtraceroptimization_tpu_torch.ops import mxu_bf
from kdtreepathtraceroptimization_tpu_torch.ops import pairs as tpairs
from kdtreepathtraceroptimization_tpu_torch.ops import walk as twalk
from kdtreepathtraceroptimization_tpu_torch.ops.cluster import build_cluster_mesh
from kdtreepathtraceroptimization_tpu_torch.scene.structs import MeshSoA
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


def _walk_inputs(cm, n, tile, seed, dead_frac=0.2):
    """Sorted walk inputs for random rays, the way intersect_mesh_walk
    builds them; the last tile is all dead."""
    rng = np.random.default_rng(seed)
    dev = cm.w.device
    # origins around the sphere, aimed near its centre: most rays hit
    o = rng.normal(size=(n, 3)).astype(np.float32) * 4.0
    d = (np.array([0.3, -0.2, 0.5], np.float32)
         + rng.normal(size=(n, 3)).astype(np.float32) * 1.5 - o)
    o = torch.tensor(o, device=dev)
    d = torch.tensor(d / np.linalg.norm(d, axis=1, keepdims=True), device=dev)
    act = torch.tensor(rng.uniform(size=n) > dead_frac, device=dev)
    act[-tile:] = False
    t0 = torch.tensor(rng.uniform(2.0, 20.0, n).astype(np.float32), device=dev)
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


@pytest.mark.parametrize("block, tile", [(64, 256), (256, 1024), (512, 512), (1024, 128)])
def test_walk_kernel_matches_plain(cuda, block, tile):
    cm = build_cluster_mesh(_mesh(5), block=block, device=cuda)
    n = 8 * tile
    x, sel, lb, nsel, r, t0, act = _walk_inputs(cm, n, tile, seed=block)
    assert int(nsel.min()) == 0  # the dead tile has an empty list
    before = twalk.WALK.launches
    bt_k, btri_k = twalk.walk(sel, lb, nsel, r, t0, act, cm.w, tile, block)
    bt_p, btri_p = twalk._walk_ref(sel, lb, r, t0, act, cm.w, tile, block)
    assert twalk.WALK.launches == before + 1
    assert int((btri_p >= 0).sum()) > n // 4
    assert torch.equal(btri_k, btri_p)
    torch.testing.assert_close(bt_k, bt_p, rtol=1e-5, atol=0)
    assert (btri_k[-tile:] == -1).all()


@pytest.mark.parametrize("n, c", [(1, 19), (1000, 19), (640_000, 19), (5000, 3)])
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
        twalk.walk(sel.long(), lb, nsel, r, t0, act, cm.w, 256, cm.block)
    with pytest.raises(ValueError):
        twalk.walk(sel, lb, nsel, r.T.contiguous().T, t0, act, cm.w, 256, cm.block)
    with pytest.raises(ValueError):
        tmesh.gather_cols(torch.zeros((4, 19), device=cuda), torch.zeros(3, dtype=torch.int64, device=cuda))
    before = tmesh.GATHER_COLS.launches
    out = tmesh.gather_cols(torch.zeros((4, 19), device=cuda),
                            torch.zeros(0, dtype=torch.int32, device=cuda))
    assert out.shape == (19, 0) and tmesh.GATHER_COLS.launches == before


def test_walk_intersector_on_cuda_matches_cpu(cuda):
    """The whole intersector, kernels against plain versions."""
    mesh = _mesh(4)
    rng = np.random.default_rng(3)
    o = rng.normal(size=(4096, 3)).astype(np.float32) * 4.0
    d = rng.normal(size=(4096, 3)).astype(np.float32)
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


@pytest.mark.parametrize("subdiv, block, F", [
    (4, 64, 1), (4, 64, 3), (5, 8, 12), (5, 8, 16), (6, 10, 3),
])
def test_extract_kernel_bit_equal(cuda, subdiv, block, F):
    """kp from 128 to 8192 (icosphere-6 in 10-triangle leaves: the cap)."""
    cm = build_cluster_mesh(_mesh(subdiv), block=block, device=cuda)
    x = _pair_inputs(cm, 8192, seed=F)
    before = tpairs.EXTRACT.launches
    got = tpairs.extract(x, cm.slab, cm.blk, F)
    want = tpairs._extract_ref(x, cm.slab, cm.blk, F)
    assert tpairs.EXTRACT.launches == before + 1
    assert int((want[2] > F).sum()) > 0 or F == 16
    for a, b in zip(got, want):
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


@pytest.mark.parametrize("block, ptile", [(64, 256), (256, 256), (1024, 128)])
def test_pair_runs_kernel_matches_plain(cuda, block, ptile):
    """Block-sorted pairs from a real extraction: runs that split tiles,
    and a tail of whole tiles that are all sentinel."""
    cm = build_cluster_mesh(_mesh(5), block=block, device=cuda)
    x = _pair_inputs(cm, 4096, seed=block)
    ids, _, _, feat = tpairs.extract(x, cm.slab, cm.blk, 3)
    flat = torch.cat([ids.reshape(-1), torch.full((4 * ptile,), cm.n_blocks,
                                                  dtype=torch.int32, device=cuda)])
    blk_s, src = torch.sort(flat, stable=True)
    featp = feat[torch.clamp_max(src // 3, 4095)]
    before = tpairs.PAIR_RUNS.launches
    got = tpairs.pair_runs(blk_s, featp, cm.w, block, ptile, cm.n_real_blocks)
    want = tpairs._pair_runs_ref(blk_s, featp, cm.w, block, cm.n_real_blocks)
    assert tpairs.PAIR_RUNS.launches == before + 1
    tiles = blk_s.reshape(-1, ptile)
    # a run that goes on from one tile into the next
    assert bool(((tiles[1:, 0] == tiles[:-1, -1]) & (tiles[1:, 0] < cm.n_real_blocks)).any())
    assert bool((tiles[:, 0] >= cm.n_real_blocks).any())
    _check_packed(got, want, blk_s, cm.n_real_blocks)


@pytest.mark.parametrize("n_tris_subdiv, tri_block, ray_tile", [(3, 512, 1024), (4, 64, 256),
                                                                 (4, 1024, 512)])
def test_brute_force_kernel_matches_plain(cuda, n_tris_subdiv, tri_block, ray_tile):
    """1,280 or 5,120 triangles (not multiples of 512 or 1024), 3,000 rays
    (not a multiple of the ray tile), some with a t bound."""
    mesh = build_cluster_mesh(_mesh(n_tris_subdiv), block=64, device=cuda).tris
    rng = np.random.default_rng(tri_block)
    o = torch.tensor(rng.normal(size=(3000, 3)).astype(np.float32) * 4.0, device=cuda)
    d = torch.tensor(np.array([0.3, -0.2, 0.5], np.float32)
                     + rng.normal(size=(3000, 3)).astype(np.float32), device=cuda) - o
    d = d / d.norm(dim=1, keepdim=True)
    t_max = torch.where(torch.arange(3000, device=cuda) % 3 == 0, 4.0, 1e30)
    before = mxu_bf.BF.launches
    got = mxu_bf.intersect_brute_mxu(o, d, mesh.v0, mesh.v1, mesh.v2, t_max=t_max,
                                     ray_tile=ray_tile, tri_block=tri_block)
    want = mxu_bf.intersect_brute_mxu_ref(o, d, mesh.v0, mesh.v1, mesh.v2, t_max=t_max,
                                          block=tri_block)
    assert mxu_bf.BF.launches == before + 1
    assert int((want.tri >= 0).sum()) > 300
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
        tpairs.pair_runs(blk_s, feat, cm.w, 64, 384, cm.n_real_blocks)
    with pytest.raises(ValueError):
        tpairs.pair_runs(blk_s.long(), feat, cm.w, 64, 256, cm.n_real_blocks)
    v = cm.tris.v0
    with pytest.raises(ValueError):  # 82-ray tiles: not 4 rays per thread
        mxu_bf.intersect_brute_mxu(x[:, :3], x[:, 3:6], v, v, v, ray_tile=82)
    with pytest.raises(ValueError):  # 2048-triangle blocks need 320 KB
        mxu_bf.intersect_brute_mxu(x[:, :3], x[:, 3:6], v, v, v, tri_block=2048)


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
