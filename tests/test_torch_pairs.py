"""The pair-list intersector and its kernels' plain versions against the
JAX package.

Inputs are the JAX cluster tests' meshes and ray sets (numpy seeds), plus
grazing rays that cross many blocks without a hit, which is what leaves
rays for the third pass. Tolerances: the extraction is bit for bit
(against the JAX mirror run eagerly, as the port's arithmetic is unfused
like the TPU's); the pair test's packed (t | loc) keys and every
intersector's triangle ids exactly, with t within 1e-6 relative (a
16-term float32 product summed in another order); brute force within the
JAX pair tests' own 2e-4.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kdtreepathtraceroptimization_tpu.config import RenderConfig as JCfg
from kdtreepathtraceroptimization_tpu.ops import camera as jcam
from kdtreepathtraceroptimization_tpu.ops import intersect as jisect
from kdtreepathtraceroptimization_tpu.ops import pairs as jpairs
from kdtreepathtraceroptimization_tpu.ops import walk as jwalk
from kdtreepathtraceroptimization_tpu.ops.cluster import build_cluster_mesh as jbuild
from kdtreepathtraceroptimization_tpu.ops.mesh import intersect_mesh_brute
from kdtreepathtraceroptimization_tpu.ops.rng import bounce_key
from kdtreepathtraceroptimization_tpu.render.integrator import render as jrender
from kdtreepathtraceroptimization_tpu.scene import parser as jparser
from kdtreepathtraceroptimization_tpu_torch.config import RenderConfig as TCfg
from kdtreepathtraceroptimization_tpu_torch.convert import scene_from_numpy
from kdtreepathtraceroptimization_tpu_torch.ops import intersect as tisect
from kdtreepathtraceroptimization_tpu_torch.ops import pairs as tpairs
from kdtreepathtraceroptimization_tpu_torch.ops import walk as twalk
from kdtreepathtraceroptimization_tpu_torch.ops.cluster import build_cluster_mesh as tbuild
from kdtreepathtraceroptimization_tpu_torch.render.integrator import mesh_route, render
from kdtreepathtraceroptimization_tpu_torch.scene import parser as tparser
from tests.test_cluster import _mesh, _rays
from tests.test_torch_render import CORNELL, GOLDENS, _mesh_obj
from tests.test_torch_walk import _fma_entries

T_RTOL = 1e-6
PAIRS = dict(cluster=True, cluster_pairs=True)
# The mesh_pairs_48 pixels whose paths branch in the golden itself (jit).
JIT_BRANCHED_PIXELS = (490, 518)


def _t(a):
    return torch.from_numpy(np.array(a))


def _tables(subdiv, block=64):
    mesh = _mesh(subdiv)
    return mesh, jbuild(mesh, block=block), tbuild(mesh, block=block, device="cpu")


def _x(cm, o, d):
    """The JAX _ray16 record of a ray set with dead rays (every 7th) and
    t0 bounds from 0.5 to 30."""
    n = o.shape[0]
    act = np.arange(n) % 7 != 0
    t0 = np.linspace(0.5, 30.0, n).astype(np.float32)
    return jwalk._ray16(jnp.asarray(o) - cm.center_shift, d * act[:, None],
                        jnp.asarray(t0), jnp.asarray(act, jnp.float32))


def _grazing_rays(n, seed):
    """Rays from 10 units out aimed at the sphere's silhouette: they cross
    many block boxes, and about a tenth miss."""
    rng = np.random.default_rng(seed)
    c = np.array([0.3, -0.2, 0.5])  # tests.test_cluster._mesh's centre
    u = rng.normal(size=(n, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    v = rng.normal(size=(n, 3))
    v -= (v * u).sum(1, keepdims=True) * u
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    o = c + 10.0 * u
    d = c + v * rng.uniform(1.9, 2.05, (n, 1)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


@pytest.mark.parametrize("F", [3, 12])
def test_extract_matches_jax_eager_ref(F):
    """ids, lb_over, count and the feature record, bit for bit, with
    grazing rays on a 2048-block table."""
    _, jcm, tcm = _tables(4, 4)
    x = _x(jcm, *_grazing_rays(2048, seed=1))
    want = jpairs._extract_ref(x, jcm.slab, jcm.blk, F)
    got = tpairs.extract(_t(x), tcm.slab, tcm.blk, F)
    assert (np.asarray(want[2]) > F).sum() > 10  # some rays overflow the window
    for a, b in zip(want, got):
        assert b.dtype == (torch.int32 if np.asarray(a).dtype == np.int32 else torch.float32)
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_extract_matches_pallas_interpret_through_fused_entries():
    """The TPU kernel in interpret mode runs under jit, where XLA's CPU
    compiler fuses ``lo * invd - oinv`` into an FMA. Its ids, counts and
    lb_over equal the port's selection applied to the fused entries, bit
    for bit; the port's own (unfused) selection agrees on >= 99% of the
    ids here."""
    _, jcm, tcm = _tables(3)
    x = _x(jcm, *_rays(1024, seed=2))
    F = 3
    ids_i, lbov_i, cnt_i, feat_i = jpairs._extract_pallas(x, jcm.slab, jcm.blk, 256, F, True)
    fused = torch.from_numpy(_fma_entries(x, jcm.slab, jcm.blk, 1))
    kp = fused.shape[1]
    key = (fused.view(torch.int32) & ~tpairs._IDX_MASK) | torch.arange(kp, dtype=torch.int32)
    top = torch.sort(key, dim=1).values[:, :F + 1]
    ids_f = torch.where(top[:, :F] < tpairs._BIG_KEY, top[:, :F] & tpairs._IDX_MASK, kp)
    lbov_f = torch.where(top[:, F] < tpairs._BIG_KEY,
                         (top[:, F] & ~tpairs._IDX_MASK).view(torch.float32), 1e30)
    np.testing.assert_array_equal(np.asarray(ids_i), ids_f.numpy())
    np.testing.assert_array_equal(np.asarray(lbov_i), lbov_f.numpy())
    np.testing.assert_array_equal(np.asarray(cnt_i), (fused < 1e30).sum(1).numpy())
    ids_t, _, cnt_t, feat_t = tpairs.extract(_t(x), tcm.slab, tcm.blk, F)
    assert (np.asarray(ids_i) == ids_t.numpy()).mean() >= 0.99
    np.testing.assert_allclose(np.asarray(feat_i), feat_t.numpy(), rtol=1e-6, atol=1e-6)


def _face_rays(slab, blk):
    """Axis-parallel rays whose origins lie on a face of a real block's box
    (the face's centre), moving along one of the face's two axes, both
    ways: the slab cull's hazard (a ray with d_a = 0 whose o_a lies on a
    box face; the camera of the Cornell scenes sits on the icosphere's
    split plane x = 0), as _ray16 records with t0 = 30."""
    lo, hi = slab[0:3].T, slab[3:6].T
    real = blk[5] >= 0.0
    lo, hi = lo[real], hi[real]
    cen = 0.5 * (lo + hi)
    o, d = [], []
    for a in range(3):
        for face in (lo, hi):
            for b in range(3):
                if b == a:
                    continue
                for sign in (1.0, -1.0):
                    oa = cen.clone()
                    oa[:, a] = face[:, a]
                    da = torch.zeros_like(oa)
                    da[:, b] = sign
                    o.append(oa)
                    d.append(da)
    o, d = torch.cat(o), torch.cat(d)
    n = o.shape[0]
    return twalk._ray16(o, d, torch.full((n,), 30.0), torch.ones((n,)))


def _record(monkeypatch, module, name):
    """Keeps the arguments of every call to ``module.name``."""
    calls = []
    real = getattr(module, name)

    def record(*args, **kwargs):
        calls.append(args)
        return real(*args, **kwargs)

    monkeypatch.setattr(module, name, record)
    return calls


# The group premise's routes: kernel 5's calls on the pair path (its ids
# keep the test's earlier names), kernel 1's on the walk route and on a
# pass-3 call of the pair path.
_PREMISE_CASES = ([pytest.param("pairs", G, id=str(G)) for G in (4, 8, 16)]
                  + [pytest.param(route, G, id=f"{route}-{G}")
                     for route in ("walk", "pass3") for G in (4, 8, 16)])


@pytest.mark.parametrize("route, G", _PREMISE_CASES)
def test_extract_group_premise_on_its_own_inputs(tmp_path, monkeypatch, route, G):
    """Kernels 5 (the extraction) and 1 (the slab cull) run a group's
    member tests for a warp only if the group test (``_group_entry`` on
    ``_group_slab``'s union boxes) passes for one of its rays. That is exact
    if every block the exact test passes (a finite ``_slab_entry_math``
    entry) lies in a group whose group test passes for the same ray.
    Checked on every ``extract`` call of a depth-2 render of icosphere-3 in
    the Cornell box (32x32, so 1,024 rays a bounce, passes 1 and 2; 64-slot
    blocks: 20 real blocks and 108 sentinels, so the groups hold sentinel
    members and some none), the default config; on every ``slab_cull``
    call of the same render on the walk route; and on the pass-3 calls of
    the pair path on grazing rays (a 1,280-block table of 4-triangle
    blocks, one slot a ray); each with axis-parallel rays from block faces.
    On kernel 1's calls the kernel's skip in plain form
    (``_slab_cull_grouped``) also equals the plain slab cull bit for bit."""
    if route == "pass3":
        _, _, tcm = _tables(4, 4)
        calls = _record(monkeypatch, twalk, "slab_cull")
        o, d = _grazing_rays(1024, seed=1)
        _, stats = tpairs.intersect_mesh_pairs(
            _t(o), _t(d), tcm, TCfg(cluster_tile=256, pair_slots=1, **PAIRS),
            collect_stats=True)
        assert stats["p3_rounds"] >= 1 and len(calls) == stats["p3_rounds"]
    else:
        scene = tparser.with_resolution(
            tparser.load_scene(CORNELL, obj_path=_mesh_obj(tmp_path, 3, 2.5),
                               cluster_block=64, device="cpu"), 32, 32)
        cfg = TCfg(trace_depth=2) if route == "pairs" else TCfg(
            trace_depth=2, cluster=True, cluster_walk=True, cluster_pairs=False)
        assert mesh_route(scene.mesh, scene.cmesh, cfg) == route
        calls = _record(monkeypatch, tpairs if route == "pairs" else twalk,
                        "extract" if route == "pairs" else "slab_cull")
        render(scene, cfg, spp=2, seed=0, device="cpu")
        if route == "pairs":
            assert len(calls) == 8 and {c[3] for c in calls} == {TCfg().pair_slots, tpairs.F2}
        else:
            assert len(calls) == 4
    slab, blk = calls[0][1], calls[0][2]
    if route != "pairs":
        for x, _, _, tile in calls:
            assert torch.equal(twalk._slab_cull_grouped(x, slab, blk, tile, G),
                               twalk._slab_cull_ref(x, slab, blk, tile))
    calls.append((_face_rays(slab, blk), slab, blk, 3))
    kp = blk.shape[1]
    group_of = torch.arange(kp) // G
    feasible_faces = culled = 0
    for x, slab, blk, _ in calls:
        gslab = twalk._group_slab(slab, blk, G)
        feasible = twalk._slab_entry_math(x, slab, blk, kp) < 1e30
        meets = twalk._group_entry(x, gslab) < 1e30
        assert not (feasible & ~meets[:, group_of]).any()
        live = x[:, 7] > 0
        culled += int((live[:, None] & (gslab[6] > 0)[None] & ~meets).sum())
        feasible_faces = int(feasible.sum())  # the last call's: the face rays
    assert feasible_faces > 100 and culled > 0


def test_group_slab_is_the_union_of_real_members():
    """``_group_slab`` against a numpy union over a 37-block table in
    groups of 8: a ragged last group (5 blocks), an all-sentinel (empty)
    group, sentinel members among real ones, and boxes whose lo exceeds
    hi on an axis (the union holds both ends)."""
    rng = np.random.default_rng(5)
    kp, G = 37, 8
    lo = rng.normal(size=(3, kp)).astype(np.float32)
    hi = lo + rng.uniform(0.0, 2.0, (3, kp)).astype(np.float32)
    hi[1, 3] = lo[1, 3] - 0.5  # an inverted axis
    slab = np.zeros((8, kp), np.float32)
    slab[0:3], slab[3:6] = lo, hi
    r2 = np.ones(kp, np.float32)
    r2[8:16] = -1.0  # group 1: no real member
    r2[[17, 20, 33]] = -1.0  # sentinels among real members, one in the ragged group
    blk = np.zeros((8, kp), np.float32)
    blk[5] = r2
    got = twalk._group_slab(_t(slab), _t(blk), G).numpy()
    assert got.shape == (8, 5)
    for g in range(5):
        ks = [k for k in range(g * G, min(kp, (g + 1) * G)) if r2[k] >= 0]
        if not ks:
            assert got[6, g] == -1.0 and (got[0:3, g] >= 1e30).all()
            continue
        both = np.concatenate([lo[:, ks], hi[:, ks]], axis=1)
        np.testing.assert_array_equal(got[0:3, g], both.min(axis=1))
        np.testing.assert_array_equal(got[3:6, g], both.max(axis=1))
        assert got[6, g] == 1.0
    np.testing.assert_array_equal(got[7], 0.0)


def test_extract_group_premise_on_near_misses():
    """The group test's widening against the member test's slack where it
    matters: rays that miss a member box by less than its slack (aimed
    just past a box corner, at distances from 0.01 to 1e4), many with
    d_a = 0, against a table of 4,096 small boxes in groups of 16 whose
    union boxes reach far from the members (one member near the origin,
    the others far). Every block the exact test passes lies in a group
    the group test passes."""
    rng = np.random.default_rng(11)
    kp, G, n = 4096, 16, 4096
    c = rng.normal(size=(3, kp)).astype(np.float32) * 50.0
    c[:, ::G] *= 1e-3  # one member of each group near the origin
    ext = rng.uniform(1e-3, 1.0, (3, kp)).astype(np.float32)
    slab = np.zeros((8, kp), np.float32)
    slab[0:3], slab[3:6] = c - ext, c + ext
    blk = np.zeros((8, kp), np.float32)
    blk[5] = 1.0
    k = rng.integers(0, kp, n)
    dist = 10.0 ** rng.uniform(-2.0, 4.0, n)
    d = rng.normal(size=(n, 3))
    d[rng.random(n) < 0.3, rng.integers(0, 3)] = 0.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    corner = (c + ext)[:, k].T
    # aim just past the corner: a miss by about its slack
    off = rng.normal(size=(n, 3)) * (1e-6 * dist + 1e-5)[:, None]
    o = corner + off - dist[:, None] * d
    x = twalk._ray16(_t(o.astype(np.float32)), _t(d.astype(np.float32)),
                     _t(np.full(n, 3e4, np.float32)), torch.ones(n))
    sl, bl = _t(slab), _t(blk)
    feasible = twalk._slab_entry_math(x, sl, bl, kp) < 1e30
    meets = twalk._group_entry(x, twalk._group_slab(sl, bl, G)) < 1e30
    assert int(feasible[torch.arange(n), _t(k)].sum()) > n // 10
    assert not (feasible & ~meets[:, torch.arange(kp) // G]).any()


def test_pack_unpack_match_jax():
    """(t | loc) keys bit for bit; t truncated downward by < 2^-13
    relative (10 loc bits); misses decode as exactly BIG."""
    rng = np.random.default_rng(0)
    t = (rng.random(4096) * 100.0 + 1e-4).astype(np.float32)
    t[:4] = 1e30
    loc = rng.integers(0, 1024, 4096).astype(np.int32)
    pj = np.asarray(jpairs._pack_tl(jnp.asarray(t), jnp.asarray(loc)))
    pt = tpairs._pack_tl(_t(t), _t(loc))
    np.testing.assert_array_equal(pj, pt.numpy())
    tq, lq = tpairs._unpack_tl(pt)
    for a, b in zip(jpairs._unpack_tl(jnp.asarray(pj)), (tq, lq)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    np.testing.assert_array_equal(lq.numpy(), loc)
    tqn = tq.numpy()[4:]
    assert (tqn <= t[4:]).all() and (tqn >= t[4:] * (1 - 2.0 ** -13)).all()
    assert (pt[:4] >= tpairs._PBIG).all() and (tq[:4] == np.float32(1e30)).all()
    assert tpairs._PBIG == jpairs._PBIG


def test_pair_runs_plain_matches_pallas_interpret():
    """Block-sorted pairs whose runs cross 256-pair tiles, a tile that
    starts mid-run, and a sentinel tail (ids kreal..kp), against the TPU
    kernel in interpret mode: packed keys bit for bit."""
    _, jcm, tcm = _tables(3)
    kreal, kp = jcm.n_real_blocks, jcm.n_blocks
    rng = np.random.default_rng(4)
    lens = [300, 1, 7, 200, 40, 2, 250]  # 800 real pairs over 7 blocks
    blocks = np.sort(rng.choice(kreal, len(lens), replace=False))
    # sentinel ids: padding blocks (kreal..kp-1), then empty slots (kp)
    blk_s = np.concatenate([np.full(k, b) for k, b in zip(lens, blocks)]
                           + [np.full(50, kreal), np.full(174, kp)]).astype(np.int32)
    n = blk_s.shape[0]  # 1024 pairs, 4 tiles
    # rays aimed at each pair's block centre: those that meet its front faces hit
    o, _ = _rays(n, seed=6)
    o = np.asarray(o) - np.asarray(jcm.center_shift)
    cen = np.asarray(jcm.blk)[0:3, np.minimum(blk_s, kreal - 1)].T
    d = cen - o + rng.normal(size=(n, 3)) * 0.05
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    od = np.concatenate([o, d, rng.uniform(5.0, 40.0, (n, 1)), np.ones((n, 1))],
                        axis=1).astype(np.float32)
    feat = np.asarray(jpairs._feat16t(jnp.asarray(od)))
    want = np.asarray(jpairs._pair_runs_pallas(jnp.asarray(blk_s), jnp.asarray(feat),
                                               jcm.w, jcm.block, 256, kreal, True))
    got = tpairs.pair_runs(_t(blk_s), _t(feat), tcm, 256, kreal).numpy()
    assert (want < tpairs._PBIG).sum() > 150  # front faces hit
    assert (got[800:] == tpairs._PBIG).all()
    np.testing.assert_array_equal(want, got)


def _supertile_pairs(jcm, runs_per_tile, ptile, seed):
    """Block-sorted pairs over whole tiles of ``ptile``: tile k holds
    ``runs_per_tile[k]`` runs of ascending block ids (the last run of a
    tile goes on into the next, which then starts mid-run), then a tile
    half real and half sentinel ids (padding blocks kreal.., empty slots
    kp) and a tile of sentinels only. Each pair's ray is aimed at a random
    triangle of its block from four radii out, so most pairs hit. ->
    (blk_s [P] i32, feat [P, 16] f32)."""
    rng = np.random.default_rng(seed)
    kreal, kp, block = jcm.n_real_blocks, jcm.n_blocks, jcm.block
    tiles, b = [], 0
    for k, runs in enumerate(runs_per_tile):
        cuts = np.sort(rng.choice(np.arange(1, ptile), runs - 1, replace=False))
        lens = np.diff(np.concatenate([[0], cuts, [ptile]]))
        ids = np.repeat(np.arange(b, b + runs), lens)
        tiles.append(ids)
        b += runs - 1  # the next tile starts inside this tile's last run
    half = ptile // 2
    tiles.append(np.concatenate([np.full(half // 2, b), np.full(half - half // 2, b + 1),
                                 np.full(half // 2, kreal), np.full(half - half // 2, kp)]))
    tiles.append(np.full(ptile, kp))
    blk_s = np.concatenate(tiles).astype(np.int32)
    assert b + 1 < kreal and (np.diff(blk_s) >= 0).all()
    n = blk_s.shape[0]
    # real triangles only: a padding slot repeats a vertex, where triangles tie
    t = jcm.tris
    real = ((np.asarray(t.v1) != np.asarray(t.v0)).any(1)
            | (np.asarray(t.v2) != np.asarray(t.v0)).any(1)).reshape(-1, block)
    bb = np.minimum(blk_s, kreal - 1)
    tri = bb * block + (rng.random(n) * real.sum(1)[bb]).astype(np.int64)
    cen = ((np.asarray(t.v0)[tri] + np.asarray(t.v1)[tri] + np.asarray(t.v2)[tri]) / 3.0
           - np.asarray(jcm.center_shift))  # the weight blocks' frame
    o = 4.0 * cen
    d = (cen - o) / np.linalg.norm(cen - o, axis=1, keepdims=True)
    od = np.concatenate([o, d, rng.uniform(5.0, 40.0, (n, 1)), np.ones((n, 1))],
                        axis=1).astype(np.float32)
    return blk_s, np.asarray(jpairs._feat16t(jnp.asarray(od)))


def test_pair_bdiag_plain_matches_jax_runs_kernel():
    """Kernel 7's plain version on 1024-pair supertiles of 1, 3, 8 and 12
    runs, runs that cross tiles, a sentinel tail and an all-sentinel tile:
    packed keys bit for bit equal to the JAX runs kernel (kernel 6) in
    interpret mode, to the port's kernel-6 wrapper and, in slot order, to
    the JAX jnp mirror ``_pair_slots_ref``. (Not to the JAX bdiag kernel
    in interpret mode: see the next test.)"""
    mesh, jcm, tcm = _tables(4)
    ptile, kreal = 1024, jcm.n_real_blocks
    blk_s, feat = _supertile_pairs(jcm, [1, 3, 8, 12], ptile, seed=3)
    got = tpairs.pair_bdiag(_t(blk_s), _t(feat), tcm, ptile, kreal).numpy()
    want = np.asarray(jpairs._pair_runs_pallas(jnp.asarray(blk_s), jnp.asarray(feat), jcm.w,
                                               jcm.block, ptile, kreal, True))
    assert (want < tpairs._PBIG).mean() > 0.5
    assert (got[blk_s >= kreal] == tpairs._PBIG).all()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, tpairs.pair_runs(_t(blk_s), _t(feat), tcm, 256, kreal).numpy())
    t_s, loc_s = jpairs._pair_slots_ref(jnp.asarray(blk_s)[:, None], jnp.asarray(feat), jcm.w,
                                        jcm.block, kreal)
    t_g, loc_g = tpairs._unpack_tl(_t(got))
    np.testing.assert_array_equal(np.asarray(t_s)[:, 0], t_g.numpy())
    np.testing.assert_array_equal(np.asarray(loc_s)[:, 0], loc_g.numpy())


def test_jax_bdiag_interpret_reads_unstaged_slots():
    """A defect of the JAX package's kernel 7, shown here and left there:
    ``_pair_bdiag_kernel`` multiplies all 8 weight slots of its stack and
    relies on the slots it did not stage in a round being zero. In
    interpret mode unwritten scratch is NaN, and 0 * NaN poisons every
    row: a 256-pair tile (block 64) of 8 runs equals kernel 6, one of a
    single run comes back all _PBIG although kernel 6 finds hits. The
    port's kernel never reads a slot it did not stage."""
    _, jcm, tcm = _tables(4)
    kreal = jcm.n_real_blocks
    for runs in (8, 1):
        blk_s, feat = _supertile_pairs(jcm, [runs], 256, seed=runs)
        blk_s, feat = blk_s[:256], feat[:256]
        args = (jnp.asarray(blk_s), jnp.asarray(feat), jcm.w, jcm.block, 256, kreal, True)
        runs_k = np.asarray(jpairs._pair_runs_pallas(*args))
        bdiag_k = np.asarray(jpairs._pair_bdiag_pallas(*args))
        assert (runs_k < tpairs._PBIG).sum() > 100
        np.testing.assert_array_equal(
            runs_k, tpairs.pair_bdiag(_t(blk_s), _t(feat), tcm, 256, kreal).numpy())
        if runs == 8:
            np.testing.assert_array_equal(bdiag_k, runs_k)
        else:
            assert (bdiag_k == tpairs._PBIG).all()


@pytest.mark.parametrize("F", [1, 3])
def test_pairs_bdiag_match_jax_and_brute(F):
    """intersect_mesh_pairs with pair_bdiag (1024-pair supertiles for the
    whole call, narrowing chunks included) against the JAX package's with
    the same config (its jnp mirror on the CPU) and the brute force: ids
    equal, t within 1e-6 relative; and against the port's default pair
    tile: the same hits. Grazing rays leave rays for the exhaustive walk
    at F = 1."""
    mesh, jcm, tcm = _tables(4, 4)
    o, d = _grazing_rays(1024, seed=2)
    kw = dict(cluster_tile=256, pair_slots=F, pair_bdiag=True, **PAIRS)
    hit_t, stats = tpairs.intersect_mesh_pairs(_t(o), _t(d), tcm, TCfg(**kw),
                                               collect_stats=True)
    assert stats["m1"] == 1024
    hit_j = jax.jit(lambda o, d: jpairs.intersect_mesh_pairs(o, d, jcm, JCfg(**kw)))(o, d)
    np.testing.assert_array_equal(np.asarray(hit_j.tri), hit_t.tri.numpy())
    np.testing.assert_allclose(np.asarray(hit_j.t), hit_t.t.numpy(), rtol=T_RTOL)
    _brute_check(o, d, mesh, hit_t)
    plain = tpairs.intersect_mesh_pairs(_t(o), _t(d), tcm, TCfg(**{**kw, "pair_bdiag": False}))
    assert torch.equal(plain.tri, hit_t.tri) and torch.equal(plain.t, hit_t.t)
    if F == 1:
        assert stats["pass3_rays"] > 0


def _brute_check(o, d, mesh, hit):
    hb = intersect_mesh_brute(o, d, jax.tree.map(jnp.asarray, mesh), use_bbox=False)
    t_p, t_b = hit.t.numpy(), np.asarray(hb.t)
    miss_p, miss_b = t_p >= 1e30, t_b >= 1e30
    assert (miss_p == miss_b).all(), f"{(miss_p != miss_b).sum()} hit/miss diffs"
    np.testing.assert_allclose(t_p[~miss_p], t_b[~miss_b], rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("case", [
    # (subdiv, block, rays, F, ray set): slot 1 with grazing rays on a
    # 2048-block table (kp > 1024) leaves rays for pass 3; 768 grazing
    # rays, all mesh-active, take three narrowing rounds (m1 = 256)
    (3, 64, 4096, 1, "random"),
    (4, 4, 1024, 1, "grazing"),
    (3, 64, 4096, 2, "random"),
    (3, 64, 768, 3, "grazing"),
    (3, 64, 4096, 8, "random"),
])
def test_pairs_match_jax_and_brute(case):
    subdiv, block, n, F, rays = case
    mesh, jcm, tcm = _tables(subdiv, block)
    o, d = _rays(n, seed=n) if rays == "random" else _grazing_rays(n, seed=1)
    kw = dict(cluster_tile=256, pair_slots=F, **PAIRS)
    hit_t, stats = tpairs.intersect_mesh_pairs(_t(o), _t(d), tcm, TCfg(**kw),
                                               collect_stats=True)
    hit_j = jax.jit(lambda o, d: jpairs.intersect_mesh_pairs(o, d, jcm, JCfg(**kw)))(o, d)
    np.testing.assert_array_equal(np.asarray(hit_j.tri), hit_t.tri.numpy())
    np.testing.assert_allclose(np.asarray(hit_j.t), hit_t.t.numpy(), rtol=T_RTOL)
    _brute_check(o, d, mesh, hit_t)
    assert (hit_t.tri.numpy() >= 0).sum() > n // 50
    if block == 4:
        assert tcm.n_blocks > 1024 and stats["p3_rounds"] == 1 and stats["pass3_rays"] > 0
    if n == 768:
        assert stats["m1"] == 256 and stats["n1_rounds"] == 3
    if F == 1:
        assert stats["p2_rounds"] == 1


@pytest.mark.parametrize("max_passes", [1, 2])
def test_pairs_max_passes_matches_jax(max_passes):
    """A cut proof chain (``max_passes`` < 3, a measurement mode): the
    passes past the cut do not run, the result equals the JAX package's
    with the same cut (ids exactly, t within 1e-6 relative), and it is
    never nearer than the exact result."""
    _, jcm, tcm = _tables(4, 4)
    o, d = _grazing_rays(1024, seed=1)
    kw = dict(cluster_tile=256, pair_slots=1, **PAIRS)
    hit_t, stats = tpairs.intersect_mesh_pairs(_t(o), _t(d), tcm, TCfg(**kw),
                                               max_passes=max_passes, collect_stats=True)
    hit_j = jax.jit(lambda o, d: jpairs.intersect_mesh_pairs(
        o, d, jcm, JCfg(**kw), max_passes=max_passes))(o, d)
    np.testing.assert_array_equal(np.asarray(hit_j.tri), hit_t.tri.numpy())
    np.testing.assert_allclose(np.asarray(hit_j.t), hit_t.t.numpy(), rtol=T_RTOL)
    assert stats["p3_rounds"] == 0 and stats["p2_rounds"] == (max_passes - 1)
    exact = tpairs.intersect_mesh_pairs(_t(o), _t(d), tcm, TCfg(**kw))
    assert (exact.t <= hit_t.t).all()


def test_pairs_wide_window_skips_pass_two():
    """pair_slots >= F2 leaves pass 2 no window: the unproven rays go
    straight to the exhaustive walk, and the result stays exact."""
    mesh, _, tcm = _tables(4, 4)
    o, d = _grazing_rays(512, seed=3)
    hit, stats = tpairs.intersect_mesh_pairs(
        _t(o), _t(d), tcm, TCfg(cluster_tile=256, pair_slots=tpairs.F2, **PAIRS),
        collect_stats=True)
    assert stats["p2_rounds"] == 0 and stats["pass3_rays"] > 0
    _brute_check(o, d, mesh, hit)


def test_pairs_t_init_and_active_masking():
    _, _, tcm = _tables(2)
    o, d = _rays(512, seed=5)
    cfg = TCfg(cluster_tile=256, pair_slots=4, **PAIRS)
    bounded = tpairs.intersect_mesh_pairs(_t(o), _t(d), tcm, cfg,
                                          t_init=torch.full((512,), 1e-3))
    assert (bounded.t >= 1e30).all() and (bounded.tri == -1).all()
    dead = tpairs.intersect_mesh_pairs(_t(o), _t(d), tcm, cfg,
                                       active=torch.zeros((512,), dtype=torch.bool))
    assert (dead.t >= 1e30).all()


@pytest.mark.parametrize("kw, match", [
    (dict(binned_shards=4), "binned_shards"),
])
def test_pairs_unported_options_raise(kw, match):
    _, _, tcm = _tables(1)
    o, d = _rays(256, seed=9)
    with pytest.raises(NotImplementedError, match=match):
        tpairs.intersect_mesh_pairs(_t(o), _t(d), tcm, TCfg(cluster_tile=256, **kw))


def test_default_config_routes_meshes_to_pairs(tmp_path):
    scene = tparser.load_scene(CORNELL, obj_path=_mesh_obj(tmp_path, 3, 2.0), device="cpu")
    assert scene.mesh.v0.shape[0] >= TCfg().cluster_min_tris
    assert mesh_route(scene.mesh, scene.cmesh, TCfg()) == "pairs"
    assert mesh_route(scene.mesh, scene.cmesh, TCfg(cluster_pairs=False, cluster_walk=True)) == "walk"


def test_pairs_render_matches_jax(tmp_path):
    """48x48, depth 4, 4 spp, a 1,280-triangle sphere in the default
    config: both packages render the identical scene tables. Bound: mean
    |d| <= 2e-3 (float rounding moves a path only where a ray grazes an
    edge)."""
    jscene = jparser.with_resolution(
        jparser.load_scene(CORNELL, obj_path=_mesh_obj(tmp_path, 3, 2.5),
                           build_kd=False), 48, 48)
    tscene = scene_from_numpy(jax.tree.map(np.asarray, jscene), "cpu")
    kw = dict(trace_depth=4, antialias=True, cluster_tile=256)
    img_j = np.asarray(jrender(jscene, JCfg(**kw), spp=4, seed=0))
    img_t = render(tscene, TCfg(**kw), spp=4, seed=0, device="cpu").numpy()
    assert np.abs(img_j - img_t).mean() <= 2e-3


def test_mesh_pairs_48_golden(tmp_path):
    """The pair-list golden in its own config (tools/goldens.py
    mesh_pairs_48). Bound: per-pixel atol 2e-3 on every pixel but 490 and
    518, and mean |d| <= 2e-4. The golden was rendered under jit, where
    XLA's CPU compiler fuses multiply-adds: the first hit of those two
    pixels (no antialiasing, so every iteration) lands one ulp away on a
    wall, and their paths branch there
    (``test_mesh_pairs_48_golden_pixels_branch_under_jit``). The port
    computes unfused, as the JAX package does when run eagerly."""
    scene = tparser.with_resolution(
        tparser.load_scene(CORNELL, obj_path=_mesh_obj(tmp_path, 4, 2.0),
                           device="cpu"), 48, 48)
    img = render(scene, TCfg(trace_depth=4, cluster_tile=256, **PAIRS), spp=8,
                 seed=0, device="cpu").numpy()
    diff = np.abs(img - np.load(os.path.join(GOLDENS, "mesh_pairs_48.npy")))
    off = np.flatnonzero((diff > 2e-3).any(axis=-1))
    assert set(off.tolist()) <= set(JIT_BRANCHED_PIXELS), off
    assert diff.mean() <= 2e-4


def test_mesh_pairs_48_golden_pixels_branch_under_jit():
    """Why pixels 490 and 518 leave the golden: their camera rays first
    hit a wall, and under jit that t is an ulp away from the JAX package's
    eager t, which the port equals bit for bit (two other pixels agree in
    all three)."""
    jscene = jparser.with_resolution(jparser.load_scene(CORNELL), 48, 48)
    cfg = JCfg(trace_depth=4, cluster_tile=256)
    assert not cfg.antialias  # every iteration casts the same camera rays
    key = bounce_key(jax.random.PRNGKey(0), jnp.int32(1), 0)
    rays = jcam.generate_rays(jscene.camera, cfg, key, cfg.trace_depth)
    px = [*JIT_BRANCHED_PIXELS, 100, 1000]
    o = np.asarray(rays.origin)[:, px].T
    d = np.asarray(rays.direction)[:, px].T
    t_jit = np.asarray(jax.jit(lambda o, d: jisect.intersect_geoms(o, d, jscene.geoms))(o, d).t)
    with jax.disable_jit():
        t_eager = np.asarray(jisect.intersect_geoms(o, d, jscene.geoms).t)
    tgeoms = scene_from_numpy(jax.tree.map(np.asarray, jscene), "cpu").geoms
    t_port = tisect.intersect_geoms(_t(o), _t(d), tgeoms).t.numpy()
    np.testing.assert_array_equal(t_port, t_eager)
    ulp_away = ((t_jit == np.nextafter(t_eager, np.float32(np.inf)))
                | (t_jit == np.nextafter(t_eager, np.float32(-np.inf))))
    assert ulp_away[:2].all() and (t_jit[2:] == t_eager[2:]).all()
