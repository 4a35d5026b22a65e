"""The cluster-walk intersector and its kernels' plain versions against the
JAX package.

Inputs are the JAX walk tests' meshes and ray sets (numpy seeds). The
slab cull is compared bit for bit; the walk's hits triangle for
triangle, with t within the rounding of a 10-term product (the two
libraries sum the matrix product in different orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kdtreepathtraceroptimization_tpu.config import RenderConfig as JCfg
from kdtreepathtraceroptimization_tpu.ops import walk as jwalk
from kdtreepathtraceroptimization_tpu.ops import mxu_bf as jmxu
from kdtreepathtraceroptimization_tpu.ops.cluster import build_cluster_mesh as jbuild
from kdtreepathtraceroptimization_tpu.ops.mesh import (
    intersect_mesh_brute,
    refine_tri_hit as jrefine,
    tri_hit_to_hit as jtri_hit_to_hit,
)
from kdtreepathtraceroptimization_tpu_torch.config import RenderConfig as TCfg
from kdtreepathtraceroptimization_tpu_torch.ops import mxu_bf as tmxu
from kdtreepathtraceroptimization_tpu_torch.ops import mesh as tmesh
from kdtreepathtraceroptimization_tpu_torch.ops import walk as twalk
from kdtreepathtraceroptimization_tpu_torch.ops.cluster import build_cluster_mesh as tbuild
from kdtreepathtraceroptimization_tpu_torch.render.integrator import render as trender
from kdtreepathtraceroptimization_tpu_torch.scene.parser import load_scene, with_resolution
from kdtreepathtraceroptimization_tpu_torch.scene.structs import MeshSoA as TMesh
from kdtreepathtraceroptimization_tpu_torch.utils.cuda_build import CSRC
from tests.test_cluster import _mesh, _rays
from tests.test_torch_render import CORNELL, _mesh_obj

# t agrees to 1e-6 relative (a 10-term float32 dot product summed in
# another order), and hit/miss and triangle ids exactly.
T_RTOL = 1e-6


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _tables(subdiv, block=64):
    mesh = _mesh(subdiv)
    return mesh, jbuild(mesh, block=block), tbuild(mesh, block=block, device="cpu")


def _x(cm, n, seed, t0=1e30):
    o, d = _rays(n, seed=seed)
    oc = jnp.asarray(o) - cm.center_shift
    return jwalk._ray16(oc, jnp.asarray(d), jnp.full((n,), t0, jnp.float32),
                        jnp.ones((n,), jnp.float32))


def test_ray16_matches_jax():
    _, jcm, tcm = _tables(2)
    o, d = _rays(1024, seed=4)
    d = d.at[:7, 1].set(0.0)  # axis-parallel rays hit the 1e7 clamp
    t0 = np.linspace(0.5, 30, 1024).astype(np.float32)
    act = (np.arange(1024) % 5 != 0).astype(np.float32)
    xj = jwalk._ray16(jnp.asarray(o) - jcm.center_shift, d, jnp.asarray(t0),
                      jnp.asarray(act))
    xt = twalk._ray16(_t(o) - tcm.center_shift, _t(d), _t(t0), _t(act))
    np.testing.assert_array_equal(np.asarray(xj), xt.numpy())


@pytest.mark.parametrize("tile", [1, 128, 256])
def test_slab_cull_matches_jax_ref(tile):
    """Plain slab cull == the JAX jnp mirror, bit for bit (both unfused)."""
    _, jcm, tcm = _tables(2)
    x = _x(jcm, 1024, seed=3, t0=20.0)
    want = np.asarray(jwalk._slab_cull_ref(x, jcm.slab, jcm.blk, tile))
    got = twalk.slab_cull(_t(x), tcm.slab, tcm.blk, tile).numpy()
    np.testing.assert_array_equal(want, got)


def _fma_entries(x, slab, blk, tile):
    """The slab cull with every ``a * b - c`` and ``a * b + c`` fused into
    one rounding (float64 arithmetic, rounded once to float32), as XLA's
    CPU compiler fuses them inside ``jit``."""
    x = np.asarray(x, np.float64)
    slab = np.asarray(slab, np.float64)
    kp = slab.shape[1]

    def f32(v):
        return v.astype(np.float32).astype(np.float64)

    tmin = np.full((x.shape[0], kp), -1e30)
    tmax = np.full((x.shape[0], kp), 1e30)
    for a in range(3):
        tlo = f32(slab[a][None] * x[:, 8 + a:9 + a] - x[:, 11 + a:12 + a])
        thi = f32(slab[3 + a][None] * x[:, 8 + a:9 + a] - x[:, 11 + a:12 + a])
        tmin = np.maximum(tmin, np.minimum(tlo, thi))
        tmax = np.minimum(tmax, np.maximum(tlo, thi))
    slack = f32(np.float64(np.float32(1e-6)) * np.abs(tmin) + np.float64(np.float32(1e-5)))
    tmin, tmax = f32(tmin - slack), f32(tmax + slack)
    entry = np.maximum(tmin, 0.0)
    ok = ((tmax >= entry) & (tmax > 0) & (entry < x[:, 6:7])
          & (x[:, 7:8] > 0) & (np.asarray(blk)[5][None] >= 0))
    e = np.where(ok, entry, 1e30).astype(np.float32)
    return e.reshape(-1, tile, kp).min(axis=1)


@pytest.mark.parametrize("tile", [128, 256])
def test_slab_cull_matches_pallas_interpret(tile):
    """Against the TPU kernel run in interpret mode. Under ``jit`` XLA's
    CPU compiler fuses ``lo * invd - oinv`` into an FMA, so the interpret
    kernel equals the plain slab cull with fused products, bit for bit;
    the port's plain version (unfused, like the CUDA kernel and the TPU)
    agrees with it on every feasible/infeasible decision here and differs
    only where the fused rounding moves an entry (a few of 1024, by at
    most 2e-8 absolute after the slab cancellation)."""
    _, jcm, tcm = _tables(2)
    x = _x(jcm, 1024, seed=3, t0=20.0)
    interp = np.asarray(jwalk._slab_cull_pallas(x, jcm.slab, jcm.blk, tile, True))
    np.testing.assert_array_equal(
        interp, _fma_entries(x, jcm.slab, jcm.blk, tile))
    got = twalk.slab_cull(_t(x), tcm.slab, tcm.blk, tile).numpy()
    np.testing.assert_array_equal(interp < 1e30, got < 1e30)
    assert (interp != got).mean() < 0.01
    np.testing.assert_allclose(interp, got, rtol=1e-6, atol=3e-8)


@pytest.mark.parametrize("subdiv, block, tile", [(2, 64, 256), (3, 16, 128), (3, 16, 256)])
def test_slab_cull_grouped_matches_ref_and_pallas_interpret(subdiv, block, tile):
    """Kernel 1's skip in plain form (``_slab_cull_grouped``: each tile's
    live rays in warps of 32, a group of ``SLAB_GROUP`` (16) blocks tested
    only where its union box passes for one ray of the warp) equals the
    plain slab cull bit for bit; here with dead rays (every 5th, direction
    zeroed) and t0 bounds from 0.5 to 30, on a 5-block and a 128-block
    table (8 full groups). The TPU kernel in interpret mode equals the
    slab cull with XLA's fused products (``_fma_entries``) bit for bit,
    and the grouped form in its feasible pattern, with entries within 1e-6
    (the fused rounding after the slab cancellation: an ulp of the largest
    slab parameters here is 9.5e-7)."""
    _, jcm, tcm = _tables(subdiv, block)
    o, d = _rays(1024, seed=6)
    act = (np.arange(1024) % 5 != 0).astype(np.float32)
    t0 = np.linspace(0.5, 30.0, 1024).astype(np.float32)
    x = jwalk._ray16(jnp.asarray(o) - jcm.center_shift, jnp.asarray(d * act[:, None]),
                     jnp.asarray(t0), jnp.asarray(act))
    source = (CSRC / "slab_cull.cu").read_text()
    assert f"constexpr int kGroup = {twalk.SLAB_GROUP};" in source  # the kernel's groups
    got = twalk._slab_cull_grouped(_t(x), tcm.slab, tcm.blk, tile)
    want = twalk._slab_cull_ref(_t(x), tcm.slab, tcm.blk, tile)
    assert torch.equal(got, want) and int((want < 1e30).sum()) > 20
    interp = np.asarray(jwalk._slab_cull_pallas(x, jcm.slab, jcm.blk, tile, True))
    np.testing.assert_array_equal(interp, _fma_entries(x, jcm.slab, jcm.blk, tile))
    np.testing.assert_array_equal(interp < 1e30, got.numpy() < 1e30)
    np.testing.assert_allclose(interp, got.numpy(), rtol=0, atol=1e-6)


def test_full_select_matches_jax():
    te = np.full((6, 128), 1e30, np.float32)
    rng = np.random.default_rng(0)
    te[:5, :40] = rng.integers(0, 8, (5, 40)).astype(np.float32)  # many ties
    te[2] = 1e30  # a tile with no feasible block
    sj, lj, nj = jwalk._full_select(jnp.asarray(te))
    st, lt, nt = twalk._full_select(_t(te))
    for a, b in ((sj, st), (lj, lt), (nj, nt)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def _walk_inputs(jcm, tile, n=1024, seed=3):
    """The JAX pipeline's sorted walk inputs for a ray set."""
    o, d = _rays(n, seed=seed)
    oc = jnp.asarray(o) - jcm.center_shift
    x = jwalk._ray16(oc, d, jnp.full((n,), 1e30, jnp.float32),
                     jnp.ones((n,), jnp.float32))
    sel, lb, nsel = jwalk._full_select(jwalk._slab_cull_ref(x, jcm.slab, jcm.blk, tile))
    r = jnp.concatenate([jmxu.ray_features(x[:, 0:3], x[:, 3:6]),
                         jnp.zeros((n, 6), jnp.float32)], axis=1)
    return sel, lb, nsel, r, x[:, 6], x[:, 7]


@pytest.mark.parametrize("tile", [128, 256])
def test_walk_matches_jax_kernel_and_ref(tile):
    """Plain walk vs the TPU kernel in interpret mode and the jnp mirror."""
    _, jcm, tcm = _tables(2)
    sel, lb, nsel, r, t0, act = _walk_inputs(jcm, tile)
    bt_i, btri_i = jwalk._walk_pallas(sel, lb, nsel, r, t0, act, jcm.w, tile,
                                      jcm.block, True)
    bt_r, btri_r = jwalk._walk_ref(sel, lb, r, t0, act, jcm.w, tile, jcm.block)
    bt_t, btri_t = twalk.walk(_t(sel), _t(lb), _t(nsel), _t(r), _t(t0), _t(act), tcm, tile)
    assert (np.asarray(btri_i) >= 0).sum() > 20
    for bt, btri in ((bt_i, btri_i), (bt_r, btri_r)):
        np.testing.assert_array_equal(np.asarray(btri), btri_t.numpy())
        np.testing.assert_allclose(np.asarray(bt), bt_t.numpy(), rtol=T_RTOL)


@pytest.mark.parametrize("tile", [256, 512])
def test_walk_matches_brute_and_jax_walk(tile):
    mesh, jcm, tcm = _tables(3)  # 1280 tris, 20 blocks
    o, d = _rays(4096)
    tcfg = TCfg(cluster=True, cluster_walk=True, cluster_tile=tile)
    hit_t = twalk.intersect_mesh_walk(_t(o), _t(d), tcm, tcfg)
    hit_b = intersect_mesh_brute(o, d, jax.tree.map(jnp.asarray, mesh),
                                 use_bbox=False)
    t_t, t_b = hit_t.t.numpy(), np.asarray(hit_b.t)
    miss_t, miss_b = t_t >= 1e30, t_b >= 1e30
    assert (miss_t == miss_b).all(), f"{(miss_t != miss_b).sum()} hit/miss diffs"
    np.testing.assert_allclose(t_t[~miss_t], t_b[~miss_b], rtol=2e-4, atol=2e-4)

    jcfg = JCfg(cluster=True, cluster_walk=True, cluster_tile=tile)
    hit_j = jwalk.intersect_mesh_walk(o, d, jcm, jcfg)
    np.testing.assert_array_equal(np.asarray(hit_j.tri), hit_t.tri.numpy())
    np.testing.assert_allclose(np.asarray(hit_j.t), t_t, rtol=T_RTOL)


def test_walk_t_init_and_active_masking():
    _, _, tcm = _tables(2)
    o, d = _rays(512, seed=5)
    cfg = TCfg(cluster=True, cluster_walk=True, cluster_tile=256)
    bounded = twalk.intersect_mesh_walk(_t(o), _t(d), tcm, cfg,
                                        t_init=torch.full((512,), 1e-3))
    assert (bounded.t >= 1e30).all() and (bounded.tri == -1).all()
    dead = twalk.intersect_mesh_walk(_t(o), _t(d), tcm, cfg,
                                     active=torch.zeros((512,), dtype=torch.bool))
    assert (dead.t >= 1e30).all()


def test_walk_shards_are_not_ported():
    """binned_shards = 4 (once refused) sorts each row of the [4, n / 4]
    view on its own: the hits equal S = 1's; the coherence sort's rank
    and permutation keep every ray in its row and match JAX's row-local
    ones."""
    from kdtreepathtraceroptimization_tpu.ops import binned as jbinned

    _, _, tcm = _tables(1)
    o, d = _rays(1024, seed=9)
    cfg = TCfg(cluster=True, cluster_walk=True, cluster_tile=256)
    base = twalk.intersect_mesh_walk(_t(o), _t(d), tcm, cfg)
    hit = twalk.intersect_mesh_walk(_t(o), _t(d), tcm, TCfg(cluster=True, cluster_walk=True,
                                                            cluster_tile=256, binned_shards=4))
    assert (hit.tri >= 0).sum() > 20
    assert torch.equal(hit.tri, base.tri) and torch.equal(hit.t, base.t)
    keys = np.random.default_rng(3).integers(0, 9, 3000).astype(np.int32)
    rank_j, perm_j = jbinned._bin_rank(jnp.asarray(keys), 4)
    rank_t, perm_t = twalk._bin_rank(_t(keys), 4)
    offset = np.arange(0, 3000, 750)[:, None]
    np.testing.assert_array_equal((np.asarray(perm_j) + offset).reshape(-1), perm_t.numpy())
    np.testing.assert_array_equal((np.asarray(rank_j) + offset).reshape(-1), rank_t.numpy())


def test_bin_rank_matches_jax():
    """Stable rank/perm of the coherence sort, with many ties."""
    from kdtreepathtraceroptimization_tpu.ops import binned as jbinned

    keys = np.random.default_rng(2).integers(0, 9, 3000).astype(np.int32)
    rank_j, perm_j = jbinned._bin_rank(jnp.asarray(keys))
    rank_t, perm_t = twalk._bin_rank(_t(keys))
    np.testing.assert_array_equal(np.asarray(perm_j).reshape(-1), perm_t.numpy())
    np.testing.assert_array_equal(np.asarray(rank_j).reshape(-1), rank_t.numpy())
    x = _t(np.arange(3000 * 2, dtype=np.float32).reshape(3000, 2))
    np.testing.assert_array_equal(twalk._apply_perm(twalk._apply_perm(x, perm_t), rank_t), x)


def test_tri_hit_to_hit_matches_jax():
    mesh, jcm, tcm = _tables(2)
    o, d = _rays(2048, seed=7)
    hit_j = jwalk.intersect_mesh_walk(o, d, jcm, JCfg(cluster_tile=256))
    assert (np.asarray(hit_j.tri) >= 0).sum() > 50
    tri = _t(hit_j.tri)
    th = tmesh.TriHit(t=_t(hit_j.t), tri=tri, u=_t(hit_j.u), v=_t(hit_j.v))
    hj = jtri_hit_to_hit(o, d, hit_j, jcm.tris)
    ht = tmesh.tri_hit_to_hit(_t(o), _t(d), th, tcm.packed)
    np.testing.assert_array_equal(np.asarray(hj.material_id), ht.material_id.numpy())
    np.testing.assert_array_equal(np.asarray(hj.outside), ht.outside.numpy())
    np.testing.assert_allclose(np.asarray(hj.t), ht.t.numpy(), rtol=T_RTOL)
    for c in "xyz":
        for f in ("point", "normal"):
            np.testing.assert_allclose(np.asarray(getattr(getattr(hj, f), c)),
                                       getattr(getattr(ht, f), c).numpy(),
                                       rtol=1e-5, atol=1e-6)
    # the row form of the re-evaluation, on the lanes that hit
    hit = np.asarray(hit_j.tri) >= 0
    for a, b in zip(jrefine(o, d, hit_j.tri, jcm.tris),
                    tmesh.refine_tri_hit(_t(o), _t(d), tri, tcm.tris)):
        np.testing.assert_allclose(np.asarray(a)[hit], b.numpy()[hit],
                                   rtol=1e-5, atol=1e-6)


def test_gather_cols_is_indexing_transposed():
    rng = np.random.default_rng(0)
    packed = rng.normal(size=(300, 19)).astype(np.float32)
    tri = rng.integers(0, 300, 1000).astype(np.int32)
    got = tmesh.gather_cols(_t(packed), _t(tri))
    np.testing.assert_array_equal(got.numpy(), packed[tri].T)


def test_empty_mesh_gives_misses():
    _, _, tcm = _tables(1)
    empty = tmesh.pack_tris(TMesh(*(a[:0] for a in tcm.tris)))
    o, d = _rays(64)
    th = tmesh.TriHit(t=torch.full((64,), 1e30), tri=torch.full((64,), -1, dtype=torch.int32),
                      u=torch.zeros(64), v=torch.zeros(64))
    h = tmesh.tri_hit_to_hit(_t(o), _t(d), th, empty)
    assert (h.t >= 1e30).all() and (h.material_id == -1).all()


@pytest.mark.parametrize("tile", [128, 256])
def test_walk_skip_premise_on_its_own_inputs(tmp_path, monkeypatch, tile):
    """The walk kernel lets a ray take part in round rr of its tile only
    while its best t exceeds lb[g, rr], the tile-min conservative entry
    into block sel[g, rr], and it meets the block's box, widened by the
    kernel's margin, before its best t (``_box_entry``). That is exact if
    no triangle of the block gives any live ray of the tile an accepted t
    below lb[g, rr], nor below the ray's own widened-box entry (nor any t
    below its t0 where it misses the box). Checked with the plain epilogue
    on every listed round of every call a depth-2 render of icosphere-3 in
    the Cornell box (32x32, so 1,024 rays a bounce, the camera on the
    mesh's split plane x = 0; 64-slot blocks, most of them padded) makes to
    the walk."""
    scene = with_resolution(load_scene(CORNELL, obj_path=_mesh_obj(tmp_path, 3, 2.5),
                                       cluster_block=64, device="cpu"), 32, 32)
    calls = []
    real_walk = twalk.walk

    def record(*args):
        calls.append(args)
        return real_walk(*args)

    monkeypatch.setattr(twalk, "walk", record)
    trender(scene, TCfg(trace_depth=2, cluster=True, cluster_walk=True,
                        cluster_pairs=False, cluster_tile=tile), spp=2, seed=0, device="cpu")
    assert len(calls) == 4
    rounds = skipped = 0
    for sel, lb, nsel, r, t0, act, cm, wtile in calls:
        assert wtile == tile and (cm.real < cm.block).any()
        entry = twalk._box_entry(r[:, 0:3], r[:, 3:6], cm.slab)
        for g in range(r.shape[0] // tile):
            rows = slice(g * tile, (g + 1) * tile)
            live = act[rows] > 0
            rt = r[rows][live]
            for rr in range(int(nsel[g, 0]) if live.any() else 0):
                k = int(sel[g, rr])
                prod = rt @ cm.w[k]
                t = tmxu._epilogue(prod, cm.block, lb[g, rr].expand(rt.shape[0]))
                assert (t >= 1e30).all(), (g, rr)  # no accepted t below lb[g, rr]
                own = torch.minimum(entry[rows, k], t0[rows])[live]
                t = tmxu._epilogue(prod, cm.block, own)
                assert (t >= 1e30).all(), (g, rr)  # nor below the ray's own entry
                rounds += 1
                skipped += int((entry[rows, k][live] >= t0[rows][live]).sum())
    assert rounds > 100 and skipped > rounds  # most rays of a tile skip most of its blocks
