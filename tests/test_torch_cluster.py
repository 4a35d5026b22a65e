"""The cluster-rounds intersector and its kernels' plain versions against the
JAX package.

Inputs are the JAX cluster tests' meshes and ray sets (numpy seeds).
Tolerances, and why:

- the sphere cull equals the TPU kernel run in interpret mode bit for
  bit (both take each (d.c | o.c) half as its three non-zero products);
  against the JAX jnp mirror, whose ``x @ cull_w`` sums eight products in
  another order, the infeasible pattern is equal and the entries within
  2e-6 (an ulp of the largest entries here, the closest approach minus
  the radius cancelling);
- ``_select`` bit for bit (both sorts are stable);
- the plain rounds and sweep: triangle ids exactly, t within 1e-6
  relative (a 16-term float32 product summed in another order); the
  sweep of a row list bit for bit against the port's full-width sweep
  (the plain version keeps the caller's tile, so its products sum alike);
- whole intersectors: ids and t against the JAX intersector as above, and
  against brute force within the JAX cluster tests' own 2e-4.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kdtreepathtraceroptimization_tpu.config import RenderConfig as JCfg
from kdtreepathtraceroptimization_tpu.ops import cluster as jcl
from kdtreepathtraceroptimization_tpu.ops import mxu_bf as jmxu
from kdtreepathtraceroptimization_tpu.ops.mesh import intersect_mesh_brute
from kdtreepathtraceroptimization_tpu.render.integrator import render as jrender
from kdtreepathtraceroptimization_tpu.scene import parser as jparser
from kdtreepathtraceroptimization_tpu_torch.config import RenderConfig as TCfg
from kdtreepathtraceroptimization_tpu_torch.convert import scene_from_numpy
from kdtreepathtraceroptimization_tpu_torch.ops import cluster as tcl
from kdtreepathtraceroptimization_tpu_torch.ops import mxu_bf as tmxu
from kdtreepathtraceroptimization_tpu_torch.ops import walk as twalk
from kdtreepathtraceroptimization_tpu_torch.render.integrator import mesh_route, render
from kdtreepathtraceroptimization_tpu_torch.scene import parser as tparser
from tests.test_cluster import _mesh, _rays
from tests.test_torch_render import CORNELL, GOLDENS, _mesh_obj

T_RTOL = 1e-6
CLUSTER = dict(cluster=True, cluster_pairs=False)
# The JAX round loop, compiled once per shape (its scan compiles slowly
# op by op).
_jax_cluster_ref = jax.jit(jcl._cluster_ref, static_argnums=(6, 7, 8))


def _t(a):
    return torch.from_numpy(np.array(a))


def _tables(subdiv, block=64):
    mesh = _mesh(subdiv)
    return mesh, jcl.build_cluster_mesh(mesh, block=block), tcl.build_cluster_mesh(
        mesh, block=block, device="cpu")


def _aimed_rays(n, seed):
    """Rays from about 4 units out aimed near the test sphere's centre
    (tests.test_cluster._mesh): most hit it."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3)).astype(np.float32) * 4.0
    d = np.array([0.3, -0.2, 0.5], np.float32) + rng.normal(size=(n, 3)) * 1.5 - o
    return o, (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


def _x(cm, n, seed):
    """[n, 8] ray records (o d t0 act) centred on the table: aimed rays,
    dead rays (every 7th, direction zeroed) and t0 bounds from 0.5 to 30."""
    o, d = _aimed_rays(n, seed)
    act = np.arange(n) % 7 != 0
    t0 = np.linspace(0.5, 30.0, n, dtype=np.float32)
    return np.concatenate([np.asarray(o - cm.center_shift), np.asarray(d) * act[:, None],
                           t0[:, None], act[:, None]], axis=1).astype(np.float32)


def _features(x):
    """[n, 16] MT feature rows of the records, as the JAX pipeline builds
    them."""
    x = jnp.asarray(x)
    return jnp.concatenate([jmxu.ray_features(x[:, 0:3], x[:, 3:6]),
                            jnp.zeros((x.shape[0], 6), jnp.float32)], axis=1)


def _assert_hits(want, bt, btri):
    (wt, wtri) = want
    np.testing.assert_array_equal(np.asarray(wtri), btri.numpy())
    np.testing.assert_allclose(np.asarray(wt), bt.numpy(), rtol=T_RTOL)


# --------------------------------------------------------------------------
# kernel 9: the sphere cull
# --------------------------------------------------------------------------


@pytest.mark.parametrize("tile", [1, 128, 256])
def test_cull_matches_jax_ref(tile):
    _, jcm, tcm = _tables(2)
    x = _x(jcm, 2048, seed=3)
    want = np.asarray(jcl._cull_ref(jnp.asarray(x), jcm.cull_w, jcm.blk, tile))
    got = tcl.cull(_t(x), tcm.cull_w, tcm.blk, tile).numpy()
    assert (want < 1e30).any()
    np.testing.assert_array_equal(want < 1e30, got < 1e30)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


def test_cull_matches_pallas_interpret_bit_for_bit():
    _, jcm, tcm = _tables(2)
    x = _x(jcm, 1024, seed=3)
    interp = np.asarray(jcl._cull_pallas(jnp.asarray(x), jcm.cull_w, jcm.blk, 256, True))
    got = tcl.cull(_t(x), tcm.cull_w, tcm.blk, 256).numpy()
    np.testing.assert_array_equal(interp, got)


def test_cull_tables_match_the_jax_build():
    _, jcm, tcm = _tables(3)
    for name in ("cull_w", "blk", "w"):
        np.testing.assert_array_equal(np.asarray(getattr(jcm, name)),
                                      getattr(tcm, name).numpy())


# --------------------------------------------------------------------------
# select
# --------------------------------------------------------------------------


@pytest.mark.parametrize("rounds", [1, 4, 128, 500])
def test_select_matches_jax(rounds):
    """JAX's own tile_entry, many ties, a tile with no feasible block and
    one with every block feasible; rounds below, at and above kp = 128."""
    _, jcm, _ = _tables(2)
    te = np.array(jcl._cull_ref(jnp.asarray(_x(jcm, 2048, seed=5)), jcm.cull_w, jcm.blk, 256))
    rng = np.random.default_rng(0)
    te[0, :40] = rng.integers(0, 8, 40).astype(np.float32)  # ties
    te[1] = 1e30
    te[2] = rng.integers(0, 4, 128).astype(np.float32)
    for got, want in zip(tcl._select(_t(te), rounds), jcl._select(jnp.asarray(te), rounds)):
        np.testing.assert_array_equal(np.asarray(want), got.numpy())


# --------------------------------------------------------------------------
# kernels 10 and 11: rounds and sweep
# --------------------------------------------------------------------------


def _round_inputs(jcm, tile, rounds, n=1024, seed=3):
    x = _x(jcm, n, seed)
    sel, lb, _ = jcl._select(jcl._cull_ref(jnp.asarray(x), jcm.cull_w, jcm.blk, tile), rounds)
    return sel, lb, _features(x), jnp.asarray(x[:, 6]), jnp.asarray(x[:, 7])


@pytest.mark.parametrize("tile, rounds", [(128, 4), (256, 64)])
def test_cluster_rounds_matches_jax_ref(tile, rounds):
    _, jcm, tcm = _tables(2)
    sel, lb, r, t0, act = _round_inputs(jcm, tile, rounds)
    want = _jax_cluster_ref(sel, lb, r, t0, act, jcm.w, tile, jcm.block, sel.shape[1])
    bt, btri = tcl.cluster_rounds(_t(sel), _t(lb), _t(r), _t(t0), _t(act), tcm, tile)
    assert (np.asarray(want[1]) >= 0).sum() > 200
    _assert_hits(want, bt, btri)


def test_cluster_rounds_matches_pallas_interpret():
    _, jcm, tcm = _tables(2)
    sel, lb, r, t0, act = _round_inputs(jcm, 256, 4)
    want = jcl._cluster_pallas(sel, lb, r, t0, act, jcm.w, 256, jcm.block, 4, True)
    bt, btri = tcl.cluster_rounds(_t(sel), _t(lb), _t(r), _t(t0), _t(act), tcm, 256)
    _assert_hits(want, bt, btri)


@pytest.mark.parametrize("route", ["cluster", "binned"])
def test_rounds_skip_premise_on_their_own_inputs(tmp_path, monkeypatch, route):
    """Kernel 10 runs the walk's round loop (csrc/round_walk.cuh): a ray
    takes part in round rr of its tile only while its best t exceeds
    lb[g, rr], the tile-min sphere entry into block sel[g, rr], and it
    meets the block's box, widened by the kernel's margin, before its best
    t (``walk._box_entry``); a part of a tile stops at the first round
    none of its live rays wants. That is exact if no triangle of the block
    gives any live ray of the tile an accepted t below lb[g, rr], nor below
    the ray's own widened-box entry, and if lb ascends along each tile's
    list (a best t only falls, so a round no ray wants is followed by
    none). Checked with the plain epilogue on every listed round of every
    call a depth-2 render of icosphere-3 in the Cornell box (32x32, 2 spp;
    64-slot blocks, most of them padded) makes to the rounds, on the
    cluster route and on the binned route (whose compacted repair passes
    R = K), each with 4 rounds: fewer than some tiles' feasible blocks."""
    scene = tparser.with_resolution(
        tparser.load_scene(CORNELL, obj_path=_mesh_obj(tmp_path, 3, 2.5), cluster_block=64,
                           device="cpu"), 32, 32)
    calls, over = [], []
    real_rounds, real_select = tcl.cluster_rounds, tcl._select

    def record(*args):
        calls.append(args)
        return real_rounds(*args)

    def select(tile_entry, rounds):
        out = real_select(tile_entry, rounds)
        over.append(out[2])
        return out

    monkeypatch.setattr(tcl, "cluster_rounds", record)
    monkeypatch.setattr(tcl, "_select", select)
    cfg = TCfg(trace_depth=2, cluster_tile=256, cluster_rounds=4, binned_rounds=4,
               cluster_binned=route == "binned", **CLUSTER)
    assert mesh_route(scene.mesh, scene.cmesh, cfg) == route
    render(scene, cfg, spp=2, seed=0, device="cpu")
    assert len(calls) >= 4 and any(bool((o < 1e30).any()) for o in over)  # R < feasible
    assert any(sel.shape[1] == 4 for sel, *_ in calls)
    rounds = skipped = 0
    for sel, lb, r, t0, act, cm, tile in calls:
        assert tile == 256 and (cm.real < cm.block).any()
        assert (lb[:, 1:] >= lb[:, :-1]).all()  # entry order: the early exit is exact
        entry = twalk._box_entry(r[:, 0:3], r[:, 3:6], cm.slab)
        for g in range(r.shape[0] // tile):
            rows = slice(g * tile, (g + 1) * tile)
            live = act[rows] > 0
            rt = r[rows][live]
            for rr in range(int((lb[g] < 1e30).sum()) if live.any() else 0):
                k = int(sel[g, rr])
                prod = rt @ cm.w[k]
                t = tmxu._epilogue(prod, cm.block, lb[g, rr].expand(rt.shape[0]))
                assert (t >= 1e30).all(), (g, rr)  # no accepted t below lb[g, rr]
                own = torch.minimum(entry[rows, k], t0[rows])[live]
                t = tmxu._epilogue(prod, cm.block, own)
                assert (t >= 1e30).all(), (g, rr)  # nor below the ray's own entry
                rounds += 1
                skipped += int((entry[rows, k][live] >= t0[rows][live]).sum())
    assert rounds > 20 and skipped > rounds  # most rays of a tile skip most of its blocks


def test_sweep_matches_jax_ref_and_pallas_interpret():
    """Against the JAX package's own repair forms: ``_cluster_ref`` over
    every block with lb=None, and the sweep kernel in interpret mode. The
    port's sweep skips the lane-padding blocks, whose zero weights never
    hit."""
    _, jcm, tcm = _tables(2)
    x = _x(jcm, 1024, seed=4)
    r, t0 = _features(x), jnp.asarray(x[:, 6])
    g, kp = 1024 // 256, jcm.n_blocks
    all_sel = jnp.broadcast_to(jnp.arange(kp, dtype=jnp.int32)[None, :], (g, kp))
    refs = (_jax_cluster_ref(all_sel, None, r, t0, jnp.ones(1024), jcm.w, 256, jcm.block, kp),
            jcl._sweep_pallas(r, t0, jcm.w, 256, jcm.block, True))
    every = torch.arange(1024, dtype=torch.int32)  # the full-width form: every ray listed
    bt, btri = tcl.sweep(every, _t(r), _t(t0), torch.full((1024,), -1, dtype=torch.int32),
                         tcm, 256)
    assert (btri.numpy() >= 0).sum() > 200 and tcm.n_real_blocks < kp
    for want in refs:
        _assert_hits(want, bt, btri)


@functools.lru_cache(maxsize=None)
def _repair_case(subdiv, rounds, tile=256, n=1024):
    """The JAX pipeline up to the repair on _x's rays: the rounds' (bt,
    btri), the flagged rays, and the full sweep over every block merged
    into (bt, btri) as the JAX intersector merges it."""
    _, jcm, tcm = _tables(subdiv)
    x = _x(jcm, n, seed=subdiv + rounds)
    sel, lb, lb_over = jcl._select(jcl._cull_ref(jnp.asarray(x), jcm.cull_w, jcm.blk, tile),
                                   rounds)
    r, t0, act = _features(x), jnp.asarray(x[:, 6]), jnp.asarray(x[:, 7])
    bt, btri = _jax_cluster_ref(sel, lb, r, t0, act, jcm.w, tile, jcm.block, sel.shape[1])
    flagged = (act > 0) & (jnp.repeat(lb_over, tile) < bt)
    kp = jcm.n_blocks
    all_sel = jnp.broadcast_to(jnp.arange(kp, dtype=jnp.int32)[None, :], (n // tile, kp))
    bt2, btri2 = _jax_cluster_ref(all_sel, None, r, bt, act, jcm.w, tile, jcm.block, kp)
    keep = btri2 >= 0
    merged = (np.asarray(jnp.where(keep, bt2, bt)), np.asarray(jnp.where(keep, btri2, btri)))
    return (tcm, np.asarray(r), np.asarray(bt), np.asarray(btri), np.asarray(flagged),
            np.asarray(act) > 0, merged)


@pytest.mark.parametrize("subdiv", [2, 3])
@pytest.mark.parametrize("rounds", [1, 4])
@pytest.mark.parametrize("listed", ["flagged", "empty", "with dead lanes"])
def test_row_sweep_matches_jax_full_sweep_merged(subdiv, rounds, listed):
    """The sweep of a row list against the JAX full sweep of every tile,
    merged into the rounds' result: the listed rows take the merged
    result, every other row keeps its own. On the flagged rows the full
    sweep changes no other row, so the row sweep is the whole repair. Ids
    exactly and t within T_RTOL against JAX; against the port's own
    full-width form (every row listed, same tile), bit for bit."""
    tcm, r, bt, btri, flagged, live, (mt, mtri) = _repair_case(subdiv, rounds)
    n = bt.shape[0]
    if listed == "flagged":
        rows = np.flatnonzero(flagged)
        assert rows.size > 0
        np.testing.assert_array_equal(mtri[~flagged], btri[~flagged])
    elif listed == "empty":
        rows = np.zeros(0, np.int64)
    else:
        dead = np.flatnonzero(~live)
        rows = np.union1d(np.flatnonzero(flagged), dead[::3])
        assert dead.size > 0
    on = np.zeros(n, bool)
    on[rows] = True
    want = (np.where(on, mt, bt), np.where(on, mtri, btri))
    args = (_t(r), _t(bt), _t(btri))
    got = tcl.sweep(torch.from_numpy(rows.astype(np.int32)), *args, tcm, 256)
    _assert_hits(want, *got)
    full_t, full_tri = tcl.sweep(torch.arange(n, dtype=torch.int32), *args, tcm, 256)
    assert torch.equal(got[1], torch.where(torch.from_numpy(on), full_tri, _t(btri)))
    assert torch.equal(got[0], torch.where(torch.from_numpy(on), full_t, _t(bt)))


@pytest.mark.parametrize("method", ["kd", "morton"])
def test_real_slots_match_the_jax_padding(method):
    """The per-block real-slot counts equal the padding pattern of the JAX
    build (its padding slots copy v0 into v1 and v2, at the end of each
    block), in the port's build and in a JAX table carried over. 1,280
    triangles in blocks of 48: every kd leaf and the last morton block are
    padded."""
    mesh = _mesh(3)
    jcm = jcl.build_cluster_mesh(mesh, block=48, method=method)
    tcm = tcl.build_cluster_mesh(mesh, block=48, method=method, device="cpu")
    t = jcm.tris
    pad = ((np.asarray(t.v1) == np.asarray(t.v0)).all(1)
           & (np.asarray(t.v2) == np.asarray(t.v0)).all(1)).reshape(-1, 48)
    count = (~pad).sum(axis=1)
    assert pad.any() and all(not pad[k, :c].any() for k, c in enumerate(count))  # trailing
    want = np.concatenate([count, np.zeros(jcm.n_blocks - jcm.n_real_blocks, int)])
    np.testing.assert_array_equal(tcm.real.numpy(), want)
    scene = jparser.load_scene(CORNELL, build_kd=False)._replace(cmesh=jcm)
    carried = scene_from_numpy(jax.tree.map(np.asarray, scene), "cpu").cmesh
    np.testing.assert_array_equal(carried.real.numpy(), want)


# --------------------------------------------------------------------------
# the intersector
# --------------------------------------------------------------------------


def _check_against_brute(mesh, o, d, hit):
    hb = intersect_mesh_brute(o, d, jax.tree.map(jnp.asarray, mesh), use_bbox=False)
    t_c, t_b = hit.t.numpy(), np.asarray(hb.t)
    miss_c, miss_b = t_c >= 1e30, t_b >= 1e30
    assert (miss_c == miss_b).all(), f"{(miss_c != miss_b).sum()} hit/miss diffs"
    np.testing.assert_allclose(t_c[~miss_c], t_b[~miss_b], rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("rounds, repair", [(1, "sweep"), (4, "sweep"), (64, "none")])
def test_cluster_matches_jax_and_brute(rounds, repair):
    """1,280 triangles in 20 blocks, 4,096 rays; rounds = 1 and 4 leave
    feasible blocks unselected, so rays flag and the sweep repairs them.
    Against the JAX intersector at rounds 4 and 64 (its sweep compiles
    slowly at 1), against brute force at all three."""
    mesh, jcm, tcm = _tables(3)
    o, d = _rays(4096)
    kw = dict(cluster_tile=512, cluster_rounds=rounds, **CLUSTER)
    hit, stats = tcl.intersect_mesh_cluster(_t(o), _t(d), tcm, TCfg(**kw), collect_stats=True)
    assert stats["repair"] == repair and (stats["flagged"] > 0) == (repair == "sweep")
    _check_against_brute(mesh, o, d, hit)
    if rounds > 1:
        hj = jax.jit(lambda o, d: jcl.intersect_mesh_cluster(o, d, jcm, JCfg(**kw)))(o, d)
        _assert_hits((hj.t, hj.tri), hit.t, hit.tri)


def test_cluster_without_coherence_sort_matches_jax():
    _, jcm, tcm = _tables(2)
    o, d = _rays(1024, seed=6)
    kw = dict(cluster_tile=256, cluster_rounds=4, cluster_sort=False, **CLUSTER)
    hit = tcl.intersect_mesh_cluster(_t(o), _t(d), tcm, TCfg(**kw))
    hj = jax.jit(lambda o, d: jcl.intersect_mesh_cluster(o, d, jcm, JCfg(**kw)))(o, d)
    _assert_hits((hj.t, hj.tri), hit.t, hit.tri)


def test_cluster_t_init_and_active_masking():
    """A bound below every hit leaves only misses; dead lanes never hit
    and never flag; with a bound per lane, some dead lanes and n not a
    multiple of the tile, the result is the unbounded one, cut."""
    _, _, tcm = _tables(2)
    o, d = _aimed_rays(500, seed=5)
    cfg = TCfg(cluster_tile=256, cluster_rounds=2, **CLUSTER)
    bounded = tcl.intersect_mesh_cluster(_t(o), _t(d), tcm, cfg, t_init=torch.full((500,), 1e-3))
    assert (bounded.t >= 1e30).all() and (bounded.tri == -1).all()
    dead, stats = tcl.intersect_mesh_cluster(_t(o), _t(d), tcm, cfg,
                                             active=torch.zeros(500, dtype=torch.bool),
                                             collect_stats=True)
    assert (dead.t >= 1e30).all() and stats["flagged"] == 0
    base = tcl.intersect_mesh_cluster(_t(o), _t(d), tcm, cfg)
    act = torch.arange(500) % 3 != 0
    t_init = torch.linspace(1.0, 8.0, 500)
    hit = tcl.intersect_mesh_cluster(_t(o), _t(d), tcm, cfg, t_init=t_init, active=act)
    keep = act & (base.t < t_init)
    assert keep.sum() > 20 and (~keep & (base.tri >= 0)).sum() > 20
    assert torch.equal(hit.tri, torch.where(keep, base.tri, -1))
    assert torch.equal(hit.t, torch.where(keep, base.t, 1e30))


# --------------------------------------------------------------------------
# renders
# --------------------------------------------------------------------------


def test_cluster_render_matches_jax(tmp_path):
    """24x24, depth 2, 2 spp, a 1,280-triangle sphere with cluster rounds
    = 4 (so the sweep runs): both packages render the identical scene
    tables. Bound: mean |d| <= 2e-3 (rounding moves a path only where a
    ray grazes an edge)."""
    jscene = jparser.with_resolution(
        jparser.load_scene(CORNELL, obj_path=_mesh_obj(tmp_path, 3, 2.5), build_kd=False),
        24, 24)
    tscene = scene_from_numpy(jax.tree.map(np.asarray, jscene), "cpu")
    kw = dict(trace_depth=2, antialias=True, cluster_tile=256, cluster_rounds=4, **CLUSTER)
    assert mesh_route(tscene.mesh, tscene.cmesh, TCfg(**kw)) == "cluster"
    img_j = np.asarray(jrender(jscene, JCfg(**kw), spp=2, seed=0))
    img_t = render(tscene, TCfg(**kw), spp=2, seed=0, device="cpu").numpy()
    assert np.abs(img_j - img_t).mean() <= 2e-3


def test_mesh_pairs_48_golden_in_cluster_config(tmp_path):
    """The pair-list golden's scene and seed through cluster rounds
    (tests/test_cluster.py:206-207's config): both intersectors are exact,
    so the images agree to the golden tests' cross-mode bound (mean |d|
    <= 1e-2)."""
    scene = tparser.with_resolution(
        tparser.load_scene(CORNELL, obj_path=_mesh_obj(tmp_path, 4, 2.0), device="cpu"),
        48, 48)
    img = render(scene, TCfg(trace_depth=4, cluster_tile=256, cluster_rounds=6, **CLUSTER),
                 spp=8, seed=0, device="cpu").numpy()
    assert np.abs(img - np.load(os.path.join(GOLDENS, "mesh_pairs_48.npy"))).mean() <= 1e-2
