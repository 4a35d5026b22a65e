"""The binned intersector and its kernel's plain version against the JAX
package.

Inputs are the JAX binned tests' meshes and ray sets (numpy seeds), plus
rays that start on the mesh, inside several bounding spheres at once, so
that many blocks tie at entry 0. Tolerances: the argmin bins bit for bit
(against the JAX jnp mirror and the TPU kernel in interpret mode: every
bin here is the same although ``x @ cull_w`` rounds some entries
differently); the intersector's triangle ids exactly, with t within 1e-6
relative (a 16-term float32 product summed in another order); brute force
within the JAX binned tests' own 2e-4.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kdtreepathtraceroptimization_tpu.config import RenderConfig as JCfg
from kdtreepathtraceroptimization_tpu.ops import binned as jbn
from kdtreepathtraceroptimization_tpu.render.integrator import render as jrender
from kdtreepathtraceroptimization_tpu.scene import parser as jparser
from kdtreepathtraceroptimization_tpu_torch import render_loss
from kdtreepathtraceroptimization_tpu_torch.config import RenderConfig as TCfg
from kdtreepathtraceroptimization_tpu_torch.convert import materials_to_torch, scene_from_numpy
from kdtreepathtraceroptimization_tpu_torch.ops import binned as tbn
from kdtreepathtraceroptimization_tpu_torch.ops.rng import prng_key
from kdtreepathtraceroptimization_tpu_torch.render.integrator import mesh_route, render
from kdtreepathtraceroptimization_tpu_torch.scene import parser as tparser
from tests.test_cluster import _rays
from tests.test_torch_cluster import (
    _adversarial_rays,
    _aimed_rays,
    _assert_group_sphere_premise,
    _assert_hits,
    _check_against_brute,
    _t,
    _tables,
    _x,
)
from tests.test_torch_render import CORNELL, GOLDENS, _mesh_obj

BINNED = dict(cluster=True, cluster_pairs=False, cluster_binned=True)


def _surface_x(cm, n, seed):
    """[n, 8] records of rays leaving points of the icosphere (radius 2,
    centre (0.3, -0.2, 0.5)) in random directions: each origin lies inside
    several blocks' spheres, whose entry bounds are all 0."""
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(n, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    o = np.array([0.3, -0.2, 0.5]) + 2.0 * u
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return np.concatenate([o - np.asarray(cm.center_shift), d, np.full((n, 1), 1e30),
                           np.ones((n, 1))], axis=1).astype(np.float32)


def test_argmin_matches_jax_ref_and_pallas_interpret():
    _, jcm, tcm = _tables(2)
    x = np.concatenate([_x(jcm, 1024, seed=11), _surface_x(jcm, 1024, seed=12)])
    got = tbn.argmin_bins(_t(x), tcm.cull_w, tcm.blk).numpy()
    entry0 = np.asarray(jbn.cl._cull_ref(jnp.asarray(x), jcm.cull_w, jcm.blk, 1)) == 0
    assert (entry0[1024:].sum(axis=1) > 1).mean() > 0.5  # ties at entry 0
    assert 0.1 < (got < jcm.n_blocks).mean() < 0.99
    np.testing.assert_array_equal(np.asarray(jbn._argmin_ref(jnp.asarray(x), jcm.cull_w,
                                                             jcm.blk)), got)
    np.testing.assert_array_equal(
        np.asarray(jbn._argmin_pallas(jnp.asarray(x), jcm.cull_w, jcm.blk, 256, True)), got)


@pytest.mark.parametrize("rounds, repair", [(1, "compact"), (4, "compact"), (32, "none")])
def test_binned_matches_jax_and_brute(rounds, repair):
    """1,280 triangles in 20 blocks, 4,096 rays; rounds = 1 and 4 leave
    feasible blocks unselected, so rays flag and the compacted pass
    repairs them."""
    mesh, jcm, tcm = _tables(3)
    o, d = _rays(4096)
    kw = dict(cluster_tile=512, binned_rounds=rounds, **BINNED)
    hit, stats = tbn.intersect_mesh_binned(_t(o), _t(d), tcm, TCfg(**kw), collect_stats=True)
    assert stats["repair"] == repair and (stats["flagged"] > 0) == (repair != "none")
    _check_against_brute(mesh, o, d, hit)
    hj = jax.jit(lambda o, d: jbn.intersect_mesh_binned(o, d, jcm, JCfg(**kw)))(o, d)
    _assert_hits((hj.t, hj.tri), hit.t, hit.tri)


def test_binned_sweep_fallback(monkeypatch):
    """More flagged rays than the repair buffer take the sweep, in both
    packages; the port's sweeps the flagged rows alone."""
    mesh, jcm, tcm = _tables(3)
    o, d = _rays(2048, seed=7)
    monkeypatch.setattr(tbn, "REPAIR_LANES", 64)
    monkeypatch.setattr(jbn, "REPAIR_LANES", 64)
    listed = []
    real_sweep = tbn.cl.sweep

    def sweep(rows, *args, **kwargs):
        listed.append(rows)
        return real_sweep(rows, *args, **kwargs)

    monkeypatch.setattr(tbn.cl, "sweep", sweep)
    kw = dict(cluster_tile=256, binned_rounds=1, **BINNED)
    hit, stats = tbn.intersect_mesh_binned(_t(o), _t(d), tcm, TCfg(**kw), collect_stats=True)
    assert stats["repair"] == "sweep" and stats["flagged"] > 64
    (rows,) = listed
    assert rows.dtype == torch.int32 and rows.shape == (stats["flagged"],)
    assert bool((rows[1:] > rows[:-1]).all()) and int(rows[-1]) < 2048
    _check_against_brute(mesh, o, d, hit)
    hj = jax.jit(lambda o, d: jbn.intersect_mesh_binned(o, d, jcm, JCfg(**kw)))(o, d)
    _assert_hits((hj.t, hj.tri), hit.t, hit.tri)


def test_binned_t_init_and_active_masking():
    """The result with a bound and dead lanes is the unbounded one, cut: a
    hit beyond its lane's bound and any hit of a dead lane are misses."""
    _, _, tcm = _tables(2)
    o, d = _aimed_rays(500, seed=5)
    cfg = TCfg(cluster_tile=256, binned_rounds=2, **BINNED)
    base = tbn.intersect_mesh_binned(_t(o), _t(d), tcm, cfg)
    act = torch.arange(500) % 3 != 0
    t_init = torch.linspace(1.0, 8.0, 500)
    hit = tbn.intersect_mesh_binned(_t(o), _t(d), tcm, cfg, t_init=t_init, active=act)
    keep = act & (base.t < t_init)
    assert keep.sum() > 20 and (~keep & (base.tri >= 0)).sum() > 20
    assert torch.equal(hit.tri, torch.where(keep, base.tri, -1))
    assert torch.equal(hit.t, torch.where(keep, base.t, 1e30))


def test_binned_shards_are_not_ported():
    """binned_shards = 4 (once refused: the sorts and the repair compaction
    row by row on the [4, n / 4] view) gives S = 1's hits on the CPU, and
    an unaligned ray count drops back to S = 1 as JAX does."""
    _, _, tcm = _tables(2)
    for n in (1024, 1000):
        o, d = _rays(n, seed=9)
        base = tbn.intersect_mesh_binned(_t(o), _t(d), tcm,
                                         TCfg(cluster_tile=256, binned_rounds=2, **BINNED))
        hit, stats = tbn.intersect_mesh_binned(
            _t(o), _t(d), tcm, TCfg(cluster_tile=256, binned_rounds=2, binned_shards=4,
                                    **BINNED), collect_stats=True)
        assert (hit.tri >= 0).sum() > 20 and stats["flagged"] > 0
        assert torch.equal(hit.tri, base.tri) and torch.equal(hit.t, base.t)


def test_binned_render_matches_jax(tmp_path):
    """24x24, depth 2, 2 spp, a 1,280-triangle sphere with binned rounds =
    4 (so the compacted repair runs): both packages render the identical
    scene tables. Bound: mean |d| <= 2e-3."""
    jscene = jparser.with_resolution(
        jparser.load_scene(CORNELL, obj_path=_mesh_obj(tmp_path, 3, 2.5), build_kd=False),
        24, 24)
    tscene = scene_from_numpy(jax.tree.map(np.asarray, jscene), "cpu")
    kw = dict(trace_depth=2, antialias=True, cluster_tile=256, binned_rounds=4, **BINNED)
    assert mesh_route(tscene.mesh, tscene.cmesh, TCfg(**kw)) == "binned"
    img_j = np.asarray(jrender(jscene, JCfg(**kw), spp=2, seed=0))
    img_t = render(tscene, TCfg(**kw), spp=2, seed=0, device="cpu").numpy()
    assert np.abs(img_j - img_t).mean() <= 2e-3


def test_mesh_pairs_48_golden_in_binned_config(tmp_path):
    """The pair-list golden's scene and seed through the binned
    intersector (tests/test_golden.py:78-81's config): mean |d| <= 1e-2,
    the cross-mode bound of the golden tests."""
    scene = tparser.with_resolution(
        tparser.load_scene(CORNELL, obj_path=_mesh_obj(tmp_path, 4, 2.0), device="cpu"),
        48, 48)
    img = render(scene, TCfg(trace_depth=4, cluster_tile=256, binned_rounds=8, **BINNED),
                 spp=8, seed=0, device="cpu").numpy()
    assert np.abs(img - np.load(os.path.join(GOLDENS, "mesh_pairs_48.npy"))).mean() <= 1e-2


def test_binned_material_grad_equals_the_pair_route(tmp_path):
    """Both intersectors are exact, so a render MSE's material gradient
    through the binned route equals the pair route's: the same hits give
    the same graph."""
    scene = tparser.with_resolution(
        tparser.load_scene(CORNELL, obj_path=_mesh_obj(tmp_path, 3, 2.5), device="cpu"),
        16, 16)
    grads = []
    for route in (BINNED, dict(cluster=True, cluster_pairs=True)):
        cfg = TCfg(trace_depth=3, antialias=True, cluster_tile=256, binned_rounds=4, **route)
        mats = materials_to_torch(scene.materials, "cpu", requires_grad=True)
        loss = render_loss(mats, scene, cfg, prng_key(0), 1, torch.zeros((256, 3)))
        grads.append(torch.autograd.grad(loss, mats.color))
    assert grads[0][0].abs().max() > 0
    torch.testing.assert_close(grads[0][0], grads[1][0], rtol=1e-6, atol=0)


def _ragged_table(kp=45, seed=8):
    """A synthetic [8, 2kp] / [8, kp] table of kp blocks (not a multiple of
    8: a ragged last group of 5) whose group 1 has no real member, with
    sentinels among real members (one in the ragged group) and one block
    whose r2 exceeds its radius squared; and [1024, 8] records of rays
    among the blocks, some starting inside several spheres (ties at entry
    0), every 5th dead."""
    rng = np.random.default_rng(seed)
    c = (rng.normal(size=(3, kp)) * 2.0).astype(np.float32)
    radius = rng.uniform(0.2, 0.9, kp).astype(np.float32)
    r2 = radius * radius
    r2[2] = 4.0 * r2[2]
    r2[8:16] = -1.0
    r2[[17, 20, kp - 2]] = -1.0
    blk = np.zeros((8, kp), np.float32)
    blk[0:3], blk[3], blk[4], blk[5] = c, radius, (c * c).sum(0), r2
    cull_w = np.zeros((8, 2 * kp), np.float32)
    cull_w[3:6, :kp], cull_w[0:3, kp:] = c, c
    n = 1024
    o = (rng.normal(size=(n, 3)) * 4.0).astype(np.float32)
    o[: n // 4] = c.T[rng.integers(0, kp, n // 4)]  # at a block's centre: entry 0
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    act = np.arange(n) % 5 != 0
    t0 = rng.uniform(0.5, 12.0, n)
    x = np.concatenate([o, d * act[:, None], t0[:, None], act[:, None]], axis=1)
    return x.astype(np.float32), cull_w, blk


@pytest.mark.parametrize("case", ["ties", "ragged"])
def test_argmin_grouped_matches_ref_and_jax(case):
    """Kernel 12's skip in plain form (``_argmin_grouped``: groups of 8 in
    index order, a group's members tested only below the ray's best
    entry) bit for bit against the plain argmin, the JAX jnp mirror and
    the JAX TPU kernel in interpret mode: on icosphere-2's table (8 real
    blocks of 128: 15 groups without a real member) with rays that tie at
    entry 0, and on a 45-block table with a ragged last group, an empty
    group and sentinels among real members."""
    if case == "ties":
        _, jcm, tcm = _tables(2)
        x = np.concatenate([_x(jcm, 1024, seed=21), _surface_x(jcm, 1024, seed=22)])
        cull_w, blk = tcm.cull_w, tcm.blk
    else:
        x, cw, bk = _ragged_table()
        cull_w, blk = _t(cw), _t(bk)
    kp = blk.shape[1]
    got = tbn._argmin_grouped(_t(x), cull_w, blk)
    want = tbn._argmin_ref(_t(x), cull_w, blk)
    assert 0.1 < (want < kp).float().mean().item() < 0.99
    assert torch.equal(got, want)
    jargs = (jnp.asarray(x), jnp.asarray(cull_w.numpy()), jnp.asarray(blk.numpy()))
    np.testing.assert_array_equal(np.asarray(jbn._argmin_ref(*jargs)), got.numpy())
    np.testing.assert_array_equal(np.asarray(jbn._argmin_pallas(*jargs, 256, True)),
                                  got.numpy())


def test_argmin_group_premise_on_a_binned_render(tmp_path, monkeypatch):
    """Every ``argmin_bins`` call of a depth-2 binned render of icosphere-3
    in the Cornell box (32x32, 2 spp; 64-slot blocks): every feasible
    (ray, block) lies in a group whose widened entry is no later than the
    block's (so kernel 12's skip is exact), and the skip in plain form
    equals the plain argmin bit for bit."""
    scene = tparser.with_resolution(
        tparser.load_scene(CORNELL, obj_path=_mesh_obj(tmp_path, 3, 2.5), cluster_block=64,
                           device="cpu"), 32, 32)
    calls = []
    real = tbn.argmin_bins

    def record(*args):
        calls.append(args)
        return real(*args)

    monkeypatch.setattr(tbn, "argmin_bins", record)
    cfg = TCfg(trace_depth=2, cluster_tile=256, binned_rounds=4, **BINNED)
    render(scene, cfg, spp=2, seed=0, device="cpu")
    assert len(calls) >= 4
    feasible = 0
    for x, cull_w, blk in calls:
        assert torch.equal(tbn._argmin_grouped(x, cull_w, blk), tbn._argmin_ref(x, cull_w, blk))
        feasible += _assert_group_sphere_premise(x, cull_w, blk)[0]
    assert feasible > 1000


@pytest.mark.parametrize("kind", ["grazing", "inside", "on", "head_on", "away", "off_unit"])
def test_argmin_grouped_on_adversarial_rays(kind):
    """Kernel 9's adversarial rays (``_adversarial_rays``: at the edge of
    the group test's margins) through kernel 12's skip: the plain form
    equals the plain argmin bit for bit on the icosphere-3 table with
    16-slot blocks."""
    _, _, tcm = _tables(3, 16)
    x = _t(_adversarial_rays(tcm, kind, 8192, seed=len(kind)))
    want = tbn._argmin_ref(x, tcm.cull_w, tcm.blk)
    assert (want < tcm.n_blocks).sum() > 1000
    assert torch.equal(tbn._argmin_grouped(x, tcm.cull_w, tcm.blk), want)
