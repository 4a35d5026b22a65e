"""The brute-force intersectors (``enable_kd=False``) against the JAX
package: Moller-Trumbore, the chunked brute force, the matrix-product
brute force and its kernel's semantics, and a render.

Tolerances: triangle ids and hit/miss exactly; t within 4e-6 relative
(a few ulps: JAX runs these loops under jit, where XLA's CPU compiler
fuses multiply-adds, and sums of 3 or 16 terms go in another order), u/v
of hits within 1e-4 (they scale by the reciprocal of the determinant,
which magnifies its ulps on grazing hits); the render within mean |d|
2e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kdtreepathtraceroptimization_tpu.config import RenderConfig as JCfg
from kdtreepathtraceroptimization_tpu.ops import intersect as jisect
from kdtreepathtraceroptimization_tpu.ops import mesh as jmesh
from kdtreepathtraceroptimization_tpu.ops import mxu_bf as jmxu
from kdtreepathtraceroptimization_tpu.render.integrator import render as jrender
from kdtreepathtraceroptimization_tpu.scene import parser as jparser
from kdtreepathtraceroptimization_tpu_torch.config import RenderConfig as TCfg
from kdtreepathtraceroptimization_tpu_torch.convert import scene_from_numpy
from kdtreepathtraceroptimization_tpu_torch.ops import intersect as tisect
from kdtreepathtraceroptimization_tpu_torch.ops import mesh as tmesh
from kdtreepathtraceroptimization_tpu_torch.ops import mxu_bf as tmxu
from kdtreepathtraceroptimization_tpu_torch.render.integrator import intersect_scene, mesh_route, render
from kdtreepathtraceroptimization_tpu_torch.scene.structs import MeshSoA
from tests.test_cluster import _mesh, _rays
from tests.test_torch_render import CORNELL, _mesh_obj

T_RTOL = 4e-6


def _t(a):
    return torch.from_numpy(np.array(a))


def _tmesh(mesh):
    return MeshSoA(*(_t(a) for a in mesh))


def _same_hits(a, b, rtol=T_RTOL):
    np.testing.assert_array_equal(np.asarray(a.tri), b.tri.numpy())
    np.testing.assert_allclose(np.asarray(a.t), b.t.numpy(), rtol=rtol)


def test_moller_trumbore_matches_jax():
    mesh = _mesh(1)
    o, d = _rays(2048, seed=2)
    want = jisect.moller_trumbore(o, d, mesh.v0, mesh.v1, mesh.v2)
    got = tisect.moller_trumbore(_t(o), _t(d), _t(mesh.v0), _t(mesh.v1), _t(mesh.v2))
    hit = np.asarray(want[0]) < 1e30
    assert hit.sum() > 50
    np.testing.assert_array_equal(hit, got[0].numpy() < 1e30)
    np.testing.assert_allclose(np.asarray(want[0]), got[0].numpy(), rtol=T_RTOL)
    for a, b in zip(want[1:], got[1:]):
        np.testing.assert_allclose(np.asarray(a)[hit], b.numpy()[hit], atol=1e-4)


@pytest.mark.parametrize("use_bbox, chunk", [(True, 512), (False, 128)])
def test_intersect_mesh_brute_matches_jax(use_bbox, chunk):
    """320 triangles in chunks that do not divide them, with and without
    the per-shape box cull; a bound below some hits."""
    mesh = _mesh(2)
    o, d = _rays(2048, seed=3)
    t_max = np.linspace(1.0, 10.0, 2048).astype(np.float32)
    for tm in (None, t_max):
        want = jmesh.intersect_mesh_brute(o, d, jax.tree.map(jnp.asarray, mesh),
                                          chunk=chunk, use_bbox=use_bbox,
                                          t_max=None if tm is None else jnp.asarray(tm))
        got = tmesh.intersect_mesh_brute(_t(o), _t(d), _tmesh(mesh), chunk=chunk,
                                         use_bbox=use_bbox,
                                         t_max=None if tm is None else _t(tm))
        assert (got.tri >= 0).sum() > 50
        _same_hits(want, got)
        hit = got.tri.numpy() >= 0
        for a, b in ((want.u, got.u), (want.v, got.v)):
            np.testing.assert_allclose(np.asarray(a)[hit], b.numpy()[hit], atol=1e-4)


@pytest.mark.parametrize("block", [64, 2048])
def test_brute_mxu_ref_matches_jax(block):
    """The plain brute force, offset far from the origin (the centring),
    with a t bound, against the JAX mirror and the JAX brute force."""
    mesh = _mesh(2)
    shift = np.float32([40.0, -25.0, 10.0])
    v = [np.asarray(a) + shift for a in (mesh.v0, mesh.v1, mesh.v2)]
    o, d = _rays(2048, seed=4)
    o = np.asarray(o) + shift
    t_max = np.full(2048, 1e30, np.float32)
    t_max[::5] = 3.0
    want = jmxu.intersect_brute_mxu_ref(o, d, *v, t_max=jnp.asarray(t_max), block=block)
    got = tmxu.intersect_brute_mxu_ref(_t(o), _t(d), *map(_t, v), t_max=_t(t_max), block=block)
    assert (got.tri >= 0).sum() > 50
    _same_hits(want, got)


def test_brute_mxu_matches_pallas_interpret():
    """The kernel wrapper's semantics (padded rays and triangles, the
    first minimum within a 128-triangle block, strict < across blocks)
    against the TPU kernel in interpret mode; on CPU tensors the wrapper
    runs the plain version at its triangle block."""
    mesh = _mesh(2)
    o, d = _rays(1000, seed=5)  # not a multiple of the ray tile
    want = jmxu.intersect_brute_mxu(o, d, mesh.v0, mesh.v1, mesh.v2, ray_tile=256,
                                    tri_block=128, interpret=True)
    got = tmxu.intersect_brute_mxu(_t(o), _t(d), _t(mesh.v0), _t(mesh.v1), _t(mesh.v2),
                                   ray_tile=256, tri_block=128)
    assert (got.tri >= 0).sum() > 30
    _same_hits(want, got)


@pytest.mark.parametrize("mxu_brute", [True, False])
def test_brute_render_matches_jax(tmp_path, mxu_brute):
    """48x48, depth 4, 4 spp, a 320-triangle sphere (below
    cluster_min_tris, so enable_kd=False takes a brute force): both
    packages render the identical scene tables. Bound: mean |d| <= 2e-3."""
    jscene = jparser.with_resolution(
        jparser.load_scene(CORNELL, obj_path=_mesh_obj(tmp_path, 2, 2.5),
                           build_kd=False), 48, 48)
    tscene = scene_from_numpy(jax.tree.map(np.asarray, jscene), "cpu")
    kw = dict(trace_depth=4, antialias=True, enable_kd=False, mxu_brute=mxu_brute)
    assert mesh_route(tscene.mesh, tscene.cmesh, TCfg(**kw)) == ("mxu" if mxu_brute else "brute")
    img_j = np.asarray(jrender(jscene, JCfg(**kw), spp=4, seed=0))
    img_t = render(tscene, TCfg(**kw), spp=4, seed=0, device="cpu").numpy()
    assert np.abs(img_j - img_t).mean() <= 2e-3


@pytest.mark.parametrize("mxu_brute", [True, False])
def test_brute_routes_need_the_triangle_record(tmp_path, mxu_brute):
    """The brute-force routes expand hits from the mesh's [T, 19] record,
    which the render step builds once; a direct call without it raises."""
    scene = scene_from_numpy(jax.tree.map(np.asarray, jparser.load_scene(
        CORNELL, obj_path=_mesh_obj(tmp_path, 1, 2.5), build_kd=False)), "cpu")
    cfg = TCfg(enable_kd=False, mxu_brute=mxu_brute)
    o, d = _rays(64, seed=6)
    with pytest.raises(ValueError, match="mesh_packed"):
        intersect_scene(_t(o), _t(d), scene.geoms, scene.mesh, cfg, cmesh=scene.cmesh)
    hit = intersect_scene(_t(o), _t(d), scene.geoms, scene.mesh, cfg, cmesh=scene.cmesh,
                          mesh_packed=tmesh.pack_tris(scene.mesh))
    assert hit.t.shape == (64,) and torch.isfinite(hit.t).all()


def test_live_first_permutation_round_trips():
    """Kernel 8's wrapper sorts rays with d = 0 to the back (``live_first``)
    and un-permutes the outputs: stable within each group, and the
    inverse gives back every ray's own result."""
    rng = np.random.default_rng(7)
    mesh = _mesh(2)
    o = np.array(_rays(1000, seed=8)[0])
    d = np.float32([0.3, -0.2, 0.5]) + rng.normal(size=(1000, 3)).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)  # aimed near the sphere: most hit
    d[rng.uniform(size=1000) < 0.3] = 0.0
    d[5, :2] = 0.0  # one non-zero component: still a ray that moves
    t_max = np.where(np.arange(1000) % 4 == 0, 3.0, 1e30).astype(np.float32)
    perm, inv = tmxu.live_first(_t(d))
    dead = np.all(d == 0, axis=1)
    nlive = int((~dead).sum())
    p = perm.numpy()
    assert not dead[p[:nlive]].any() and dead[p[nlive:]].all()
    assert (np.diff(p[:nlive]) > 0).all() and (np.diff(p[nlive:]) > 0).all()
    assert torch.equal(perm[inv], torch.arange(1000))
    v = [_t(a) for a in (mesh.v0, mesh.v1, mesh.v2)]
    want = tmxu.intersect_brute_mxu_ref(_t(o), _t(d), *v, t_max=_t(t_max), block=128)
    got = tmxu.intersect_brute_mxu_ref(_t(o)[perm], _t(d)[perm], *v, t_max=_t(t_max)[perm],
                                       block=128)
    assert (want.tri >= 0).sum() > 300 and (want.tri[_t(dead)] == -1).all()
    assert torch.equal(got.tri[inv], want.tri)
    torch.testing.assert_close(got.t[inv], want.t, rtol=T_RTOL, atol=0)
