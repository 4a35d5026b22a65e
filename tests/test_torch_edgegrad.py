"""The port's edge-sampled geometry gradients (``ops/edgegrad.py``) on the
KD route against the JAX package on the CPU.

The scenes are tests/test_edgegrad.py's (a dark triangle in front of the
Cornell box's back wall; a dark horizontal triangle between the light and
the floor) and tests/test_grad.py's icosphere(1): the JAX package loads
them and ``scene_from_numpy`` carries the same tables (the KD tree
included) into the port. Inputs and cotangents come from numpy seeds. The
JAX references run under ``jit`` in spawned processes while this one
builds the port's side. Tolerances, and why:

- ``build_edges``, ``silhouette_mask``, the viewpoint offset and
  ``retris``' tables: equal (integer work, selects and copies);
- ``project_to_screen``: 2 ulps of the coordinates' scale (three-term
  dot products summed in another order than XLA's);
- the silhouette and the alive samples of both boundary terms: equal;
- the boundary terms and ``make_render_geo``'s gradients against JAX:
  rtol 1e-4 of each entry and of the largest (the radiances agree to
  float32 rounding; XLA's CPU compiler fuses multiply-adds under ``jit``
  where the port rounds each product);
- the depth AOV's vertex gradient against JAX: rtol 1e-4, as
  tests/test_torch_grad.py's (a quotient of cross and dot products that
  the fusion rounds differently);
- finite differences: tests/test_edgegrad.py's own bounds (0.25 of the
  larger for the vertex term, 0.3 for the camera, 0.45 for the secondary
  term, on supersampled renders at SS 8) and tests/test_grad.py's (two of
  three depth-AOV components within 1e-1).
"""

import contextlib
import multiprocessing
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kdtreepathtraceroptimization_tpu.config import RenderConfig as JCfg
from kdtreepathtraceroptimization_tpu.ops import edgegrad as jeg
from kdtreepathtraceroptimization_tpu.ops.intersect import BIG as JBIG
from kdtreepathtraceroptimization_tpu.render import integrator as jint
from kdtreepathtraceroptimization_tpu.scene import parser as jparser
from kdtreepathtraceroptimization_tpu_torch.config import RenderConfig as TCfg
from kdtreepathtraceroptimization_tpu_torch.convert import materials_to_torch, scene_from_numpy
from kdtreepathtraceroptimization_tpu_torch.ops import edgegrad as teg
from kdtreepathtraceroptimization_tpu_torch.ops.camera import generate_rays
from kdtreepathtraceroptimization_tpu_torch.ops.intersect import BIG
from kdtreepathtraceroptimization_tpu_torch.ops.mesh import pack_tris
from kdtreepathtraceroptimization_tpu_torch.ops.rng import (
    bounce_key,
    fold_in,
    prng_key,
    uniform_scalar,
)
from kdtreepathtraceroptimization_tpu_torch.ops.traverse import intersect_mesh_kd
from kdtreepathtraceroptimization_tpu_torch.ops.vecmath import v3_to_rows
from kdtreepathtraceroptimization_tpu_torch.render import integrator as tint
from kdtreepathtraceroptimization_tpu_torch.utils.procmesh import icosphere, write_obj
from tests.test_edgegrad import SCENE, SS, _occluder_scene, _shadow_scene

# The JAX comparisons' resolution; the finite-difference checks run at
# tests/test_edgegrad.py's RES (32) with SS 8.
LO = 16
FD_RES = 32
RTOL = 1e-4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, rtol=RTOL):
    """Each entry within ``rtol`` of itself and of the largest entry."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-30))


def _scenes(make, res):
    """(JAX scene, port scene on the CPU, vertices [3, 3], faces) of one of
    tests/test_edgegrad.py's scenes at ``res`` x ``res``."""
    js, verts, faces = make()
    js = jparser.with_resolution(js, res, res)
    return js, scene_from_numpy(_np(js), "cpu"), np.asarray(verts), faces


def _cot(res, seed):
    return np.random.default_rng(seed).uniform(-1.0, 1.0, (res * res, 3)).astype(np.float32)


def _ramp(res, ss=1):
    """A weight per pixel growing with its column (tests/test_edgegrad.py):
    under a plain mean the camera's translation gradient is about 0."""
    cols = (np.arange(res * ss * res * ss) % (res * ss)) // ss
    return (cols.astype(np.float32) / res)[:, None]


def _floor_mask(res, ss=1):
    """The shadow test's floor rows (below 0.65 of the image)."""
    rows = (np.arange(res * ss * res * ss) // (res * ss)) // ss
    return (rows >= int(0.65 * res)).astype(np.float32)[:, None]


# --------------------------------------------------------------------------
# The JAX references, in spawned processes
# --------------------------------------------------------------------------


@contextlib.contextmanager
def _capturing(calls, job):
    """While the block runs, the JAX integrator's ``intersect_scene``
    records, under ``jit``, the ``active`` mask and the hit t of each call
    the boundary terms make with one, and its ``trace_rays`` the remaining
    bounces of each wavefront it is handed: ``calls`` gets (kind, job,
    arrays) as the compiled function runs."""
    real_isect, real_trace = jint.intersect_scene, jint.trace_rays

    def record(kind, *arrays):
        jax.debug.callback(lambda *v: calls.append((kind, job, [np.asarray(a) for a in v])),
                           *arrays)

    def isect(*args, **kwargs):
        hit = real_isect(*args, **kwargs)
        if kwargs.get("active") is not None:
            record("isect", kwargs["active"], hit.t)
        return hit

    def trace(rays, *args, **kwargs):
        record("trace", rays.remaining_bounces)
        jint.intersect_scene = real_isect  # the bounce loop's own calls
        try:
            return real_trace(rays, *args, **kwargs)
        finally:
            jint.intersect_scene = isect

    jint.intersect_scene, jint.trace_rays = isect, trace
    try:
        yield
    finally:
        jint.intersect_scene, jint.trace_rays = real_isect, real_trace


def _jscene(make, res):
    js, verts, _ = make()
    return jparser.with_resolution(js, res, res), verts


def _jtables(js, v, f):
    mesh_t = js.mesh._replace(v0=v[f[:, 0]], v1=v[f[:, 1]], v2=v[f[:, 2]])
    return (js.geoms, js.materials, mesh_t, jeg.retris(js.kd, v, f))


def _job_occ_bnd(inp, key, one):
    """The primary term on the occluder scene, and its silhouette."""
    js, _ = _jscene(_occluder_scene, LO)
    v, f = jnp.asarray(inp["occ_verts"]), jnp.asarray(inp["faces"])
    edges = jeg.build_edges(inp["faces"])
    cfg = JCfg(trace_depth=1, antialias=False)
    sil = np.asarray(jeg.silhouette_mask(v, f, edges, jnp.asarray(js.camera.position)))
    return (lambda v, cot: jeg.boundary_image_grad(
        v, f, edges, _jtables(js, v, f), js.camera, cfg, key, one, cot, samples_per_edge=16),
        (v, jnp.asarray(inp["cot"])), sil)


def _job_shadow_bnd(inp, key, one):
    """The secondary term on the shadow scene."""
    js, _ = _jscene(_shadow_scene, LO)
    v, f = jnp.asarray(inp["shadow_verts"]), jnp.asarray(inp["faces"])
    edges = jeg.build_edges(inp["faces"])
    cfg = JCfg(trace_depth=2, antialias=False)
    return (lambda v, cot: jeg.boundary_secondary_grad(
        v, f, edges, _jtables(js, v, f), js.camera, cfg, key, one, cot, n_view=256,
        samples_per_edge=4), (v, jnp.asarray(inp["cot"])), None)


def _job_occ_geo(inp, key, one):
    """make_render_geo under the ramp-weighted mean, occluder scene."""
    js, verts = _jscene(_occluder_scene, LO)
    rg = jeg.make_render_geo(js, verts, inp["faces"], JCfg(trace_depth=1, antialias=False),
                             samples_per_edge=16)
    ramp = jnp.asarray(_ramp(LO))
    return (jax.grad(lambda v, c: jnp.mean(rg(v, c, key, one) * ramp), argnums=(0, 1)),
            (verts, jnp.asarray(js.camera.position)), None)


def _job_shadow_geo(inp, key, one):
    """make_render_geo with the secondary term under the floor mask."""
    js, verts = _jscene(_shadow_scene, LO)
    rg = jeg.make_render_geo(js, verts, inp["faces"], JCfg(trace_depth=2, antialias=False),
                             samples_per_edge=16, secondary_viewpoints=LO * LO)
    mask = jnp.asarray(_floor_mask(LO))
    cam = jnp.asarray(js.camera.position)
    return (jax.grad(lambda v: jnp.sum(rg(v, cam, key, one) * mask) / jnp.sum(mask)),
            (verts,), None)


def _job_kd_depth(inp, key, one):
    """The depth AOV's gradient with respect to the KD table's v0."""
    js = jparser.with_resolution(jparser.load_scene(SCENE, obj_path=inp["ico1"]), LO, LO)
    cfg = JCfg(trace_depth=2, enable_kd=True)

    def depth_loss(v0):
        kd = js.kd._replace(tris=js.kd.tris._replace(v0=v0))
        hit = jint.intersect_scene(jnp.asarray(inp["origin"]), jnp.asarray(inp["direction"]),
                                   js.geoms, js.materials, js.mesh, kd, cfg)
        return jnp.sum(jnp.where(jnp.asarray(inp["lane_mask"]) & (hit.t < JBIG), hit.t, 0.0))

    return jax.grad(depth_loss), (jnp.asarray(js.kd.tris.v0),), None


def _jax_refs(names, inp):
    """The named JAX references (``_job_<name>``), as numpy: each job's
    value, its recorded calls (``<name> calls``) and its extra
    (``<name> post``). Traced one by one, compiled in parallel threads."""
    key = jax.random.PRNGKey(0)
    one = jnp.int32(1)
    calls, jobs, lowered = [], {}, {}
    for name in names:
        fn, args, post = globals()[f"_job_{name}"](inp, key, one)
        jobs[name] = (args, post)
        with _capturing(calls, name):
            lowered[name] = jax.jit(fn).lower(*args)
    with ThreadPoolExecutor(len(lowered)) as pool:
        compiled = {k: pool.submit(lo.compile) for k, lo in lowered.items()}
        compiled = {k: c.result() for k, c in compiled.items()}
    out = {}
    for name, (args, post) in jobs.items():
        out[name] = _np(compiled[name](*args))
        out[name + " post"] = post
    jax.effects_barrier()
    for name in names:
        out[name + " calls"] = [(kind, arrays) for kind, job, arrays in calls if job == name]
    return out


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    out = SimpleNamespace()
    _, _, occ_verts, faces = _scenes(_occluder_scene, LO)
    _, _, shadow_verts, _ = _scenes(_shadow_scene, LO)
    # tests/test_grad.py's test_mesh_vertex_grad scene: icosphere(1) in
    # Cornell, 16x16, depth 2, the KD walk; its camera rays and the lanes
    # that hit the most-hit triangle
    ico1 = str(tmp_path_factory.mktemp("ico1") / "ico1.obj")
    write_obj(ico1, *icosphere(1, radius=2.0, center=(0.0, 3.0, 0.0)))
    js = jparser.with_resolution(jparser.load_scene(SCENE, obj_path=ico1), LO, LO)
    ts = scene_from_numpy(_np(js), "cpu")
    cfg = TCfg(trace_depth=2, enable_kd=True)
    rays = generate_rays(ts.camera, cfg, bounce_key(prng_key(0), 1, 0), 1, "cpu")
    o, d = (v3_to_rows(v) for v in (rays.origin, rays.direction))
    win = intersect_mesh_kd(o, d, ts.kd, cfg).tri.numpy()
    rows, counts = np.unique(win[win >= 0], return_counts=True)
    lane_mask = win == int(rows[np.argmax(counts)])
    out.kd = SimpleNamespace(scene=ts, cfg=cfg, origin=o, direction=d,
                             lane_mask=torch.from_numpy(lane_mask))
    out.faces = faces
    inp = dict(occ_verts=occ_verts, shadow_verts=shadow_verts, faces=faces, cot=_cot(LO, 3),
               ico1=ico1, origin=o.numpy(), direction=d.numpy(), lane_mask=lane_mask)
    with ProcessPoolExecutor(3, mp_context=multiprocessing.get_context("spawn")) as pool:
        far = [pool.submit(_jax_refs, names, inp) for names in
               (("shadow_geo",), ("occ_geo", "kd_depth"), ("shadow_bnd",))]
        res = _jax_refs(("occ_bnd",), inp)
        for f in far:
            res.update(f.result())
    out.res = res
    out.cot = inp["cot"]
    return out


# --------------------------------------------------------------------------
# host tables, projection, silhouettes, the offset, retris
# --------------------------------------------------------------------------


@pytest.mark.parametrize("mesh", ["quad", "ico1"])
def test_build_edges_matches_jax(mesh):
    if mesh == "quad":
        faces = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    else:
        faces = icosphere(1)[1]
    got, want = teg.build_edges(faces), jeg.build_edges(faces)
    for name in got._fields:
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
        assert getattr(got, name).dtype == np.int32
    assert got.va.shape[0] == (5 if mesh == "quad" else 120)


def test_project_and_silhouette_match_jax():
    """Random points (some behind the camera) and icosphere(1)'s silhouette
    seen from four camera positions, inside and outside the sphere."""
    js, ts, _, _ = _scenes(_occluder_scene, LO)
    rng = np.random.default_rng(5)
    X = (rng.normal(size=(4096, 3)) * 4.0 + np.array([0.0, 5.0, 0.0])).astype(np.float32)
    got = teg.project_to_screen(ts.camera, torch.from_numpy(X))
    want = jeg.project_to_screen(js.camera, jnp.asarray(X))
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=2 * 2.0 ** -23 * np.abs(w).max())
    assert (np.asarray(want[2]) < 0).any()
    verts, faces = icosphere(1, radius=2.0, center=(0.0, 3.0, 0.0))
    edges = teg.build_edges(faces)
    for cam in ([0.0, 5.0, 10.5], [3.0, 1.0, -7.0], [0.1, 3.2, 0.3], [-9.0, 8.0, 2.0]):
        cam = np.asarray(cam, np.float32)
        got = teg.silhouette_mask(torch.from_numpy(verts), faces, edges, torch.from_numpy(cam))
        want = jeg.silhouette_mask(jnp.asarray(verts), jnp.asarray(faces), jeg.build_edges(faces),
                                   jnp.asarray(cam))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_viewpoint_offset_matches_jax():
    """``boundary_secondary_grad``'s lattice offset, ``uniform(fold_in(key,
    0x5EC0), ())``, bit for bit on keys of several seeds and iterations."""
    for seed in (0, 1, 42, 2 ** 31 - 1, 123456789):
        for it in (0, 1, 7):
            jkey = jax.random.fold_in(jax.random.PRNGKey(seed), it)
            want = np.float32(jax.random.uniform(jax.random.fold_in(jkey, 0x5EC0), ()))
            got = uniform_scalar(fold_in(fold_in(prng_key(seed), it), 0x5EC0))
            assert np.float32(got) == want and float(want) == got


def test_retris_matches_jax(tmp_path):
    """icosphere(2) in Cornell with its vertices moved by a seeded jitter:
    the rebuilt [T', 19] record equals ``pack_tris`` of the JAX ``retris``
    tables, the fat rows (inline slots) equal the JAX ones, the octant
    layouts are dropped, and a loss on the record reaches the vertices."""
    verts, faces = icosphere(2, radius=2.0, center=(0.0, 3.0, 0.0))
    obj = str(tmp_path / "ico2.obj")
    write_obj(obj, verts, faces)
    js = jparser.load_scene(SCENE, obj_path=obj)
    ts = scene_from_numpy(_np(js), "cpu")
    moved = (verts + np.random.default_rng(2).normal(size=verts.shape) * 0.01).astype(np.float32)
    jkd = jeg.retris(js.kd, jnp.asarray(moved), jnp.asarray(faces))
    v = torch.from_numpy(moved).requires_grad_(True)
    tkd = teg.retris(ts.kd, v, faces)
    want = pack_tris(type(tkd.tris)(*(torch.tensor(np.asarray(a)) for a in jkd.tris)))
    assert torch.equal(tkd.packed.detach(), want)
    np.testing.assert_array_equal(tkd.fat.rows.numpy(), np.asarray(jkd.fat.rows))
    assert not np.array_equal(np.asarray(js.kd.fat.rows), np.asarray(jkd.fat.rows))
    assert tkd.oct is None and jkd.oct is None
    (g,) = torch.autograd.grad(tkd.packed[:, 0:9].sum(), v)
    assert (g.abs().sum(dim=1) > 0).all()


# --------------------------------------------------------------------------
# the boundary terms against JAX
# --------------------------------------------------------------------------


def _port_tables(ts, verts, faces):
    v = torch.tensor(verts)
    f = torch.from_numpy(faces).long()
    mesh_t = ts.mesh._replace(v0=v[f[:, 0]], v1=v[f[:, 1]], v2=v[f[:, 2]])
    return v, (ts.geoms, materials_to_torch(ts.materials, "cpu"), mesh_t,
               teg.retris(ts.kd, v, f))


def test_boundary_image_grad_matches_jax(refs):
    """The primary term on the occluder scene, 16x16, depth 1, 16 samples
    an edge, a seeded cotangent: the same silhouette, the same samples on
    screen and unoccluded, and gradients for the vertices and the camera
    within rtol 1e-4."""
    js, ts, verts, faces = _scenes(_occluder_scene, LO)
    v, arrays = _port_tables(ts, verts, faces)
    dv, dc, stats = teg.boundary_image_grad(
        v, faces, teg.build_edges(faces), arrays, ts.camera, TCfg(trace_depth=1, antialias=False),
        prng_key(0), 1, torch.from_numpy(refs.cot), samples_per_edge=16, collect_stats=True)
    want_dv, want_dc = refs.res["occ_bnd"]
    ((_, (active, occ_t)),) = [c for c in refs.res["occ_bnd calls"] if c[0] == "isect"]
    np.testing.assert_array_equal(stats["silhouette"].numpy(), refs.res["occ_bnd post"])
    np.testing.assert_array_equal(stats["framed"].numpy().reshape(-1), active)
    # the JAX samples' occlusion test: t against the distance to the point
    s = (np.arange(16, dtype=np.float32) + 0.5) / 16
    e = teg.build_edges(faces)
    X = verts[e.va][:, None, :] * (1 - s)[:, None] + verts[e.vb][:, None, :] * s[:, None]
    dist = np.sqrt(((X.reshape(-1, 3) - ts.camera.position) ** 2).sum(-1) + 1e-12)
    np.testing.assert_array_equal(stats["alive"].numpy().reshape(-1),
                                  active & (occ_t >= dist * (1.0 - 1e-3)))
    assert stats["alive"].sum() > 20
    _close(dv, want_dv)
    _close(dc, want_dc)
    assert np.abs(want_dv).max() > 0


def test_boundary_secondary_grad_matches_jax(refs):
    """The secondary term on the shadow scene, 16x16, depth 2, 256
    viewpoints, 4 samples an edge: the same samples alive before and after
    the occlusion test, and vertex gradients within rtol 1e-4."""
    js, ts, verts, faces = _scenes(_shadow_scene, LO)
    v, arrays = _port_tables(ts, verts, faces)
    dv, stats = teg.boundary_secondary_grad(
        v, faces, teg.build_edges(faces), arrays, ts.camera, TCfg(trace_depth=2, antialias=False),
        prng_key(0), 1, torch.from_numpy(refs.cot), n_view=256, samples_per_edge=4,
        collect_stats=True)
    calls = refs.res["shadow_bnd calls"]
    ((_, (active, _)),) = [c for c in calls if c[0] == "isect"]
    traced = [c[1][0] for c in calls if c[0] == "trace"]
    assert len(traced) == 2
    np.testing.assert_array_equal(stats["framed"].numpy().reshape(-1), active)
    np.testing.assert_array_equal(stats["alive"].numpy().reshape(-1), traced[0] > 0)
    assert stats["alive"].sum() > 100 and stats["diffuse"].sum() > 100
    _close(dv, refs.res["shadow_bnd"])
    assert np.abs(refs.res["shadow_bnd"]).max() > 0


# --------------------------------------------------------------------------
# make_render_geo: against JAX and against finite differences
# --------------------------------------------------------------------------


def _render_geo(make, res, cfg, **kw):
    js, ts, verts, faces = _scenes(make, res)
    rg = teg.make_render_geo(ts, verts, faces, cfg, device="cpu", **kw)
    cam = torch.from_numpy(np.asarray(ts.camera.position, np.float32))
    return ts, torch.tensor(verts), faces, cam, rg


def _grads(rg, verts, cam, weight):
    """d mean(render * weight) / d (verts, cam_pos)."""
    v = verts.clone().requires_grad_(True)
    c = cam.clone().requires_grad_(True)
    img = rg(v, c, prng_key(0), 1)
    return torch.autograd.grad(torch.mean(img * weight), (v, c))


def test_render_geo_matches_jax(refs):
    """make_render_geo on the occluder scene (16x16, depth 1, 16 samples
    an edge) under the ramp-weighted mean: the interior plus primary term
    for the vertices and the camera; on the shadow scene (16x16, depth 2,
    the secondary term from every pixel) under the floor-masked mean: the
    vertices. Within rtol 1e-4 of JAX's."""
    _, verts, _, cam, rg = _render_geo(_occluder_scene, LO, TCfg(trace_depth=1, antialias=False),
                                       samples_per_edge=16)
    gv, gc = _grads(rg, verts, cam, torch.from_numpy(_ramp(LO)))
    want_v, want_c = refs.res["occ_geo"]
    _close(gv, want_v)
    _close(gc, want_c)
    _, verts, _, cam, rg = _render_geo(_shadow_scene, LO, TCfg(trace_depth=2, antialias=False),
                                       samples_per_edge=16, secondary_viewpoints=LO * LO)
    mask = torch.from_numpy(_floor_mask(LO))
    v = verts.clone().requires_grad_(True)
    (gv,) = torch.autograd.grad(torch.sum(rg(v, cam, prng_key(0), 1) * mask) / mask.sum(), v)
    _close(gv, refs.res["shadow_geo"])
    assert np.abs(refs.res["shadow_geo"]).max() > 0


def _fd_render(ts_hi, cfg, verts, faces, cam=None, with_mesh=True):
    """The radiance of the SS-times supersampled render of ``ts_hi``
    (tests/test_edgegrad.py's FD reference), the triangles from ``verts``."""
    f = torch.from_numpy(faces).long()
    mats = materials_to_torch(ts_hi.materials, "cpu")
    camera = ts_hi.camera if cam is None else ts_hi.camera._replace(position=cam)
    with torch.no_grad():
        rays = generate_rays(camera, cfg, bounce_key(prng_key(0), 1, 0), cfg.effective_depth,
                             "cpu")
        if not with_mesh:
            return tint.trace_rays(rays, ts_hi.geoms, mats, None, cfg, prng_key(0), 1)
        mesh_t = ts_hi.mesh._replace(v0=verts[f[:, 0]], v1=verts[f[:, 1]], v2=verts[f[:, 2]])
        return tint.trace_rays(rays, ts_hi.geoms, mats, mesh_t, cfg, prng_key(0), 1,
                               kd=teg.retris(ts_hi.kd, verts, f))


@pytest.mark.parametrize("wrt", ["vertex", "camera"])
def test_render_geo_boundary_grad_matches_fd(wrt):
    """tests/test_edgegrad.py's test_boundary_grad_matches_fd on the port:
    the occluder at 32x32, depth 1, 64 samples an edge, against finite
    differences of a render supersampled 8 x 8. Vertex: the mean loss, the
    two largest components within 0.25. Camera: the ramp-weighted loss,
    its x translation within 0.3, with the mesh-free scene's interior
    camera gradient subtracted (the FD differences the render against the
    same render without the occluder, whose analytic silhouettes the mesh
    estimator does not sample)."""
    cfg = TCfg(trace_depth=1, antialias=False)
    ts, verts, faces, cam, rg = _render_geo(_occluder_scene, FD_RES, cfg, samples_per_edge=64)
    hi = _scenes(_occluder_scene, FD_RES * SS)[1]
    if wrt == "vertex":
        gv, _ = _grads(rg, verts, cam, torch.ones((1, 1)))
        assert torch.isfinite(gv).all() and gv.abs().max() > 0
        eps = 0.08
        for idx in np.argsort(np.abs(gv.numpy()).ravel())[-2:]:
            i, c = divmod(int(idx), 3)
            e = torch.zeros_like(verts)
            e[i, c] = eps
            fd = (_fd_render(hi, cfg, verts + e, faces).mean().item()
                  - _fd_render(hi, cfg, verts - e, faces).mean().item()) / (2 * eps)
            ad = gv[i, c].item()
            assert abs(fd - ad) <= 0.25 * max(abs(fd), abs(ad)), f"vertex[{i},{c}]: {fd} {ad}"
        return
    _, gc = _grads(rg, verts, cam, torch.from_numpy(_ramp(FD_RES)))
    # the mesh-free scene's interior camera gradient under the same loss
    c = cam.clone().requires_grad_(True)
    plain = ts.camera._replace(position=c)
    rays = generate_rays(plain, cfg, bounce_key(prng_key(0), 1, 0), cfg.effective_depth, "cpu")
    img0 = tint.trace_rays(rays, ts.geoms, materials_to_torch(ts.materials, "cpu"), None, cfg,
                           prng_key(0), 1)
    loss0 = torch.mean(img0 * torch.from_numpy(_ramp(FD_RES)))
    if loss0.requires_grad:  # at depth 1 the radiance does not move with the eye
        gc = gc - torch.autograd.grad(loss0, c)[0]
    ramp_hi = torch.from_numpy(_ramp(FD_RES, SS))
    eps, k = 0.16, 0
    vals = []
    for sgn in (1.0, -1.0):
        p = cam.clone()
        p[k] += sgn * eps
        vals.append(torch.mean((_fd_render(hi, cfg, verts, faces, cam=p)
                                - _fd_render(hi, cfg, verts, faces, cam=p, with_mesh=False))
                               * ramp_hi).item())
    fd = (vals[0] - vals[1]) / (2 * eps)
    ad = gc[k].item()
    assert abs(ad) > 1e-5, f"camera boundary gradient ~0: {gc}"
    assert abs(fd - ad) <= 0.3 * max(abs(fd), abs(ad)), f"cam[{k}]: fd={fd} ad={ad}"


def test_render_geo_secondary_shadow_grad_matches_fd():
    """tests/test_edgegrad.py's test_secondary_boundary_shadow_grad on the
    port: the shadow scene at 32x32, depth 2, 16 samples an edge, a loss on
    the floor rows only. The primary-only estimator gives under a quarter
    of the finite difference at vertex 0, x; with the secondary term from
    every pixel the gradient has the finite difference's sign and lies
    within 0.45 of it."""
    cfg = TCfg(trace_depth=2, antialias=False)
    _, verts, faces, cam, rg0 = _render_geo(_shadow_scene, FD_RES, cfg, samples_per_edge=16)
    _, _, _, _, rg1 = _render_geo(_shadow_scene, FD_RES, cfg, samples_per_edge=16,
                                  secondary_viewpoints=FD_RES * FD_RES)
    mask = torch.from_numpy(_floor_mask(FD_RES))
    g = []
    for rg in (rg0, rg1):
        v = verts.clone().requires_grad_(True)
        (gv,) = torch.autograd.grad(torch.sum(rg(v, cam, prng_key(0), 1) * mask) / mask.sum(), v)
        assert torch.isfinite(gv).all()
        g.append(gv)
    hi = _scenes(_shadow_scene, FD_RES * SS)[1]
    mask_hi = torch.from_numpy(_floor_mask(FD_RES, SS))
    i, c, eps = 0, 0, 0.15
    e = torch.zeros_like(verts)
    e[i, c] = eps
    fd = (torch.sum(_fd_render(hi, cfg, verts + e, faces) * mask_hi).item()
          - torch.sum(_fd_render(hi, cfg, verts - e, faces) * mask_hi).item()) / (
        2 * eps * mask_hi.sum().item())
    assert abs(fd) > 1e-4, f"shadow FD unexpectedly tiny: {fd}"
    assert abs(g[0][i, c].item()) < 0.25 * abs(fd)
    ad = g[1][i, c].item()
    assert np.sign(ad) == np.sign(fd), f"sign mismatch: ad={ad} fd={fd}"
    assert abs(fd - ad) <= 0.45 * max(abs(fd), abs(ad)), f"vertex[{i},{c}]: fd={fd} ad={ad}"


# --------------------------------------------------------------------------
# tests/test_grad.py's test_mesh_vertex_grad on the KD route
# --------------------------------------------------------------------------


def _kd_with_v0(kd, v0):
    """``kd`` with its leaf triangles' v0 table replaced and its [T', 19]
    record rebuilt, where gradients enter the hit expansion."""
    tris = kd.tris._replace(v0=v0)
    return kd._replace(tris=tris, packed=pack_tris(tris))


def test_kd_vertex_grad(refs):
    """icosphere(1) in Cornell, 16x16, depth 2, the KD walk: (a) the
    radiance MSE's gradient with respect to the KD table's v0 is finite
    (zero is right: Lambertian radiance is piecewise constant in the
    geometry); (b) the depth AOV of the lanes that hit the most-hit
    triangle has a non-zero gradient, within rtol 1e-4 of JAX's and, on
    two of its three largest components, within 1e-1 of finite
    differences (eps 1e-3)."""
    p = refs.kd
    ts, cfg = p.scene, p.cfg
    assert tint.mesh_route(ts.mesh, ts.cmesh, cfg, ts.kd) == "kd"
    mats = materials_to_torch(ts.materials, "cpu")
    v0 = ts.kd.tris.v0.clone().requires_grad_(True)
    radiance = tint.trace_iteration(ts.geoms, mats, ts.mesh, ts.camera, cfg, prng_key(0), 1,
                                    device="cpu", kd=_kd_with_v0(ts.kd, v0))
    loss = torch.mean(radiance ** 2)
    # no graph reaches v0 where the radiance does not move with it: zero
    g = torch.autograd.grad(loss, v0)[0] if loss.requires_grad else torch.zeros_like(v0)
    assert torch.isfinite(g).all()

    def depth_loss(v0):
        hit = tint.intersect_scene(p.origin, p.direction, ts.geoms, ts.mesh, cfg,
                                   kd=_kd_with_v0(ts.kd, v0))
        return torch.where(p.lane_mask & (hit.t < BIG), hit.t, 0.0).sum()

    (gd,) = torch.autograd.grad(depth_loss(v0), v0)
    assert torch.isfinite(gd).all() and gd.abs().max() > 0
    _close(gd, refs.res["kd_depth"])
    agree = 0
    results = []
    for idx in gd.abs().flatten().argsort()[-3:].tolist():
        i, c = divmod(idx, 3)
        e = torch.zeros_like(v0)
        e[i, c] = 1e-3
        with torch.no_grad():
            fd = (depth_loss(v0 + e) - depth_loss(v0 - e)).item() / 2e-3
        ad = gd[i, c].item()
        results.append((fd, ad))
        agree += abs(fd - ad) <= 1e-1 * max(abs(fd), abs(ad), 1e-3)
    assert agree >= 2, f"FD/AD disagree: {results}"
