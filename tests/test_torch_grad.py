"""Gradients of the port against the JAX package on the CPU.

The same scene tables (carried across with ``scene_from_numpy``), keys and
targets go through ``jax.grad`` of the JAX package and through the port's
autograd. Each JAX reference is computed once per module. Tolerances, and
why:

- kernel 4's plain version against the VJP of the TPU composition: the
  same sums in another order, rtol 1e-6;
- material and camera gradients and losses: rtol 1e-5 of each entry and
  of the field's largest entry (measured: 1e-7 and less). The JAX
  references run under ``jit``, whose CPU compiler fuses multiply-adds
  where the port rounds each product, and sums in its own order;
- the vertex depth AOV: rtol 1e-4 (measured 1.1e-5): t is a quotient of
  three-term cross and dot products of the gathered vertices, which the
  fusion rounds differently;
- the optimizer: torch's Adam divides by the bias corrections in another
  order than optax's: rtol 1e-5 after 3 steps (measured 1.8e-6);
- the finite-difference checks keep the JAX package's own bounds
  (tests/test_grad.py).
"""

import functools
import os
import multiprocessing
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kdtreepathtraceroptimization_tpu.config import RenderConfig as JCfg
from kdtreepathtraceroptimization_tpu.models import inverse as jinv
from kdtreepathtraceroptimization_tpu.ops import camera as jcam
from kdtreepathtraceroptimization_tpu.ops import mesh as jmesh
from kdtreepathtraceroptimization_tpu.ops.intersect import BIG as JBIG
from kdtreepathtraceroptimization_tpu.render import integrator as jint
from kdtreepathtraceroptimization_tpu.scene import parser as jparser
from kdtreepathtraceroptimization_tpu_torch import make_train_step, render_loss
from kdtreepathtraceroptimization_tpu_torch.config import RenderConfig as TCfg
from kdtreepathtraceroptimization_tpu_torch.convert import (
    materials_to_numpy,
    materials_to_torch,
    scene_from_numpy,
    with_tris,
)
from kdtreepathtraceroptimization_tpu_torch.ops import camera as tcam
from kdtreepathtraceroptimization_tpu_torch.ops import mesh as tmesh
from kdtreepathtraceroptimization_tpu_torch.ops import pairs as tpairs
from kdtreepathtraceroptimization_tpu_torch.ops.intersect import BIG
from kdtreepathtraceroptimization_tpu_torch.ops.rng import bounce_key, prng_key
from kdtreepathtraceroptimization_tpu_torch.ops.vecmath import v3_to_rows
from kdtreepathtraceroptimization_tpu_torch.render import integrator as tint
from kdtreepathtraceroptimization_tpu_torch.scene import parser as tparser
from kdtreepathtraceroptimization_tpu_torch.utils.procmesh import icosphere, write_obj
from tests.test_grad import CAMERA_SSS_SCENE

CORNELL = os.path.join(os.path.dirname(__file__), "..", "scenes", "cornell.txt")
PAIRS = dict(cluster=True, cluster_pairs=True)
TRI_FIELDS = ("v0", "v1", "v2", "n0", "n1", "n2")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _grads_close(got, want, rtol):
    """Each field's gradient within ``rtol`` of each entry and of the
    field's largest entry; a field the port's graph never reaches (None)
    must have an all-zero JAX gradient."""
    for name, g, w in zip(want._fields, got, want):
        w = np.asarray(w)
        if g is None:
            assert not np.any(w), name
            continue
        np.testing.assert_allclose(g.numpy(), w, rtol=rtol,
                                   atol=rtol * max(np.abs(w).max(), 1e-30), err_msg=name)


def _port_grads(loss, params):
    return torch.autograd.grad(loss, list(params), allow_unused=True)


# --------------------------------------------------------------------------
# (a) kernel 4's plain version against the TPU composition's VJP
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n, nt, seed", [(5000, 300, 0), (4096, 7, 1), (1, 3, 3)])
def test_scatter_cols_ref_matches_pallas_vjp(monkeypatch, n, nt, seed):
    """``_scatter_cols_ref`` against ``jax.vjp`` of ``_transpose_rows(packed
    [tri])``, the TPU kernels 3 and 4 in interpret mode: repeated and
    out-of-order ids, n on and off the 4096-lane tile."""
    from jax.experimental import pallas as pl

    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    rng = np.random.default_rng(seed)
    packed = rng.normal(size=(nt, 19)).astype(np.float32)
    tri = rng.integers(0, nt, n).astype(np.int32)
    ct = rng.normal(size=(19, n)).astype(np.float32)
    ct[:, rng.uniform(size=n) < 0.3] = 0.0  # lanes with a zero cotangent (misses)
    cols, vjp = jax.vjp(lambda p: jmesh._transpose_rows(p[jnp.asarray(tri)]), jnp.asarray(packed))
    np.testing.assert_array_equal(np.asarray(cols), packed[tri].T)
    (want,) = vjp(jnp.asarray(ct))
    got = tmesh.scatter_cols(torch.from_numpy(ct), torch.from_numpy(tri), nt)
    assert got.shape == (nt, 19)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_gather_cols_backward_is_scatter_cols():
    """The autograd function's backward is the scatter-add, in float64."""
    g = torch.Generator().manual_seed(0)
    packed = torch.randn((12, 19), generator=g, dtype=torch.float64, requires_grad=True)
    tri = torch.randint(0, 12, (40,), generator=g, dtype=torch.int32)
    assert torch.autograd.gradcheck(lambda p: tmesh.gather_cols(p, tri), (packed,))
    ct = torch.randn((19, 40), generator=g, dtype=torch.float64)
    (grad,) = torch.autograd.grad(tmesh.gather_cols(packed, tri), packed, ct)
    torch.testing.assert_close(grad, tmesh._scatter_cols_ref(ct, tri, 12), rtol=0, atol=0)


def test_scatter_cols_refuses_other_devices():
    with pytest.raises(ValueError):
        tmesh.scatter_cols(torch.zeros((19, 4), device="meta"),
                           torch.zeros(4, dtype=torch.int32, device="meta"), 3)


# --------------------------------------------------------------------------
# The JAX references. Tracing them is Python and takes most of their cost,
# so the two largest run in two spawned processes while this one traces
# the rest; each process compiles its share in parallel threads (XLA's
# compiles release the GIL).
# --------------------------------------------------------------------------


def _jax_refs(names, inp):
    """The named JAX references for the inputs ``inp``, as numpy."""
    key = jax.random.PRNGKey(0)
    one = jnp.int32(1)
    jobs = {}
    if "c24" in names:  # (b) Cornell, 24x24, depth 3, zero target
        jc24 = jparser.with_resolution(jparser.load_scene(CORNELL), 24, 24)
        cfg_b = JCfg(trace_depth=3, antialias=False)
        jobs["c24"] = (jax.value_and_grad(lambda m: jinv.render_loss(
            m, jc24, cfg_b, key, one, jnp.zeros((576, 3), jnp.float32))),
            (jax.tree.map(jnp.asarray, jc24.materials),))
    if "p16" in names or "depth" in names:  # (c) the pair scene
        jp = jparser.with_resolution(jparser.load_scene(CORNELL, obj_path=inp["obj"]), 16, 16)
        jcfg = JCfg(**inp["pair_cfg"])
        jobs["p16"] = (jax.value_and_grad(lambda m: jinv.render_loss(
            m, jp, jcfg, key, one, jnp.zeros((256, 3), jnp.float32))),
            (jax.tree.map(jnp.asarray, jp.materials),))

        def depth_loss(v0):
            cmesh = jp.cmesh._replace(tris=jp.cmesh.tris._replace(v0=v0))
            hit = jint.intersect_scene(jnp.asarray(inp["origin"]), jnp.asarray(inp["direction"]),
                                       jp.geoms, jp.materials, jp.mesh, jp.kd, jcfg, cmesh=cmesh)
            return jnp.sum(jnp.where(jnp.asarray(inp["lane_mask"]) & (hit.t < JBIG), hit.t, 0.0))

        jobs["depth"] = (jax.grad(depth_loss), (jnp.asarray(jp.cmesh.tris.v0),))
    if "cam" in names:  # (d) the camera of CAMERA_SSS_SCENE, 16x16, depth 4
        js = jparser.parse_scene_text(CAMERA_SSS_SCENE)
        cfg_d = JCfg(trace_depth=4, enable_sss=True)

        def camera_loss(params):
            eye, fovy = params
            cam = jcam.derive_camera(js.camera.resolution, fovy, eye, js.camera.look_at,
                                     jnp.asarray([0.0, 1.0, 0.0]))
            radiance = jint.trace_iteration(js.geoms, js.materials, None, None, cam, cfg_d,
                                            key, one)
            return jnp.sum(radiance * jnp.asarray(inp["mask"])) / radiance.shape[0]

        jobs["cam"] = (jax.value_and_grad(camera_loss),
                       ((jnp.asarray([0.0, 0.0, 2.3]), jnp.asarray(45.0)),))
    if "train" in names:  # (e) three optax steps from halved colours
        jc16 = jparser.with_resolution(jparser.load_scene(CORNELL), 16, 16)
        perturbed = jc16._replace(materials=jc16.materials._replace(
            color=np.asarray(jc16.materials.color) * 0.5))
        init_state, train_step = jinv.make_train_step(
            perturbed, JCfg(**inp["train_cfg"]), jnp.asarray(inp["target"]), learning_rate=2e-2)
        state = init_state()
        jobs["train"] = (train_step, (state, key, one))
    jobs = {k: v for k, v in jobs.items() if k in names}
    lowered = {k: jax.jit(f).lower(*a) for k, (f, a) in jobs.items()}
    with ThreadPoolExecutor(len(lowered)) as pool:
        fns = {k: pool.submit(lo.compile) for k, lo in lowered.items()}
        fns = {k: f.result() for k, f in fns.items()}
    out = {k: _np(fns[k](*args)) for k, (_, args) in jobs.items() if k != "train"}
    if "train" in jobs:
        losses = []
        for _ in range(3):
            state, loss = fns["train"](state, key, one)
            losses.append(float(loss))
        out["train"] = (losses, _np(state.materials))
    return out


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    out = SimpleNamespace()
    c24 = jparser.with_resolution(jparser.load_scene(CORNELL), 24, 24)
    out.c24 = SimpleNamespace(tscene=scene_from_numpy(_np(c24), "cpu"),
                              cfg=TCfg(trace_depth=3, antialias=False))

    # (c) test_grad.py's test_pairs_vertex_and_material_grad scene:
    # icosphere(2) in Cornell, 16x16, depth 2, the pair list. The port's
    # camera rays and winners (equal to the JAX package's,
    # tests/test_torch_pairs.py) pick the lanes that hit the most-hit
    # triangle for the depth AOV.
    obj = str(tmp_path_factory.mktemp("pairs16") / "ico2.obj")
    write_obj(obj, *icosphere(2, radius=2.0, center=(0.0, 3.0, 0.0)))
    tp = tparser.with_resolution(tparser.load_scene(CORNELL, obj_path=obj, device="cpu"), 16, 16)
    pair_cfg = dict(trace_depth=2, **PAIRS)
    rays = tcam.generate_rays(tp.camera, TCfg(**pair_cfg), bounce_key(prng_key(0), 1, 0), 1,
                              "cpu")
    o, d = (v3_to_rows(v).numpy() for v in (rays.origin, rays.direction))
    win = tpairs.intersect_mesh_pairs(torch.from_numpy(o), torch.from_numpy(d), tp.cmesh,
                                      TCfg(**pair_cfg)).tri.numpy()
    rows, counts = np.unique(win[win >= 0], return_counts=True)
    lane_mask = win == int(rows[np.argmax(counts)])
    out.p16 = SimpleNamespace(tscene=tp, cfg=pair_cfg, lane_mask=torch.from_numpy(lane_mask),
                              origin=o, direction=d)

    # (d) the inner 8x8 pixels of CAMERA_SSS_SCENE: the FD of the whole
    # image is dominated by silhouette pixels (test_grad.py:385-391)
    js = tparser.parse_scene_text(CAMERA_SSS_SCENE)
    xs = np.arange(16)
    inner = (np.abs(xs - 7.5)[None, :] <= 3.5) & (np.abs(xs - 7.5)[:, None] <= 3.5)
    mask = inner.reshape(-1).astype(np.float32)[:, None]
    out.cam = SimpleNamespace(tscene=scene_from_numpy(js, "cpu"),
                              cfg=TCfg(trace_depth=4, enable_sss=True),
                              mask=torch.from_numpy(mask))

    # (e) the target is the port's render of the true materials
    train_cfg = dict(trace_depth=2, antialias=False)
    c16 = tparser.with_resolution(tparser.load_scene(CORNELL, device="cpu"), 16, 16)
    with torch.no_grad():
        target = tint.trace_iteration(c16.geoms, c16.materials, None, c16.camera,
                                      TCfg(**train_cfg), prng_key(0), 1, device="cpu").numpy()
    perturbed = c16._replace(materials=c16.materials._replace(
        color=np.asarray(c16.materials.color) * 0.5))
    out.train = SimpleNamespace(scene=perturbed, cfg=TCfg(**train_cfg), target=target)

    inp = dict(obj=obj, pair_cfg=pair_cfg, origin=o, direction=d, lane_mask=lane_mask,
               mask=mask, train_cfg=train_cfg, target=target)
    with ProcessPoolExecutor(2, mp_context=multiprocessing.get_context("spawn")) as pool:
        far = [pool.submit(_jax_refs, (name,), inp) for name in ("p16", "train")]
        res = _jax_refs(("c24", "cam", "depth"), inp)
        for f in far:
            res.update(f.result())
    out.c24.loss, out.c24.grads = float(res["c24"][0]), res["c24"][1]
    out.p16.loss, out.p16.g_mat = float(res["p16"][0]), res["p16"][1]
    out.p16.g_depth = res["depth"]
    out.cam.loss, (out.cam.g_eye, out.cam.g_fov) = float(res["cam"][0]), res["cam"][1]
    out.train.losses, out.train.materials = res["train"]
    return out


# --------------------------------------------------------------------------
# (b) material and emittance gradients on Cornell, 24x24, depth 3
# --------------------------------------------------------------------------


def _cornell_loss(c, materials):
    return render_loss(materials, c.tscene, c.cfg, prng_key(0), 1, torch.zeros((576, 3)))


def test_material_grads_match_jax(refs):
    c = refs.c24
    mats = materials_to_torch(c.tscene.materials, "cpu", requires_grad=True)
    loss = _cornell_loss(c, mats)
    assert loss.item() == pytest.approx(c.loss, rel=1e-6)
    grads = _port_grads(loss, mats)
    assert grads[0].abs().max() > 0 and grads[6].abs().max() > 0  # color, emittance
    _grads_close(grads, c.grads, rtol=1e-5)


def test_material_grads_match_finite_differences(refs):
    """tests/test_grad.py:20-73 in the port: the four largest colour
    entries (eps 3e-3) and the light's emittance (eps 1e-2), within 2e-2."""
    c = refs.c24
    mats = materials_to_torch(c.tscene.materials, "cpu", requires_grad=True)
    g_color, g_em = _port_grads(_cornell_loss(c, mats), [mats.color, mats.emittance])

    def loss_at(field, idx, eps):
        m = materials_to_torch(c.tscene.materials, "cpu")
        getattr(m, field)[idx] += eps
        with torch.no_grad():
            return _cornell_loss(c, m).item()

    checks = [("color", divmod(int(i), 3), 3e-3, g_color)
              for i in np.argsort(np.abs(g_color.numpy()).ravel())[-4:]]
    checks.append(("emittance", 0, 1e-2, g_em))
    for field, idx, eps, g in checks:
        fd = (loss_at(field, idx, eps) - loss_at(field, idx, -eps)) / (2 * eps)
        ad = float(g[idx])
        assert abs(fd - ad) <= 2e-2 * max(abs(fd), abs(ad), 1e-3), (field, idx, fd, ad)


# --------------------------------------------------------------------------
# (c) the pair path: materials and the vertex depth AOV
# --------------------------------------------------------------------------


def _pair_loss(p, sss: bool = False):
    """The port's render MSE through the pair path, with its materials and
    the cluster table's vertex and normal tables as leaves; ``sss`` makes
    the mesh's material (row 6, the OBJ default) subsurface."""
    tscene = p.tscene
    mats = materials_to_torch(tscene.materials, "cpu", requires_grad=True)
    if sss:
        with torch.no_grad():
            mats.transmittance[6] = torch.tensor([0.9, 0.7, 0.5])
    tris = tscene.cmesh.tris._replace(**{
        f: getattr(tscene.cmesh.tris, f).clone().requires_grad_(True) for f in TRI_FIELDS})
    scene = tscene._replace(cmesh=with_tris(tscene.cmesh, tris))
    cfg = TCfg(enable_sss=sss, **p.cfg)
    loss = render_loss(mats, scene, cfg, prng_key(0), 1, torch.zeros((256, 3)))
    return loss, mats, [getattr(tris, f) for f in TRI_FIELDS]


def _scatter_calls():
    """Wrap ``ops.mesh.scatter_cols``; returns (calls list, restore)."""
    calls, real = [], tmesh.scatter_cols

    def wrapped(ct, tri, nt):
        calls.append(int((ct != 0).any(dim=0).sum()))
        return real(ct, tri, nt)

    tmesh.scatter_cols = wrapped
    return calls, lambda: setattr(tmesh, "scatter_cols", real)


def test_pairs_material_grads_match_jax(refs):
    """Without subsurface scattering the radiance is piecewise constant in
    the geometry: the port's graph never reaches the triangle tables (the
    JAX package's gradient is zero there, tests/test_grad.py:101-140), and
    the scatter-add is never called."""
    p = refs.p16
    calls, restore = _scatter_calls()
    try:
        loss, mats, tris = _pair_loss(p)
        grads = _port_grads(loss, list(mats) + tris)
    finally:
        restore()
    assert loss.item() == pytest.approx(p.loss, rel=1e-6)
    assert grads[0].abs().max() > 0
    _grads_close(grads[:8], p.g_mat, rtol=1e-5)
    assert all(g is None for g in grads[8:]) and not calls


def test_subsurface_radiance_reaches_the_triangle_tables(refs):
    """With the mesh subsurface, shade reads each bounce's hit distance at
    the next bounce: the reverse pass calls the scatter-add once for every
    bounce but the last, and every table gets a finite gradient."""
    calls, restore = _scatter_calls()
    try:
        loss, mats, tris = _pair_loss(refs.p16, sss=True)
        grads = _port_grads(loss, tris)
    finally:
        restore()
    assert len(calls) == refs.p16.cfg["trace_depth"] - 1
    assert all(g is not None and torch.isfinite(g).all() for g in grads)


def _depth_loss(p, v0):
    cm = with_tris(p.tscene.cmesh, p.tscene.cmesh.tris._replace(v0=v0))
    hit = tint.intersect_scene(torch.from_numpy(p.origin), torch.from_numpy(p.direction),
                               p.tscene.geoms, p.tscene.mesh, TCfg(**p.cfg), cmesh=cm)
    return torch.where(p.lane_mask & (hit.t < BIG), hit.t, 0.0).sum()


def test_pairs_vertex_depth_grad_matches_jax_and_finite_differences(refs):
    """The depth-AOV check of tests/test_grad.py:275-310: the winner is
    detached, t re-evaluates against the gathered row, so d(depth)/d(v0)
    is exact for interior hits; against JAX and central differences."""
    p = refs.p16
    v0 = p.tscene.cmesh.tris.v0.clone().requires_grad_(True)
    (gd,) = torch.autograd.grad(_depth_loss(p, v0), v0)
    want = p.g_depth
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(gd.numpy(), want, rtol=1e-4, atol=1e-4 * np.abs(want).max())
    agree = 0
    for idx in np.argsort(np.abs(gd.numpy()).ravel())[-3:]:
        i, c = divmod(int(idx), 3)
        e = torch.zeros_like(v0)
        e[i, c] = 1e-3
        with torch.no_grad():
            fd = (_depth_loss(p, v0 + e) - _depth_loss(p, v0 - e)).item() / 2e-3
        ad = float(gd[i, c])
        agree += abs(fd - ad) <= 1e-1 * max(abs(fd), abs(ad), 1e-3)
    assert agree >= 2


# --------------------------------------------------------------------------
# (d) the camera
# --------------------------------------------------------------------------


def _camera_loss(c, eye, fovy):
    cam = tcam.derive_camera(c.tscene.camera.resolution, fovy, eye, c.tscene.camera.look_at,
                             [0.0, 1.0, 0.0], device="cpu")
    radiance = tint.trace_iteration(c.tscene.geoms, c.tscene.materials, None, cam, c.cfg,
                                    prng_key(0), 1, device="cpu")
    return torch.sum(radiance * c.mask) / radiance.shape[0]


def test_camera_grad_matches_jax_and_finite_differences(refs):
    """tests/test_grad.py:359-419: the eye and fov reach the image through
    the subsurface depth; AD against JAX and against central differences
    on eye z and fov (bound 0.15, the JAX test's)."""
    c = refs.cam
    eye = torch.tensor([0.0, 0.0, 2.3], requires_grad=True)
    fovy = torch.tensor(45.0, requires_grad=True)
    loss = _camera_loss(c, eye, fovy)
    assert loss.item() == pytest.approx(c.loss, rel=1e-5)
    g_eye, g_fov = torch.autograd.grad(loss, [eye, fovy])
    assert np.abs(c.g_eye).max() > 0
    np.testing.assert_allclose(g_eye.numpy(), c.g_eye, rtol=1e-5,
                               atol=1e-5 * np.abs(c.g_eye).max())
    assert float(g_fov) == pytest.approx(float(c.g_fov), rel=1e-5)
    with torch.no_grad():
        dz = torch.tensor([0.0, 0.0, 1e-2])
        fd_z = (_camera_loss(c, eye + dz, fovy) - _camera_loss(c, eye - dz, fovy)).item() / 2e-2
        fd_f = (_camera_loss(c, eye, fovy + 1e-2)
                - _camera_loss(c, eye, fovy - 1e-2)).item() / 2e-2
    for fd, ad in ((fd_z, float(g_eye[2])), (fd_f, float(g_fov))):
        assert abs(fd - ad) <= 0.15 * max(abs(fd), abs(ad), 1e-4), (fd, ad)


@pytest.mark.parametrize("move", ["orbit", "zoom", "pan", "look_from"])
def test_camera_controls_match_jax(move):
    jc = jparser.parse_scene_text(CAMERA_SSS_SCENE).camera
    tc = tparser.parse_scene_text(CAMERA_SSS_SCENE).camera
    calls = {
        "orbit": (lambda m, c, **k: m.orbit_camera(c, d_phi=0.7, d_theta=0.2, **k)),
        "zoom": (lambda m, c, **k: m.orbit_camera(c, d_zoom=-2.0, **k)),
        "pan": (lambda m, c, **k: m.pan_camera(c, dx=1.0, dy=-0.5, **k)),
        "look_from": (lambda m, c, **k: m.look_from(c, [3.0, 3.0, 3.0], **k)),
    }
    want = calls[move](jcam, jc)
    got = calls[move](tcam, tc, device="cpu")
    for name, g, w in zip(want._fields, got, want):
        g = g.detach().numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-6, atol=1e-6, err_msg=name)


def test_derive_camera_matches_the_parser():
    """derive_camera of the parsed camera's own inputs gives its basis."""
    tc = tparser.parse_scene_text(CAMERA_SSS_SCENE).camera
    got = tcam.derive_camera(tc.resolution, tc.fov[1], tc.position, tc.look_at, [0, 1, 0],
                             device="cpu")
    for name in ("view", "up", "right", "fov", "pixel_length"):
        np.testing.assert_allclose(getattr(got, name).numpy(), getattr(tc, name),
                                   rtol=1e-6, atol=1e-7, err_msg=name)


# --------------------------------------------------------------------------
# (e) the training step
# --------------------------------------------------------------------------


def _port_steps(t, steps):
    init_state, train_step = make_train_step(t.scene, t.cfg, t.target, learning_rate=2e-2,
                                             device="cpu")
    state = init_state()
    losses = []
    for _ in range(steps):
        state, loss = train_step(state, prng_key(0), 1)
        losses.append(loss.item())
    return state, losses


def test_train_steps_match_optax(refs):
    t = refs.train
    state, losses = _port_steps(t, 3)
    assert state.step == 3
    np.testing.assert_allclose(losses, t.losses, rtol=1e-5)
    got = materials_to_numpy(state.materials)
    for name, g, w in zip(got._fields, got, t.materials):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-7, err_msg=name)


def test_train_step_reduces_loss(refs):
    """tests/test_grad.py:76-97: 12 steps halve the loss, within the clamps."""
    state, losses = _port_steps(refs.train, 12)
    assert losses[-1] < losses[0] * 0.5, losses
    m = state.materials
    assert (m.color >= 0).all() and (m.color <= 1).all() and (m.emittance >= 0).all()


# --------------------------------------------------------------------------
# (f) tensors in, the same image out
# --------------------------------------------------------------------------


def test_tensor_materials_and_camera_render_bit_equal(tmp_path):
    """Materials and camera as tensors that require grad give the numpy
    path's radiance bit for bit (the same selects and products)."""
    obj = str(tmp_path / "ico1.obj")
    write_obj(obj, *icosphere(1, radius=2.0, center=(0.0, 3.0, 0.0)))
    scene = tparser.with_resolution(tparser.load_scene(CORNELL, obj_path=obj, device="cpu"),
                                    24, 24)
    cfg = TCfg(trace_depth=4, antialias=True, cluster_tile=64, **PAIRS)

    def radiance(materials, camera):
        return tint.trace_iteration(scene.geoms, materials, scene.mesh, camera, cfg,
                                    prng_key(3), 2, cmesh=scene.cmesh, device="cpu")

    with torch.no_grad():
        want = radiance(scene.materials, scene.camera)
    cam = scene.camera._replace(**{
        f: torch.tensor(getattr(scene.camera, f), requires_grad=True)
        for f in ("position", "view", "up", "right", "pixel_length")})
    got = radiance(materials_to_torch(scene.materials, "cpu", requires_grad=True), cam)
    assert got.requires_grad and want.mean() > 0
    assert torch.equal(got.detach(), want)
