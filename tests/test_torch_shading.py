"""The per-lane shading chain equals the JAX package's on camera rays.

Inputs come from one scene and numpy seeds and go through both packages.
The JAX functions run eagerly, op by op, as PyTorch does, so both apply
the same float32 operations in the same order. Integers and booleans are
compared exactly. Floats may differ where the two libraries round
differently: PyTorch's vectorized float32 sqrt on the CPU is not always
correctly rounded (1 ulp off for ~0.7% of inputs) and sin/cos/arccos are
other implementations; such 1-ulp differences then scale with the
magnitudes downstream (a point is origin + t * direction). So a float
passes within ``MAXULP`` units in the last place of max(|x|, 1), i.e.
within 1.9e-6 in a scene whose coordinates run to ~15 (measured: at most
15 such ulp). Depth of field gets ``DOF_MAXULP``: it rotates each ray by
sin/cos of a random angle and pivots it about a point 8 units away,
which multiplies the sin/cos differences (measured: at most 120).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kdtreepathtraceroptimization_tpu.config import RenderConfig as JCfg
from kdtreepathtraceroptimization_tpu.ops import bsdf as jbsdf
from kdtreepathtraceroptimization_tpu.ops import camera as jcamera
from kdtreepathtraceroptimization_tpu.ops import intersect as jisect
from kdtreepathtraceroptimization_tpu.ops import rng as jrng
from kdtreepathtraceroptimization_tpu.ops import sampling as jsampling
from kdtreepathtraceroptimization_tpu.ops import shade as jshade
from kdtreepathtraceroptimization_tpu.ops import vecmath as jvm
from kdtreepathtraceroptimization_tpu.scene import parser as jparser
from kdtreepathtraceroptimization_tpu_torch.config import RenderConfig as TCfg
from kdtreepathtraceroptimization_tpu_torch.ops import bsdf as tbsdf
from kdtreepathtraceroptimization_tpu_torch.ops import camera as tcamera
from kdtreepathtraceroptimization_tpu_torch.ops import intersect as tisect
from kdtreepathtraceroptimization_tpu_torch.ops import rng as trng
from kdtreepathtraceroptimization_tpu_torch.ops import sampling as tsampling
from kdtreepathtraceroptimization_tpu_torch.ops import shade as tshade
from kdtreepathtraceroptimization_tpu_torch.ops import vecmath as tvm
from kdtreepathtraceroptimization_tpu_torch.scene import parser as tparser
from kdtreepathtraceroptimization_tpu_torch.utils import trace

CORNELL = os.path.join(os.path.dirname(__file__), "..", "scenes", "cornell.txt")
MAXULP = 16
DOF_MAXULP = 256
RES = 48


def _t(a):
    return torch.from_numpy(np.array(a))


def _v3t(v):
    return tvm.V3(_t(v.x), _t(v.y), _t(v.z))


def _same(a, b, what, maxulp=MAXULP):
    """Exact for integers/bools, within ``maxulp`` for floats."""
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape, what
    if a.dtype.kind == "f":
        scale = np.spacing(np.maximum(np.abs(a), np.float32(1)))
        err = np.abs(a.astype(np.float64) - b) / scale
        assert err.max() <= maxulp, f"{what}: {err.max()} ulp"
    else:
        np.testing.assert_array_equal(a, b, err_msg=what)


def _same_v3(a, b, what, maxulp=MAXULP):
    for c in "xyz":
        _same(getattr(a, c), getattr(b, c), f"{what}.{c}", maxulp)


@pytest.fixture(scope="module")
def scenes():
    j = jparser.with_resolution(jparser.load_scene(CORNELL), RES, RES)
    t = tparser.with_resolution(tparser.load_scene(CORNELL, device="cpu"), RES, RES)
    return j, t


@pytest.mark.parametrize("aa, dof", [(False, 0.0), (True, 0.0), (True, 0.3)])
def test_generate_rays_match(scenes, aa, dof):
    js, ts = scenes
    kj = jrng.bounce_key(jax.random.PRNGKey(3), 2, 0)
    kt = trng.bounce_key(trng.prng_key(3), 2, 0)
    rj = jcamera.generate_rays(js.camera, JCfg(antialias=aa, dof_angle=dof), kj, 8)
    rt = tcamera.generate_rays(ts.camera, TCfg(antialias=aa, dof_angle=dof), kt, 8,
                               "cpu")
    maxulp = DOF_MAXULP if dof else MAXULP
    _same_v3(rj.origin, rt.origin, "origin", maxulp)
    _same_v3(rj.direction, rt.direction, "direction", maxulp)
    for f in ("is_inside", "sdepth", "pixel_index", "remaining_bounces"):
        _same(getattr(rj, f), getattr(rt, f), f)


def _camera_rays(js, ts):
    kj = jrng.bounce_key(jax.random.PRNGKey(0), 1, 0)
    kt = trng.bounce_key(trng.prng_key(0), 1, 0)
    cfg = dict(antialias=True)
    return (jcamera.generate_rays(js.camera, JCfg(**cfg), kj, 8),
            tcamera.generate_rays(ts.camera, TCfg(**cfg), kt, 8, "cpu"))


def _bounce_rays(n, seed):
    """Rays from inside the box in uniform random directions."""
    rng = np.random.default_rng(seed)
    o = rng.uniform([-4.5, 0.5, -4.5], [4.5, 9.5, 4.5], (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def test_intersect_geoms_match(scenes):
    js, ts = scenes
    rj, rt = _camera_rays(js, ts)
    o, d = _bounce_rays(4096, seed=1)
    for (oj, dj), (ot, dt) in (
        ((rj.origin, rj.direction), (rt.origin, rt.direction)),
        ((jnp.asarray(o), jnp.asarray(d)), (_t(o), _t(d))),
    ):
        hj = jisect.intersect_geoms(oj, dj, js.geoms)
        ht = tisect.intersect_geoms(ot, dt, ts.geoms)
        _same(hj.t, ht.t, "t")
        _same_v3(hj.point, ht.point, "point")
        _same_v3(hj.normal, ht.normal, "normal")
        _same(hj.material_id, ht.material_id, "material_id")
        _same(hj.outside, ht.outside, "outside")


def _traced_lanes(fn):
    """``fn()`` with tracing on; returns its result and the geom counters."""
    trace.reset()
    trace.enable(True)
    try:
        out = fn()
        return out, trace.counters()
    finally:
        trace.enable(False)
        trace.reset()


def _hits_equal(a, b):
    for f in ("t", "material_id", "outside"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    for f in ("point", "normal"):
        for c in "xyz":
            assert torch.equal(getattr(getattr(a, f), c), getattr(getattr(b, f), c)), f + c


def test_intersect_geoms_match_compares_the_plain_path(scenes):
    """On CPU tensors ``intersect_geoms`` is its plain version, so
    test_intersect_geoms_match holds the plain version against JAX."""
    _, ts = scenes
    rt = _camera_rays(*scenes)[1]
    o, d = _bounce_rays(4096, seed=1)
    for ot, dt in ((rt.origin, rt.direction), (_t(o), _t(d))):
        hit, lanes = _traced_lanes(lambda: tisect.intersect_geoms(ot, dt, ts.geoms))
        n = tvm.as_rows(ot).shape[0]
        assert lanes == {"geoms_plain_lanes": [n]}
        rows = (ot, dt) if isinstance(ot, tvm.V3) else (tvm.v3_from_rows(ot),
                                                         tvm.v3_from_rows(dt))
        _hits_equal(hit, tisect._intersect_geoms_plain(*rows, ts.geoms))


@pytest.mark.parametrize("grad_mode", [True, False])
def test_intersect_geoms_rays_with_grad_take_the_plain_path(scenes, grad_mode):
    """Rays that carry a gradient take the plain path, which autograd
    differentiates; under no_grad the same rays carry none."""
    _, ts = scenes
    o, d = _bounce_rays(512, seed=3)
    ot = _t(o).requires_grad_(True)
    with torch.set_grad_enabled(grad_mode):
        hit, lanes = _traced_lanes(lambda: tisect.intersect_geoms(ot, _t(d), ts.geoms))
    assert lanes == {"geoms_plain_lanes": [512]}
    assert hit.t.requires_grad == grad_mode
    if grad_mode:
        torch.where(hit.t < tisect.BIG, hit.t, 0.0).sum().backward()
        assert torch.isfinite(ot.grad).all() and ot.grad.abs().sum() > 0


@pytest.mark.parametrize("requires_grad, grad_mode, wants", [
    (True, True, True), (True, False, False), (False, True, False), (False, False, False)])
def test_kernel_dispatch_wants_grad(requires_grad, grad_mode, wants):
    """The kernel takes no call whose rays want a gradient, and no call on
    CPU tensors."""
    channels = [torch.zeros(8) for _ in range(6)]
    channels[4].requires_grad_(requires_grad)
    with torch.set_grad_enabled(grad_mode):
        assert tisect._wants_grad(channels) == wants
        assert not tisect._kernel_takes(channels)


@pytest.mark.parametrize("names", ["cornell.txt", "cornell_spheres.txt", "sphere.txt",
                                   "cornell2.txt+cornell4.txt", ""])
def test_geom_tables_hold_the_geoms(names):
    """The kernel's tables: MAX_GEOMS geoms a table, in scene order, the
    matrices' rows 0-2 as float32."""
    parts = [tparser.load_scene(os.path.join(os.path.dirname(CORNELL), f), device="cpu").geoms
             for f in names.split("+") if f]
    if parts:
        geoms = type(parts[0])(*(np.concatenate(a) for a in zip(*parts)))
    else:
        geoms = tparser.load_scene(CORNELL, device="cpu").geoms
        geoms = type(geoms)(*(a[:0] for a in geoms))
    tables = tisect.geom_tables(geoms)
    count = geoms.count
    assert len(tables) == max(1, -(-count // tisect.MAX_GEOMS))
    assert [t.count for t in tables][:-1] == [tisect.MAX_GEOMS] * (len(tables) - 1)
    assert sum(t.count for t in tables) == count
    lo = 0
    for t in tables:
        k = t.count
        assert list(t.type[:k]) == geoms.type[lo:lo + k].tolist()
        assert list(t.material[:k]) == geoms.material_id[lo:lo + k].tolist()
        for field, m, r, c in (("inv", geoms.inverse_transform, 3, 4),
                               ("fwd", geoms.transform, 3, 4),
                               ("inv_t", geoms.inv_transpose, 3, 3)):
            got = np.array(getattr(t, field)[:k * r * c], np.float32).reshape(k, r, c)
            np.testing.assert_array_equal(got, m[lo:lo + k, :r, :c], err_msg=field)
        lo += k


def test_geoms_hit_refuses_cpu_tensors(scenes):
    _, ts = scenes
    o, d = _bounce_rays(16, seed=4)
    with pytest.raises(ValueError):
        tisect.geoms_hit(tvm.v3_from_rows(_t(o)), tvm.v3_from_rows(_t(d)), ts.geoms)


@pytest.mark.parametrize("softness, inside_frac", [(0.0, 0.0), (0.5, 0.3)])
def test_scatter_and_shade_match(scenes, softness, inside_frac):
    """Every material class, fed the same hits and uniforms."""
    js, ts = scenes
    n = 4096
    o, d = _bounce_rays(n, seed=2)
    hj = jisect.intersect_geoms(jnp.asarray(o), jnp.asarray(d), js.geoms)
    rng = np.random.default_rng(5)
    # all scene materials, not only the ones the box's walls use
    mid = rng.integers(-1, js.materials.count, n).astype(np.int32)
    inside = rng.uniform(size=n) < inside_frac
    sdepth = rng.uniform(0, 1.5, n).astype(np.float32)
    color = rng.uniform(0, 1, (3, n)).astype(np.float32)
    bounces = rng.integers(0, 4, n).astype(np.int32)
    hit_t = np.where(mid >= 0, np.asarray(hj.t), 1e30).astype(np.float32)
    kj = jrng.bounce_key(jax.random.PRNGKey(1), 1, 2)
    kt = trng.bounce_key(trng.prng_key(1), 1, 2)
    uj = jrng.uniform_cols(kj, n, 8)
    ut = trng.uniform_cols(kt, n, 8, device="cpu")

    mj = jbsdf.gather_materials(js.materials, jnp.asarray(mid))
    mt = tbsdf.gather_materials(ts.materials, _t(mid))
    for f in mj._fields:
        a, b = getattr(mj, f), getattr(mt, f)
        if isinstance(a, jvm.V3):
            _same_v3(a, b, f)
        else:
            _same(a, b, f)

    oj, dj = jvm.v3_from_rows(jnp.asarray(o)), jvm.v3_from_rows(jnp.asarray(d))
    ot, dt = tvm.v3_from_rows(_t(o)), tvm.v3_from_rows(_t(d))
    sj = jbsdf.scatter(oj, dj, jnp.asarray(inside), hj.point, hj.normal, mj,
                       uj, softness)
    st = tbsdf.scatter(ot, dt, _t(inside), _v3t(hj.point), _v3t(hj.normal), mt,
                       ut, softness)
    _same_v3(sj.origin, st.origin, "origin")
    _same_v3(sj.direction, st.direction, "direction")
    _same(sj.is_inside, st.is_inside, "is_inside")
    _same(sj.sdepth, st.sdepth, "sdepth")

    for sss in (False, True):
        cj, bj = jshade.shade(jvm.V3(*map(jnp.asarray, color)),
                              jnp.asarray(bounces), jnp.asarray(hit_t), mj,
                              jnp.asarray(sdepth), sss)
        ct, bt = tshade.shade(tvm.V3(*map(_t, color)), _t(bounces), _t(hit_t),
                              mt, _t(sdepth), sss)
        _same_v3(cj, ct, "color")
        _same(bj, bt, "bounces")


@pytest.mark.parametrize("fn", ["clip", "maximum"])
def test_clamp_grads_at_ties_match_jax(fn):
    """vecmath.clip / vecmath.maximum against jnp.clip / jnp.maximum, at
    exact bounds, inside and outside: the same values, and the same
    gradient, exactly (half of it at a tie: jax.grad's rule, where
    torch.clamp passes all of it)."""
    x = np.array([-2.0, -1.0, -0.25, 0.0, 0.5, 1.0, 3.0], np.float32)
    if fn == "clip":
        jf, tf = (lambda v: jnp.clip(v, -1.0, 1.0)), (lambda v: tvm.clip(v, -1.0, 1.0))
    else:
        jf, tf = (lambda v: jnp.maximum(v, 0.0)), (lambda v: tvm.maximum(v, 0.0))
    w = np.arange(1, 8, dtype=np.float32)  # a weight per entry: a full vector-Jacobian product
    gj = np.asarray(jax.grad(lambda v: jnp.sum(jf(v) * w))(jnp.asarray(x)))
    xt = _t(x).requires_grad_(True)
    yt = tf(xt)
    (gt,) = torch.autograd.grad((yt * _t(w)).sum(), xt)
    np.testing.assert_array_equal(np.asarray(jf(jnp.asarray(x))), yt.detach().numpy())
    np.testing.assert_array_equal(gj, gt.numpy())
    assert 0.5 in (gt.numpy() / w)  # a tie took half


def test_fresnel_grad_at_a_clip_bound_matches_jax():
    """A differentiated site: the Schlick cosine of a ray leaving along
    the normal sits exactly at the clip's lower bound (-1); its gradients
    with respect to the incident direction and the normal equal
    jax.grad's."""
    inc = np.array([[0.0, 0.0, 1.0], [0.0, 0.6, -0.8]], np.float32)
    nrm = np.array([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0]], np.float32)

    def jloss(i, n):
        return jnp.sum(jsampling.schlick_fresnel_v(jvm.v3_from_rows(i), jvm.v3_from_rows(n), 1.5))

    gj = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(inc), jnp.asarray(nrm))
    it, nt = _t(inc).requires_grad_(True), _t(nrm).requires_grad_(True)
    loss = tsampling.schlick_fresnel_v(tvm.v3_from_rows(it), tvm.v3_from_rows(nt), 1.5).sum()
    gt = torch.autograd.grad(loss, (it, nt))
    for a, b in zip(gj, gt):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=1e-6, atol=0)
    assert gt[0][0, 2].item() != 0.0
