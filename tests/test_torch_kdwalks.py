"""The other KD walks against the JAX package and the brute force: the
thin-table skip-link, short-stack and push-down walks (``fat_rows=False``),
the fat-row short-stack walk and packets of 32.

The JAX package's tests/test_kdtree.py:82-215 and tests/test_mesh_render.py:
74-135 for the port. Inputs come from numpy seeds. Tolerances: source-mesh
triangle ids equal to the JAX walk's and the brute force's on every lane,
t within 1e-4 relative (the JAX package's KD bound: its KD tests hold the
walks to brute force at rtol 1e-4); renders of one walk against another
within atol 1e-3 a pixel (tests/test_mesh_render.py:92).
"""

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kdtreepathtraceroptimization_tpu.accel import kdtree as jkd
from kdtreepathtraceroptimization_tpu.config import RenderConfig as JCfg
from kdtreepathtraceroptimization_tpu.ops import traverse as jtrav
from kdtreepathtraceroptimization_tpu.scene import parser as jparser
from kdtreepathtraceroptimization_tpu_torch.accel import kdtree as tkd
from kdtreepathtraceroptimization_tpu_torch.config import RenderConfig as TCfg
from kdtreepathtraceroptimization_tpu_torch.convert import kd_to_device
from kdtreepathtraceroptimization_tpu_torch.ops import traverse as ttrav
from kdtreepathtraceroptimization_tpu_torch.ops.camera import generate_rays
from kdtreepathtraceroptimization_tpu_torch.ops.intersect import BIG
from kdtreepathtraceroptimization_tpu_torch.ops.mesh import intersect_mesh_brute
from kdtreepathtraceroptimization_tpu_torch.ops.rng import bounce_key, prng_key
from kdtreepathtraceroptimization_tpu_torch.render.integrator import render
from kdtreepathtraceroptimization_tpu_torch.scene import parser as tparser
from kdtreepathtraceroptimization_tpu_torch.scene.structs import MeshSoA
from tests.test_torch_kd import _source_ids
from tests.test_torch_render import CORNELL, _mesh_obj

T_RTOL = 1e-4
WALKS = {
    "skiplink": dict(fat_rows=False),
    "shortstack": dict(fat_rows=False, short_stack=True),
    "pushdown": dict(fat_rows=False, short_stack=True, push_down_restart=True),
    "fatrow_shortstack": dict(short_stack=True),
    "packet": dict(packet_size=32),
}
THIN = ("skiplink", "shortstack", "pushdown")


def _soup(rng, n, spread=4.0, size=0.6):
    c = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    return tuple(c + rng.uniform(-size, size, (n, 3)).astype(np.float32) for _ in range(3))


def _rays(rng, n, aim=2.0, spread=8.0):
    """Origins in a box around the soup, aimed at points near its middle
    (about a fifth of them hit)."""
    o = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    d = rng.uniform(-aim, aim, (n, 3)).astype(np.float32) - o
    return o, (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


def _brute(v, o, d, t_max=None):
    mesh = MeshSoA(*(torch.from_numpy(np.ascontiguousarray(a)) for a in v),
                   None, None, None, None, None, None, None)
    return intersect_mesh_brute(torch.from_numpy(o), torch.from_numpy(d), mesh, use_bbox=False,
                                t_max=None if t_max is None else torch.from_numpy(t_max))


def _walk(kd_np, o, d, walk, t_init=None, active=None, **cfg):
    """The port's walk -> (t, tri, stats), a miss as t = BIG."""
    hit, stats = ttrav.intersect_mesh_kd(
        torch.from_numpy(o), torch.from_numpy(d), kd_to_device(kd_np, "cpu"),
        TCfg(**WALKS[walk], **cfg), t_init=None if t_init is None else torch.from_numpy(t_init),
        active=None if active is None else torch.from_numpy(active), collect_stats=True)
    tri = hit.tri.numpy()
    return np.where(tri >= 0, hit.t.numpy(), BIG), tri, stats


def _jax_walk(v, kd_kw, o, d, walk, t_init=None, active=None, **cfg):
    kd = jkd.build_kdtree(*v, **kd_kw)
    hit = jtrav.intersect_mesh_kd(jnp.asarray(o), jnp.asarray(d), kd,
                                  JCfg(**WALKS[walk], **cfg),
                                  t_init=None if t_init is None else jnp.asarray(t_init),
                                  active=None if active is None else jnp.asarray(active))
    tri = np.asarray(hit.tri)
    return np.where(tri >= 0, np.asarray(hit.t), BIG), tri, kd


def _check(kd_np, got, want_src, want_t, label):
    """Source ids equal on every lane, t within T_RTOL where they hit."""
    gt, gtri = got[0], got[1]
    np.testing.assert_array_equal(_source_ids(kd_np, gtri), want_src, err_msg=label)
    hit = gtri >= 0
    np.testing.assert_allclose(gt[hit], want_t[hit], rtol=T_RTOL, err_msg=label)


@pytest.mark.parametrize("walk", list(WALKS))
def test_walk_matches_jax_and_brute(walk):
    """tests/test_kdtree.py:82 for every walk: a 300-triangle soup in
    leaves of 4, 1,024 rays, a t bound on a third of them, a fifth
    inactive (the thin walks ignore ``active``, as in the JAX package).
    Source ids and t against the JAX walk and the brute force; no lane
    cut; the loop condition read at most once per ``traversal_unroll``
    steps, plus one."""
    rng = np.random.default_rng(42)
    v = _soup(rng, 300)
    o, d = _rays(rng, 1024)
    n = o.shape[0]
    t_init = np.where(np.arange(n) % 3 == 0, 6.0, BIG).astype(np.float32)
    active = np.arange(n) % 5 != 0
    kd_np = tkd.build_kdtree(*v, leaf_size=4)
    got = _walk(kd_np, o, d, walk, t_init, active)
    stats = got[2]
    assert stats["walk"] == walk
    assert stats["cut"] == 0
    assert stats["host_reads"] <= stats["steps"] // TCfg().traversal_unroll + 1

    jt, jtri, jk = _jax_walk(v, dict(leaf_size=4), o, d, walk, t_init, active)
    src_j = np.where(jtri >= 0, np.asarray(jk.tris.orig_index)[np.maximum(jtri, 0)], -1)
    _check(kd_np, got, src_j, jt, f"{walk} vs JAX")

    brute = _brute(v, o, d, t_init)
    lanes = np.ones(n, bool) if walk in THIN else active
    want = np.where(lanes, brute.tri.numpy(), -1)
    assert (want >= 0).sum() > n // 8
    _check(kd_np, got, want, brute.t.numpy(), f"{walk} vs brute")


@pytest.mark.parametrize("walk", list(WALKS))
def test_walk_inside_cluster(walk):
    """tests/test_kdtree.py:118: rays from the middle of a dense soup (the
    origin inside the root box and inside leaves)."""
    rng = np.random.default_rng(7)
    v = _soup(rng, 200, spread=2.0)
    o = np.zeros((64, 3), np.float32)
    d = rng.normal(size=(64, 3)).astype(np.float32)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    kd_np = tkd.build_kdtree(*v)
    got = _walk(kd_np, o, d, walk)
    brute = _brute(v, o, d)
    _check(kd_np, got, brute.tri.numpy(), brute.t.numpy(), walk)
    jt, jtri, jk = _jax_walk(v, {}, o, d, walk)
    np.testing.assert_allclose(got[0], jt, rtol=T_RTOL)


@pytest.mark.parametrize("stack_k", [2, 3])
def test_pushdown_overflow_recovery(stack_k):
    """tests/test_kdtree.py:126: a deep tree (leaves of 2, 6,000
    triangles) under a push-down stack of 2 or 3 entries, so most rays
    evict their oldest entry and restart from the pushed-down root; the
    hits still equal the brute force's, and the JAX walk's."""
    rng = np.random.default_rng(3)
    v = _soup(rng, 6000, spread=6.0, size=0.4)
    o, d = _rays(rng, 1024, aim=4.0)
    kd_np = tkd.build_kdtree(*v, leaf_size=2)
    cfg = dict(pushdown_stack=stack_k, max_traversal_steps=65536)
    got = _walk(kd_np, o, d, "pushdown", **cfg)
    assert got[2]["stack"] == stack_k and got[2]["cut"] == 0
    brute = _brute(v, o, d)
    _check(kd_np, got, brute.tri.numpy(), brute.t.numpy(), "brute")
    jt, jtri, jk = _jax_walk(v, dict(leaf_size=2), o, d, "pushdown", **cfg)
    np.testing.assert_array_equal(got[0] < BIG, jt < BIG)
    np.testing.assert_allclose(got[0], jt, rtol=T_RTOL)


@pytest.mark.parametrize("walk", list(WALKS))
def test_big_leaf_chunking(walk):
    """tests/test_kdtree.py:152 and :196: leaves of up to 64 triangles
    (max depth 2) walked 4 triangles a step by the thin walks' cursor
    (``leaf_chunk=4``) and through continuation rows by the fat-row walks."""
    rng = np.random.default_rng(3)
    v = _soup(rng, 128)
    o, d = _rays(rng, 256)
    kd_np = tkd.build_kdtree(*v, leaf_size=64, max_depth=2)
    assert kd_np.fat.count > kd_np.nodes.count  # chains exist
    got = _walk(kd_np, o, d, walk, leaf_chunk=4)
    brute = _brute(v, o, d)
    _check(kd_np, got, brute.tri.numpy(), brute.t.numpy(), walk)


@pytest.mark.parametrize("walk", [w for w in WALKS if w != "packet"])
def test_step_bound_cuts_as_jax(walk):
    """A step bound of 10 cuts most lanes mid-walk: the port counts them
    and marks them (``cut_rays``), and every lane, cut or not, holds the JAX walk's hit so far (the bound
    cuts each lane at the same step however the JAX package tiles the
    wavefront: four tiles of 128 lanes there)."""
    rng = np.random.default_rng(11)
    v = _soup(rng, 300)
    o, d = _rays(rng, 512)
    kd_np = tkd.build_kdtree(*v, leaf_size=4)
    cfg = dict(max_traversal_steps=10, tile_lanes=128)
    got = _walk(kd_np, o, d, walk, **cfg)
    assert got[2]["cut"] > 0 and got[2]["steps"] == 10
    assert int(got[2]["cut_rays"].sum()) == got[2]["cut"]
    jt, jtri, jk = _jax_walk(v, dict(leaf_size=4), o, d, walk, **cfg)
    src_j = np.where(jtri >= 0, np.asarray(jk.tris.orig_index)[np.maximum(jtri, 0)], -1)
    assert (src_j >= 0).sum() > 0
    _check(kd_np, got, src_j, jt, walk)


def test_packets_pad_and_sort():
    """Packets of 32 over 1,000 rays (padded with 8 dead lanes) equal the
    per-ray fat-row walk; without ``sort_rays`` too; every packet walks
    from the root and the padding never reports a hit."""
    rng = np.random.default_rng(5)
    v = _soup(rng, 300)
    o, d = _rays(rng, 1000)
    kd_np = tkd.build_kdtree(*v, leaf_size=4)
    base = ttrav.intersect_mesh_kd(torch.from_numpy(o), torch.from_numpy(d),
                                   kd_to_device(kd_np, "cpu"), TCfg())
    for sort_rays in (True, False):
        got = _walk(kd_np, o, d, "packet", sort_rays=sort_rays)
        assert got[2]["packets"] == 32 and got[1].shape == (1000,)
        _check(kd_np, got, _source_ids(kd_np, base.tri.numpy()), base.t.numpy(),
               f"sort_rays={sort_rays}")


class KDScene(NamedTuple):
    scene: object  # the port's
    kd: object  # the port's KD table (tensors)
    camera: object
    jkd: object  # the JAX package's build of the same mesh


@pytest.fixture(scope="module")
def kd_scene(tmp_path_factory):
    """The mesh_kd_48 scene (icosphere-2 in the Cornell box) at 32x32, and
    the JAX package's KD build of its mesh."""
    obj = _mesh_obj(tmp_path_factory.mktemp("kdwalks"), 2, 2.0)
    scene = tparser.with_resolution(tparser.load_scene(CORNELL, obj_path=obj, device="cpu"),
                                    32, 32)
    return KDScene(scene, scene.kd, scene.camera, jparser.load_scene(CORNELL, obj_path=obj).kd)


@pytest.mark.parametrize("walk", list(WALKS))
def test_first_hits_and_render_match_default(kd_scene, walk):
    """tests/test_mesh_render.py:74-135: on the camera rays every walk
    finds the JAX package's hits for the same walk (source ids, t) and,
    but for the push-down walk, the default fat-row walk's; it renders the
    default's image within atol 1e-3 a pixel (depth 4, 2 spp).

    The push-down walk misses, in both packages, exactly the mesh hits of
    the rays that leave the root's split plane (x = 0, where the camera
    sits) towards +x: its split test takes t_split = 0 as "far only" and
    sends them to the low side (JAX ops/traverse.py:372-378), a fault of
    the JAX design that the port keeps."""
    kd = kd_scene.kd
    rays = generate_rays(kd_scene.camera, TCfg(), bounce_key(prng_key(0), 1, 0), 8, "cpu")
    o = torch.stack(tuple(rays.origin), 1)
    d = torch.stack(tuple(rays.direction), 1)
    src = kd.tris.orig_index

    def source(tri):
        return torch.where(tri >= 0, src[tri.clamp_min(0).long()], -1)

    base = ttrav.intersect_mesh_kd(o, d, kd, TCfg())
    hit = ttrav.intersect_mesh_kd(o, d, kd, TCfg(**WALKS[walk]))
    jhit = jtrav.intersect_mesh_kd(jnp.asarray(o.numpy()), jnp.asarray(d.numpy()),
                                   kd_scene.jkd, JCfg(**WALKS[walk]))
    jtri = np.asarray(jhit.tri)
    jsrc = np.where(jtri >= 0, np.asarray(kd_scene.jkd.tris.orig_index)[np.maximum(jtri, 0)], -1)
    np.testing.assert_array_equal(source(hit.tri).numpy(), jsrc)
    np.testing.assert_allclose(hit.t.numpy()[jtri >= 0], np.asarray(jhit.t)[jtri >= 0],
                               rtol=T_RTOL)
    assert (base.tri >= 0).sum() > 20
    if walk == "pushdown":
        assert float(kd.nodes.split_pos[0]) == float(o[0, int(kd.nodes.axis[0])]) == 0.0
        lost = (base.tri >= 0) & (hit.tri < 0)
        assert lost.any() and torch.equal(lost, (base.tri >= 0) & (d[:, 0] > 0))
        return
    assert torch.equal(source(hit.tri), source(base.tri))
    both = base.tri >= 0
    torch.testing.assert_close(hit.t[both], base.t[both], rtol=1e-5, atol=0)

    a = render(kd_scene.scene, TCfg(trace_depth=4, **WALKS[walk]), spp=2, seed=0, device="cpu")
    b = render(kd_scene.scene, TCfg(trace_depth=4), spp=2, seed=0, device="cpu")
    assert torch.isfinite(a).all() and a.max() > 0.1
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-3)
