"""The KD route against the JAX package: the build, the tools, the walk,
the default dispatch and the mesh_kd_48 golden.

Inputs are made from numpy seeds. Tolerances: the build's arrays (numpy
and native builders) bit for bit; the walk's triangle ids equal the JAX
walk's except on grazing ties (at most 0.5% of the rays, each with t
within rtol 1e-5, since XLA's CPU jit fuses multiply-adds in the JAX
walk and the port computes unfused) and, as source-mesh ids, the brute
force's; renders as the golden tests bound them.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kdtreepathtraceroptimization_tpu.accel import kdtools as jkdtools
from kdtreepathtraceroptimization_tpu.accel import kdtree as jkd
from kdtreepathtraceroptimization_tpu.config import RenderConfig as JCfg
from kdtreepathtraceroptimization_tpu.ops import traverse as jtrav
from kdtreepathtraceroptimization_tpu.scene import parser as jparser
from kdtreepathtraceroptimization_tpu_torch.accel import kdtools as tkdtools
from kdtreepathtraceroptimization_tpu_torch.accel import kdtree as tkd
from kdtreepathtraceroptimization_tpu_torch.accel.native import load_native
from kdtreepathtraceroptimization_tpu_torch.config import RenderConfig as TCfg
from kdtreepathtraceroptimization_tpu_torch.convert import kd_to_device, scene_from_numpy
from kdtreepathtraceroptimization_tpu_torch.ops import traverse as ttrav
from kdtreepathtraceroptimization_tpu_torch.ops.mesh import intersect_mesh_brute
from kdtreepathtraceroptimization_tpu_torch.render.integrator import mesh_route, render
from kdtreepathtraceroptimization_tpu_torch.scene import parser as tparser
from kdtreepathtraceroptimization_tpu_torch.scene.structs import MeshSoA
from kdtreepathtraceroptimization_tpu_torch.utils.procmesh import icosphere
from tests.test_torch_pairs import JIT_BRANCHED_PIXELS
from tests.test_torch_render import CORNELL, GOLDENS, _mesh_obj

T_RTOL = 1e-5
# Rays whose JAX and port walks may pick another triangle: a grazing tie
# that the JAX walk's fused multiply-adds break another way.
MAX_TIE_FRAC = 5e-3


def _ico(subdiv):
    verts, faces = icosphere(subdiv, radius=2.0, center=(0.3, -0.2, 0.5))
    v = verts[faces].astype(np.float32)
    return v[:, 0], v[:, 1], v[:, 2]


def _soup(n, seed):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-4, 4, (n, 3)).astype(np.float32)
    return tuple(c + rng.uniform(-0.6, 0.6, (n, 3)).astype(np.float32) for _ in range(3))


def _rays(n, seed, target=(0.3, -0.2, 0.5)):
    """Rays from around the scene aimed near ``target``: most hit."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3)).astype(np.float32) * 5.0
    d = np.asarray(target, np.float32) + rng.normal(size=(n, 3)).astype(np.float32) * 1.5 - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d.astype(np.float32)


def _source_ids(kd, tri):
    """KD triangle ids (into the leaf-duplicated kd.tris) as source-mesh ids."""
    orig = np.asarray(kd.tris.orig_index)
    tri = np.asarray(tri)
    return np.where(tri >= 0, orig[np.maximum(tri, 0)], -1)


@pytest.mark.parametrize("backend", ["numpy", "native"])
@pytest.mark.parametrize("geometry", ["icosphere2", "soup"])
def test_kd_build_equals_jax(geometry, backend):
    """Every array of the port's build (either builder) equals the JAX
    package's numpy build bit for bit, octant table included, and passes
    validate_kdtree. Leaf size 4 on the soup (deep tree, chained leaves
    at max_depth 5), 32 with the default cap on the icosphere."""
    if backend == "native" and load_native() is None:
        pytest.fail("the native KD builder did not build (g++ missing?)")
    v0, v1, v2 = _ico(2) if geometry == "icosphere2" else _soup(600, seed=4)
    kw = dict(leaf_size=32, inline_cap=32) if geometry == "icosphere2" else dict(
        leaf_size=4, max_depth=5)
    got = tkd.build_kdtree(v0, v1, v2, backend=backend, **kw)
    want = jkd.build_kdtree(v0, v1, v2, backend="numpy", **kw)
    for part in ("nodes", "tris"):
        for name, a, b in zip(getattr(got, part)._fields, getattr(got, part),
                              getattr(want, part)):
            np.testing.assert_array_equal(a, b, err_msg=f"{part}.{name}")
    assert got.max_depth == want.max_depth
    np.testing.assert_array_equal(got.root_bbox_min, want.root_bbox_min)
    np.testing.assert_array_equal(got.root_bbox_max, want.root_bbox_max)
    np.testing.assert_array_equal(got.fat.rows, want.fat.rows)
    assert got.fat.inline_cap == want.fat.inline_cap
    assert (got.oct is None) == (want.oct is None)
    if got.oct is not None:
        np.testing.assert_array_equal(got.oct.rows, want.oct.rows)
        assert got.oct.layout_size == want.oct.layout_size
    tkd.validate_kdtree(got, v0.shape[0])


def test_kd_tools_equal_jax(tmp_path):
    """tree_stats, the node-box dump and the triangle-file reader give the
    JAX package's results on the same tree and file."""
    v0, v1, v2 = _soup(300, seed=2)
    got = tkd.build_kdtree(v0, v1, v2, leaf_size=4)
    want = jkd.build_kdtree(v0, v1, v2, leaf_size=4)
    assert tkdtools.tree_stats(got) == jkdtools.tree_stats(want)
    tkdtools.write_kd_to_file(got, str(tmp_path / "port.txt"))
    jkdtools.write_kd_to_file(want, str(tmp_path / "jax.txt"))
    assert (tmp_path / "port.txt").read_text() == (tmp_path / "jax.txt").read_text()
    path = tmp_path / "tris.txt"
    path.write_text("\n".join(f"{x:.6g}" for x in np.stack([v0, v1, v2], 1).ravel()[:90]))
    np.testing.assert_array_equal(tkdtools.read_triangles_file(str(path)),
                                  jkdtools.read_triangles_file(str(path)))


@pytest.mark.parametrize("octant_rows", [True, False])
def test_kd_walk_matches_jax_and_brute(octant_rows):
    """The fat-row walk (octant layouts on or off) against the JAX
    package's intersect_mesh_kd and the brute force, with t bounds on a
    third of the rays and a fifth of them inactive. A leaf size of 8 with
    max_depth 3 leaves chained continuation rows."""
    v0, v1, v2 = _ico(3)
    kd_np = tkd.build_kdtree(v0, v1, v2, leaf_size=8, max_depth=3)
    assert kd_np.fat.count > kd_np.nodes.count and kd_np.oct is not None
    kd = kd_to_device(kd_np, "cpu")
    o, d = _rays(3000, seed=5)
    n = o.shape[0]
    t_init = np.where(np.arange(n) % 3 == 0, 4.5, 1e30).astype(np.float32)
    active = np.arange(n) % 5 != 0
    cfg = dict(octant_rows=octant_rows, tile_lanes=1024)
    got, stats = ttrav.intersect_mesh_kd(torch.from_numpy(o), torch.from_numpy(d), kd,
                                         TCfg(**cfg), t_init=torch.from_numpy(t_init),
                                         active=torch.from_numpy(active), collect_stats=True)
    assert stats["octant_rows"] == octant_rows
    assert stats["host_reads"] <= stats["steps"] // TCfg().traversal_unroll + 1
    jkd_np = jkd.build_kdtree(v0, v1, v2, leaf_size=8, max_depth=3)
    want = jtrav.intersect_mesh_kd(jnp.asarray(o), jnp.asarray(d), jkd_np, JCfg(**cfg),
                                   t_init=jnp.asarray(t_init), active=jnp.asarray(active))
    wt, wtri = np.asarray(want.t), np.asarray(want.tri)
    gt, gtri = got.t.numpy(), got.tri.numpy()
    assert int((wtri >= 0).sum()) > n // 3
    same = gtri == wtri
    assert (~same).mean() <= MAX_TIE_FRAC
    np.testing.assert_allclose(gt, wt, rtol=T_RTOL)
    assert (gtri[~active] == -1).all() and (gt[~active] >= 1e30).all()

    mesh = MeshSoA(*(torch.from_numpy(np.ascontiguousarray(a)) for a in (v0, v1, v2)),
                   None, None, None, None, None, None, None)
    brute = intersect_mesh_brute(torch.from_numpy(o), torch.from_numpy(d), mesh,
                                 use_bbox=False, t_max=torch.from_numpy(t_init))
    want_src = np.where(active, brute.tri.numpy(), -1)
    np.testing.assert_array_equal(_source_ids(kd_np, gtri), want_src)
    hit = gtri >= 0
    np.testing.assert_allclose(gt[hit], brute.t.numpy()[hit], rtol=T_RTOL)


@pytest.mark.parametrize("kw, match", [
    (dict(short_stack=True), "short_stack"),
    (dict(short_stack=True, push_down_restart=True), "short_stack"),
    (dict(packet_size=32), "packet_size"),
    (dict(fat_rows=False), "thin-table"),
])
def test_kd_unported_walks_raise(kw, match):
    """The four walk configurations the port raised for before it had
    them (the fat-row short-stack walk, which push_down_restart does not
    change with fat rows; packets; the thin skip-link walk): each now
    gives the JAX package's hits under the same parameters, as source-mesh
    ids with t within 1e-4 relative (the JAX KD bound), on an
    icosphere-1 in leaves of 4, and no lane is cut. ``match`` names the
    option each case selects."""
    v = _ico(1)
    kd_np = tkd.build_kdtree(*v, leaf_size=4)
    o, d = _rays(64, seed=1)
    got, stats = ttrav.intersect_mesh_kd(torch.from_numpy(o), torch.from_numpy(d),
                                         kd_to_device(kd_np, "cpu"), TCfg(**kw),
                                         collect_stats=True)
    assert stats["cut"] == 0
    jk = jkd.build_kdtree(*v, leaf_size=4)
    want = jtrav.intersect_mesh_kd(jnp.asarray(o), jnp.asarray(d), jk, JCfg(**kw))
    wtri = np.asarray(want.tri)
    gtri = got.tri.numpy()
    assert (wtri >= 0).sum() > 16
    np.testing.assert_array_equal(_source_ids(kd_np, gtri), _source_ids(jk, wtri), err_msg=match)
    hit = gtri >= 0
    np.testing.assert_allclose(got.t.numpy()[hit], np.asarray(want.t)[hit], rtol=1e-4)


def test_kd_routes(tmp_path):
    """The JAX dispatch: the default config sends a mesh below
    cluster_min_tris to the KD walk and a bigger one to the pair list;
    cluster_auto=False sends any mesh to the KD walk; without a KD table
    enable_kd falls through to the brute force."""
    small = tparser.load_scene(CORNELL, obj_path=_mesh_obj(tmp_path, 2, 2.0), device="cpu")
    big = tparser.load_scene(CORNELL, obj_path=_mesh_obj(tmp_path, 3, 2.0), device="cpu")
    assert small.kd is not None and small.kd.packed.shape == (small.kd.tris.count, 19)
    assert mesh_route(small.mesh, small.cmesh, TCfg(), small.kd) == "kd"
    assert mesh_route(big.mesh, big.cmesh, TCfg(), big.kd) == "pairs"
    assert mesh_route(big.mesh, big.cmesh, TCfg(cluster_auto=False), big.kd) == "kd"
    bare = tparser.load_scene(CORNELL, obj_path=_mesh_obj(tmp_path, 2, 2.0), build_kd=False,
                              device="cpu")
    assert bare.kd is None and mesh_route(bare.mesh, bare.cmesh, TCfg(), bare.kd) == "mxu"


def test_jax_scene_kd_table_carried(tmp_path):
    """scene_from_numpy carries a JAX scene's KD table onto the device,
    equal to the port's own build of the same mesh."""
    obj = _mesh_obj(tmp_path, 2, 2.0)
    jscene = jparser.load_scene(CORNELL, obj_path=obj)
    tscene = scene_from_numpy(jax.tree.map(np.asarray, jscene), "cpu")
    own = tparser.load_scene(CORNELL, obj_path=obj, device="cpu")
    for a, b in ((tscene.kd.fat.rows, own.kd.fat.rows), (tscene.kd.oct.rows, own.kd.oct.rows),
                 (tscene.kd.packed, own.kd.packed)):
        assert torch.equal(a, b)
    assert tscene.kd.oct.layout_size == own.kd.oct.layout_size


def test_mesh_kd_48_golden(tmp_path):
    """The KD golden (tools/goldens.py mesh_kd_48: icosphere-2, 320
    triangles, the default config) at the golden test's per-pixel atol
    2e-3 on every pixel but 490 and 518, and mean |d| <= 2e-4. Those two
    are the mesh_pairs_48 exemption: their camera rays first hit a wall,
    where the golden's jit-fused t is an ulp from the port's
    (``test_mesh_pairs_48_golden_pixels_branch_under_jit``); the mesh
    plays no part in it."""
    from kdtreepathtraceroptimization_tpu_torch.tools import goldens

    make_scene, cfg, _ = goldens.CASES["mesh_kd_48"]
    scene = make_scene("cpu")
    assert mesh_route(scene.mesh, scene.cmesh, cfg, scene.kd) == "kd"
    img = goldens.render_case("mesh_kd_48", "cpu")
    diff = np.abs(img - np.load(os.path.join(GOLDENS, "mesh_kd_48.npy")))
    off = np.flatnonzero((diff > 2e-3).any(axis=-1))
    assert set(off.tolist()) <= set(JIT_BRANCHED_PIXELS), off
    assert diff.mean() <= 2e-4


def test_cross_mode_agreement(tmp_path):
    """tests/test_golden.py's cross-mode check for its seven modes: pairs,
    walk, binned, KD packets and both brute forces within mean 1e-2 of
    the KD render, on the mesh_kd_48
    scene (at 4 spp where the JAX test takes 8: every mode draws the same
    random streams, so they differ only where a ray grazes an edge)."""
    scene = tparser.with_resolution(
        tparser.load_scene(CORNELL, obj_path=_mesh_obj(tmp_path, 2, 2.0), device="cpu"),
        48, 48)
    cbase = dict(trace_depth=4, cluster=True, cluster_tile=256)
    configs = {
        "pairs": TCfg(**cbase, cluster_pairs=True),
        "walk": TCfg(**cbase, cluster_pairs=False, cluster_walk=True),
        "binned": TCfg(**cbase, cluster_pairs=False, cluster_binned=True, binned_rounds=8),
        "kd_packet": TCfg(trace_depth=4, packet_size=32),
        "brute_mxu": TCfg(trace_depth=4, enable_kd=False),
        "brute_vpu": TCfg(trace_depth=4, enable_kd=False, mxu_brute=False),
    }
    base = render(scene, TCfg(trace_depth=4), spp=4, seed=0, device="cpu").numpy()
    for name, cfg in configs.items():
        img = render(scene, cfg, spp=4, seed=0, device="cpu").numpy()
        assert np.abs(img - base).mean() < 1e-2, name
