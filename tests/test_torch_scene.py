"""The port's scene tables equal the JAX package's, bit for bit.

Every array of ``load_scene`` (camera, geoms, materials, mesh, the KD
table and the cluster table, including its 512-block fallback) is
compared exactly: both packages build them with the same numpy code.
"""

import os

import jax
import numpy as np
import pytest
import torch

from kdtreepathtraceroptimization_tpu.scene import parser as jparser
from kdtreepathtraceroptimization_tpu_torch.convert import scene_from_numpy
from kdtreepathtraceroptimization_tpu_torch.ops.cluster import real_slots
from kdtreepathtraceroptimization_tpu_torch.scene import parser as tparser
from kdtreepathtraceroptimization_tpu_torch.scene.structs import MeshSoA
from kdtreepathtraceroptimization_tpu_torch.utils.device import to_tensor
from kdtreepathtraceroptimization_tpu_torch.utils.procmesh import icosphere, write_obj

CORNELL = os.path.join(os.path.dirname(__file__), "..", "scenes", "cornell.txt")


def _obj(tmp_path, subdiv):
    verts, faces = icosphere(subdiv, radius=2.5, center=(0.0, 3.0, 0.0))
    path = str(tmp_path / f"ico{subdiv}.obj")
    write_obj(path, verts, faces)
    return path


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def assert_scene_equal(jscene, tscene):
    """Exact equality of every table (tolerance: none)."""
    for part in ("camera", "geoms", "materials", "mesh"):
        jp, tp = getattr(jscene, part), getattr(tscene, part)
        assert (jp is None) == (tp is None), part
        if jp is None:
            continue
        assert jp._fields == tp._fields, part
        for f in jp._fields:
            a, b = getattr(jp, f), getattr(tp, f)
            assert (a is None) == (b is None), (part, f)
            if a is not None:
                a, b = np.asarray(a), _np(b)
                assert a.dtype == b.dtype, (part, f, a.dtype, b.dtype)
                np.testing.assert_array_equal(a, b, err_msg=f"{part}.{f}")
    assert tuple(jscene.state) == tuple(tscene.state)
    jk, tk = getattr(jscene, "kd", None), tscene.kd
    assert (jk is None) == (tk is None)
    if jk is not None:
        for part in ("nodes", "tris"):
            for f, a, b in zip(getattr(jk, part)._fields, getattr(jk, part), getattr(tk, part)):
                np.testing.assert_array_equal(np.asarray(a), _np(b), err_msg=f"kd.{part}.{f}")
        for part in ("fat", "oct"):
            jp, tp = getattr(jk, part), getattr(tk, part)
            assert (jp is None) == (tp is None), part
            if jp is not None:
                np.testing.assert_array_equal(np.asarray(jp.rows), _np(tp.rows))
        assert int(jk.max_depth) == tk.max_depth
    jc, tc = jscene.cmesh, tscene.cmesh
    assert (jc is None) == (tc is None)
    if jc is None:
        return
    # the port keeps two more fields: the hit expansion's packed rows and
    # the repair sweep's real-slot counts
    assert jc._fields + ("packed", "real") == tc._fields
    real = real_slots(MeshSoA(*(to_tensor(np.asarray(a), "cpu") for a in jc.tris)),
                      int(jc.block), jc.n_blocks)
    assert torch.equal(real, tc.real.cpu())
    np.testing.assert_array_equal(
        _np(tc.packed),
        np.concatenate([np.asarray(getattr(jc.tris, f), np.float32).reshape(
            len(jc.tris.v0), -1) for f in ("v0", "v1", "v2", "n0", "n1", "n2",
                                            "material_id")], axis=1))
    assert int(jc.block) == tc.block
    assert int(jc.n_real_blocks) == tc.n_real_blocks
    for f in ("w", "blk", "cull_w", "slab", "center_shift", "root_min", "root_max"):
        a, b = np.asarray(getattr(jc, f)), _np(getattr(tc, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f"cmesh.{f}")
    for f in jc.tris._fields:
        np.testing.assert_array_equal(np.asarray(getattr(jc.tris, f)),
                                      _np(getattr(tc.tris, f)),
                                      err_msg=f"cmesh.tris.{f}")


@pytest.mark.parametrize("subdiv", [None, 3])
def test_load_scene_matches_jax(tmp_path, subdiv):
    obj = None if subdiv is None else _obj(tmp_path, subdiv)
    jscene = jparser.load_scene(CORNELL, obj_path=obj)
    tscene = tparser.load_scene(CORNELL, obj_path=obj, device="cpu")
    assert_scene_equal(jscene, tscene)
    assert_scene_equal(jparser.with_resolution(jscene, 40, 24),
                       tparser.with_resolution(tscene, 40, 24))


@pytest.mark.parametrize("cap, subdiv, block", [(8, 3, 512), (8, 4, None)])
def test_cluster_block_fallback_matches_jax(tmp_path, monkeypatch, cap,
                                            subdiv, block):
    """With the block-id cap lowered, a mesh past cap/2 * 256 triangles
    takes 512-triangle blocks, and one past cap/2 * 1024 gets no table,
    in both packages."""
    import kdtreepathtraceroptimization_tpu.ops.pairs as jpairs

    monkeypatch.setattr(jpairs, "MAX_CLUSTER_BLOCKS", cap)
    monkeypatch.setattr(tparser, "MAX_CLUSTER_BLOCKS", cap)
    obj = _obj(tmp_path, subdiv)
    jscene = jparser.load_scene(CORNELL, obj_path=obj)
    tscene = tparser.load_scene(CORNELL, obj_path=obj, device="cpu")
    assert_scene_equal(jscene, tscene)
    assert (tscene.cmesh is None) == (block is None)
    if block is not None:
        assert tscene.cmesh.block == block


def test_scene_from_numpy_round_trip(tmp_path):
    """A JAX scene carried across equals the port's own load."""
    obj = _obj(tmp_path, 2)
    jscene = jparser.load_scene(CORNELL, obj_path=obj)
    carried = scene_from_numpy(jax.tree.map(np.asarray, jscene), "cpu")
    assert_scene_equal(jscene, carried)
    assert_scene_equal(jscene, tparser.load_scene(CORNELL, obj_path=obj,
                                                  device="cpu"))
    # and carrying the port's scene again changes nothing
    assert_scene_equal(jscene, scene_from_numpy(carried, "cpu"))


def test_build_kd_is_not_ported(tmp_path):
    """The name dates from before the KD build was ported; the test now
    holds what replaced the raise: ``build_kd=True`` (the default, as in
    the JAX package) builds the KD table, equal to the JAX package's bit
    for bit (``assert_scene_equal``), and ``build_kd=False`` builds none."""
    obj = _obj(tmp_path, 1)
    jscene = jparser.load_scene(CORNELL, obj_path=obj, build_kd=True)
    tscene = tparser.load_scene(CORNELL, obj_path=obj, build_kd=True, device="cpu")
    assert tscene.kd is not None
    assert_scene_equal(jscene, tscene)
    assert tparser.load_scene(CORNELL, obj_path=obj, build_kd=False, device="cpu").kd is None
