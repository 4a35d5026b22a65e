"""The slice end to end on the CPU: the cluster-walk render against the
JAX package's render of the same scene tables and against its goldens."""

import os

import jax
import numpy as np
import pytest
import torch

from kdtreepathtraceroptimization_tpu.config import RenderConfig as JCfg
from kdtreepathtraceroptimization_tpu.render.integrator import render as jrender
from kdtreepathtraceroptimization_tpu.scene import parser as jparser
from kdtreepathtraceroptimization_tpu_torch.config import RenderConfig as TCfg
from kdtreepathtraceroptimization_tpu_torch.convert import scene_from_numpy
from kdtreepathtraceroptimization_tpu_torch.render.film import tonemap_srgb_u8
from kdtreepathtraceroptimization_tpu_torch.render.integrator import (
    make_render_block_fn,
    render,
)
from kdtreepathtraceroptimization_tpu_torch.ops.rng import prng_key
from kdtreepathtraceroptimization_tpu_torch.scene import parser as tparser
from kdtreepathtraceroptimization_tpu_torch.utils.image import write_png
from kdtreepathtraceroptimization_tpu_torch.utils.procmesh import icosphere, write_obj

HERE = os.path.dirname(__file__)
CORNELL = os.path.join(HERE, "..", "scenes", "cornell.txt")
GOLDENS = os.path.join(HERE, "goldens")
WALK = dict(cluster=True, cluster_walk=True, cluster_pairs=False)


def _mesh_obj(tmp_path, subdiv, radius, center=(0.0, 3.0, 0.0)):
    verts, faces = icosphere(subdiv, radius=radius, center=center)
    path = str(tmp_path / f"ico{subdiv}.obj")
    write_obj(path, verts, faces)
    return path


def test_walk_render_matches_jax(tmp_path):
    """48x48, depth 4, 4 spp, a 320-triangle sphere: both packages render
    the identical scene tables (carried across with scene_from_numpy).
    Bound: mean |d| <= 2e-3; the two differ only by float rounding, which
    changes a path only where a ray grazes an edge."""
    jscene = jparser.with_resolution(
        jparser.load_scene(CORNELL, obj_path=_mesh_obj(tmp_path, 2, 2.5),
                           build_kd=False), 48, 48)
    tscene = scene_from_numpy(jax.tree.map(np.asarray, jscene), "cpu")
    kw = dict(trace_depth=4, antialias=True, cluster_tile=256, **WALK)
    img_j = np.asarray(jrender(jscene, JCfg(**kw), spp=4, seed=0))
    img_t = render(tscene, TCfg(**kw), spp=4, seed=0, device="cpu")
    assert img_t.shape == (48, 48, 3) and img_t.dtype == torch.float32
    diff = np.abs(img_j - img_t.numpy())
    assert diff.mean() <= 2e-3, diff.mean()


def test_cornell_64_golden():
    """The analytic-only golden case (tools/goldens.py cornell_64) at the
    golden test's per-pixel atol."""
    scene = tparser.with_resolution(tparser.load_scene(CORNELL, device="cpu"), 64, 64)
    img = render(scene, TCfg(trace_depth=8, antialias=True), spp=8, seed=0,
                 device="cpu").numpy()
    np.testing.assert_allclose(img, np.load(os.path.join(GOLDENS, "cornell_64.npy")),
                               atol=2e-3)


def test_mesh_pairs_48_golden_in_walk_config(tmp_path):
    """The pair-list golden's scene and seed, rendered by the exact walk:
    both intersectors are exact, so the images agree to the cross-mode
    bound of the golden tests (mean |d| <= 1e-2)."""
    scene = tparser.with_resolution(
        tparser.load_scene(CORNELL, obj_path=_mesh_obj(tmp_path, 4, 2.0),
                           device="cpu"), 48, 48)
    img = render(scene, TCfg(trace_depth=4, cluster_tile=256, **WALK), spp=8,
                 seed=0, device="cpu").numpy()
    golden = np.load(os.path.join(GOLDENS, "mesh_pairs_48.npy"))
    assert np.abs(img - golden).mean() <= 1e-2


def test_block_fn_accumulates_iterations(tmp_path):
    """make_render_block_fn's film is the sum of the iterations render
    averages, and the PNG writer takes its tonemapped image."""
    scene = tparser.with_resolution(
        tparser.load_scene(CORNELL, obj_path=_mesh_obj(tmp_path, 1, 2.0),
                           device="cpu"), 16, 16)
    cfg = TCfg(trace_depth=3, antialias=True, cluster_tile=64, **WALK)
    step = make_render_block_fn(scene, cfg, 3, device="cpu")
    film = step(torch.zeros((256, 3)), prng_key(5), 1)
    img = render(scene, cfg, spp=3, seed=5, device="cpu")
    np.testing.assert_allclose((film / 3).reshape(16, 16, 3).numpy(), img.numpy(),
                               rtol=1e-6, atol=1e-7)
    assert torch.isfinite(img).all() and img.mean() > 0
    write_png(str(tmp_path / "img.png"), tonemap_srgb_u8(img))
    assert (tmp_path / "img.png").stat().st_size > 0


@pytest.mark.parametrize("kw", [
    dict(cluster=True, pair_bdiag=True),  # the block-diagonal pair kernel
    {},  # an 80-triangle mesh is below cluster_min_tris: the KD walk
    dict(cluster=True, cluster_pairs=False),  # cluster rounds
    dict(cluster=True, cluster_pairs=False, cluster_binned=True),
    dict(compaction=True, **WALK),
    dict(material_sort=True, **WALK),
    dict(ray_cache=True, **WALK),
])
def test_unported_configs_raise(tmp_path, kw):
    scene = tparser.load_scene(CORNELL, obj_path=_mesh_obj(tmp_path, 1, 2.0),
                               device="cpu")
    with pytest.raises(NotImplementedError):
        render(scene, TCfg(trace_depth=1, **kw), spp=1, device="cpu")

