"""The port's interactive controller and loop against the JAX package's.

``apply_key`` against JAX ``apply_key`` for every key of the JAX table
and an unknown one: the camera's fields within 1e-5 (float32 trigonometry
in two libraries), the config, the film reset, the rebuild and the action
equal. The loop (16x16, depth 2, Cornell) renders the films of
``make_render_fn`` bit for bit, restarts on a camera key, follows the JAX
loop through the same key scripts (films within the golden tests' atol),
rebuilds its step with the caller's seed (the JAX loop builds it without
one, so its ray cache holds seed 0's rays whatever the seed: the one
case where the two loops are meant to differ), and ``--interactive``
runs through the command line with a piped key script.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from kdtreepathtraceroptimization_tpu.config import RenderConfig as JCfg
from kdtreepathtraceroptimization_tpu.render import interactive as jia
from kdtreepathtraceroptimization_tpu.scene import parser as jparser
from kdtreepathtraceroptimization_tpu_torch.config import RenderConfig as TCfg
from kdtreepathtraceroptimization_tpu_torch.ops.rng import prng_key
from kdtreepathtraceroptimization_tpu_torch.render import interactive as tia
from kdtreepathtraceroptimization_tpu_torch.render.film import tonemap_srgb_u8
from kdtreepathtraceroptimization_tpu_torch.render.integrator import make_render_fn
from kdtreepathtraceroptimization_tpu_torch.scene import parser as tparser
from kdtreepathtraceroptimization_tpu_torch.utils.image import read_png
from tests.test_torch_render import CORNELL

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAMERA_FIELDS = ("resolution", "position", "look_at", "view", "up", "right", "fov",
                 "pixel_length")
# every key of the JAX table (orbit, zoom, pan, lens, toggles in both
# cases, save, quit) and one it does not know
KEYS = ["LEFT", "RIGHT", "UP", "DOWN", "h", "l", "k", "j", "+", "=", "-",
        "a", "d", "w", "s", "[", "]", ",", ".",
        "A", "C", "X", "F", "M", "K", "L", "B", "c", "x", "f", "m", "b",
        "S", "q", "Q", "ESC", "z"]


def _scene(res=16):
    return tparser.with_resolution(tparser.load_scene(CORNELL, device="cpu"), res, res)


@pytest.mark.parametrize("key", KEYS)
def test_apply_key_matches_jax(key):
    jcam = jparser.with_resolution(jparser.load_scene(CORNELL), 16, 16).camera
    tcam = _scene().camera
    cfg = dict(trace_depth=2, dof_angle=0.05)
    want = jia.apply_key(key, jcam, JCfg(**cfg))
    got = tia.apply_key(key, tcam, TCfg(**cfg), device="cpu")
    assert (got.reset_film, got.recompile, got.action) == (
        want.reset_film, want.recompile, want.action)
    assert dataclasses.asdict(got.config) == dataclasses.asdict(want.config)
    for f in CAMERA_FIELDS:
        np.testing.assert_allclose(np.asarray(getattr(got.camera, f), np.float64),
                                   np.asarray(getattr(want.camera, f), np.float64),
                                   rtol=1e-5, atol=1e-5, err_msg=f)
    if not got.reset_film:
        assert got.camera is tcam


def test_run_interactive_non_tty(monkeypatch):
    """No key arrives: max_iters iterations, saved through save_fn, the
    averaged film of make_render_fn bit for bit."""
    scene, cfg = _scene(), TCfg(trace_depth=2, antialias=True)
    saved = {}
    monkeypatch.setattr(tia, "_read_key", lambda timeout_s: None)
    accum, it = tia.run_interactive(scene, cfg, 0, lambda img, i: saved.update(img=img, it=i),
                                    cols=16, max_iters=3, device="cpu")
    assert it == 3 and saved["it"] == 3
    step = make_render_fn(scene, cfg, device="cpu")
    film = torch.zeros((256, 3))
    for i in (1, 2, 3):
        film = step(film, prng_key(0), i)
    assert torch.equal(accum, film)
    np.testing.assert_array_equal(saved["img"], film.numpy() / 3)
    assert saved["img"].max() > 0


def test_run_interactive_camera_reset(monkeypatch):
    """A camera key mid-run restarts the film at iteration 0 (the JAX
    test's key sequence): the film is the orbited camera's 5 iterations."""
    scene, cfg = _scene(), TCfg(trace_depth=2)
    keys = iter([None, "LEFT", None, None, None, None])
    monkeypatch.setattr(tia, "_read_key", lambda timeout_s: next(keys, "q"))
    saved = {}
    accum, it = tia.run_interactive(scene, cfg, 0, lambda img, i: saved.update(it=i), cols=16,
                                    device="cpu")
    assert saved["it"] == it == 5
    moved = tparser.replace_camera(scene, tia.apply_key("LEFT", scene.camera, cfg, "cpu").camera)
    step = make_render_fn(moved, cfg, device="cpu")
    film = torch.zeros((256, 3))
    for i in range(1, 6):
        film = step(film, prng_key(0), i)
    assert torch.equal(accum, film)


# Key scripts (one key, or None, read after each iteration; "q" once the
# script runs out) and max_iters: orbit, toggle and quit; save, zoom and
# pan; a toggle that rebuilds the step until max_iters.
SCRIPTS = {
    "orbit_toggle_quit": ([None, "LEFT", "A", None, "q"], 0),
    "save_zoom_pan": ([None, "S", "+", "d", "z", None, "ESC"], 0),
    "toggle_to_max_iters": (["X", None, "C"], 4),
}


@pytest.mark.parametrize("script", list(SCRIPTS))
def test_run_interactive_matches_jax(monkeypatch, script):
    """Both packages' loops driven by the same key script (16x16, depth 2,
    AA on, seed 0, no ray cache): the same iteration counts and saves, and
    the port's accumulated film and saved images within the golden tests'
    per-pixel atol 2e-3 of the JAX loop's (its steps run under jit, and a
    moved camera is computed by each library's float32 trigonometry)."""
    keys, max_iters = SCRIPTS[script]
    saved = {"jax": [], "port": []}
    for pkg, mod in (("jax", jia), ("port", tia)):
        it_keys = iter(keys)
        monkeypatch.setattr(mod, "_read_key", lambda timeout_s, k=it_keys: next(k, "q"))
    cfg = dict(trace_depth=2, antialias=True)
    jscene = jparser.with_resolution(jparser.load_scene(CORNELL), 16, 16)
    jaccum, jit_ = jia.run_interactive(jscene, JCfg(**cfg), 0,
                                       lambda img, i: saved["jax"].append((i, img)), cols=16,
                                       max_iters=max_iters)
    accum, it = tia.run_interactive(_scene(), TCfg(**cfg), 0,
                                    lambda img, i: saved["port"].append((i, img)), cols=16,
                                    max_iters=max_iters, device="cpu")
    assert it == jit_ and [i for i, _ in saved["port"]] == [i for i, _ in saved["jax"]]
    assert len(saved["port"]) >= 1 and accum.max() > 0
    np.testing.assert_allclose(accum.numpy(), np.asarray(jaccum), atol=2e-3 * it)
    for (_, got), (_, want) in zip(saved["port"], saved["jax"]):
        np.testing.assert_allclose(got, np.asarray(want), atol=2e-3)


def test_run_interactive_keeps_film_across_toggle_and_uses_seed(monkeypatch):
    """A toggle rebuilds the step and keeps accumulating; the step is built
    with the caller's seed, so the ray cache holds seed 3's camera rays
    (the JAX loop's make_render_fn has no seed: seed 0's, ROADMAP Queue 3)."""
    scene, cfg = _scene(), TCfg(trace_depth=2, antialias=True, ray_cache=True)
    keys = iter(["X"])  # subsurface on after iteration 1
    monkeypatch.setattr(tia, "_read_key", lambda timeout_s: next(keys, None))
    accum, it = tia.run_interactive(scene, cfg, 3, lambda img, i: None, cols=16, max_iters=3,
                                    device="cpu")
    assert it == 3
    film = make_render_fn(scene, cfg, seed=3, device="cpu")(torch.zeros((256, 3)),
                                                            prng_key(3), 1)
    step = make_render_fn(scene, dataclasses.replace(cfg, enable_sss=True), seed=3,
                          device="cpu")
    for i in (2, 3):
        film = step(film, prng_key(3), i)
    assert torch.equal(accum, film)
    seed0 = make_render_fn(scene, cfg, seed=0, device="cpu")(torch.zeros((256, 3)),
                                                             prng_key(3), 1)
    first = make_render_fn(scene, cfg, seed=3, device="cpu")(torch.zeros((256, 3)),
                                                             prng_key(3), 1)
    assert not torch.equal(seed0, first)


def test_cli_interactive_with_piped_keys(tmp_path):
    """``cli --interactive`` in a child, its stdin the key script LEFT, A,
    S, q: exit 0, the PNGs of iterations 2 and 3, and the last is the
    orbited camera's film (iteration 1 with AA on, 2-3 with it off)
    tonemapped, byte for byte."""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-m", "kdtreepathtraceroptimization_tpu_torch.cli", CORNELL,
         "--interactive", "--res", "16", "16", "--depth", "3", "--aa", "--device", "cpu"],
        input=b"\x1b[DASq", cwd=tmp_path, env=env, capture_output=True, timeout=120)
    assert out.returncode == 0, out.stderr.decode()[-2000:]
    text = out.stdout.decode()
    assert "[orbit LEFT]" in text and "[antialias=False]" in text
    pngs = sorted(p.name for p in tmp_path.glob("cornell.*samp.png"))
    assert len(pngs) == 2 and pngs[0].endswith(".2samp.png") and pngs[1].endswith(".3samp.png")

    scene, cfg = _scene(), TCfg(trace_depth=3, antialias=True)
    moved = tparser.replace_camera(scene, tia.apply_key("LEFT", scene.camera, cfg, "cpu").camera)
    film = make_render_fn(moved, cfg, device="cpu")(torch.zeros((256, 3)), prng_key(0), 1)
    step = make_render_fn(moved, dataclasses.replace(cfg, antialias=False), device="cpu")
    for i in (2, 3):
        film = step(film, prng_key(0), i)
    want = tonemap_srgb_u8((film.numpy() / 3).reshape(16, 16, 3))
    np.testing.assert_array_equal(read_png(str(tmp_path / pngs[1])), want)
