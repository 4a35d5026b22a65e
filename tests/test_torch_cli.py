"""The port's command line against the JAX package's, on the CPU.

``cli.main([..., "--device", "cpu"])`` and the JAX package's ``cli.main``
run with the same flags on ``scenes/cornell.txt`` and an icosphere OBJ at
16x16, each in its own working directory (the CLI writes there). The
films are compared through the ``--save-every`` checkpoints: ``accum``
over its iterations within the golden tests' atol 2e-3 a pixel
(tests/test_torch_render.py), iteration and seed equal. The port's own
resumed film equals its uninterrupted film bit for bit, and its output
files are the ones its film gives.
"""

import contextlib
import glob
import json
import os

import jax
import numpy as np
import pytest
import torch

from kdtreepathtraceroptimization_tpu import cli as jcli
from kdtreepathtraceroptimization_tpu.config import RenderConfig as JCfg
from kdtreepathtraceroptimization_tpu.ops import vecmath as jvm
from kdtreepathtraceroptimization_tpu.ops.camera import generate_rays as jgenerate_rays
from kdtreepathtraceroptimization_tpu.ops.kdviz import render_kd_boxes as jrender_kd_boxes
from kdtreepathtraceroptimization_tpu.ops.rng import bounce_key as jbounce_key
from kdtreepathtraceroptimization_tpu.scene import parser as jparser
from kdtreepathtraceroptimization_tpu_torch import cli
from kdtreepathtraceroptimization_tpu_torch.config import RenderConfig as TCfg
from kdtreepathtraceroptimization_tpu_torch.ops.rng import prng_key
from kdtreepathtraceroptimization_tpu_torch.render.integrator import make_render_fn
from kdtreepathtraceroptimization_tpu_torch.render.film import tonemap_srgb_u8
from kdtreepathtraceroptimization_tpu_torch.scene import parser as tparser
from kdtreepathtraceroptimization_tpu_torch.utils import trace
from kdtreepathtraceroptimization_tpu_torch.utils.image import read_png, write_hdr
from tests.test_torch_render import CORNELL, _mesh_obj

ATOL = 2e-3
BASE = ["--res", "16", "16", "--depth", "3", "--aa"]


@contextlib.contextmanager
def _cwd(path):
    old = os.getcwd()
    os.makedirs(path, exist_ok=True)
    os.chdir(path)
    try:
        yield path
    finally:
        os.chdir(old)


def _run(main, workdir, args, port=True):
    """Run one CLI in ``workdir`` -> (exit code, its checkpoint or None)."""
    with _cwd(workdir):
        rc = main(args + (["--device", "cpu"] if port else []))
        ckpt = glob.glob("cornell.ckpt.npz")
        return rc, (dict(np.load(ckpt[0])) if ckpt else None)


@pytest.mark.parametrize("subdiv, flags", [
    (2, []),  # a 320-triangle sphere: the KD walk
    (3, []),  # 1,280 triangles: the pair list
    (2, ["--compaction", "--material-sort"]),
    (2, ["--ray-cache"]),
    (2, ["--short-stack"]),
    (2, ["--no-kd"]),
], ids=["kd", "pairs", "reorder", "ray_cache", "short_stack", "no_kd"])
def test_cli_matches_jax(tmp_path, subdiv, flags):
    """Each flag set renders the JAX CLI's film (2 spp, checkpointed)."""
    args = [CORNELL, _mesh_obj(tmp_path, subdiv, 2.0), *BASE, "--spp", "2", "--save-every", "2",
            *flags]
    rc_t, got = _run(cli.main, tmp_path / "port", args)
    rc_j, want = _run(jcli.main, tmp_path / "jax", args, port=False)
    assert rc_t == rc_j == 0
    assert int(got["iteration"]) == int(want["iteration"]) == 2
    assert int(got["seed"]) == int(want["seed"])
    assert got["accum"].max() > 0
    np.testing.assert_allclose(got["accum"] / 2, want["accum"] / 2, atol=ATOL)


def test_cli_resume_bit_equal(tmp_path):
    """--spp 2 --save-every 2, then --resume to --spp 4: the film equals an
    uninterrupted 4-spp film bit for bit; --unroll-bounces changes nothing."""
    args = [CORNELL, _mesh_obj(tmp_path, 2, 2.0), *BASE, "--save-every", "2"]
    part = tmp_path / "part"
    assert _run(cli.main, part, args + ["--spp", "2"])[0] == 0
    rc, resumed = _run(cli.main, part, args + ["--spp", "4", "--resume", "cornell.ckpt.npz"])
    assert rc == 0 and int(resumed["iteration"]) == 4
    rc, straight = _run(cli.main, tmp_path / "straight", args + ["--spp", "4"])
    assert rc == 0
    np.testing.assert_array_equal(resumed["accum"], straight["accum"])
    rc, unrolled = _run(cli.main, tmp_path / "unroll", args + ["--spp", "4", "--unroll-bounces"])
    np.testing.assert_array_equal(unrolled["accum"], straight["accum"])


def test_cli_resumes_a_jax_checkpoint(tmp_path):
    """A checkpoint the JAX CLI wrote after 2 iterations, resumed by the
    port to 4, agrees with the port's own 4-iteration film."""
    args = [CORNELL, _mesh_obj(tmp_path, 2, 2.0), *BASE]
    jdir = tmp_path / "jax"
    assert _run(jcli.main, jdir, args + ["--spp", "2", "--save-every", "2"], port=False)[0] == 0
    resume = ["--resume", str(jdir / "cornell.ckpt.npz"), "--spp", "4", "--save-every", "4"]
    rc, got = _run(cli.main, tmp_path / "port", args + resume)
    rc2, own = _run(cli.main, tmp_path / "own", args + ["--spp", "4", "--save-every", "4"])
    assert rc == rc2 == 0
    np.testing.assert_allclose(got["accum"] / 4, own["accum"] / 4, atol=ATOL)


def test_cli_outputs(tmp_path, capsys, monkeypatch):
    """--benchmark prints the JAX CLI's JSON line; the PNG (read back by
    read_png) and the .hdr are the tonemapped film and write_hdr's file of
    it; --live draws frames; --profile writes a trace; --print-kd-stats
    prints the JAX CLI's statistics and writes its box dump; --viz-kd
    writes the JAX package's render_kd_boxes image within one 8-bit step;
    --interactive with no key for --spp 3 iterations writes the PNG of the
    same 3-iteration film."""
    obj = _mesh_obj(tmp_path, 2, 2.0)
    args = [CORNELL, obj, *BASE]
    rc, film = _run(cli.main, tmp_path / "a", args + [
        "--spp", "3", "--save-every", "3", "--benchmark", "--hdr", "--live", "1",
        "--profile", "prof", "--print-kd-stats"])
    out = capsys.readouterr().out
    assert rc == 0
    bench = json.loads([line for line in out.splitlines() if line.startswith("{")][-1])
    assert bench["metric"] == "ms/iteration" and bench["iterations"] == 3 and bench["value"] > 0
    assert "iter 1\n" in out and "iter 3\n" in out and "\x1b[2Kiter 2" in out
    img = film["accum"].reshape(16, 16, 3) / 3
    png, = glob.glob(str(tmp_path / "a" / "cornell.*.3samp.png"))
    np.testing.assert_array_equal(read_png(png), tonemap_srgb_u8(img))
    write_hdr(str(tmp_path / "want.hdr"), img)
    hdr, = glob.glob(str(tmp_path / "a" / "cornell.*.3samp.hdr"))
    assert open(hdr, "rb").read() == (tmp_path / "want.hdr").read_bytes()
    assert os.path.getsize(tmp_path / "a" / "prof" / "trace.json") > 0
    # the profiled iterations carry the port's stage spans; tracing is off again after
    names = {e.get("name") for e in json.loads(
        (tmp_path / "a" / "prof" / "trace.json").read_text())["traceEvents"]}
    assert {"kdpt.frame", "kdpt.bounce"} <= names
    assert not trace.enabled()

    assert _run(jcli.main, tmp_path / "j", args + ["--spp", "1", "--print-kd-stats"],
                port=False)[0] == 0
    jout = capsys.readouterr().out
    stats = [line for line in (out, jout) for line in line.splitlines() if line.startswith("kd:")]
    assert len(stats) == 2 and stats[0] == stats[1]
    assert ((tmp_path / "a" / "cornell.kdboxes.txt").read_text()
            == (tmp_path / "j" / "cornell.kdboxes.txt").read_text())

    assert _run(cli.main, tmp_path / "v", args + ["--viz-kd", "-o", "viz.png"])[0] == 0
    jscene = jparser.with_resolution(jparser.load_scene(CORNELL, obj_path=obj), 16, 16)
    rays = jgenerate_rays(jscene.camera, JCfg(trace_depth=3, antialias=True),
                          jbounce_key(jax.random.PRNGKey(0), 1, 0), 1)
    want = jrender_kd_boxes(jvm.v3_to_rows(rays.origin), jvm.v3_to_rows(rays.direction),
                            jscene.kd)
    a = read_png(str(tmp_path / "v" / "viz.png")).astype(int)
    b = tonemap_srgb_u8(np.asarray(want).reshape(16, 16, 3)).astype(int)
    assert a.max() > 0 and np.abs(a - b).max() <= 1
    # the JAX CLI's own --viz-kd hands its V3 rays to render_kd_boxes,
    # which wants [N, 3] rows (JAX cli.py:189-193): it raises
    with pytest.raises(AttributeError):
        _run(jcli.main, tmp_path / "vj", args + ["--viz-kd", "-o", "viz.png"], port=False)
    from kdtreepathtraceroptimization_tpu_torch.render import interactive

    monkeypatch.setattr(interactive, "_read_key", lambda timeout_s: None)
    assert _run(cli.main, tmp_path / "i", args + ["--interactive", "--spp", "3", "-o",
                                                  "inter.png"])[0] == 0
    np.testing.assert_array_equal(read_png(str(tmp_path / "i" / "inter.png")),
                                  tonemap_srgb_u8(img))


def test_cli_ray_cache_follows_seed(tmp_path):
    """--ray-cache --seed 3 caches the camera rays of seed 3 (the film is
    make_render_fn(seed=3)'s bit for bit), where the JAX CLI caches seed
    0's whatever --seed says (it builds make_render_fn without the seed,
    JAX cli.py:209)."""
    obj = _mesh_obj(tmp_path, 2, 2.0)
    rc, got = _run(cli.main, tmp_path / "p", [CORNELL, obj, *BASE, "--spp", "2", "--save-every",
                                              "2", "--ray-cache", "--seed", "3"])
    assert rc == 0
    scene = tparser.with_resolution(tparser.load_scene(CORNELL, obj_path=obj, device="cpu"),
                                    16, 16)
    step = make_render_fn(scene, TCfg(trace_depth=3, antialias=True, ray_cache=True), seed=3,
                          device="cpu")
    film = torch.zeros((256, 3))
    for it in (1, 2):
        film = step(film, prng_key(3), it)
    np.testing.assert_array_equal(got["accum"], film.numpy())


def test_cli_runs_on_cuda_unless_asked(tmp_path):
    """Without --device the CLI asks for CUDA, and without it raises
    instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present, so the default device is valid")
    with _cwd(tmp_path), pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main([CORNELL, "--res", "8", "8", "--spp", "1"])
