"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points refuse to run on the CPU unless asked to."""

import os
import subprocess
import sys
import textwrap

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = textwrap.dedent("""
    import importlib, importlib.util, pkgutil, sys

    BLOCKED = ("jax", "jaxlib", "kdtreepathtraceroptimization_tpu")

    class Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError("blocked import: " + name)
            return None

    sys.meta_path.insert(0, Block())
    import kdtreepathtraceroptimization_tpu_torch as pkg

    names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
    for name in names:
        importlib.import_module(name)
    # the KD route's modules and the command line's are among them
    for name in ("accel.kdtree", "accel.kdtools", "accel.native", "ops.traverse", "cli",
                 "ops.compaction", "ops.kdviz", "render.film", "utils.image",
                 "utils.termview", "render.interactive", "utils.fault",
                 "parallel.sharding", "parallel.multihost", "tools.benchmarks",
                 "tools.charts", "tools.goldens", "tools.scaling", "tools.scene_writer"):
        assert pkg.__name__ + "." + name in names, name
    spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    assert not leaked, leaked
    print("imported", len(names), "modules")
""")


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _CHILD], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "imported" in out.stdout


def test_entry_points_refuse_cpu_without_being_asked():
    from kdtreepathtraceroptimization_tpu_torch.config import RenderConfig
    from kdtreepathtraceroptimization_tpu_torch.render.integrator import render
    from kdtreepathtraceroptimization_tpu_torch.scene.parser import load_scene
    from kdtreepathtraceroptimization_tpu_torch.utils.device import resolve_device

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present, so the default device is valid")
    scene = load_scene(os.path.join(REPO, "scenes", "cornell.txt"), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        render(scene, RenderConfig(trace_depth=1), spp=1)
    with pytest.raises(RuntimeError):
        load_scene(os.path.join(REPO, "scenes", "cornell.txt"))
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
