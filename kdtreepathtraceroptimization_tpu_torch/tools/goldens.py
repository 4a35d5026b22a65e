"""Golden-image cases: the JAX package's ``tools/goldens.py`` for the port.

``CASES`` holds the JAX package's golden cases (the same scenes, configs,
spp and seed 0); the port's golden tests and ``chip_smoke.py`` read their
cases from it. The committed goldens in ``tests/goldens`` are the JAX
package's renders and stay frozen: ``main`` writes the port's renders of
the cases to another directory, for comparison, and refuses that one.

    python -m kdtreepathtraceroptimization_tpu_torch.tools.goldens OUTDIR [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np

from kdtreepathtraceroptimization_tpu_torch.config import RenderConfig

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
GOLDEN_DIR = os.path.join(_REPO, "tests", "goldens")
CORNELL = os.path.join(_REPO, "scenes", "cornell.txt")


def _cornell_scene(res, device):
    from kdtreepathtraceroptimization_tpu_torch.scene.parser import load_scene, with_resolution

    return with_resolution(load_scene(CORNELL, device=device), res, res)


def _mesh_scene(res, device, subdiv=2):
    from kdtreepathtraceroptimization_tpu_torch.scene.parser import load_scene, with_resolution
    from kdtreepathtraceroptimization_tpu_torch.utils.procmesh import icosphere, write_obj

    verts, faces = icosphere(subdiv, radius=2.0, center=(0.0, 3.0, 0.0))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, f"icosphere{subdiv}.obj")
        write_obj(path, verts, faces)
        scene = load_scene(CORNELL, obj_path=path, device=device)
    return with_resolution(scene, res, res)


# name -> (make_scene(device), config, spp); seed 0.
CASES = {
    "cornell_64": (
        lambda device: _cornell_scene(64, device),
        RenderConfig(trace_depth=8, antialias=True),
        8,
    ),
    "cornell_spec_64": (
        lambda device: _cornell_scene(64, device),
        RenderConfig(trace_depth=8, antialias=False, enable_sss=True),
        8,
    ),
    "mesh_kd_48": (
        lambda device: _mesh_scene(48, device),
        RenderConfig(trace_depth=4, enable_kd=True),
        8,
    ),
    # the pair-list path at mesh scale (5,120 triangles)
    "mesh_pairs_48": (
        lambda device: _mesh_scene(48, device, subdiv=4),
        RenderConfig(trace_depth=4, cluster=True, cluster_pairs=True, cluster_tile=256),
        8,
    ),
}


def render_case(name: str, device=None) -> np.ndarray:
    """The port's render of case ``name`` on ``device`` (the CUDA device by
    default), [H, W, 3] float32 on the host."""
    from kdtreepathtraceroptimization_tpu_torch.render.integrator import render

    make_scene, config, spp = CASES[name]
    return render(make_scene(device), config, spp=spp, seed=0, device=device).cpu().numpy()


def main(outdir: str, device=None) -> int:
    """Write each case's render to ``outdir/<name>.npy``. ``tests/goldens``
    is refused: its files are the JAX package's, frozen."""
    if os.path.realpath(outdir) == os.path.realpath(GOLDEN_DIR):
        raise ValueError(f"{GOLDEN_DIR} holds the JAX package's goldens, which stay frozen: "
                         f"write the port's renders elsewhere")
    os.makedirs(outdir, exist_ok=True)
    for name in CASES:
        img = render_case(name, device)
        path = os.path.join(outdir, f"{name}.npy")
        np.save(path, img.astype(np.float32))
        print(f"wrote {path}  shape={img.shape} mean={img.mean():.4f}")
    return 0


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("outdir")
    p.add_argument("--device", default="cuda")
    args = p.parse_args()
    sys.exit(main(args.outdir, args.device))
