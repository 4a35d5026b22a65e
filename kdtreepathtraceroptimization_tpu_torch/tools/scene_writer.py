"""Scene-file writer: re-emit a SceneData in the reference keyword
format (the inverse of scene/parser.py; format per scene.cpp:118-271).

The JAX package's ``tools/scene_writer.py`` for the port's scene model:
the same text for the same scene. Scene files hold only the host tables
(materials, camera, geoms), so ``main`` loads the scene on the CPU and
renders nothing.

    python -m kdtreepathtraceroptimization_tpu_torch.tools.scene_writer \
        IN.txt OUT.txt
"""

from __future__ import annotations

import sys

import numpy as np

from kdtreepathtraceroptimization_tpu_torch.scene.structs import (
    GEOM_SPHERE,
    SceneData,
)


def _num(x: float) -> str:
    """Compact numeric formatting (5 -> '5', 0.98 -> '.98')."""
    f = float(x)
    if f == int(f) and abs(f) < 1e9:
        return str(int(f))
    s = f"{f:.6g}"
    return s.replace("0.", ".", 1) if s.startswith("0.") else s


def _vec(v) -> str:
    return " ".join(_num(c) for c in np.asarray(v).ravel())


def write_scene(scene: SceneData, path_or_file) -> None:
    close = False
    if isinstance(path_or_file, str):
        f = open(path_or_file, "w")
        close = True
    else:
        f = path_or_file
    try:
        m = scene.materials
        for i in range(m.count):
            f.write(f"MATERIAL {i}\n")
            f.write(f"RGB         {_vec(m.color[i])}\n")
            f.write(f"SPECEX      {_num(m.specular_exponent[i])}\n")
            f.write(f"SPECRGB     {_vec(m.specular_color[i])}\n")
            f.write(f"REFL        {_num(m.has_reflective[i])}\n")
            f.write(f"REFR        {_num(m.has_refractive[i])}\n")
            f.write(f"REFRIOR     {_num(m.index_of_refraction[i])}\n")
            f.write(f"EMITTANCE   {_num(m.emittance[i])}\n")
            if np.any(np.asarray(m.transmittance[i]) != 0):
                f.write(f"TRANSMITTANCE {_vec(m.transmittance[i])}\n")
            f.write("\n")

        cam = scene.camera
        st = scene.state
        f.write("CAMERA\n")
        f.write(f"RES         {int(cam.resolution[0])} {int(cam.resolution[1])}\n")
        f.write(f"FOVY        {_num(cam.fov[1])}\n")
        f.write(f"ITERATIONS  {int(st.iterations)}\n")
        f.write(f"DEPTH       {int(st.trace_depth)}\n")
        f.write(f"FILE        {st.image_name}\n")
        f.write(f"EYE         {_vec(cam.position)}\n")
        f.write(f"LOOKAT      {_vec(cam.look_at)}\n")
        f.write(f"UP          {_vec(cam.up)}\n\n")

        g = scene.geoms
        if g.translation is None:
            raise ValueError("scene geoms carry no TRS; cannot re-emit")
        for i in range(g.count):
            f.write(f"OBJECT {i}\n")
            f.write("sphere\n" if int(g.type[i]) == GEOM_SPHERE else "cube\n")
            f.write(f"material {int(g.material_id[i])}\n")
            f.write(f"TRANS       {_vec(g.translation[i])}\n")
            f.write(f"ROTAT       {_vec(g.rotation[i])}\n")
            f.write(f"SCALE       {_vec(g.scale[i])}\n\n")
    finally:
        if close:
            f.close()


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 2:
        print(__doc__)
        return 2
    from kdtreepathtraceroptimization_tpu_torch.scene.parser import load_scene

    write_scene(load_scene(argv[0], build_kd=False, device="cpu"), argv[1])
    return 0


if __name__ == "__main__":
    sys.exit(main())
