"""Text scene-file parser, keyword-compatible with the reference format.

The port's copy of the JAX package's ``scene/parser.py``: the MATERIAL /
OBJECT / CAMERA block format of scenes/*.txt (reference:
src/scene.cpp:7-271), parsed in numpy into the same arrays. Only
``load_scene`` differs: it puts the mesh, KD and cluster tables on a
device.

Divergence from the reference (as in the JAX package): the camera basis
is ``right = normalize(cross(view, up))``, ``up = cross(right, view)``
from the start, where the reference computes ``right`` from an
uninitialized ``view`` until the first camera move (scene.cpp:221,
main.cpp:1118-1123).
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from kdtreepathtraceroptimization_tpu_torch.accel.kdtree import build_kdtree_from_mesh
from kdtreepathtraceroptimization_tpu_torch.convert import scene_from_numpy
from kdtreepathtraceroptimization_tpu_torch.ops.cluster import build_cluster_mesh
from kdtreepathtraceroptimization_tpu_torch.ops.pairs import MAX_CLUSTER_BLOCKS
from kdtreepathtraceroptimization_tpu_torch.ops.vecmath import build_transformation_matrix
from kdtreepathtraceroptimization_tpu_torch.scene.obj_loader import load_obj
from kdtreepathtraceroptimization_tpu_torch.scene.structs import (
    GEOM_CUBE,
    GEOM_SPHERE,
    Camera,
    GeomSoA,
    MaterialSoA,
    RenderState,
    SceneData,
    concat_materials,
)
from kdtreepathtraceroptimization_tpu_torch.utils.device import resolve_device


def _tokenize(line: str) -> List[str]:
    return line.split()


def _is_comment(line: str) -> bool:
    s = line.strip()
    return s.startswith("//") or s.startswith("#")


class _Reader:
    def __init__(self, text: str):
        self.lines = text.splitlines()
        self.pos = 0

    def next_line(self) -> Optional[str]:
        """Next non-empty, non-comment line (like safeGetline + skip)."""
        while self.pos < len(self.lines):
            line = self.lines[self.pos]
            self.pos += 1
            if line.strip() and not _is_comment(line):
                return line
        return None

    def next_raw(self) -> Optional[str]:
        """Next line verbatim (empty line terminates a block, like the
        reference's ``while (!line.empty())`` loops)."""
        while self.pos < len(self.lines):
            line = self.lines[self.pos]
            self.pos += 1
            if _is_comment(line):
                continue
            return line
        return None


def _make_camera(res, fovy_deg, eye, look_at, up) -> Camera:
    res = np.asarray(res, np.int32)
    eye = np.asarray(eye, np.float32)
    look_at = np.asarray(look_at, np.float32)
    up = np.asarray(up, np.float32)

    # fov.x from aspect (reference: scene.cpp:217-220)
    yscaled = np.tan(np.deg2rad(fovy_deg))
    xscaled = yscaled * res[0] / res[1]
    fovx_deg = np.rad2deg(np.arctan(xscaled))
    pixel_length = np.array(
        [2.0 * xscaled / res[0], 2.0 * yscaled / res[1]], np.float32
    )

    view = look_at - eye
    view = view / np.linalg.norm(view)
    right = np.cross(view, up)
    right = right / np.linalg.norm(right)
    up_ortho = np.cross(right, view)
    up_ortho = up_ortho / np.linalg.norm(up_ortho)

    return Camera(
        resolution=res,
        position=eye,
        look_at=look_at,
        view=view.astype(np.float32),
        up=up_ortho.astype(np.float32),
        right=right.astype(np.float32),
        fov=np.array([fovx_deg, fovy_deg], np.float32),
        pixel_length=pixel_length,
    )


def with_resolution(scene: SceneData, width: int, height: int) -> SceneData:
    """Return the scene with camera resolution changed and the derived
    pixel_length/fov recomputed (avoids stale pixel_length)."""
    cam = scene.camera
    new_cam = _make_camera(
        [width, height], float(cam.fov[1]), cam.position, cam.look_at, cam.up
    )
    return scene._replace(camera=new_cam)


def replace_camera(scene: SceneData, camera) -> SceneData:
    """Return the scene with ``camera`` swapped in (the interactive orbit
    and pan rebuild the camera through ``ops.camera.derive_camera``)."""
    return scene._replace(camera=camera)


def load_scene(
    path: str,
    obj_path: Optional[str] = None,
    mtl_dir: Optional[str] = None,
    build_kd: bool = True,
    leaf_size: int = 32,
    max_depth: Optional[int] = None,
    build_cluster: bool = True,
    cluster_block: int = 256,
    device=None,
) -> SceneData:
    """Load a reference-format scene file, optionally with an OBJ mesh, its
    KD tree (``build_kd``, ``leaf_size``, ``max_depth``: the JAX package's
    defaults) and its cluster table, onto ``device`` (the CUDA device by
    default).

    OBJ materials are appended after the scene materials and triangle
    material ids offset accordingly (reference: scene.cpp:7-57, 579).
    """
    device = resolve_device(device)
    with open(path, "r") as f:
        text = f.read()
    scene = parse_scene_text(text, name=os.path.basename(path))
    if obj_path is not None:
        mesh, obj_mats = load_obj(
            obj_path, mtl_dir, material_offset=scene.materials.count
        )
        materials = concat_materials(scene.materials, obj_mats)
        kd = None
        if build_kd:
            kd = build_kdtree_from_mesh(mesh, leaf_size=leaf_size, max_depth=max_depth)
        cmesh = None
        if build_cluster:
            # Meshes past the 13-bit block-id cap take bigger blocks: the
            # build targets <= MAX_CLUSTER_BLOCKS / 2 blocks of at most
            # 1024 triangles (the 10-bit in-block id), and skips the
            # table beyond that.
            for blk_size in (cluster_block, 512, 1024):
                if (blk_size >= cluster_block
                        and mesh.v0.shape[0]
                        <= (MAX_CLUSTER_BLOCKS // 2) * blk_size):
                    cmesh = build_cluster_mesh(mesh, block=blk_size,
                                               device=device)
                    break
        scene = scene._replace(mesh=mesh, materials=materials, kd=kd, cmesh=cmesh)
    return scene_from_numpy(scene, device)


def parse_scene_text(text: str, name: str = "<string>") -> SceneData:
    reader = _Reader(text)

    materials = {}
    geoms = []
    camera = None
    iterations = 0
    trace_depth = 8
    image_name = "render"

    while True:
        line = reader.next_line()
        if line is None:
            break
        tokens = _tokenize(line)
        head = tokens[0].upper()

        if head == "MATERIAL":
            mid = int(tokens[1])
            # 7 fixed property lines (reference: scene.cpp:243-266), plus
            # our TRANSMITTANCE extension (the reference only gets
            # transmittance from MTL files).
            props = {
                "RGB": [0.0, 0.0, 0.0],
                "SPECEX": 0.0,
                "SPECRGB": [0.0, 0.0, 0.0],
                "REFL": 0.0,
                "REFR": 0.0,
                "REFRIOR": 0.0,
                "EMITTANCE": 0.0,
                "TRANSMITTANCE": [0.0, 0.0, 0.0],
            }
            for _ in range(7):
                pline = reader.next_line()
                if pline is None:
                    break
                ptok = _tokenize(pline)
                key = ptok[0].upper()
                vals = [float(v) for v in ptok[1:]]
                if key in ("RGB", "SPECRGB", "TRANSMITTANCE"):
                    props[key] = vals[:3]
                elif key in props:
                    props[key] = vals[0]
            # Optional extension line
            save = reader.pos
            pline = reader.next_raw()
            if pline is not None and pline.strip():
                ptok = _tokenize(pline)
                if ptok[0].upper() == "TRANSMITTANCE":
                    props["TRANSMITTANCE"] = [float(v) for v in ptok[1:4]]
                else:
                    reader.pos = save
            materials[mid] = props

        elif head == "OBJECT":
            shape_line = reader.next_line()
            shape = shape_line.strip().lower()
            gtype = GEOM_SPHERE if "sphere" in shape else GEOM_CUBE
            mat_line = _tokenize(reader.next_line())
            material_id = int(mat_line[1])
            trans = [0.0, 0.0, 0.0]
            rotat = [0.0, 0.0, 0.0]
            scale = [1.0, 1.0, 1.0]
            for _ in range(3):
                pline = reader.next_line()
                if pline is None:
                    break
                ptok = _tokenize(pline)
                key = ptok[0].upper()
                vals = [float(v) for v in ptok[1:4]]
                if key == "TRANS":
                    trans = vals
                elif key == "ROTAT":
                    rotat = vals
                elif key == "SCALE":
                    scale = vals
            geoms.append((gtype, material_id, trans, rotat, scale))

        elif head == "CAMERA":
            res = [800, 800]
            fovy = 45.0
            eye = [0.0, 0.0, 0.0]
            look_at = [0.0, 0.0, -1.0]
            up = [0.0, 1.0, 0.0]
            # 5 static lines (scene.cpp:182-198) then EYE/LOOKAT/UP until
            # blank (scene.cpp:201-214).
            for _ in range(5):
                pline = reader.next_line()
                if pline is None:
                    break
                ptok = _tokenize(pline)
                key = ptok[0].upper()
                if key == "RES":
                    res = [int(ptok[1]), int(ptok[2])]
                elif key == "FOVY":
                    fovy = float(ptok[1])
                elif key == "ITERATIONS":
                    iterations = int(ptok[1])
                elif key == "DEPTH":
                    trace_depth = int(ptok[1])
                elif key == "FILE":
                    image_name = ptok[1]
            while True:
                pline = reader.next_raw()
                if pline is None or not pline.strip():
                    break
                ptok = _tokenize(pline)
                key = ptok[0].upper()
                vals = [float(v) for v in ptok[1:4]]
                if key == "EYE":
                    eye = vals
                elif key == "LOOKAT":
                    look_at = vals
                elif key == "UP":
                    up = vals
                else:
                    reader.pos -= 1
                    break
            camera = _make_camera(res, fovy, eye, look_at, up)

    if camera is None:
        raise ValueError(f"scene {name!r} has no CAMERA block")

    # Assemble material SoA in id order (dense 0..max like the reference's
    # vector indexed by id).
    n_mat = (max(materials) + 1) if materials else 0
    default = {
        "RGB": [0.0, 0.0, 0.0],
        "SPECEX": 0.0,
        "SPECRGB": [0.0, 0.0, 0.0],
        "REFL": 0.0,
        "REFR": 0.0,
        "REFRIOR": 0.0,
        "EMITTANCE": 0.0,
        "TRANSMITTANCE": [0.0, 0.0, 0.0],
    }
    mats = [materials.get(i, default) for i in range(n_mat)]
    material_soa = MaterialSoA(
        color=np.array([m["RGB"] for m in mats], np.float32).reshape(n_mat, 3),
        specular_exponent=np.array([m["SPECEX"] for m in mats], np.float32),
        specular_color=np.array([m["SPECRGB"] for m in mats], np.float32).reshape(n_mat, 3),
        has_reflective=np.array([m["REFL"] for m in mats], np.float32),
        has_refractive=np.array([m["REFR"] for m in mats], np.float32),
        index_of_refraction=np.array([m["REFRIOR"] for m in mats], np.float32),
        emittance=np.array([m["EMITTANCE"] for m in mats], np.float32),
        transmittance=np.array([m["TRANSMITTANCE"] for m in mats], np.float32).reshape(n_mat, 3),
    )

    n_geom = len(geoms)
    transforms = np.stack(
        [build_transformation_matrix(t, r, s) for (_, _, t, r, s) in geoms]
    ) if n_geom else np.zeros((0, 4, 4), np.float32)
    inverses = (
        np.linalg.inv(transforms.astype(np.float64)).astype(np.float32)
        if n_geom
        else np.zeros((0, 4, 4), np.float32)
    )
    geom_soa = GeomSoA(
        type=np.array([g[0] for g in geoms], np.int32),
        material_id=np.array([g[1] for g in geoms], np.int32),
        transform=transforms,
        inverse_transform=inverses,
        inv_transpose=np.transpose(inverses, (0, 2, 1)).copy(),
        translation=np.array([g[2] for g in geoms], np.float32).reshape(n_geom, 3),
        rotation=np.array([g[3] for g in geoms], np.float32).reshape(n_geom, 3),
        scale=np.array([g[4] for g in geoms], np.float32).reshape(n_geom, 3),
    )

    return SceneData(
        camera=camera,
        geoms=geom_soa,
        materials=material_soa,
        state=RenderState(
            iterations=iterations, trace_depth=trace_depth, image_name=image_name
        ),
    )
