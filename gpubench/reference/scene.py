"""The plain reference's scene: the scene text and the OBJ, read afresh.

The reference renderer's scene format (MATERIAL, OBJECT and CAMERA blocks)
and a plain OBJ (``v``, ``vn``, ``f a//n``) read into numpy. Nothing here
comes from the program: the benchmark writes these two files and both
sides read them.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

MATERIAL_FIELDS = ("RGB", "SPECEX", "SPECRGB", "REFL", "REFR", "REFRIOR", "EMITTANCE")


class Camera(NamedTuple):
    resolution: tuple  # (width, height)
    position: np.ndarray  # [3] float32
    view: np.ndarray
    up: np.ndarray
    right: np.ndarray
    pixel_length: np.ndarray  # [2] float32


class Geom(NamedTuple):
    kind: str  # "cube" or "sphere"
    material: int
    transform: np.ndarray  # [4, 4] float32
    inverse: np.ndarray


class Scene(NamedTuple):
    camera: Camera
    geoms: list
    materials: dict  # field -> float32 array over material ids
    tris: dict  # v0, v1, v2, n0, n1, n2 [T, 3] float32, material [T] int


def _rot(axis: int, deg: float) -> np.ndarray:
    r = np.deg2rad(deg)
    c, s = np.cos(r), np.sin(r)
    m = np.eye(4)
    i, j = [(1, 2), (0, 2), (0, 1)][axis]
    m[i, i], m[j, j] = c, c
    if axis == 1:
        m[i, j], m[j, i] = s, -s
    else:
        m[i, j], m[j, i] = -s, s
    return m


def transform_matrix(translation, rotation_deg, scale) -> np.ndarray:
    """T Rx Ry Rz S in float64, stored as float32 (the reference renderer's
    buildTransformationMatrix)."""
    t = np.eye(4)
    t[:3, 3] = translation
    s = np.diag([scale[0], scale[1], scale[2], 1.0])
    r = _rot(0, rotation_deg[0]) @ _rot(1, rotation_deg[1]) @ _rot(2, rotation_deg[2])
    return (t @ r @ s).astype(np.float32)


def make_camera(res, fovy_deg, eye, look_at, up) -> Camera:
    eye = np.asarray(eye, np.float32)
    look_at = np.asarray(look_at, np.float32)
    up = np.asarray(up, np.float32)
    yscaled = np.tan(np.deg2rad(fovy_deg))
    xscaled = yscaled * res[0] / res[1]
    pixel_length = np.array([2.0 * xscaled / res[0], 2.0 * yscaled / res[1]], np.float32)
    view = look_at - eye
    view = view / np.linalg.norm(view)
    right = np.cross(view, up)
    right = right / np.linalg.norm(right)
    up_ortho = np.cross(right, view)
    up_ortho = up_ortho / np.linalg.norm(up_ortho)
    return Camera((int(res[0]), int(res[1])), eye, view.astype(np.float32),
                  up_ortho.astype(np.float32), right.astype(np.float32), pixel_length)


def _lines(text: str):
    for raw in text.splitlines():
        line = raw.strip()
        yield line if line and not line.startswith("//") else ""


def parse_scene(text: str, resolution=None):
    """(camera, geoms, materials) of a scene text; ``resolution`` (w, h)
    replaces the file's RES."""
    lines = list(_lines(text))
    i = 0
    mats, geoms, cam = {}, [], None

    def next_nonblank():
        nonlocal i
        while i < len(lines) and not lines[i]:
            i += 1
        i += 1
        return lines[i - 1].split()

    while i < len(lines):
        if not lines[i]:
            i += 1
            continue
        tok = lines[i].split()
        i += 1
        head = tok[0].upper()
        if head == "MATERIAL":
            props = {}
            for _ in range(len(MATERIAL_FIELDS)):
                t = next_nonblank()
                props[t[0].upper()] = [float(v) for v in t[1:]]
            mats[int(tok[1])] = props
        elif head == "OBJECT":
            kind = next_nonblank()[0].lower()
            material = int(next_nonblank()[1])
            trs = {}
            for _ in range(3):
                t = next_nonblank()
                trs[t[0].upper()] = [float(v) for v in t[1:4]]
            m = transform_matrix(trs["TRANS"], trs["ROTAT"], trs["SCALE"])
            inv = np.linalg.inv(m.astype(np.float64)).astype(np.float32)
            geoms.append(Geom("sphere" if "sphere" in kind else "cube", material, m, inv))
        elif head == "CAMERA":
            fields = {}
            while i < len(lines) and lines[i]:
                t = lines[i].split()
                fields[t[0].upper()] = t[1:]
                i += 1
            res = resolution or (int(fields["RES"][0]), int(fields["RES"][1]))
            cam = make_camera(res, float(fields["FOVY"][0]),
                              [float(v) for v in fields["EYE"]],
                              [float(v) for v in fields["LOOKAT"]],
                              [float(v) for v in fields["UP"]])
    ids = range(max(mats) + 1)
    materials = {
        "color": np.array([mats[k]["RGB"] for k in ids], np.float32),
        "specular_color": np.array([mats[k]["SPECRGB"] for k in ids], np.float32),
        "has_reflective": np.array([mats[k]["REFL"][0] for k in ids], np.float32),
        "has_refractive": np.array([mats[k]["REFR"][0] for k in ids], np.float32),
        "emittance": np.array([mats[k]["EMITTANCE"][0] for k in ids], np.float32),
        "transmittance": np.zeros((len(ids), 3), np.float32),
    }
    return cam, geoms, materials


def parse_obj(path):
    """Triangles of a plain OBJ: corners and vertex normals [T, 3] each."""
    v, vn, faces = [], [], []
    with open(path) as f:
        for line in f:
            t = line.split()
            if not t:
                continue
            if t[0] == "v":
                v.append([float(x) for x in t[1:4]])
            elif t[0] == "vn":
                vn.append([float(x) for x in t[1:4]])
            elif t[0] == "f":
                faces.append([[int(x) - 1 for x in c.split("//")] for c in t[1:4]])
    v = np.asarray(v, np.float32)
    vn = np.asarray(vn, np.float32)
    f = np.asarray(faces, np.int64)  # [T, 3 corners, (v, n)]
    return {"v0": v[f[:, 0, 0]], "v1": v[f[:, 1, 0]], "v2": v[f[:, 2, 0]],
            "n0": vn[f[:, 0, 1]], "n1": vn[f[:, 1, 1]], "n2": vn[f[:, 2, 1]]}


def load(scene_path, obj_path=None, resolution=None) -> Scene:
    """The scene and its mesh. An OBJ without materials takes one white
    diffuse material after the scene's own (the reference renderer's
    default for a mesh with no MTL)."""
    with open(scene_path) as f:
        cam, geoms, mats = parse_scene(f.read(), resolution)
    tris = None
    if obj_path is not None:
        tris = parse_obj(obj_path)
        n = mats["emittance"].shape[0]
        tris["material"] = np.full((tris["v0"].shape[0],), n, np.int64)
        white = {"color": [1.0, 1.0, 1.0], "specular_color": [0.0, 0.0, 0.0],
                 "has_reflective": 0.0, "has_refractive": 0.0, "emittance": 0.0,
                 "transmittance": [0.0, 0.0, 0.0]}
        mats = {k: np.concatenate([a, np.asarray([white[k]], np.float32).reshape(
            (1,) + a.shape[1:])]) for k, a in mats.items()}
    return Scene(cam, geoms, mats, tris)
