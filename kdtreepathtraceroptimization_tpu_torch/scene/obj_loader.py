"""Pure-Python OBJ/MTL loader producing SoA triangle arrays.

Replaces the vendored tiny_obj_loader (reference: src/tiny_obj_loader.h,
src/objmesh.cpp) and the flattening pass in Scene::loadObj (reference:
src/scene.cpp:579-903): vertices/normals are pre-gathered per triangle so
the device arrays need no index indirection, faces are fan-triangulated
(tinyobj triangulate=true, objmesh.cpp:14), per-shape AABBs are computed
(scene.cpp:692-711), and MTL illum models map onto the path tracer's
Material the same way (scene.cpp:716-821):

    illum <= 2 -> diffuse        (color = max(Ka, Kd) per channel)
    illum == 3 -> mirror         (REFL=1, specular = Ks)
    else       -> refract+reflect (REFL=1, REFR=1, IOR = Ni)

Transmittance (Tf) is copied through for subsurface scattering
(scene.cpp:793). Missing normals are filled with face normals.

The port's own copy of the JAX package's ``scene/obj_loader.py`` (numpy
only): the loaded arrays are the same bit for bit.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from kdtreepathtraceroptimization_tpu_torch.scene.structs import MaterialSoA, MeshSoA


@dataclass
class MtlMaterial:
    name: str = ""
    ambient: Tuple[float, float, float] = (0.0, 0.0, 0.0)  # Ka
    diffuse: Tuple[float, float, float] = (0.0, 0.0, 0.0)  # Kd
    specular: Tuple[float, float, float] = (0.0, 0.0, 0.0)  # Ks
    transmittance: Tuple[float, float, float] = (0.0, 0.0, 0.0)  # Tf
    emission: Tuple[float, float, float] = (0.0, 0.0, 0.0)  # Ke
    shininess: float = 1.0  # Ns
    ior: float = 1.0  # Ni
    dissolve: float = 1.0  # d
    illum: int = 0


def _parse_floats(tokens: List[str], n: int) -> Tuple[float, ...]:
    vals = [float(t) for t in tokens[:n]]
    while len(vals) < n:
        vals.append(vals[-1] if vals else 0.0)
    return tuple(vals)


def load_mtl(path: str) -> Dict[str, MtlMaterial]:
    """Parse a .mtl file (reference: tiny_obj_loader LoadMtl)."""
    mats: Dict[str, MtlMaterial] = {}
    cur: Optional[MtlMaterial] = None
    if not os.path.exists(path):
        return mats
    with open(path, "r", errors="replace") as f:
        for line in f:
            tokens = line.split()
            if not tokens or tokens[0].startswith("#"):
                continue
            key = tokens[0]
            if key == "newmtl":
                cur = MtlMaterial(name=tokens[1] if len(tokens) > 1 else "")
                mats[cur.name] = cur
            elif cur is None:
                continue
            elif key == "Ka":
                cur.ambient = _parse_floats(tokens[1:], 3)
            elif key == "Kd":
                cur.diffuse = _parse_floats(tokens[1:], 3)
            elif key == "Ks":
                cur.specular = _parse_floats(tokens[1:], 3)
            elif key in ("Tf", "Kt"):
                cur.transmittance = _parse_floats(tokens[1:], 3)
            elif key == "Ke":
                cur.emission = _parse_floats(tokens[1:], 3)
            elif key == "Ns":
                cur.shininess = float(tokens[1])
            elif key == "Ni":
                cur.ior = float(tokens[1])
            elif key == "d":
                cur.dissolve = float(tokens[1])
            elif key == "Tr":
                cur.dissolve = 1.0 - float(tokens[1])
            elif key == "illum":
                cur.illum = int(float(tokens[1]))
    return mats


def _resolve_index(idx: int, count: int) -> int:
    """OBJ 1-based indices; negative = relative to end."""
    return idx - 1 if idx > 0 else count + idx


@dataclass
class ObjData:
    """Raw parse result before SoA packing."""

    vertices: np.ndarray  # [V, 3]
    normals: np.ndarray  # [VN, 3]
    # Per-triangle index triples and attribution
    tri_v: np.ndarray  # [T, 3] vertex indices
    tri_n: np.ndarray  # [T, 3] normal indices (-1 = missing)
    tri_mtl: np.ndarray  # [T] material index into `materials` (-1 = none)
    tri_shape: np.ndarray  # [T] shape index
    materials: List[MtlMaterial] = field(default_factory=list)
    shape_names: List[str] = field(default_factory=list)


def parse_obj(path: str, mtl_dir: Optional[str] = None) -> ObjData:
    """Parse an OBJ file with fan triangulation.

    Shapes split on ``o``/``g`` tags like tinyobj; ``usemtl`` sets the
    active material for subsequent faces.
    """
    mtl_dir = mtl_dir or os.path.dirname(os.path.abspath(path))
    verts: List[Tuple[float, float, float]] = []
    norms: List[Tuple[float, float, float]] = []
    tri_v: List[Tuple[int, int, int]] = []
    tri_n: List[Tuple[int, int, int]] = []
    tri_mtl: List[int] = []
    tri_shape: List[int] = []
    materials: List[MtlMaterial] = []
    mat_index: Dict[str, int] = {}
    shape_names: List[str] = ["default"]
    cur_shape = 0
    shape_used = False
    cur_mtl = -1

    with open(path, "r", errors="replace") as f:
        for line in f:
            tokens = line.split()
            if not tokens or tokens[0].startswith("#"):
                continue
            key = tokens[0]
            if key == "v":
                verts.append(_parse_floats(tokens[1:], 3))
            elif key == "vn":
                norms.append(_parse_floats(tokens[1:], 3))
            elif key == "f":
                corners = []
                for tok in tokens[1:]:
                    parts = tok.split("/")
                    vi = _resolve_index(int(parts[0]), len(verts))
                    ni = -1
                    if len(parts) >= 3 and parts[2]:
                        ni = _resolve_index(int(parts[2]), len(norms))
                    corners.append((vi, ni))
                # fan triangulation (tinyobj triangulate=true)
                for k in range(1, len(corners) - 1):
                    tri_v.append((corners[0][0], corners[k][0], corners[k + 1][0]))
                    tri_n.append((corners[0][1], corners[k][1], corners[k + 1][1]))
                    tri_mtl.append(cur_mtl)
                    tri_shape.append(cur_shape)
                    shape_used = True
            elif key in ("o", "g"):
                name = " ".join(tokens[1:]) or "default"
                if shape_used:
                    shape_names.append(name)
                    cur_shape = len(shape_names) - 1
                    shape_used = False
                else:
                    shape_names[cur_shape] = name
            elif key == "usemtl":
                name = " ".join(tokens[1:])
                cur_mtl = mat_index.get(name, -1)
            elif key == "mtllib":
                for mtl_name in tokens[1:]:
                    loaded = load_mtl(os.path.join(mtl_dir, mtl_name))
                    for mname, m in loaded.items():
                        if mname not in mat_index:
                            mat_index[mname] = len(materials)
                            materials.append(m)

    return ObjData(
        vertices=np.asarray(verts, np.float32).reshape(-1, 3),
        normals=np.asarray(norms, np.float32).reshape(-1, 3),
        tri_v=np.asarray(tri_v, np.int64).reshape(-1, 3),
        tri_n=np.asarray(tri_n, np.int64).reshape(-1, 3),
        tri_mtl=np.asarray(tri_mtl, np.int32).reshape(-1),
        tri_shape=np.asarray(tri_shape, np.int32).reshape(-1),
        materials=materials,
        shape_names=shape_names,
    )


def mtl_to_materials(materials: List[MtlMaterial]) -> MaterialSoA:
    """Map MTL illum models to path-tracer materials.

    Mirrors the illum switch in Scene::loadObj (reference:
    scene.cpp:716-807). Emittance additionally honors Ke (extension: the
    reference always sets emittance=0 for OBJ materials).
    """
    n = len(materials)
    color = np.zeros((n, 3), np.float32)
    spec_ex = np.zeros((n,), np.float32)
    spec_rgb = np.zeros((n, 3), np.float32)
    refl = np.zeros((n,), np.float32)
    refr = np.zeros((n,), np.float32)
    ior = np.zeros((n,), np.float32)
    emit = np.zeros((n,), np.float32)
    trans = np.zeros((n, 3), np.float32)
    for i, m in enumerate(materials):
        base = np.maximum(np.asarray(m.ambient, np.float32), np.asarray(m.diffuse, np.float32))
        color[i] = base
        trans[i] = np.asarray(m.transmittance, np.float32)
        if m.illum <= 2:
            pass  # pure diffuse
        elif m.illum == 3:
            spec_ex[i] = 1.0
            spec_rgb[i] = np.asarray(m.specular, np.float32)
            refl[i] = 1.0
        else:
            spec_ex[i] = 1.0
            spec_rgb[i] = np.asarray(m.specular, np.float32)
            refl[i] = 1.0
            refr[i] = 1.0
            ior[i] = m.ior
        ke = np.asarray(m.emission, np.float32)
        if ke.max() > 0:
            emit[i] = float(ke.max())
            color[i] = ke / max(float(ke.max()), 1e-8)
    return MaterialSoA(
        color=color,
        specular_exponent=spec_ex,
        specular_color=spec_rgb,
        has_reflective=refl,
        has_refractive=refr,
        index_of_refraction=ior,
        emittance=emit,
        transmittance=trans,
    )


def load_obj(
    path: str,
    mtl_dir: Optional[str] = None,
    material_offset: int = 0,
) -> Tuple[MeshSoA, MaterialSoA]:
    """Load an OBJ into pre-gathered triangle SoA + its material table.

    ``material_offset`` is the index of the first OBJ material within the
    merged scene material table (reference: obj_materialOffsets,
    scene.cpp:819; applied per-triangle at pathtrace.cu:991). Triangles
    with no usemtl map to offset 0 of the OBJ block (reference behavior:
    shape 0's material).
    """
    data = parse_obj(path, mtl_dir)
    if data.tri_v.shape[0] == 0:
        raise ValueError(f"OBJ {path!r} contains no faces")

    v = data.vertices
    vn = data.normals
    t_v = data.tri_v
    t_n = data.tri_n

    v0 = v[t_v[:, 0]]
    v1 = v[t_v[:, 1]]
    v2 = v[t_v[:, 2]]

    # Face normals as fallback where vn is missing.
    face_n = np.cross(v1 - v0, v2 - v0)
    lens = np.linalg.norm(face_n, axis=1, keepdims=True)
    face_n = face_n / np.maximum(lens, 1e-12)

    def gather_normals(col: int) -> np.ndarray:
        idx = t_n[:, col]
        ok = (idx >= 0) & (idx < max(len(vn), 1))
        if len(vn) == 0:
            return face_n.copy()
        out = vn[np.clip(idx, 0, len(vn) - 1)]
        return np.where(ok[:, None], out, face_n).astype(np.float32)

    n0 = gather_normals(0)
    n1 = gather_normals(1)
    n2 = gather_normals(2)

    mtl = np.where(data.tri_mtl >= 0, data.tri_mtl, 0).astype(np.int32)
    material_id = (mtl + material_offset).astype(np.int32)

    # Per-shape AABBs (reference: scene.cpp:692-711) with the same 0.01 pad
    # applied by the brute-force kernel (pathtrace.cu:499-506).
    n_shapes = int(data.tri_shape.max()) + 1 if data.tri_shape.size else 1
    bb_min = np.zeros((n_shapes, 3), np.float32)
    bb_max = np.zeros((n_shapes, 3), np.float32)
    for s in range(n_shapes):
        mask = data.tri_shape == s
        if mask.any():
            pts = np.concatenate([v0[mask], v1[mask], v2[mask]], axis=0)
            bb_min[s] = pts.min(axis=0)
            bb_max[s] = pts.max(axis=0)

    mesh = MeshSoA(
        v0=v0.astype(np.float32),
        v1=v1.astype(np.float32),
        v2=v2.astype(np.float32),
        n0=n0,
        n1=n1,
        n2=n2,
        material_id=material_id,
        shape_id=data.tri_shape.astype(np.int32),
        shape_bbox_min=bb_min,
        shape_bbox_max=bb_max,
    )

    mat_soa = mtl_to_materials(data.materials) if data.materials else mtl_to_materials(
        [MtlMaterial(name="default", diffuse=(1.0, 1.0, 1.0), illum=2)]
    )
    return mesh, mat_soa
