"""Procedural meshes and the files a configuration's scene is loaded from.

A frozen copy of the port's ``utils/procmesh.py`` (``icosphere`` and
``write_obj``), kept here so that the benchmark's inputs do not move when
the program changes. A configuration names its generator and arguments;
``write_inputs`` writes the scene text and the OBJ into a fixed directory
inside the checkout, once per content.
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path

import numpy as np


def icosphere(subdiv: int = 1, radius: float = 1.0, center=(0.0, 0.0, 0.0)):
    """(vertices [V, 3] float32, faces [F, 3] int64) of a subdivided icosahedron."""
    t = (1.0 + 5**0.5) / 2.0
    verts = np.array(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        np.float64,
    )
    faces = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        np.int64,
    )
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    for _ in range(subdiv):
        cache = {}
        vlist = list(verts)

        def midpoint(i, j):
            key = (min(i, j), max(i, j))
            if key not in cache:
                m = vlist[i] + vlist[j]
                m = m / np.linalg.norm(m)
                cache[key] = len(vlist)
                vlist.append(m)
            return cache[key]

        new_faces = []
        for f in faces:
            a, b, c = int(f[0]), int(f[1]), int(f[2])
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        verts = np.asarray(vlist)
        faces = np.asarray(new_faces, np.int64)
    verts = verts * radius + np.asarray(center)
    return verts.astype(np.float32), faces


GENERATORS = {"icosphere": icosphere}


def obj_text(verts: np.ndarray, faces: np.ndarray) -> str:
    """A minimal OBJ with vertex normals (positions less their mean,
    normalised), one ``v``, ``vn`` and ``f v//n`` line each."""
    c = verts.mean(axis=0)
    n = verts - c
    n = n / np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-12)
    lines = [f"v {v[0]} {v[1]} {v[2]}" for v in verts]
    lines += [f"vn {vn[0]} {vn[1]} {vn[2]}" for vn in n]
    lines += [f"f {a + 1}//{a + 1} {b + 1}//{b + 1} {c_ + 1}//{c_ + 1}" for a, b, c_ in faces]
    return "\n".join(lines) + "\n"


def _write_once(path: Path, text: str) -> None:
    """Write ``text`` unless ``path`` already holds it."""
    data = text.encode()
    if path.exists() and hashlib.sha1(path.read_bytes()).digest() == hashlib.sha1(data).digest():
        return
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_bytes(data)
    tmp.replace(path)


def write_inputs(config: dict, work_dir: Path):
    """Write the configuration's scene text and mesh into ``work_dir``;
    return (scene path, OBJ path or None). The OBJ's name carries a hash
    of its generator, arguments and this file, so a checkout generates it
    on its first run only."""
    work_dir.mkdir(parents=True, exist_ok=True)
    scene_path = work_dir / "scene.txt"
    _write_once(scene_path, "\n".join(config["scene_text"]) + "\n")
    mesh = config.get("mesh")
    if mesh is None:
        return scene_path, None
    h = hashlib.sha1(json.dumps(mesh, sort_keys=True).encode())
    h.update(Path(__file__).read_bytes())
    obj_path = work_dir / f"mesh-{h.hexdigest()[:12]}.obj"
    if not obj_path.exists():
        verts, faces = GENERATORS[mesh["generator"]](**mesh["args"])
        _write_once(obj_path, obj_text(verts, faces))
    return scene_path, obj_path
