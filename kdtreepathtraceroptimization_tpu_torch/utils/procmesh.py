"""Procedural meshes (no external OBJ dependency) for tests and benchmarks.

The port's own copy of the JAX package's ``utils/procmesh.py`` (numpy
only), so that the port imports nothing from that package.
"""

import numpy as np


def icosphere(subdiv: int = 1, radius: float = 1.0, center=(0.0, 0.0, 0.0)):
    """Return (vertices [V,3], faces [F,3]) of a subdivided icosahedron."""
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


def write_obj(path: str, verts: np.ndarray, faces: np.ndarray,
              mtl_name=None, mtl_lib=None, with_normals: bool = True):
    """Write a minimal OBJ (vertex normals = normalized positions for
    sphere-like meshes)."""
    with open(path, "w") as f:
        if mtl_lib:
            f.write(f"mtllib {mtl_lib}\n")
        for v in verts:
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        if with_normals:
            c = verts.mean(axis=0)
            n = verts - c
            n = n / np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-12)
            for vn in n:
                f.write(f"vn {vn[0]} {vn[1]} {vn[2]}\n")
        if mtl_name:
            f.write(f"usemtl {mtl_name}\n")
        for face in faces:
            if with_normals:
                f.write(
                    f"f {face[0]+1}//{face[0]+1} {face[1]+1}//{face[1]+1} {face[2]+1}//{face[2]+1}\n"
                )
            else:
                f.write(f"f {face[0]+1} {face[1]+1} {face[2]+1}\n")
