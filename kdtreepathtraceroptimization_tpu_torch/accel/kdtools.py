"""KD-tree inspection and interchange (the port's copy of the JAX
package's ``accel/kdtools.py``, the reference's debug tooling):

- ``write_kd_to_file``: one "minx miny minz maxx maxy maxz" line per
  node in pre-order, the Houdini visual-validation format (reference:
  src/KDtree.cpp:113-135 printToFile/writeKDtoFile);
- ``read_triangles_file``: the 9-floats-per-triangle, one-float-per-line
  format of KDtree::getTrianglesFromFile (src/KDtree.cpp:59-98);
- ``tree_stats``: the node-count printf at scene load (src/scene.cpp:897);
- ``print_tree``: an indented pre-order dump (KDnode::printTree,
  src/KDnode.cpp:267-315).

They take the host (numpy) tables ``accel.kdtree`` builds, or a loaded
scene's tables on a device (``convert.kd_to_device``), which they read
back to the host first.
"""

from __future__ import annotations

import io
from typing import TextIO, Union

import numpy as np
import torch

from kdtreepathtraceroptimization_tpu_torch.scene.structs import KDFlat, KDNodes, KDTris


def _host(kd: KDFlat) -> KDFlat:
    """``kd`` with its node and triangle tables as numpy arrays."""
    def np_(a):
        return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)

    return kd._replace(nodes=KDNodes(*map(np_, kd.nodes)), tris=KDTris(*map(np_, kd.tris)))


def write_kd_to_file(kd: KDFlat, path: Union[str, TextIO]) -> None:
    """Dump every node's AABB, one line per node in pre-order.

    Our flat layout is already DFS pre-order, so this is a straight
    iteration (the reference recurses, KDtree.cpp:113-125).
    """
    kd = _host(kd)
    out = open(path, "w") if isinstance(path, str) else path
    try:
        bmin, bmax = kd.nodes.bbox_min, kd.nodes.bbox_max
        for i in range(kd.nodes.count):
            out.write(
                f"{bmin[i, 0]:g} {bmin[i, 1]:g} {bmin[i, 2]:g} "
                f"{bmax[i, 0]:g} {bmax[i, 1]:g} {bmax[i, 2]:g}\n"
            )
    finally:
        if isinstance(path, str):
            out.close()


def read_triangles_file(path: str) -> np.ndarray:
    """Read the reference's triangle interchange format: 9 floats per
    triangle, one per line (KDtree.cpp:59-98). Returns [T, 3, 3]."""
    with open(path) as f:
        vals = [float(line) for line in f if line.strip()]
    if len(vals) % 9:
        raise ValueError(f"{path}: {len(vals)} floats is not a multiple of 9")
    return np.asarray(vals, np.float32).reshape(-1, 3, 3)


def tree_stats(kd: KDFlat) -> dict:
    """Summary counters (node printf analog, scene.cpp:897-899)."""
    kd = _host(kd)
    nodes = kd.nodes
    is_leaf = nodes.axis < 0
    counts = nodes.tri_count[is_leaf]
    real = kd.tris.orig_index >= 0  # exclude alignment pad slots
    n_source = int(np.unique(kd.tris.orig_index[real]).size)
    n_leaf_tris = int(real.sum())
    return {
        "nodes": int(nodes.count),
        "fat_rows": int(kd.fat.count) if kd.fat is not None else 0,
        "leaves": int(is_leaf.sum()),
        "max_depth": int(kd.max_depth),
        "source_tris": n_source,
        "leaf_tris_total": n_leaf_tris,  # includes duplicates
        "duplication_factor": float(n_leaf_tris / max(n_source, 1)),
        "leaf_tris_mean": float(counts.mean()) if counts.size else 0.0,
        "leaf_tris_max": int(counts.max()) if counts.size else 0,
        "empty_leaves": int((counts == 0).sum()),
    }


def print_tree(kd: KDFlat, max_nodes: int = 64, file: TextIO = None) -> str:
    """Indented pre-order dump of the first ``max_nodes`` nodes
    (KDnode::printTree analog). Returns the text; also writes it to
    ``file`` when given."""
    nodes = _host(kd).nodes
    buf = io.StringIO()
    depth = np.zeros(nodes.count, np.int32)
    for i in range(nodes.count):
        p = nodes.parent[i]
        if p >= 0:
            depth[i] = depth[p] + 1
    shown = min(nodes.count, max_nodes)
    for i in range(shown):
        pad = "  " * int(depth[i])
        if nodes.axis[i] < 0:
            buf.write(f"{pad}leaf#{i} tris[{nodes.tri_start[i]}:"
                      f"{nodes.tri_start[i] + nodes.tri_count[i]}]\n")
        else:
            buf.write(f"{pad}node#{i} axis={'xyz'[nodes.axis[i]]} "
                      f"split={nodes.split_pos[i]:.4g} "
                      f"L={nodes.left[i]} R={nodes.right[i]} skip={nodes.skip[i]}\n")
    if shown < nodes.count:
        buf.write(f"... ({nodes.count - shown} more nodes)\n")
    s = buf.getvalue()
    if file is not None:
        file.write(s)
    return s
