"""KD-tree visualization (the reference's key V).

The JAX package's ``ops/kdviz.py`` (reference: pathTraceOneBounceKDbareBoxes,
src/pathtrace.cu:1738-1885): every ray's nearest KD node box is drawn as a
solid box tinted by the node's depth in the tree, so the levels are told
apart. The slab tests run over the nodes in chunks of
``max_nodes_per_chunk`` ([N, chunk] at a time).
"""

from __future__ import annotations

import torch

from kdtreepathtraceroptimization_tpu_torch.ops import vecmath as vm
from kdtreepathtraceroptimization_tpu_torch.ops.intersect import BIG, intersect_aabb

# The box of a node that is not drawn: far away, never the nearest hit.
_FAR = 1e29


def node_depths(kd) -> torch.Tensor:
    """Each node's depth (the root 0, a child its parent's + 1), from
    ``kd.nodes.parent``."""
    parent = kd.nodes.parent.long()
    depth = torch.zeros_like(parent, dtype=torch.int32)
    for _ in range(kd.max_depth + 1):
        depth = torch.where(parent >= 0, depth[parent.clamp_min(0)] + 1, 0).to(torch.int32)
    return depth


@torch.no_grad()
def render_kd_boxes(origin, direction, kd, max_nodes_per_chunk: int = 256,
                    leaves_only: bool = True) -> torch.Tensor:
    """An [N, 3] colour a ray: the nearest node box it enters (at a
    distance > 0), tinted by the node's depth and darkened with distance,
    black where it enters none. ``leaves_only`` draws the leaf cells only
    (an internal box encloses its children, so its front face would hide
    them)."""
    origin = vm.as_rows(origin).to(torch.float32)
    direction = vm.as_rows(direction).to(torch.float32)
    n = origin.shape[0]
    device = origin.device
    bmin, bmax = kd.nodes.bbox_min, kd.nodes.bbox_max
    if leaves_only:
        is_leaf = (kd.nodes.axis < 0)[:, None]
        bmin = torch.where(is_leaf, bmin, _FAR)
        bmax = torch.where(is_leaf, bmax, _FAR)
    depth = node_depths(kd)
    m = bmin.shape[0]

    best_t = torch.full((n,), BIG, dtype=torch.float32, device=device)
    best_node = torch.full((n,), -1, dtype=torch.int32, device=device)
    for s in range(0, m, max_nodes_per_chunk):
        # the last chunk is padded with far boxes, as the JAX package's
        pad = max(0, s + max_nodes_per_chunk - m)
        cmin = torch.cat([bmin[s:s + max_nodes_per_chunk],
                          torch.full((pad, 3), _FAR, dtype=bmin.dtype, device=device)])
        cmax = torch.cat([bmax[s:s + max_nodes_per_chunk],
                          torch.full((pad, 3), _FAR, dtype=bmax.dtype, device=device)])
        hit, dist = intersect_aabb(origin[:, None, :], direction[:, None, :], cmin[None],
                                   cmax[None])
        dist = torch.where(hit & (dist > 0), dist, BIG)
        lt, local = torch.min(dist, dim=1)
        better = lt < best_t
        best_t = torch.where(better, lt, best_t)
        best_node = torch.where(better, s + local.to(torch.int32), best_node)

    hit = best_node >= 0
    d = depth[best_node.clamp_min(0).long()].to(torch.float32)
    tint = d / max(float(kd.max_depth), 1.0)
    color = torch.stack([1.0 - tint, (0.5 - tint).abs() * 2.0, tint], dim=-1)
    shade = torch.exp(-0.03 * torch.where(hit, best_t, 0.0))[:, None]
    return torch.where(hit[:, None], color * shade, 0.0)
