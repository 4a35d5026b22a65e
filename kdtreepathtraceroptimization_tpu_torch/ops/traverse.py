"""KD-tree traversal: the stackless fat-row walk, in plain PyTorch.

The JAX package's ``ops/traverse.py`` (reference: src/pathtrace.cu:881-1235)
for its production layout, the fat-row table (``scene.structs.FatRows``):
every lane of the wavefront walks the tree in lockstep with one integer of
state, its current row. A step reads that row (node header and up to
``inline_cap`` leaf triangles at once), tests the node's box, tests the
inline triangles when the row is a leaf, and moves to the left child
(descend), the continuation row (the rest of a leaf) or the skip link
(pruned or finished); ``n_rows`` means done. With ``octant_rows`` and an
octant table (``scene.structs.OctantRows``) a ray walks the layout of its
direction's octant, which visits near children first. The JAX package has
no TPU kernel here (plain ``jnp``), so neither has the port.

Each lane's walk is independent of the others, and the step bound
(``max_traversal_steps``, counted in multiples of ``traversal_unroll``)
cuts every lane at the same step however the wavefront is tiled, so the
port walks all rays as one tile (the JAX package's ``tile_lanes`` is its
accelerator's cost knob) and returns the same hits. The loop runs
``traversal_unroll`` steps between two reads of its condition on the
host: one read (the count of lanes still walking) per ``traversal_unroll``
steps, and one more when the walk ends before the bound. When that count
falls to half the lanes the loop carries, it keeps only those (a stable
sort of the done flags, no further read), so finished lanes stop costing.

Rays are first sorted by ``_coherence_key`` (``sort_rays``), which
gathers similar rows into neighbouring lanes; results come back in ray
order. The thin-table walks (``fat_rows=False``), the short-stack and
push-down walks (``short_stack``) and packets (``packet_size`` > 1) are
not ported and raise ``NotImplementedError``.

Only the winning triangle is returned (its t as found, u = v = 0): the
hit expansion (``ops/mesh.tri_hit_to_hit`` on the KD table's [T', 19]
record) re-derives t, u and v, where gradients flow.
"""

from __future__ import annotations

import torch

from kdtreepathtraceroptimization_tpu_torch.ops import vecmath as vm
from kdtreepathtraceroptimization_tpu_torch.ops.intersect import BIG, intersect_aabb
from kdtreepathtraceroptimization_tpu_torch.ops.mesh import TriHit


def check_config(config, kd) -> None:
    """Raise for the KD walks this port does not implement."""
    if config.short_stack:
        raise NotImplementedError(
            "short_stack=True (the short-stack and push-down KD walks) is not ported")
    if config.packet_size > 1:
        raise NotImplementedError("packet_size > 1 (the packet KD walk) is not ported")
    if not config.fat_rows or kd is None or kd.fat is None:
        raise NotImplementedError(
            "the thin-table KD walks (fat_rows=False, or a table without fat rows) "
            "are not ported")


def _coherence_key(origin, direction, active, root_min, root_max):
    """Sort key clustering rays that walk alike, most significant first:
    [inactive or missing the root box] [direction octant] [4-bit-per-axis
    origin Morton code]. Inactive and root-missing lanes sort last."""
    hit_root, _ = intersect_aabb(origin, direction, root_min, root_max)
    octant = (
        (direction[:, 0] >= 0).to(torch.int32)
        + 2 * (direction[:, 1] >= 0).to(torch.int32)
        + 4 * (direction[:, 2] >= 0).to(torch.int32)
    )
    span = torch.clamp_min(root_max - root_min, 1e-6)
    q = torch.clamp(((origin - root_min) / span) * 15.0, 0.0, 15.0).to(torch.int32)
    morton = torch.zeros_like(octant)
    for b in range(4):
        for a in range(3):
            morton = morton | (((q[:, a] >> b) & 1) << (3 * b + a))
    key = (octant << 12) | morton
    return torch.where(active & hit_root, key, 1 << 20)


def _mt_inline(origin, direction, tri_block, inline_n, tri_base, do_leaf,
               best_t, best_tri):
    """Moller-Trumbore over the ``cap`` inline triangle slots of each
    lane's current row, merged into the running best (strict ``<``; the
    first slot among equal t). ``tri_block`` [n, 9 * cap] is
    component-major: group g is component g of every slot."""
    cap = tri_block.shape[1] // 9

    def comp(g):  # [n, cap]: component g of all slots
        return tri_block[:, g * cap:(g + 1) * cap]

    ox, oy, oz = origin[:, 0:1], origin[:, 1:2], origin[:, 2:3]
    dx, dy, dz = direction[:, 0:1], direction[:, 1:2], direction[:, 2:3]
    v0x, v0y, v0z = comp(0), comp(1), comp(2)
    e1x, e1y, e1z = comp(3) - v0x, comp(4) - v0y, comp(5) - v0z
    e2x, e2y, e2z = comp(6) - v0x, comp(7) - v0y, comp(8) - v0z

    # p = d x e2
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    a = e1x * px + e1y * py + e1z * pz
    det_ok = a > 1.19e-7  # back faces culled, as glm (intersect.inl)
    f = 1.0 / torch.where(det_ok, a, 1.0)
    sx, sy, sz = ox - v0x, oy - v0y, oz - v0z
    u = f * (sx * px + sy * py + sz * pz)
    # q = s x e1
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    v = f * (dx * qx + dy * qy + dz * qz)
    t = f * (e2x * qx + e2y * qy + e2z * qz)

    offs = torch.arange(cap, dtype=torch.int32, device=origin.device)[None, :]
    valid = do_leaf[:, None] & (offs < inline_n[:, None])
    ok = valid & det_ok & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) & (t >= 0)
    t = torch.where(ok, t, BIG)

    ct, slot = torch.min(t, dim=1)
    better = ct < best_t
    return (torch.where(better, ct, best_t),
            torch.where(better, tri_base + slot.to(torch.int32), best_tri))


def _skiplink_step(origin, direction, rows, n_rows: int, cur, bt, btri):
    """One step of the stackless walk for every lane (finished lanes,
    ``cur == n_rows``, stay as they are)."""
    lane_on = cur < n_rows
    row = rows[torch.clamp_max(cur, n_rows - 1).long()]  # the one row read
    axis = row[:, 0]
    skip = row[:, 7].to(torch.int32)
    nxt_link = row[:, 8].to(torch.int32)  # left child / continuation
    tri_base = row[:, 10].to(torch.int32)
    inline_n = row[:, 11].to(torch.int32)

    hit_box, dist = intersect_aabb(origin, direction, row[:, 1:4], row[:, 4:7])
    pruned = ~hit_box | (dist > bt)
    is_leaf = axis < 0
    do_leaf = lane_on & is_leaf & ~pruned
    bt, btri = _mt_inline(origin, direction, row[:, 12:], inline_n, tri_base, do_leaf,
                          bt, btri)
    # leaf: the continuation chain, else skip out; internal: descend left
    leaf_next = torch.where(nxt_link >= 0, nxt_link, skip)
    nxt = torch.where(pruned, skip, torch.where(is_leaf, leaf_next, nxt_link))
    return torch.where(lane_on, nxt, cur), bt, btri


def _fatrow_skiplink_tile(origin, direction, rows, n_rows: int, config, t0, active,
                          start=None):
    """The stackless walk over one table for every lane -> (t [n], tri [n]
    (-1 where no triangle beat t0), host reads, steps run).

    ``start``: per-lane entry row (the octant layouts); default row 0."""
    n = origin.shape[0]
    device = origin.device
    unroll = max(1, config.traversal_unroll)
    entry = torch.zeros((n,), dtype=torch.int32, device=device) if start is None else start
    cur = torch.where(active, entry, n_rows).to(torch.int32)
    bt = t0.clone()
    btri = torch.full((n,), -1, dtype=torch.int32, device=device)
    # The lanes the loop carries (indices into the wavefront) and their state.
    lanes = torch.arange(n, device=device)
    o, d, c, b, bi = origin, direction, cur, t0, btri.clone()
    steps = reads = 0
    while steps < config.max_traversal_steps:
        live = int((c < n_rows).sum())  # the loop condition: one host read
        reads += 1
        if live == 0:
            break
        if live <= c.shape[0] // 2:
            # keep the walking lanes (done lanes' results go home first)
            bt[lanes], btri[lanes] = b, bi
            keep = torch.sort((c >= n_rows).to(torch.int8), stable=True)[1][:live]
            lanes, o, d, c, b, bi = (a[keep] for a in (lanes, o, d, c, b, bi))
        for _ in range(unroll):
            c, b, bi = _skiplink_step(o, d, rows, n_rows, c, b, bi)
        steps += unroll
    bt[lanes], btri[lanes] = b, bi
    return bt, btri, reads, steps


def traverse_fatrow(origin, direction, kd, config, t_init=None, active=None,
                    collect_stats: bool = False):
    """The fat-row walk (octant layouts when configured and built) over
    all rays as one tile. ``t_init`` bounds each lane's useful distance
    (the nearest analytic hit): subtrees beyond it are pruned, and a lane
    that never beats it reports a miss. ``active`` lanes walk; the others
    cost no step. With ``collect_stats`` also returns the steps run and
    the host reads."""
    n = origin.shape[0]
    device = origin.device
    use_oct = config.octant_rows and kd.oct is not None and kd.oct.layout_size > 0
    if use_oct:
        rows, layout_size = kd.oct.rows, kd.oct.layout_size
    else:
        rows = kd.fat.rows
    n_rows = rows.shape[0]
    origin = origin.to(torch.float32)
    direction = direction.to(torch.float32)
    t0 = (torch.full((n,), BIG, dtype=torch.float32, device=device)
          if t_init is None else t_init.to(torch.float32))
    act = (torch.ones((n,), dtype=torch.bool, device=device)
           if active is None else active)

    order = None
    if config.sort_rays and n > 1:
        key = _coherence_key(origin, direction, act, kd.root_bbox_min, kd.root_bbox_max)
        order = torch.sort(key, stable=True)[1]
        origin, direction, t0, act = origin[order], direction[order], t0[order], act[order]

    start = None
    if use_oct:
        # bit a set iff the direction is non-negative on axis a (the
        # builder's convention: the low child first)
        octant = ((direction[:, 0] >= 0).to(torch.int32)
                  + 2 * (direction[:, 1] >= 0).to(torch.int32)
                  + 4 * (direction[:, 2] >= 0).to(torch.int32))
        start = octant * layout_size
    bt, btri, reads, steps = _fatrow_skiplink_tile(origin, direction, rows, n_rows, config,
                                                   t0, act, start=start)
    if order is not None:
        bt = torch.empty_like(bt).index_copy_(0, order, bt)
        btri = torch.empty_like(btri).index_copy_(0, order, btri)

    bt = torch.where(btri >= 0, bt, BIG)
    zero = torch.zeros((n,), dtype=torch.float32, device=device)
    hit = TriHit(t=bt, tri=btri, u=zero, v=zero)
    if collect_stats:
        return hit, {"steps": steps, "host_reads": reads, "octant_rows": use_oct,
                     "n_rows": n_rows}
    return hit


def intersect_mesh_kd(origin, direction, kd, config, t_init=None, active=None,
                      collect_stats: bool = False):
    """Nearest hit over the KD table ``kd`` (tensors on the rays' device,
    ``convert.kd_to_device``): triangle ids index ``kd.tris``, which holds a
    triangle once per leaf it lies in. Exact (brute-force-equal) within the
    step bound. See ``traverse_fatrow`` for the arguments."""
    check_config(config, kd)
    return traverse_fatrow(vm.as_rows(origin), vm.as_rows(direction), kd, config,
                           t_init=t_init, active=active, collect_stats=collect_stats)
