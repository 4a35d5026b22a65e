"""KD-tree traversal: every KD walk of the JAX package, in plain PyTorch.

The JAX package's ``ops/traverse.py`` (reference: src/pathtrace.cu:881-1566).
Every lane of the wavefront walks the tree in lockstep with a little
integer state; the JAX walks are plain ``jnp`` (no TPU kernel), and so are
these. ``intersect_mesh_kd`` picks one as the JAX dispatch does (the
reference's key-L toggle):

- **Fat rows** (``fat_rows``, the default, when the table has them:
  ``scene.structs.FatRows``). A step reads one row, the node header and up
  to ``inline_cap`` leaf triangles at once; a leaf with more chains into
  continuation rows.
  - The stackless skip-link walk (the default): descend to the left child,
    follow the continuation chain, or take the skip link (pruned or
    finished); ``n_rows`` means done. With ``octant_rows`` and an octant
    table (``scene.structs.OctantRows``) a ray walks the layout of its
    direction's octant, which visits near children first.
  - The short-stack walk (``short_stack``): the near child first by the
    direction's sign on the split axis, the far child pushed on a stack of
    ``max(2, max_depth + 2)`` entries. It walks the single fat-row table.
  - Packets (``packet_size`` P > 1): P coherence-sorted lanes share one
    cursor and one stack; a packet enters a node when any of its live lanes
    wants it, and orders children by its lanes' majority sign. The wavefront
    is padded to whole packets with dead lanes (origin 0, direction 1).
- **The thin node table** (``fat_rows=False``): one node per step, its
  leaf triangles ``leaf_chunk`` at a time with a cursor per lane
  (``_leaf_chunk_intersect``). The skip-link walk, the short-stack walk
  (``short_stack``) and Horn's push-down restart (``short_stack`` and
  ``push_down_restart``: a parametric interval per ray, a
  ``pushdown_stack``-deep stack that evicts its oldest entry on overflow,
  and a restart from the pushed-down root). As in the JAX package, these
  take no ``active``: every lane walks.

Each lane's walk is independent of the others, and packets are contiguous
runs of the sorted wavefront, so the step bound (``max_traversal_steps``)
cuts every lane, or packet, at the same step however the wavefront is
tiled: the port walks all rays as one tile (the JAX package's
``tile_lanes`` and ``packet_tile_lanes`` are its accelerator's cost knobs)
and returns the same hits. The loop runs ``traversal_unroll`` steps
between two reads of its condition on the host: one read (the count of
lanes still walking) per ``traversal_unroll`` steps, and one more when
the walk ends at the bound, which counts the lanes it cut. When the count
falls to half the lanes the loop carries, it keeps only those (a stable
sort of the done flags, no further read), so finished lanes stop costing.
The fat-row skip-link walk and packets step in multiples of
``traversal_unroll`` (their JAX loops are unrolled); the others stop at
exactly ``max_traversal_steps``.

Rays are first sorted by ``_coherence_key`` (``sort_rays``), which
gathers similar walks into neighbouring lanes; results come back in ray
order. The sort is stable, where the JAX package's is not, so packets of
tied keys may hold other lanes than JAX's and pick another of a
triangle's leaf copies; the source triangle and t are the same.

Only the winning triangle is returned: the fat-row walks give its t as
found and u = v = 0, and a miss t = BIG; the thin walks also give u and
v, and a miss keeps ``t_init``, as in the JAX package. The hit expansion
(``ops/mesh.tri_hit_to_hit`` on the KD table's [T', 19] record) re-derives
t, u and v, where gradients flow.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Tuple

import torch

from kdtreepathtraceroptimization_tpu_torch.ops import vecmath as vm
from kdtreepathtraceroptimization_tpu_torch.ops.intersect import BIG, intersect_aabb
from kdtreepathtraceroptimization_tpu_torch.ops.mesh import TriHit
from kdtreepathtraceroptimization_tpu_torch.utils.trace import span

State = Dict[str, torch.Tensor]


def _i32(n: int, value: int, device, k: int = 0) -> torch.Tensor:
    shape = (n,) if k == 0 else (n, k)
    return torch.full(shape, value, dtype=torch.int32, device=device)


def _f32(n: int, value: float, device, k: int = 0) -> torch.Tensor:
    shape = (n,) if k == 0 else (n, k)
    return torch.full(shape, value, dtype=torch.float32, device=device)


def _take(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[lane, idx[lane]]`` for a [n, k] table."""
    return table.gather(1, idx.long()[:, None])[:, 0]


def _put(table: torch.Tensor, idx: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    """``table`` with ``table[lane, idx[lane]] = value[lane]``."""
    return table.scatter(1, idx.long()[:, None], value[:, None])


def _walk_lanes(state: State, outputs: Tuple[str, ...], live: Callable[[State], torch.Tensor],
                step: Callable[[State], State], max_steps: int, unroll: int):
    """Run ``step`` on every lane of ``state`` (tensors with a leading lane
    axis) until no lane is ``live`` or ``max_steps`` steps have run,
    ``unroll`` steps between two host reads of the live count; keep only
    the live lanes once they are half of those carried. Returns (the
    ``outputs`` for every lane, stats: ``steps`` run, ``host_reads``, and
    the lanes live at the bound, ``cut`` (a count) and ``cut_mask``)."""
    n = state[outputs[0]].shape[0]
    device = state[outputs[0]].device
    full = {k: state[k] for k in outputs}
    lanes = torch.arange(n, device=device)
    cut_mask = torch.zeros((n,), dtype=torch.bool, device=device)
    steps = reads = cut = 0
    while True:
        with span("kdpt.kd.round"):
            alive = live(state)
            n_live = int(alive.sum())  # the loop condition: one host read
            reads += 1
            if n_live == 0:
                break
            if steps >= max_steps:
                cut = n_live
                cut_mask[lanes[alive]] = True
                break
            if n_live <= lanes.shape[0] // 2:
                # keep the walking lanes (done lanes' results go home first)
                full = {k: full[k].index_copy(0, lanes, state[k]) for k in outputs}
                keep = torch.sort((~alive).to(torch.int8), stable=True)[1][:n_live]
                lanes = lanes[keep]
                state = {k: v[keep] for k, v in state.items()}
            for _ in range(min(unroll, max_steps - steps)):
                state = step(state)
            steps += min(unroll, max_steps - steps)
    full = {k: full[k].index_copy(0, lanes, state[k]) for k in outputs}
    return full, dict(steps=steps, host_reads=reads, cut=cut, cut_mask=cut_mask)


def _unrolled_bound(config) -> Tuple[int, int]:
    """(step bound, unroll) of the walks whose JAX loop is unrolled: the
    bound rounds up to a whole number of unrolled bodies."""
    unroll = max(1, config.traversal_unroll)
    return -(-config.max_traversal_steps // unroll) * unroll, unroll


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


# ---------------------------------------------------------------------------
# The thin node table (fat_rows=False)
# ---------------------------------------------------------------------------


def _leaf_chunk_intersect(origin, direction, kd_tris, start, count, cursor, chunk: int,
                          best_t, best_tri, best_u, best_v, active):
    """Moller-Trumbore over one ``chunk`` of each active lane's leaf
    (triangles ``start + cursor ..``, slots past the leaf's end masked),
    merged into the running best (strict ``<``; the first slot among equal
    t). The per-leaf loop of pathtrace.cu:1113-1165."""
    offs = torch.arange(chunk, dtype=torch.int32, device=origin.device)[None, :]
    idx = start[:, None] + cursor[:, None] + offs  # [n, C]
    valid = active[:, None] & (cursor[:, None] + offs < count[:, None])
    idx_c = idx.clamp(0, kd_tris.v0.shape[0] - 1).long()
    tv0, tv1, tv2 = kd_tris.v0[idx_c], kd_tris.v1[idx_c], kd_tris.v2[idx_c]  # [n, C, 3]

    e1 = tv1 - tv0
    e2 = tv2 - tv0
    d = direction[:, None, :]
    p = vm.cross(d.expand_as(e2), e2)
    a = (e1 * p).sum(-1)
    det_ok = a > 1.19e-7  # back faces culled, as glm (intersect.inl)
    f = 1.0 / torch.where(det_ok, a, 1.0)
    s = origin[:, None, :] - tv0
    u = f * (s * p).sum(-1)
    q = vm.cross(s, e1)
    v = f * (d * q).sum(-1)
    t = f * (e2 * q).sum(-1)
    ok = valid & det_ok & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) & (t >= 0)
    t = torch.where(ok, t, BIG)

    ct, slot = torch.min(t, dim=1)
    slot = slot[:, None]
    better = ct < best_t
    return (torch.where(better, ct, best_t),
            torch.where(better, idx.gather(1, slot)[:, 0], best_tri),
            torch.where(better, u.gather(1, slot)[:, 0], best_u),
            torch.where(better, v.gather(1, slot)[:, 0], best_v))


def _thin_start(origin, direction, t_init) -> State:
    n = origin.shape[0]
    device = origin.device
    return dict(o=origin, d=direction,
                bt=_f32(n, BIG, device) if t_init is None else t_init.to(torch.float32),
                btri=_i32(n, -1, device), bu=_f32(n, 0.0, device), bv=_f32(n, 0.0, device),
                cursor=_i32(n, 0, device))


def _leaf_step(s: State, kd, node, do_leaf, chunk: int):
    """The chunked leaf test of one step: the new best hit and the leaf
    cursor's next value (and whether the leaf is done)."""
    bt, btri, bu, bv = _leaf_chunk_intersect(
        s["o"], s["d"], kd.tris, node.tri_start, node.tri_count, s["cursor"], chunk,
        s["bt"], s["btri"], s["bu"], s["bv"], do_leaf)
    new_cursor_leaf = s["cursor"] + chunk
    return dict(bt=bt, btri=btri, bu=bu, bv=bv), new_cursor_leaf, new_cursor_leaf >= node.tri_count


class _Node(NamedTuple):
    axis: torch.Tensor
    split_pos: torch.Tensor
    bbox_min: torch.Tensor
    bbox_max: torch.Tensor
    left: torch.Tensor
    right: torch.Tensor
    skip: torch.Tensor
    tri_start: torch.Tensor
    tri_count: torch.Tensor


def _device_nodes(kd, cur: torch.Tensor) -> _Node:
    """The node fields of each lane's current node (clamped into the table)."""
    nodes = kd.nodes
    c = cur.clamp(0, nodes.axis.shape[0] - 1).long()
    return _Node(*(getattr(nodes, f)[c] for f in _Node._fields))


def _thin_hit(full: State, stats: dict, collect_stats: bool, **extra):
    """The thin walks' TriHit (and stats, ``cut_rays`` the rays cut)."""
    hit = TriHit(t=full["bt"], tri=full["btri"], u=full["bu"], v=full["bv"])
    if not collect_stats:
        return hit
    stats["cut_rays"] = stats.pop("cut_mask")
    return hit, dict(stats, **extra)


_THIN_OUT = ("bt", "btri", "bu", "bv")


def traverse_skiplink(origin, direction, kd, config, t_init=None, collect_stats: bool = False):
    """The stackless skip-link walk over the node table (pre-order: the
    first child is the next node, the skip link leaves the subtree)."""
    m = kd.nodes.axis.shape[0]
    chunk = config.leaf_chunk

    def step(s):
        cur, cursor = s["cur"], s["cursor"]
        active = cur < m
        node = _device_nodes(kd, cur)
        entering = cursor == 0
        hit_box, dist = intersect_aabb(s["o"], s["d"], node.bbox_min, node.bbox_max)
        # prune on a miss or a provably farther subtree (pathtrace.cu:1095)
        pruned = entering & (~hit_box | (dist > s["bt"]))
        is_leaf = node.axis < 0
        best, new_cursor_leaf, leaf_done = _leaf_step(s, kd, node, active & is_leaf & ~pruned,
                                                      chunk)
        nxt = torch.where(pruned, node.skip,
                          torch.where(is_leaf, torch.where(leaf_done, node.skip, cur), cur + 1))
        new_cursor = torch.where(is_leaf & ~pruned & ~leaf_done, new_cursor_leaf, 0)
        return dict(s, **best, cur=torch.where(active, nxt, cur),
                    cursor=torch.where(active, new_cursor, cursor))

    state = dict(_thin_start(origin, direction, t_init), cur=_i32(origin.shape[0], 0,
                                                                   origin.device))
    full, stats = _walk_lanes(state, _THIN_OUT, lambda s: s["cur"] < m, step,
                              config.max_traversal_steps, max(1, config.traversal_unroll))
    return _thin_hit(full, stats, collect_stats, walk="skiplink")


def traverse_shortstack(origin, direction, kd, config, t_init=None,
                        collect_stats: bool = False):
    """The near/far-ordered short-stack walk over the node table
    (pathtrace.cu:1023-1235). Only far children are pushed, at most one a
    level, so the stack holds ``max(2, max_depth + 2)`` entries."""
    m = kd.nodes.axis.shape[0]
    n = origin.shape[0]
    chunk = config.leaf_chunk
    k = max(2, kd.max_depth + 2)

    def step(s):
        cur, sp, stack, cursor = s["cur"], s["sp"], s["stack"], s["cursor"]
        # lanes with no current node pop from their stack
        need_pop = (cur < 0) & (sp > 0)
        cur = torch.where(need_pop, _take(stack, (sp - 1).clamp(0, k - 1)), cur)
        sp = torch.where(need_pop, sp - 1, sp)
        active = cur >= 0
        node = _device_nodes(kd, cur)
        entering = cursor == 0
        hit_box, dist = intersect_aabb(s["o"], s["d"], node.bbox_min, node.bbox_max)
        pruned = entering & (~hit_box | (dist > s["bt"]))
        is_leaf = node.axis < 0
        best, new_cursor_leaf, leaf_done = _leaf_step(s, kd, node, active & is_leaf & ~pruned,
                                                      chunk)
        # near child first by the direction's sign on the split axis
        # (pathtrace.cu:1104-1112): non-negative -> the low (left) side
        dir_ax = _take(s["d"], node.axis.clamp(0, 2))
        near = torch.where(dir_ax >= 0, node.left, node.right)
        far = torch.where(dir_ax >= 0, node.right, node.left)
        descend_to = torch.where(near >= 0, near, far)  # a missing child: the other
        push_far = active & ~is_leaf & ~pruned & (near >= 0) & (far >= 0)
        sp_push = sp.clamp(0, k - 1)
        stack = _put(stack, sp_push, torch.where(push_far, far, _take(stack, sp_push)))
        sp = torch.where(push_far & (sp < k), sp + 1, sp)
        nxt = torch.where(pruned, -1,
                          torch.where(is_leaf, torch.where(leaf_done, -1, cur), descend_to))
        new_cursor = torch.where(is_leaf & ~pruned & ~leaf_done, new_cursor_leaf, 0)
        return dict(s, **best, cur=torch.where(active, nxt, cur), sp=sp, stack=stack,
                    cursor=torch.where(active, new_cursor, cursor))

    device = origin.device
    state = dict(_thin_start(origin, direction, t_init), cur=_i32(n, 0, device),
                 sp=_i32(n, 0, device), stack=_i32(n, -1, device, k))
    full, stats = _walk_lanes(state, _THIN_OUT, lambda s: (s["cur"] >= 0) | (s["sp"] > 0), step,
                              config.max_traversal_steps, max(1, config.traversal_unroll))
    return _thin_hit(full, stats, collect_stats, walk="shortstack", stack=k)


def traverse_pushdown(origin, direction, kd, config, t_init=None,
                      collect_stats: bool = False):
    """Horn's push-down-restart short-stack walk (traverseKDshort,
    pathtrace.cu:1238-1414).

    A ray carries a parametric interval [tmin, tmax]. An internal node
    classifies its split, tSplit = (splitPos - o[ax]) / d[ax], against it
    (near only, far only or both); both pushes the far interval on a short
    stack of ``max(2, pushdown_stack)`` entries. Pushes stack near to far
    from the bottom up, so an overflowing push evicts the oldest (bottom)
    entry, the farthest pending interval: every evicted interval lies
    beyond all kept ones, and a restart on an empty stack re-enters at
    [tmax, BIG] and walks their union again. The restart starts from the
    pushed-down root, the deepest node reached by single-child descents
    (pathtrace.cu:1293-1299, 1388-1389). A lane retires when a hit lies
    inside its processed interval (``bt <= tmax``) or the interval
    reaches BIG; the walk is exact."""
    m = kd.nodes.axis.shape[0]
    n = origin.shape[0]
    chunk = config.leaf_chunk
    k = max(2, int(config.pushdown_stack))

    def step(s):
        cur, rootn, tmin, tmax, pushd, sp, done = (s[f] for f in (
            "cur", "rootn", "tmin", "tmax", "pushd", "sp", "done"))
        st_n, st_lo, st_hi = s["st_n"], s["st_lo"], s["st_hi"]
        o, d = s["o"], s["d"]

        # -- pop, restart or retire the lanes with no current node --
        need = (cur < 0) & ~done
        can_pop = need & (sp > 0)
        spi = (sp - 1).clamp(0, k - 1)
        cur = torch.where(can_pop, _take(st_n, spi), cur)
        tmin = torch.where(can_pop, _take(st_lo, spi), tmin)
        tmax = torch.where(can_pop, _take(st_hi, spi), tmax)
        sp = torch.where(can_pop, sp - 1, sp)
        pushd = pushd & ~can_pop
        restart = need & ~can_pop & (tmax < BIG)
        cur = torch.where(restart, rootn, cur)
        tmin = torch.where(restart, tmax, tmin)
        tmax = torch.where(restart, BIG, tmax)
        pushd = pushd | restart
        done = done | (need & ~can_pop & ~restart)

        active = (cur >= 0) & ~done
        node = _device_nodes(kd, cur)
        is_leaf = node.axis < 0

        # -- internal: the split against [tmin, tmax] --
        axc = node.axis.clamp(0, 2)
        o_ax, d_ax = _take(o, axc), _take(d, axc)
        d_safe = torch.where(d_ax.abs() < 1e-30,
                             torch.where(d_ax < 0, -1e-30, 1e-30), d_ax)
        t_split = (node.split_pos - o_ax) / d_safe
        # near = the origin's side (a ray starting past the split has
        # t_split < 0 and must visit the high side)
        near = torch.where(o_ax < node.split_pos, node.left, node.right)
        far = torch.where(o_ax < node.split_pos, node.right, node.left)
        near_eff = torch.where(near >= 0, near, far)  # a missing child: the other
        far_eff = torch.where(far >= 0, far, near)
        near_only = (t_split >= tmax) | (t_split < 0.0)
        far_only = ~near_only & (t_split <= tmin)
        both = ~near_only & ~far_only & (near >= 0) & (far >= 0)

        # push the far interval; on overflow roll out the oldest entry
        want_push = active & ~is_leaf & both
        push = want_push & (sp < k)
        ovf = want_push & (sp >= k)
        st_n = torch.where(ovf[:, None], torch.roll(st_n, -1, dims=1), st_n)
        st_lo = torch.where(ovf[:, None], torch.roll(st_lo, -1, dims=1), st_lo)
        st_hi = torch.where(ovf[:, None], torch.roll(st_hi, -1, dims=1), st_hi)
        wr = push | ovf
        spp = torch.where(ovf, k - 1, sp.clamp(0, k - 1))
        st_n = _put(st_n, spp, torch.where(wr, far, _take(st_n, spp)))
        st_lo = _put(st_lo, spp, torch.where(wr, t_split, _take(st_lo, spp)))
        st_hi = _put(st_hi, spp, torch.where(wr, tmax, _take(st_hi, spp)))
        sp = torch.where(push, sp + 1, sp)

        desc = torch.where(both, near_eff, torch.where(far_only, far_eff, near_eff))
        went_int = active & ~is_leaf
        tmax = torch.where(went_int & both, t_split, tmax)
        # push-down: single-child descents keep the restart point moving
        rootn = torch.where(went_int & pushd & ~both, desc, rootn)
        pushd = pushd & ~(went_int & both)

        # -- leaf: chunked triangle tests --
        do_leaf = active & is_leaf
        best, new_cursor_leaf, leaf_done = _leaf_step(s, kd, node, do_leaf, chunk)
        # early retire: a hit inside the processed interval is final
        done = done | (do_leaf & leaf_done & (best["bt"] <= tmax))
        nxt = torch.where(is_leaf, torch.where(leaf_done, -1, cur), desc)
        new_cursor = torch.where(is_leaf & ~leaf_done, new_cursor_leaf, 0)
        return dict(s, **best, cur=torch.where(active, nxt, cur), rootn=rootn, tmin=tmin,
                    tmax=tmax, pushd=pushd, sp=sp, st_n=st_n, st_lo=st_lo, st_hi=st_hi,
                    done=done, cursor=torch.where(active, new_cursor, s["cursor"]))

    device = origin.device
    state = dict(_thin_start(origin, direction, t_init), cur=_i32(n, 0, device),
                 rootn=_i32(n, 0, device), tmin=_f32(n, 0.0, device), tmax=_f32(n, BIG, device),
                 pushd=torch.ones((n,), dtype=torch.bool, device=device), sp=_i32(n, 0, device),
                 st_n=_i32(n, -1, device, k), st_lo=_f32(n, 0.0, device, k),
                 st_hi=_f32(n, 0.0, device, k),
                 done=torch.zeros((n,), dtype=torch.bool, device=device))
    full, stats = _walk_lanes(state, _THIN_OUT, lambda s: ~s["done"], step,
                              config.max_traversal_steps, max(1, config.traversal_unroll))
    return _thin_hit(full, stats, collect_stats, walk="pushdown", stack=k)


# ---------------------------------------------------------------------------
# The fat-row table
# ---------------------------------------------------------------------------


def _mt_inline(origin, direction, tri_block, inline_n, tri_base, do_leaf,
               best_t, best_tri):
    """Moller-Trumbore over the ``cap`` inline triangle slots of each
    lane's current row, merged into the running best (strict ``<``; the
    first slot among equal t). ``tri_block`` [n, 9 * cap] is
    component-major: group g is component g of every slot.

    Packets: ``origin``/``direction`` [npk, P, 3] against ``tri_block``
    [npk, 9 * cap], ``do_leaf`` and the best [npk, P], ``inline_n`` and
    ``tri_base`` [npk, 1]: every lane of a packet tests its packet's row,
    as dense [npk, P, cap] math."""
    cap = tri_block.shape[-1] // 9
    packets = origin.dim() == 3

    def comp(g):  # component g of all slots: [n, cap], or [npk, 1, cap]
        c = tri_block[:, g * cap:(g + 1) * cap]
        return c[:, None, :] if packets else c

    ox, oy, oz = origin[..., 0:1], origin[..., 1:2], origin[..., 2:3]
    dx, dy, dz = direction[..., 0:1], direction[..., 1:2], direction[..., 2:3]
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

    offs = torch.arange(cap, dtype=torch.int32, device=origin.device)
    valid = do_leaf[..., None] & (offs < inline_n[..., None])
    ok = valid & det_ok & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) & (t >= 0)
    t = torch.where(ok, t, BIG)

    ct, slot = torch.min(t, dim=-1)
    better = ct < best_t
    return (torch.where(better, ct, best_t),
            torch.where(better, tri_base + slot.to(torch.int32), best_tri))


class _Row(NamedTuple):
    """The header fields of each lane's (or packet's) current fat row."""

    axis: torch.Tensor
    bmin: torch.Tensor
    bmax: torch.Tensor
    skip: torch.Tensor
    left: torch.Tensor  # internal: left child; leaf: continuation or -1
    right: torch.Tensor
    tri_base: torch.Tensor
    inline_n: torch.Tensor
    tris: torch.Tensor  # [.., 9 * cap] inline triangles


def _read_row(rows, n_rows: int, cur) -> _Row:
    row = rows[cur.clamp(0, n_rows - 1).long()]  # the one row read
    return _Row(row[:, 0], row[:, 1:4], row[:, 4:7], row[:, 7].to(torch.int32),
                row[:, 8].to(torch.int32), row[:, 9].to(torch.int32),
                row[:, 10].to(torch.int32), row[:, 11].to(torch.int32), row[:, 12:])


def _fatrow_skiplink_tile(origin, direction, rows, n_rows: int, config, t0, active,
                          start=None):
    """The stackless walk over one table for every lane -> (t, tri (-1
    where no triangle beat t0), stats). ``start``: per-lane entry row (the
    octant layouts); default row 0."""
    n = origin.shape[0]
    device = origin.device

    def step(s):
        cur = s["cur"]
        lane_on = cur < n_rows
        row = _read_row(rows, n_rows, cur)
        hit_box, dist = intersect_aabb(s["o"], s["d"], row.bmin, row.bmax)
        pruned = ~hit_box | (dist > s["bt"])
        is_leaf = row.axis < 0
        bt, btri = _mt_inline(s["o"], s["d"], row.tris, row.inline_n, row.tri_base,
                              lane_on & is_leaf & ~pruned, s["bt"], s["btri"])
        # leaf: the continuation chain, else skip out; internal: descend left
        leaf_next = torch.where(row.left >= 0, row.left, row.skip)
        nxt = torch.where(pruned, row.skip, torch.where(is_leaf, leaf_next, row.left))
        return dict(s, cur=torch.where(lane_on, nxt, cur), bt=bt, btri=btri)

    entry = _i32(n, 0, device) if start is None else start
    state = dict(o=origin, d=direction, cur=torch.where(active, entry, n_rows).to(torch.int32),
                 bt=t0.clone(), btri=_i32(n, -1, device))
    full, stats = _walk_lanes(state, ("bt", "btri"), lambda s: s["cur"] < n_rows, step,
                              *_unrolled_bound(config))
    return full["bt"], full["btri"], stats


def _fatrow_shortstack_tile(origin, direction, rows, n_rows: int, config, t0, active, k: int):
    """The near/far-ordered short-stack walk over the fat-row table
    (pathtrace.cu:1023-1235) -> (t, tri, stats)."""
    n = origin.shape[0]
    device = origin.device

    def step(s):
        cur, sp, stack = s["cur"], s["sp"], s["stack"]
        need_pop = (cur < 0) & (sp > 0)
        cur = torch.where(need_pop, _take(stack, (sp - 1).clamp(0, k - 1)), cur)
        sp = torch.where(need_pop, sp - 1, sp)
        lane_on = cur >= 0
        row = _read_row(rows, n_rows, cur)
        hit_box, dist = intersect_aabb(s["o"], s["d"], row.bmin, row.bmax)
        pruned = ~hit_box | (dist > s["bt"])
        is_leaf = row.axis < 0
        bt, btri = _mt_inline(s["o"], s["d"], row.tris, row.inline_n, row.tri_base,
                              lane_on & is_leaf & ~pruned, s["bt"], s["btri"])
        # near child first by the direction's sign on the split axis
        # (pathtrace.cu:1104-1112); the far child pushed for later
        dir_ax = _take(s["d"], row.axis.to(torch.int32).clamp(0, 2))
        near = torch.where(dir_ax >= 0, row.left, row.right)
        far = torch.where(dir_ax >= 0, row.right, row.left)
        descend_to = torch.where(near >= 0, near, far)
        push_far = lane_on & ~is_leaf & ~pruned & (near >= 0) & (far >= 0)
        sp_push = sp.clamp(0, k - 1)
        stack = _put(stack, sp_push, torch.where(push_far, far, _take(stack, sp_push)))
        sp = torch.where(push_far & (sp < k), sp + 1, sp)
        # a leaf follows its continuation chain; -1 ends it -> pop
        nxt = torch.where(pruned, -1, torch.where(is_leaf, row.left, descend_to))
        return dict(s, cur=torch.where(lane_on, nxt, cur), sp=sp, stack=stack, bt=bt,
                    btri=btri)

    state = dict(o=origin, d=direction, cur=torch.where(active, 0, -1).to(torch.int32),
                 sp=_i32(n, 0, device), stack=_i32(n, -1, device, k), bt=t0.clone(),
                 btri=_i32(n, -1, device))
    full, stats = _walk_lanes(state, ("bt", "btri"), lambda s: (s["cur"] >= 0) | (s["sp"] > 0),
                              step, config.max_traversal_steps, max(1, config.traversal_unroll))
    return full["bt"], full["btri"], dict(stats, stack=k)


def _fatrow_packet_tile(origin, direction, rows, n_rows: int, config, t0, active, k: int,
                        P: int):
    """The packet short-stack walk (pathtrace.cu:1023-1235 per packet of
    ``P`` consecutive lanes) -> (t, tri, stats; ``steps`` and ``cut``
    count packets).

    A packet shares one cursor and one stack. It enters a node when any
    live lane's slab test wants it (entry no farther than that lane's best
    t), so every lane sees a superset of the nodes its own walk would: an
    incoherent packet costs steps, never a wrong hit. Dead lanes never
    want a node and never hit. Children go near first by the majority
    sign of the packet's live lanes on the split axis."""
    n = origin.shape[0]
    npk = n // P
    device = origin.device
    act = active.reshape(npk, P)

    def step(s):
        cur, sp, stack, o, d, act = s["cur"], s["sp"], s["stack"], s["o"], s["d"], s["act"]
        need_pop = (cur < 0) & (sp > 0)
        cur = torch.where(need_pop, _take(stack, (sp - 1).clamp(0, k - 1)), cur)
        sp = torch.where(need_pop, sp - 1, sp)
        pk_on = cur >= 0
        row = _read_row(rows, n_rows, cur)  # one row a packet
        hit_box, dist = intersect_aabb(o, d, row.bmin[:, None, :], row.bmax[:, None, :])
        want = act & hit_box & (dist <= s["bt"])  # per-lane interest
        enter = pk_on & want.any(dim=1)  # the packet's vote
        is_leaf = row.axis < 0
        do_leaf = enter & is_leaf
        bt, btri = _mt_inline(o, d, row.tris, row.inline_n[:, None], row.tri_base[:, None],
                              do_leaf[:, None] & act, s["bt"], s["btri"])
        ax = row.axis.to(torch.int64).clamp(0, 2)
        d_ax = d.gather(2, ax[:, None, None].expand(-1, d.shape[1], 1))[:, :, 0]
        vote = torch.where(act, torch.sign(d_ax), 0.0).sum(dim=1)
        near = torch.where(vote >= 0, row.left, row.right)
        far = torch.where(vote >= 0, row.right, row.left)
        descend_to = torch.where(near >= 0, near, far)
        push_far = enter & ~is_leaf & (near >= 0) & (far >= 0)
        sp_push = sp.clamp(0, k - 1)
        stack = _put(stack, sp_push, torch.where(push_far, far, _take(stack, sp_push)))
        sp = torch.where(push_far & (sp < k), sp + 1, sp)
        nxt = torch.where(~enter, -1, torch.where(is_leaf, row.left, descend_to))
        return dict(s, cur=torch.where(pk_on, nxt, cur), sp=sp, stack=stack, bt=bt, btri=btri)

    state = dict(o=origin.reshape(npk, P, 3), d=direction.reshape(npk, P, 3), act=act,
                 cur=torch.where(act.any(dim=1), 0, -1).to(torch.int32),
                 sp=_i32(npk, 0, device), stack=_i32(npk, -1, device, k),
                 bt=t0.reshape(npk, P).clone(), btri=_i32(npk * P, -1, device).reshape(npk, P))
    full, stats = _walk_lanes(state, ("bt", "btri"), lambda s: (s["cur"] >= 0) | (s["sp"] > 0),
                              step, *_unrolled_bound(config))
    # a packet cut at the bound cuts each of its lanes
    stats["cut_mask"] = stats["cut_mask"].repeat_interleave(P)
    return full["bt"].reshape(n), full["btri"].reshape(n), dict(stats, stack=k, packets=npk)


def traverse_fatrow(origin, direction, kd, config, t_init=None, active=None,
                    collect_stats: bool = False):
    """The fat-row walks (the skip-link walk, over the octant layouts when
    configured and built; the short-stack walk; packets) over all rays as
    one tile. ``t_init`` bounds each lane's useful distance (the nearest
    analytic hit): subtrees beyond it are pruned, and a lane that never
    beats it reports a miss. ``active`` lanes walk; the others cost no
    step. With ``collect_stats`` also returns the walk, its steps, host
    reads, the lanes (packets) the step bound cut (``cut``) and the rays
    it cut (``cut_rays``, a mask)."""
    n_orig = n = origin.shape[0]
    device = origin.device
    P = int(config.packet_size)
    use_packets = P > 1
    # Octant layouts give the stackless walk near-first order; the
    # short-stack walk and packets order children themselves and walk the
    # single table.
    use_oct = (config.octant_rows and not config.short_stack and not use_packets
               and kd.oct is not None and kd.oct.layout_size > 0)
    rows = kd.oct.rows if use_oct else kd.fat.rows
    n_rows = rows.shape[0]
    origin = origin.to(torch.float32)
    direction = direction.to(torch.float32)
    t0 = (_f32(n, BIG, device) if t_init is None else t_init.to(torch.float32))
    act = torch.ones((n,), dtype=torch.bool, device=device) if active is None else active

    if use_packets and n % P:
        # whole packets: dead lanes never vote, so they cost only their slots
        pad = P - n % P
        origin = torch.cat([origin, torch.zeros((pad, 3), dtype=torch.float32, device=device)])
        direction = torch.cat([direction,
                               torch.ones((pad, 3), dtype=torch.float32, device=device)])
        t0 = torch.cat([t0, _f32(pad, BIG, device)])
        act = torch.cat([act, torch.zeros((pad,), dtype=torch.bool, device=device)])
        n += pad

    order = None
    if config.sort_rays and n > 1:
        # packets need it (a packet costs the union of its lanes' walks)
        key = _coherence_key(origin, direction, act, kd.root_bbox_min, kd.root_bbox_max)
        order = torch.sort(key, stable=True)[1]
        origin, direction, t0, act = origin[order], direction[order], t0[order], act[order]

    k = max(2, kd.max_depth + 2)
    if use_packets:
        bt, btri, stats = _fatrow_packet_tile(origin, direction, rows, n_rows, config, t0, act,
                                              k, P)
        walk = "packet"
    elif config.short_stack:
        bt, btri, stats = _fatrow_shortstack_tile(origin, direction, rows, n_rows, config, t0,
                                                  act, k)
        walk = "fatrow_shortstack"
    else:
        start = None
        if use_oct:
            # bit a set iff the direction is non-negative on axis a (the
            # KD build's convention: the low child first)
            octant = ((direction[:, 0] >= 0).to(torch.int32)
                      + 2 * (direction[:, 1] >= 0).to(torch.int32)
                      + 4 * (direction[:, 2] >= 0).to(torch.int32))
            start = octant * kd.oct.layout_size
        bt, btri, stats = _fatrow_skiplink_tile(origin, direction, rows, n_rows, config, t0,
                                                act, start=start)
        walk = "fatrow_skiplink"
    cut_rays = stats.pop("cut_mask")
    if order is not None:
        bt = torch.empty_like(bt).index_copy_(0, order, bt)
        btri = torch.empty_like(btri).index_copy_(0, order, btri)
        cut_rays = torch.empty_like(cut_rays).index_copy_(0, order, cut_rays)
    bt, btri, cut_rays = bt[:n_orig], btri[:n_orig], cut_rays[:n_orig]

    bt = torch.where(btri >= 0, bt, BIG)
    zero = torch.zeros((n_orig,), dtype=torch.float32, device=device)
    hit = TriHit(t=bt, tri=btri, u=zero, v=zero)
    if collect_stats:
        return hit, dict(walk=walk, **stats, cut_rays=cut_rays, octant_rows=use_oct,
                         n_rows=n_rows)
    return hit


def intersect_mesh_kd(origin, direction, kd, config, t_init=None, active=None,
                      collect_stats: bool = False):
    """Nearest hit over the KD table ``kd`` (tensors on the rays' device,
    ``convert.kd_to_device``): triangle ids index ``kd.tris``, which holds a
    triangle once per leaf it lies in. Exact (brute-force-equal) within the
    step bound. The JAX dispatch (the reference's key-L toggle,
    pathtrace.cu:1653-1680): the fat-row walks when ``fat_rows`` and the
    table has them (``traverse_fatrow``), else the thin push-down walk
    (``short_stack`` and ``push_down_restart``), the thin short-stack walk
    (``short_stack``) or the thin skip-link walk; the thin walks ignore
    ``active``."""
    origin = vm.as_rows(origin).to(torch.float32)
    direction = vm.as_rows(direction).to(torch.float32)
    if config.fat_rows and kd.fat is not None:
        return traverse_fatrow(origin, direction, kd, config, t_init=t_init, active=active,
                               collect_stats=collect_stats)
    if config.short_stack:
        walk = traverse_pushdown if config.push_down_restart else traverse_shortstack
    else:
        walk = traverse_skiplink
    return walk(origin, direction, kd, config, t_init=t_init, collect_stats=collect_stats)
