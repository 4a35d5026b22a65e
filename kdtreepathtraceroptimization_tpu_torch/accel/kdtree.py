"""Host-side KD-tree construction over triangle soup.

The port's copy of the JAX package's ``accel/kdtree.py`` (host numpy; its
arrays equal that package's bit for bit). It re-designs the reference's
host build (src/KDnode.cpp:151-249 split, KDnode.cpp:112-149 bbox refit,
scene.cpp:275-529 flatten) with the same split semantics:

- spatial-median split at the node bbox center, axis cycling level % 3
  (KDnode.cpp:171),
- triangles straddling the plane are duplicated into both children with
  +/-1e-4 slack (KDnode.cpp:177-187),
- child bboxes are the parent bbox clipped at the center (KDnode.cpp:209-240),
- stop at <= leaf_size triangles, level > max_depth, or a no-progress
  split (KDnode.cpp:164-190),
- 0.001 bbox padding (KDnode.cpp:138-146),

and a flat output layout for a vectorized walk (``ops/traverse.py``):

- nodes in DFS pre-order with the left child at id + 1,
- a skip link per node (the next subtree in pre-order when this node is
  missed or finished): a stackless walk with one row read per step,
- leaf triangles re-packed leaf-contiguous (the reference's
  cacheTriangles_, scene.cpp:366-500), and the fat-row tables
  (``scene.structs.FatRows``, ``OctantRows``) that inline them.

The builder is iterative (an explicit stack) with numpy partitioning per
node, or the native C++ twin (``accel/native``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from kdtreepathtraceroptimization_tpu_torch.scene.structs import (
    FatRows,
    KDFlat,
    KDNodes,
    KDTris,
    OctantRows,
)


def _auto_max_depth(n_tris: int, leaf_target: int) -> int:
    """Depth heuristic: enough levels to reach ~leaf_target tris/leaf,
    plus slack for duplication (the reference hard-codes 13 and ignores
    its own computed depth, scene.cpp:871-872 — we scale with the mesh)."""
    if n_tris <= leaf_target:
        return 0
    return int(np.ceil(np.log2(max(n_tris / leaf_target, 1.0)))) + 8


def _build_arrays_native(tri_min, tri_max, leaf_size, max_depth, slack, pad):
    """Build via the C++ builder (accel/native/kdbuild.cpp). Returns the
    same tuple as the Python DFS below, or None if the native library is
    unavailable."""
    from kdtreepathtraceroptimization_tpu_torch.accel.native import load_native

    lib = load_native()
    if lib is None:
        return None
    import ctypes

    tmin = np.ascontiguousarray(tri_min, np.float32)
    tmax = np.ascontiguousarray(tri_max, np.float32)
    fp = ctypes.POINTER(ctypes.c_float)
    h = lib.kd_build(
        tmin.ctypes.data_as(fp),
        tmax.ctypes.data_as(fp),
        tmin.shape[0],
        leaf_size,
        max_depth,
        slack,
        pad,
    )
    try:
        m = lib.kd_node_count(h)
        t = lib.kd_tri_count(h)
        deepest = lib.kd_max_depth(h)
        axis = np.empty(m, np.int32)
        split = np.empty(m, np.float32)
        bmin = np.empty((m, 3), np.float32)
        bmax = np.empty((m, 3), np.float32)
        left = np.empty(m, np.int32)
        right = np.empty(m, np.int32)
        skip = np.empty(m, np.int32)
        parent = np.empty(m, np.int32)
        tri_start = np.empty(m, np.int32)
        tri_count = np.empty(m, np.int32)
        order = np.empty(t, np.int64)
        root_min = np.empty(3, np.float32)
        root_max = np.empty(3, np.float32)
        ip = ctypes.POINTER(ctypes.c_int32)
        lp = ctypes.POINTER(ctypes.c_int64)
        lib.kd_export(
            h,
            axis.ctypes.data_as(ip), split.ctypes.data_as(fp),
            bmin.ctypes.data_as(fp), bmax.ctypes.data_as(fp),
            left.ctypes.data_as(ip), right.ctypes.data_as(ip),
            skip.ctypes.data_as(ip), parent.ctypes.data_as(ip),
            tri_start.ctypes.data_as(ip), tri_count.ctypes.data_as(ip),
            order.ctypes.data_as(lp),
            root_min.ctypes.data_as(fp), root_max.ctypes.data_as(fp),
        )
    finally:
        lib.kd_free(h)
    nodes = KDNodes(
        axis=axis, split_pos=split, bbox_min=bmin, bbox_max=bmax,
        left=left, right=right, skip=skip, parent=parent,
        tri_start=tri_start, tri_count=tri_count,
    )
    return nodes, order, int(deepest), root_min, root_max


def build_kdtree(
    v0: np.ndarray,
    v1: np.ndarray,
    v2: np.ndarray,
    n0: Optional[np.ndarray] = None,
    n1: Optional[np.ndarray] = None,
    n2: Optional[np.ndarray] = None,
    material_id: Optional[np.ndarray] = None,
    leaf_size: int = 4,
    max_depth: Optional[int] = None,
    slack: float = 1e-4,
    pad: float = 1e-3,
    backend: str = "auto",
    inline_cap: Optional[int] = None,
) -> KDFlat:
    """Build the tree and flatten it in one pass.

    Parameters mirror the reference's knobs: ``leaf_size`` (=2 at
    KDnode.cpp:164), ``max_depth`` (=13 at scene.cpp:872; None = auto),
    ``slack`` (the ±1e-4 membership slack), ``pad`` (0.001 bbox pad).
    ``backend``: 'auto' (native C++ if available, else numpy),
    'native', or 'numpy'. Both produce identical arrays.
    """
    v0 = np.asarray(v0, np.float32).reshape(-1, 3)
    v1 = np.asarray(v1, np.float32).reshape(-1, 3)
    v2 = np.asarray(v2, np.float32).reshape(-1, 3)
    n_tris = v0.shape[0]
    if n0 is None:
        n0 = n1 = n2 = np.zeros_like(v0)
    if material_id is None:
        material_id = np.zeros((n_tris,), np.int32)
    material_id = np.asarray(material_id, np.int32)

    tri_min = np.minimum(np.minimum(v0, v1), v2)  # [T, 3]
    tri_max = np.maximum(np.maximum(v0, v1), v2)

    if max_depth is None:
        max_depth = _auto_max_depth(n_tris, leaf_size)

    root_min = tri_min.min(axis=0) - pad if n_tris else np.zeros(3, np.float32)
    root_max = tri_max.max(axis=0) + pad if n_tris else np.zeros(3, np.float32)

    if backend in ("auto", "native") and n_tris > 0:
        res = _build_arrays_native(tri_min, tri_max, leaf_size, max_depth, slack, pad)
        if res is not None:
            nodes, order, deepest, root_min_n, root_max_n = res
            return _pack_kdflat(
                nodes, order, deepest, root_min_n, root_max_n,
                v0, v1, v2, n0, n1, n2, material_id, inline_cap=inline_cap,
            )
        if backend == "native":
            raise RuntimeError("native KD builder unavailable (g++ compile failed?)")

    # Output accumulators
    axis_l, split_l, bmin_l, bmax_l = [], [], [], []
    left_l, right_l, parent_l, tstart_l, tcount_l = [], [], [], [], []
    leaf_tri_chunks = []  # original-index arrays, leaf-contiguous
    n_leaf_tris = 0
    deepest = 0

    def emit(bbox_min, bbox_max, parent):
        axis_l.append(-1)
        split_l.append(0.0)
        bmin_l.append(bbox_min)
        bmax_l.append(bbox_max)
        left_l.append(-1)
        right_l.append(-1)
        parent_l.append(parent)
        tstart_l.append(0)
        tcount_l.append(0)
        return len(axis_l) - 1

    # DFS stack of (tri_indices, bbox_min, bbox_max, level, parent, node_id)
    # node_id is pre-assigned at push time? No: to get pre-order with
    # left=id+1, assign ids at pop time and push right before left.
    if n_tris > 0:
        root_entry = (np.arange(n_tris, dtype=np.int64), root_min, root_max, 0, -1, False)
        stack = [root_entry]
    else:
        stack = []

    # Each stack entry: (tris, bmin, bmax, level, parent_id, is_right_child)
    while stack:
        tris, bmin, bmax, level, parent, is_right = stack.pop()
        node_id = emit(bmin.astype(np.float32), bmax.astype(np.float32), parent)
        deepest = max(deepest, level)
        if parent >= 0:
            if is_right:
                right_l[parent] = node_id
            else:
                left_l[parent] = node_id

        num = tris.shape[0]
        make_leaf = num <= leaf_size or level > max_depth
        if not make_leaf:
            ax = level % 3
            center = 0.5 * (bmin[ax] + bmax[ax])
            go_left = tri_min[tris, ax] < center + slack
            go_right = tri_max[tris, ax] >= center - slack
            left_tris = tris[go_left]
            right_tris = tris[go_right]
            # no-progress guard (KDnode.cpp:190)
            if left_tris.shape[0] == num or right_tris.shape[0] == num:
                make_leaf = True
            # bad-split guard (ours, not in the reference): when nearly
            # every triangle straddles the plane, splitting only
            # duplicates — overlapping soups otherwise explode the tree.
            elif (
                left_tris.shape[0] >= 0.95 * num
                and right_tris.shape[0] >= 0.95 * num
            ):
                make_leaf = True

        if make_leaf:
            tstart_l[node_id] = n_leaf_tris
            tcount_l[node_id] = num
            leaf_tri_chunks.append(tris)
            n_leaf_tris += num
            continue

        axis_l[node_id] = ax
        split_l[node_id] = float(center)
        lmin, lmax = bmin.copy(), bmax.copy()
        lmax[ax] = center
        rmin, rmax = bmin.copy(), bmax.copy()
        rmin[ax] = center
        # Push right first so left is processed next (left child = id+1).
        if right_tris.shape[0] != 0:
            stack.append((right_tris, rmin, rmax, level + 1, node_id, True))
        if left_tris.shape[0] != 0:
            stack.append((left_tris, lmin, lmax, level + 1, node_id, False))

    m = len(axis_l)
    axis = np.asarray(axis_l, np.int32)
    left = np.asarray(left_l, np.int32)
    right = np.asarray(right_l, np.int32)
    parent = np.asarray(parent_l, np.int32)

    # Skip links: for each node, the next pre-order node after its whole
    # subtree. Computed bottom-up: skip(left child) = right sibling if it
    # exists else skip(parent); skip(right child) = skip(parent);
    # skip(root) = M (terminate).
    skip = np.full((m,), m, np.int32)
    for i in range(m):
        l, r = left[i], right[i]
        if l >= 0:
            skip[l] = r if r >= 0 else skip[i]
        if r >= 0:
            skip[r] = skip[i]

    order = (
        np.concatenate(leaf_tri_chunks)
        if leaf_tri_chunks
        else np.zeros((0,), np.int64)
    )
    nodes = KDNodes(
        axis=axis,
        split_pos=np.asarray(split_l, np.float32),
        bbox_min=np.asarray(bmin_l, np.float32).reshape(m, 3),
        bbox_max=np.asarray(bmax_l, np.float32).reshape(m, 3),
        left=left,
        right=right,
        skip=skip,
        parent=parent,
        tri_start=np.asarray(tstart_l, np.int32),
        tri_count=np.asarray(tcount_l, np.int32),
    )
    return _pack_kdflat(
        nodes, order, deepest, root_min, root_max, v0, v1, v2, n0, n1, n2,
        material_id, inline_cap=inline_cap,
    )


INLINE_CAP = 8  # triangles inlined per fat row (leaf chunk granularity)

# Skip building the 8x OctantRows table when it would exceed this many
# rows (the JAX package's cap, set from its accelerator's row-gather cost;
# the same cap keeps the two packages' tables equal). Walks then take the
# single fat-row layout.
OCTANT_ROWS_MAX_ROWS = 24 * 1024


def _pack_kdflat(nodes, order, deepest, root_min, root_max,
                 v0, v1, v2, n0, n1, n2, material_id,
                 inline_cap=None) -> KDFlat:
    """Pad each leaf's triangle block to a multiple of the inline cap,
    gather the leaf-contiguous triangle arrays, and build the fat-row
    table. The cap defaults to INLINE_CAP, raised to cover typical
    leaves in one row.

    Pad slots are degenerate (all-zero) triangles: Möller–Trumbore
    rejects them (det == 0), so they can never win a nearest-hit race.
    """
    cap = INLINE_CAP if inline_cap is None else int(inline_cap)
    m = nodes.count
    is_leaf = nodes.axis < 0
    counts = nodes.tri_count
    # Padded block sizes per node (0 for internal nodes).
    padded = np.where(is_leaf, ((counts + cap - 1) // cap) * cap, 0)
    # New starts: pre-order cumulative over padded sizes, but only leaves
    # own blocks; preserve the original leaf order (sorted by old start)
    # so blocks stay leaf-contiguous.
    leaf_ids = np.flatnonzero(is_leaf)
    leaf_order = leaf_ids[np.argsort(nodes.tri_start[leaf_ids], kind="stable")]
    new_start = np.zeros(m, np.int64)
    pos = 0
    for i in leaf_order:
        new_start[i] = pos
        pos += int(padded[i])
    total = pos

    # Scatter original tri ids into the padded layout; -1 marks pad slots.
    pad_order = np.full(total, -1, np.int64)
    for i in leaf_order:
        s_old, c = int(nodes.tri_start[i]), int(counts[i])
        pad_order[new_start[i]: new_start[i] + c] = order[s_old: s_old + c]

    valid = pad_order >= 0
    idx = np.where(valid, pad_order, 0)

    def take(a):
        a = np.asarray(a, np.float32).reshape(-1, 3)
        out = a[idx]
        out[~valid] = 0.0
        return out

    tris_flat = KDTris(
        v0=take(v0), v1=take(v1), v2=take(v2),
        n0=take(n0), n1=take(n1), n2=take(n2),
        material_id=np.where(valid, np.asarray(material_id, np.int32)[idx], 0
                             ).astype(np.int32),
        orig_index=np.where(valid, idx, -1).astype(np.int32),
    )
    nodes = nodes._replace(
        tri_start=new_start.astype(np.int32),
        tri_count=counts.astype(np.int32),
    )
    nodes = _refit_nodes(nodes, tris_flat)
    fat = _build_fat_rows(nodes, tris_flat, cap)
    octr = None
    if 8 * fat.rows.shape[0] <= OCTANT_ROWS_MAX_ROWS:
        octr = _build_octant_rows(nodes, tris_flat, cap)
    return KDFlat(
        nodes=nodes,
        tris=tris_flat,
        max_depth=int(deepest),
        root_bbox_min=np.asarray(root_min, np.float32),
        root_bbox_max=np.asarray(root_max, np.float32),
        fat=fat,
        oct=octr,
    )


def _refit_nodes(nodes: "KDNodes", tris: "KDTris",
                 pad: float = 1e-3) -> "KDNodes":
    """Leaf-tight bbox refit (reference: KDnode::updateBbox,
    KDnode.cpp:112-149, 0.001 pad).

    Leaves shrink to (cell box INTERSECT union of their triangles'
    bounds) + pad; interiors become the union of their children. Unlike
    the reference (whose refit merges full triangle bounds and can GROW
    a leaf past its cell), the cell intersection keeps the partition
    property while culling sparse leaves much tighter. Exactness: every
    surface point p of a triangle lies in some owning leaf's cell, and
    p is inside that leaf's triangle-union bound, so the root-to-leaf
    box chain over p survives — nearest-hit traversal is unchanged.
    """
    m = nodes.count
    bmin = nodes.bbox_min.copy()
    bmax = nodes.bbox_max.copy()
    is_leaf = nodes.axis < 0
    tmin = np.minimum(np.minimum(tris.v0, tris.v1), tris.v2)
    tmax = np.maximum(np.maximum(tris.v0, tris.v1), tris.v2)
    for i in np.flatnonzero(is_leaf):
        s, c = int(nodes.tri_start[i]), int(nodes.tri_count[i])
        if c == 0:
            continue
        lo = tmin[s: s + c].min(axis=0) - pad
        hi = tmax[s: s + c].max(axis=0) + pad
        bmin[i] = np.maximum(bmin[i], lo)
        bmax[i] = np.minimum(bmax[i], hi)
    # children always carry larger pre-order ids than their parent, so a
    # single reverse sweep propagates unions bottom-up.
    for i in range(m - 1, -1, -1):
        l, r = nodes.left[i], nodes.right[i]
        if l < 0 and r < 0:
            continue
        lo = np.full(3, np.inf, np.float32)
        hi = np.full(3, -np.inf, np.float32)
        for ch in (l, r):
            if ch >= 0:
                lo = np.minimum(lo, bmin[ch])
                hi = np.maximum(hi, bmax[ch])
        bmin[i] = lo
        bmax[i] = hi
    return nodes._replace(bbox_min=bmin, bbox_max=bmax)


def _tri_chunk_rows(tris: KDTris, cap: int) -> np.ndarray:
    """[T/cap, 9*cap] inline-triangle chunk rows, COMPONENT-MAJOR:
    group g of ``cap`` floats holds component g (v0x v0y v0z v1x ... v2z)
    of every slot. The traversal slices each component as a contiguous
    [n, cap] block, with no reshape or transpose in its loop."""
    tri9 = np.concatenate(
        [tris.v0, tris.v1, tris.v2], axis=1
    ).astype(np.float32)  # [T, 9]
    if not tri9.size:
        return np.zeros((0, cap * 9), np.float32)
    return tri9.reshape(-1, cap, 9).transpose(0, 2, 1).reshape(-1, 9 * cap)


def _build_fat_rows(nodes: KDNodes, tris: KDTris, cap: int) -> FatRows:
    """Assemble the FatRows table (scene.structs.FatRows has the layout).

    Fully numpy-vectorized: leaf chunk rows are laid out by a
    repeat/cumsum expansion instead of a per-node Python loop, so the
    build stays O(rows) numpy work even at millions of triangles (the
    reference's largest demos: R8 1.69M verts, Gutenberg 3M+,
    README.md:170-181).
    """
    m = nodes.count
    is_leaf = nodes.axis < 0
    counts = nodes.tri_count.astype(np.int64)
    n_chunks_leaf = np.maximum((counts + cap - 1) // cap, 1)
    extra = np.where(is_leaf, n_chunks_leaf - 1, 0)
    n_rows = m + int(extra.sum())
    width = 12 + 9 * cap
    rows = np.zeros((n_rows, width), np.float32)

    # skip ids must be remapped: node i's skip is an original node id (or
    # m for done). Original ids == row ids for the first m rows, so only
    # the done sentinel changes.
    skipf = np.where(nodes.skip >= m, n_rows, nodes.skip).astype(np.float32)

    # Node header rows [0:m] (leaf chunk fields overwritten below).
    rows[:m, 0] = np.where(is_leaf, -1, nodes.axis).astype(np.float32)
    rows[:m, 1:4] = nodes.bbox_min
    rows[:m, 4:7] = nodes.bbox_max
    rows[:m, 7] = skipf
    rows[:m, 8] = np.where(is_leaf, -1, nodes.left).astype(np.float32)
    rows[:m, 9] = np.where(is_leaf, -1, nodes.right).astype(np.float32)
    rows[:m, 10] = -1.0
    rows[:m, 11] = 0.0

    leaf_ids = np.flatnonzero(is_leaf)
    if leaf_ids.size:
        lc = n_chunks_leaf[leaf_ids]  # chunks per leaf
        # continuation-row base per leaf, in leaf_ids order (appended
        # after the main table, leaf order — same as the loop version)
        cont_start = m + np.concatenate(
            [[0], np.cumsum(np.maximum(lc - 1, 0))[:-1]]
        ).astype(np.int64)
        tot = int(lc.sum())
        rep = np.repeat(np.arange(leaf_ids.size), lc)  # leaf slot per chunk
        chunk_of = np.concatenate([[0], np.cumsum(lc)[:-1]])
        k = np.arange(tot) - np.repeat(chunk_of, lc)  # chunk idx in leaf
        li = leaf_ids[rep]  # node id per chunk
        rid = np.where(k == 0, li, cont_start[rep] + k - 1)
        nxt = np.where(k + 1 < lc[rep], cont_start[rep] + k, -1)
        c0 = nodes.tri_start[li].astype(np.int64) + k * cap
        inline_n = np.clip(counts[li] - k * cap, 0, cap)

        rows[rid, 0] = -1.0
        rows[rid, 1:4] = nodes.bbox_min[li]
        rows[rid, 4:7] = nodes.bbox_max[li]
        rows[rid, 7] = skipf[li]
        rows[rid, 8] = nxt.astype(np.float32)
        rows[rid, 9] = -1.0
        rows[rid, 10] = c0.astype(np.float32)
        rows[rid, 11] = inline_n.astype(np.float32)
        chunk_rows = _tri_chunk_rows(tris, cap)
        has = inline_n > 0
        rows[rid[has], 12:] = chunk_rows[c0[has] // cap]
    return FatRows(rows=rows, inline_cap=cap)


def _build_octant_rows(nodes: KDNodes, tris: KDTris, cap: int) -> OctantRows:
    """Eight near-first pre-order layouts, one per direction octant
    (OctantRows docstring). Links are absolute into the [8*M'] table."""
    m = nodes.count
    is_leaf = nodes.axis < 0
    counts = nodes.tri_count
    n_chunks = np.where(is_leaf, np.maximum((counts + cap - 1) // cap, 1), 0)

    # Subtree row counts (octant-independent): leaves contribute their
    # chain length, internal nodes 1 + children.
    size = np.zeros(m, np.int64)
    # nodes are pre-order, so children have larger ids: reverse sweep
    for i in range(m - 1, -1, -1):
        if is_leaf[i]:
            size[i] = int(n_chunks[i])
        else:
            s = 1
            if nodes.left[i] >= 0:
                s += size[nodes.left[i]]
            if nodes.right[i] >= 0:
                s += size[nodes.right[i]]
            size[i] = s
    layout_size = int(size[0]) if m else 0
    width = 12 + 9 * cap
    total = 8 * layout_size
    rows = np.zeros((total, width), np.float32)
    DONE = float(total)

    chunk_rows = _tri_chunk_rows(tris, cap)

    for o in range(8):
        base = o * layout_size
        # DFS: (orig node, assigned row id, skip target row id)
        stack = [(0, base, DONE)] if m else []
        while stack:
            i, rid, skip = stack.pop()
            if is_leaf[i]:
                start, cnt = int(nodes.tri_start[i]), int(counts[i])
                k_n = int(n_chunks[i])
                for k in range(k_n):
                    rr = rows[rid + k]
                    c0 = start + k * cap
                    rr[0] = -1.0
                    rr[1:4] = nodes.bbox_min[i]
                    rr[4:7] = nodes.bbox_max[i]
                    rr[7] = skip
                    rr[8] = float(rid + k + 1) if k + 1 < k_n else -1.0
                    rr[9] = -1.0
                    rr[10] = float(c0)
                    rr[11] = float(max(0, min(cap, cnt - k * cap)))
                    if rr[11] > 0:
                        rr[12:] = chunk_rows[c0 // cap]
                continue
            ax = int(nodes.axis[i])
            l, r = int(nodes.left[i]), int(nodes.right[i])
            # near child: low side when the octant's direction is
            # positive on the split axis (pathtrace.cu:1104-1112)
            near, far = (l, r) if (o >> ax) & 1 else (r, l)
            if near < 0:
                near, far = far, -1
            rr = rows[rid]
            rr[0] = float(ax)
            rr[1:4] = nodes.bbox_min[i]
            rr[4:7] = nodes.bbox_max[i]
            rr[7] = skip
            rr[8] = float(rid + 1)  # pre-order successor = near child
            rr[9] = -1.0
            rr[10] = -1.0
            if far >= 0:
                far_rid = rid + 1 + int(size[near])
                stack.append((far, far_rid, skip))
                stack.append((near, rid + 1, float(far_rid)))
            else:
                stack.append((near, rid + 1, skip))
    return OctantRows(rows=rows, layout_size=layout_size, inline_cap=cap)


def build_kdtree_from_mesh(mesh, leaf_size: int = 4, max_depth: Optional[int] = None) -> KDFlat:
    """Build from a scene.structs.MeshSoA (the loadObj -> KDtree path,
    reference: scene.cpp:860-903). The fat-row inline cap follows the
    leaf size so typical leaves fit one traversal step."""
    return build_kdtree(
        mesh.v0,
        mesh.v1,
        mesh.v2,
        mesh.n0,
        mesh.n1,
        mesh.n2,
        mesh.material_id,
        leaf_size=leaf_size,
        max_depth=max_depth,
        inline_cap=max(8, leaf_size),
    )


def validate_kdtree(kd: KDFlat, n_source_tris: int) -> None:
    """Structural invariants (the property tests the reference never had,
    SURVEY.md §4): every source triangle appears in >= 1 leaf; leaf
    bboxes contain their triangles (within slack); links are consistent."""
    nodes = kd.nodes
    m = nodes.count
    covered = np.zeros((n_source_tris,), bool)
    covered[kd.tris.orig_index[kd.tris.orig_index >= 0]] = True
    assert covered.all(), "some triangles missing from all leaves"

    is_leaf = nodes.axis < 0
    assert (nodes.tri_count[~is_leaf] == 0).all()
    starts = nodes.tri_start[is_leaf]
    counts = nodes.tri_count[is_leaf]
    cap = kd.fat.inline_cap if kd.fat is not None else INLINE_CAP
    order_sorted = np.argsort(starts)
    # leaves tile the flat tri array in cap-aligned padded blocks
    s, c = starts[order_sorted], counts[order_sorted]
    pad = ((c + cap - 1) // cap) * cap
    assert (s % cap == 0).all()
    assert s[0] == 0 and (s[1:] == (s[:-1] + pad[:-1])).all()
    assert s[-1] + pad[-1] == kd.tris.count
    # pad slots are marked invalid, real slots valid
    valid = kd.tris.orig_index >= 0
    for st, cn, pd in zip(s, c, pad):
        assert valid[st: st + cn].all()
        assert not valid[st + cn: st + pd].any()

    for i in range(m):
        l, r = nodes.left[i], nodes.right[i]
        if l >= 0:
            assert nodes.parent[l] == i and l == i + 1
        if r >= 0:
            assert nodes.parent[r] == i
        # children bboxes inside parent
        for ch in (l, r):
            if ch >= 0:
                assert (nodes.bbox_min[ch] >= nodes.bbox_min[i] - 1e-5).all()
                assert (nodes.bbox_max[ch] <= nodes.bbox_max[i] + 1e-5).all()
