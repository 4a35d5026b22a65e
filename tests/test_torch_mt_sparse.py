"""The zero pattern that the walk and brute-force kernels' sparse test rests
on (csrc/mt_block.cuh), in the port's weight tables and the JAX
package's cluster table, and the sparse chain against the dense one.

A triangle's Moller-Trumbore weights [a | t_num | u_num | v_num] over the
ray features [o, d, o x d, 1] may be non-zero only in 19 places, and a's
rows 3-5 are -(t_num's rows 0-2). Checked exactly: the tables hold
exact zeros and negations, no rounding is involved.
"""

import numpy as np
import pytest
import torch

from kdtreepathtraceroptimization_tpu.ops.cluster import build_cluster_mesh as jbuild
from kdtreepathtraceroptimization_tpu_torch.ops import mxu_bf as tmxu
from kdtreepathtraceroptimization_tpu_torch.ops.cluster import build_cluster_mesh as tbuild
from tests.test_cluster import _mesh


def _triangles(kind, t=300, seed=0):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(3, t, 3)).astype(np.float32) * 3.0
    if kind == "degenerate":
        v[1, ::2] = v[0, ::2]  # all three vertices equal: the build's padding
        v[2, ::2] = v[0, ::2]
        v[2, 1::4] = v[1, 1::4]  # two equal: a zero-area sliver
        v[:, 3::8, 0] = 0.0  # zero coordinates: signed zeros in n and c
    return [torch.from_numpy(a) for a in v]


def _nonzero_places(w4):
    """[K, F, 4, B] -> the set of (quantity, row) that hold a non-zero."""
    nz = (w4 != 0).any(dim=(0, 3))
    return {(q, f) for f, q in zip(*np.nonzero(nz.numpy()))}


def _check_pattern(w):
    """The pattern, independently of check_sparse_pattern, and that the
    helper passes it."""
    k, f, cols = w.shape
    w4 = w.reshape(k, f, 4, cols // 4)
    allowed = {(0, 3), (0, 4), (0, 5), (1, 0), (1, 1), (1, 2), (1, 9),
               *((2, r) for r in range(3, 9)), *((3, r) for r in range(3, 9))}
    assert len(allowed) == 19
    assert _nonzero_places(w4) <= allowed
    a, t = w4[:, 3:6, 0, :], w4[:, 0:3, 1, :]
    assert torch.equal(a, -t)
    nz = a != 0  # bit for bit where not zero
    assert torch.equal(a[nz].view(torch.int32), (-t[nz]).view(torch.int32))
    tmxu.check_sparse_pattern(w)


@pytest.mark.parametrize("kind", ["random", "degenerate"])
def test_tri_weights_and_blocks_have_the_sparse_pattern(kind):
    v0, v1, v2 = _triangles(kind)
    w = tmxu.tri_weights(v0, v1, v2)  # [10, 4T]
    _check_pattern(w[None])
    _, vs = tmxu._centered(torch.zeros((1, 3)), v0, v1, v2, 64)  # padded to 320
    blocks = tmxu._block_weights(vs, 64)
    assert blocks.shape == (5, 10, 256)
    _check_pattern(blocks)


@pytest.mark.parametrize("method", ["kd", "morton"])
def test_cluster_tables_have_the_sparse_pattern(method):
    """The port's and the JAX package's padded tables: icosphere-2 (320
    triangles) in 48-slot blocks pads leaves with degenerate copies and
    the block axis with zero sentinel blocks."""
    mesh = _mesh(2)
    tcm = tbuild(mesh, block=48, method=method, device="cpu")
    assert int(tcm.real[:tcm.n_real_blocks].sum()) == 320
    assert tcm.n_blocks > tcm.n_real_blocks
    _check_pattern(tcm.w)
    _check_pattern(torch.from_numpy(np.array(jbuild(mesh, block=48, method=method).w)))


@pytest.mark.parametrize("fault", ["stray", "sign"])
def test_check_sparse_pattern_raises(fault):
    w = tbuild(_mesh(1), block=16, device="cpu").w.clone()
    w4 = w.view(w.shape[0], 16, 4, -1)
    if fault == "stray":
        w4[0, 9, 2, 3] = 1e-30  # u_num's row 9 (the constant) must be zero
    else:
        a = np.float32(w4[0, 4, 0, 5])
        w4[0, 4, 0, 5] = float(np.nextafter(a, np.float32(2.0)))  # a no longer -t_num
    with pytest.raises(ValueError):
        tmxu.check_sparse_pattern(w)


def test_sparse_weights_layout():
    w = tbuild(_mesh(2), block=64, device="cpu").w
    ws = tmxu.sparse_weights(w)
    k, b = w.shape[0], 64
    assert ws.shape == (k, b, 16) and ws.is_contiguous()
    w4 = w.reshape(k, 16, 4, b)
    for i, (q, f) in enumerate(tmxu.SPARSE_ORDER):
        assert torch.equal(ws[:, :, i], w4[:, f, q, :])


def _fma(x, y, acc):
    """float32 fmaf emulated in float64 (the product of two float32 is
    exact there). Both chains below use it, so they are compared as the
    card would run them up to this emulation's own rounding."""
    return (x.astype(np.float64) * y + acc).astype(np.float32)


def _dense(r, w):
    """The dense chain of csrc/mt_block.cuh (dot10) for each of the four
    quantities: r [N, 10], w [10, 4] -> [N, 4]."""
    out = []
    for q in range(4):
        acc = (r[:, 0] * w[0, q]).astype(np.float32)
        for f in range(1, 10):
            acc = _fma(r[:, f], w[f, q], acc)
        out.append(acc)
    return np.stack(out, axis=1)


def _sparse(r, ws):
    """mt::sparse_accept's chains on the 16 distinct weights ws [16]."""
    a = -_fma(r[:, 5], ws[2], _fma(r[:, 4], ws[1], (r[:, 3] * ws[0]).astype(np.float32)))
    tn = _fma(r[:, 9], ws[3], _fma(r[:, 2], ws[2],
                                   _fma(r[:, 1], ws[1], (r[:, 0] * ws[0]).astype(np.float32))))
    un = (r[:, 3] * ws[4]).astype(np.float32)
    vn = (r[:, 3] * ws[10]).astype(np.float32)
    for f in range(4, 9):
        un = _fma(r[:, f], ws[f + 1], un)
        vn = _fma(r[:, f], ws[f + 7], vn)
    return np.stack([a, tn, un, vn], axis=1)


@pytest.mark.parametrize("kind", ["random", "degenerate"])
def test_sparse_chain_equals_dense_chain(kind):
    """The 19 FMAs of the sparse test give the dense 40-term chains'
    values, bit for bit but the sign of a zero (equal as floats), on rays
    with zero components too."""
    v0, v1, v2 = _triangles(kind, t=40, seed=1)
    w = tmxu.tri_weights(v0, v1, v2).numpy()  # [10, 4T]
    t = v0.shape[0]
    ws = tmxu.sparse_weights(torch.from_numpy(w)[None]).numpy()[0]  # [T, 16]
    rng = np.random.default_rng(2)
    o = rng.normal(size=(512, 3)).astype(np.float32) * 4.0
    d = rng.normal(size=(512, 3)).astype(np.float32)
    d[::7, 1] = 0.0
    d[::11] = 0.0  # dead rays
    r = tmxu.ray_features(torch.from_numpy(o), torch.from_numpy(d)).numpy()
    for j in range(t):
        dense = _dense(r, w[:, j::t])
        sparse = _sparse(r, ws[j])
        np.testing.assert_array_equal(dense, sparse)
