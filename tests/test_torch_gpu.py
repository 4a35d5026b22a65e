"""The CUDA kernels against their plain versions, on the card.

Marked ``gpu``: they need a CUDA device with nvcc and skip elsewhere. On
the H100 run ``python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q``
(``--noconftest``: the suite's conftest imports JAX, which that machine lacks).
``chip_smoke.py`` checks the kernels at the main path's shapes; these
tests cover the other shapes the wrappers accept: tiles whose staging
needs more than 48 KB of shared memory, 64- to 1024-triangle blocks,
tiles with empty feasible lists or only dead rays, and bad arguments.
Tolerances: slab cull and gather-to-columns bit for bit; walk triangle
ids exactly and t within 1e-5 relative (its 10-term sums may round
differently from the batched product).
"""

import numpy as np
import pytest
import torch

from kdtreepathtraceroptimization_tpu_torch.config import RenderConfig
from kdtreepathtraceroptimization_tpu_torch.ops import mesh as tmesh
from kdtreepathtraceroptimization_tpu_torch.ops import mxu_bf
from kdtreepathtraceroptimization_tpu_torch.ops import walk as twalk
from kdtreepathtraceroptimization_tpu_torch.ops.cluster import build_cluster_mesh
from kdtreepathtraceroptimization_tpu_torch.scene.structs import MeshSoA
from kdtreepathtraceroptimization_tpu_torch.utils.procmesh import icosphere

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


def _mesh(subdiv):
    verts, faces = icosphere(subdiv, radius=2.0, center=(0.3, -0.2, 0.5))
    v = verts[faces]
    n = np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
    n /= np.linalg.norm(n, axis=1, keepdims=True) + 1e-12
    t = v.shape[0]
    return MeshSoA(v0=v[:, 0], v1=v[:, 1], v2=v[:, 2], n0=n, n1=n, n2=n,
                   material_id=np.zeros(t, np.int32), shape_id=np.zeros(t, np.int32),
                   shape_bbox_min=v.min((0, 1))[None], shape_bbox_max=v.max((0, 1))[None])


def _walk_inputs(cm, n, tile, seed, dead_frac=0.2):
    """Sorted walk inputs for random rays, the way intersect_mesh_walk
    builds them; the last tile is all dead."""
    rng = np.random.default_rng(seed)
    dev = cm.w.device
    # origins around the sphere, aimed near its centre: most rays hit
    o = rng.normal(size=(n, 3)).astype(np.float32) * 4.0
    d = (np.array([0.3, -0.2, 0.5], np.float32)
         + rng.normal(size=(n, 3)).astype(np.float32) * 1.5 - o)
    o = torch.tensor(o, device=dev)
    d = torch.tensor(d / np.linalg.norm(d, axis=1, keepdims=True), device=dev)
    act = torch.tensor(rng.uniform(size=n) > dead_frac, device=dev)
    act[-tile:] = False
    t0 = torch.tensor(rng.uniform(2.0, 20.0, n).astype(np.float32), device=dev)
    o = o - cm.center_shift
    d = torch.where(act[:, None], d, 0.0)
    x = twalk._ray16(o, d, t0, act.float())
    tile_entry = twalk._slab_cull_ref(x, cm.slab, cm.blk, tile)
    sel, lb, nsel = twalk._full_select(tile_entry)
    r = torch.cat([mxu_bf.ray_features(x[:, 0:3], x[:, 3:6]),
                   torch.zeros((n, 6), device=dev)], dim=1)
    return x, sel, lb, nsel, r, x[:, 6].contiguous(), x[:, 7].contiguous()


@pytest.mark.parametrize("tile", [256, 1024, 4096])
def test_slab_cull_kernel_bit_equal(cuda, tile):
    cm = build_cluster_mesh(_mesh(4), block=64, device=cuda)
    x, *_ = _walk_inputs(cm, 8192, tile, seed=tile)
    got = twalk.slab_cull(x, cm.slab, cm.blk, tile)
    want = twalk._slab_cull_ref(x, cm.slab, cm.blk, tile)
    assert torch.equal(got, want)


@pytest.mark.parametrize("block, tile", [(64, 256), (256, 1024), (512, 512), (1024, 128)])
def test_walk_kernel_matches_plain(cuda, block, tile):
    cm = build_cluster_mesh(_mesh(5), block=block, device=cuda)
    n = 8 * tile
    x, sel, lb, nsel, r, t0, act = _walk_inputs(cm, n, tile, seed=block)
    assert int(nsel.min()) == 0  # the dead tile has an empty list
    before = twalk.WALK.launches
    bt_k, btri_k = twalk.walk(sel, lb, nsel, r, t0, act, cm.w, tile, block)
    bt_p, btri_p = twalk._walk_ref(sel, lb, r, t0, act, cm.w, tile, block)
    assert twalk.WALK.launches == before + 1
    assert int((btri_p >= 0).sum()) > n // 4
    assert torch.equal(btri_k, btri_p)
    torch.testing.assert_close(bt_k, bt_p, rtol=1e-5, atol=0)
    assert (btri_k[-tile:] == -1).all()


@pytest.mark.parametrize("n, c", [(1, 19), (1000, 19), (640_000, 19), (5000, 3)])
def test_gather_cols_kernel_bit_equal(cuda, n, c):
    g = torch.Generator(device="cpu").manual_seed(n)
    packed = torch.randn((4096, c), generator=g).to(cuda)
    tri = torch.randint(0, 4096, (n,), generator=g, dtype=torch.int32).to(cuda)
    assert torch.equal(tmesh.gather_cols(packed, tri), packed[tri.long()].T)


def test_wrappers_check_their_arguments(cuda):
    cm = build_cluster_mesh(_mesh(3), block=64, device=cuda)
    x, sel, lb, nsel, r, t0, act = _walk_inputs(cm, 1024, 256, seed=0)
    with pytest.raises(ValueError):
        twalk.slab_cull(x.double(), cm.slab, cm.blk, 256)
    with pytest.raises(ValueError):
        twalk.slab_cull(x, cm.slab, cm.blk, 384)  # does not divide n
    with pytest.raises(ValueError):
        twalk.walk(sel.long(), lb, nsel, r, t0, act, cm.w, 256, cm.block)
    with pytest.raises(ValueError):
        twalk.walk(sel, lb, nsel, r.T.contiguous().T, t0, act, cm.w, 256, cm.block)
    with pytest.raises(ValueError):
        tmesh.gather_cols(torch.zeros((4, 19), device=cuda), torch.zeros(3, dtype=torch.int64, device=cuda))
    before = tmesh.GATHER_COLS.launches
    out = tmesh.gather_cols(torch.zeros((4, 19), device=cuda),
                            torch.zeros(0, dtype=torch.int32, device=cuda))
    assert out.shape == (19, 0) and tmesh.GATHER_COLS.launches == before


def test_walk_intersector_on_cuda_matches_cpu(cuda):
    """The whole intersector, kernels against plain versions."""
    mesh = _mesh(4)
    rng = np.random.default_rng(3)
    o = rng.normal(size=(4096, 3)).astype(np.float32) * 4.0
    d = rng.normal(size=(4096, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    cfg = RenderConfig(cluster_tile=256)
    hits = [twalk.intersect_mesh_walk(torch.tensor(o, device=dev), torch.tensor(d, device=dev),
                                      build_cluster_mesh(mesh, block=256, device=dev), cfg)
            for dev in (cuda, torch.device("cpu"))]
    assert torch.equal(hits[0].tri.cpu(), hits[1].tri)
    torch.testing.assert_close(hits[0].t.cpu(), hits[1].t, rtol=1e-5, atol=0)
