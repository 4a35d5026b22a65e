"""Carry a scene's tables into the port, onto a device.

``scene_from_numpy`` takes a ``SceneData`` of either package — the JAX
package's with its leaves turned into numpy arrays (``jax.tree.map(
np.asarray, scene)``), or the port's own — and returns the port's
``SceneData`` with the mesh, KD and cluster tables as tensors on
``device`` and the small tables (camera, geoms, materials) as numpy on
the host. Each table with triangles gets its [T, 19] record
(``ops.mesh.pack_tris``) there, and the cluster table its blocks' real
slot counts (``ops.cluster.real_slots``).

For gradients, ``materials_to_torch`` carries a material table onto a
device as tensors (optionally leaves that require grad) and
``materials_to_numpy`` carries it back; ``with_tris`` gives a cluster
table new triangle tables (for example ones that require grad) and builds
its [T, 19] record from them, once per differentiated call.
"""

from __future__ import annotations

import numpy as np
import torch

from kdtreepathtraceroptimization_tpu_torch.ops.cluster import ClusterMesh, real_slots
from kdtreepathtraceroptimization_tpu_torch.ops.mesh import pack_tris
from kdtreepathtraceroptimization_tpu_torch.scene.structs import (
    Camera,
    FatRows,
    GeomSoA,
    KDFlat,
    KDNodes,
    KDTris,
    MaterialSoA,
    MeshSoA,
    OctantRows,
    RenderState,
    SceneData,
)
from kdtreepathtraceroptimization_tpu_torch.utils.device import resolve_device, to_tensor


def _host(a):
    if isinstance(a, torch.Tensor) and not a.requires_grad:
        a = a.cpu()  # a camera moved on the device (ops/camera.orbit_camera)
    return None if a is None else np.asarray(a)


def _mesh(mesh, device) -> MeshSoA:
    return MeshSoA(*(to_tensor(a, device) for a in mesh))


def kd_to_device(kd, device) -> KDFlat:
    """A KD table (numpy, or already tensors) as tensors on ``device``,
    with its triangles' [T', 19] record."""
    tris = KDTris(*(to_tensor(a, device) for a in kd.tris))
    fat = oct_rows = None
    if kd.fat is not None:
        fat = FatRows(rows=to_tensor(kd.fat.rows, device), inline_cap=int(kd.fat.inline_cap))
    if kd.oct is not None:
        oct_rows = OctantRows(rows=to_tensor(kd.oct.rows, device),
                              layout_size=int(kd.oct.layout_size),
                              inline_cap=int(kd.oct.inline_cap))
    return KDFlat(
        nodes=KDNodes(*(to_tensor(a, device) for a in kd.nodes)),
        tris=tris,
        max_depth=int(kd.max_depth),
        root_bbox_min=to_tensor(kd.root_bbox_min, device),
        root_bbox_max=to_tensor(kd.root_bbox_max, device),
        fat=fat,
        oct=oct_rows,
        packed=pack_tris(tris),
    )


def scene_from_numpy(scene, device) -> SceneData:
    """The port's ``SceneData`` for ``scene``, its mesh tables on ``device``."""
    device = resolve_device(device)
    state = scene.state
    cm = getattr(scene, "cmesh", None)
    cmesh = None
    if cm is not None:
        tris = _mesh(cm.tris, device)
        cmesh = ClusterMesh(
            **{f: to_tensor(getattr(cm, f), device)
               for f in ClusterMesh._fields
               if f not in ("tris", "block", "n_real_blocks", "packed", "real")},
            tris=tris,
            block=int(cm.block),
            n_real_blocks=int(cm.n_real_blocks),
            packed=pack_tris(tris),
            real=real_slots(tris, int(cm.block), int(np.shape(cm.blk)[1])),
        )
    return SceneData(
        camera=Camera(*(_host(a) for a in scene.camera)),
        geoms=GeomSoA(*(_host(a) for a in scene.geoms)),
        materials=MaterialSoA(*(_host(a) for a in scene.materials)),
        state=RenderState(int(state.iterations), int(state.trace_depth),
                          str(state.image_name)),
        mesh=None if scene.mesh is None else _mesh(scene.mesh, device),
        kd=None if getattr(scene, "kd", None) is None else kd_to_device(scene.kd, device),
        cmesh=cmesh,
    )


def materials_to_torch(materials, device, requires_grad: bool = False) -> MaterialSoA:
    """A material table (numpy or tensors) as float32 tensors on
    ``device``; with ``requires_grad`` each field is a fresh leaf that
    requires grad."""
    device = resolve_device(device)
    fields = (torch.tensor(np.asarray(a, np.float32), device=device)
              if not isinstance(a, torch.Tensor)
              else a.detach().to(device=device, dtype=torch.float32, copy=True)
              for a in materials)
    return MaterialSoA(*(f.requires_grad_(requires_grad) for f in fields))


def materials_to_numpy(materials) -> MaterialSoA:
    """A material table of tensors back on the host as numpy arrays."""
    return MaterialSoA(*(a.detach().cpu().numpy() if isinstance(a, torch.Tensor)
                         else np.asarray(a) for a in materials))


def with_tris(cmesh: ClusterMesh, tris: MeshSoA) -> ClusterMesh:
    """``cmesh`` with triangle tables ``tris`` and its [T, 19] record built
    from them, so gradients reach them through the hit expansion. The
    intersectors keep reading ``cmesh``'s own block weights, bounds and
    real-slot counts: the winner choice carries no gradient. Build it once per
    differentiated call; the record is shared by every bounce."""
    return cmesh._replace(tris=tris, packed=pack_tris(tris))
