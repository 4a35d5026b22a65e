"""Carry a scene's tables into the port, onto a device.

``scene_from_numpy`` takes a ``SceneData`` of either package — the JAX
package's with its leaves turned into numpy arrays (``jax.tree.map(
np.asarray, scene)``), or the port's own — and returns the port's
``SceneData`` with the mesh and cluster tables as tensors on ``device``
and the small tables (camera, geoms, materials) as numpy on the host.
The JAX scene's KD table, if any, is not carried: the port has no KD
intersector yet.

For gradients, ``materials_to_torch`` carries a material table onto a
device as tensors (optionally leaves that require grad) and
``materials_to_numpy`` carries it back; ``with_tris`` gives a cluster
table new triangle tables (for example ones that require grad) and builds
its [T, 19] record from them, once per differentiated call.
"""

from __future__ import annotations

import numpy as np
import torch

from kdtreepathtraceroptimization_tpu_torch.ops.cluster import ClusterMesh
from kdtreepathtraceroptimization_tpu_torch.ops.mesh import pack_tris
from kdtreepathtraceroptimization_tpu_torch.scene.structs import (
    Camera,
    GeomSoA,
    MaterialSoA,
    MeshSoA,
    RenderState,
    SceneData,
)
from kdtreepathtraceroptimization_tpu_torch.utils.device import resolve_device, to_tensor


def _host(a):
    return None if a is None else np.asarray(a)


def _mesh(mesh, device) -> MeshSoA:
    return MeshSoA(*(to_tensor(a, device) for a in mesh))


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
               if f not in ("tris", "block", "n_real_blocks", "packed")},
            tris=tris,
            block=int(cm.block),
            n_real_blocks=int(cm.n_real_blocks),
            packed=pack_tris(tris),
        )
    return SceneData(
        camera=Camera(*(_host(a) for a in scene.camera)),
        geoms=GeomSoA(*(_host(a) for a in scene.geoms)),
        materials=MaterialSoA(*(_host(a) for a in scene.materials)),
        state=RenderState(int(state.iterations), int(state.trace_depth),
                          str(state.image_name)),
        mesh=None if scene.mesh is None else _mesh(scene.mesh, device),
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
    intersectors keep reading ``cmesh``'s own block weights and bounds:
    the winner choice carries no gradient. Build it once per
    differentiated call; the record is shared by every bounce."""
    return cmesh._replace(tris=tris, packed=pack_tris(tris))
