"""Carry a scene's tables into the port, onto a device.

``scene_from_numpy`` takes a ``SceneData`` of either package — the JAX
package's with its leaves turned into numpy arrays (``jax.tree.map(
np.asarray, scene)``), or the port's own — and returns the port's
``SceneData`` with the mesh and cluster tables as tensors on ``device``
and the small tables (camera, geoms, materials) as numpy on the host.
The JAX scene's KD table, if any, is not carried: the port has no KD
intersector yet.
"""

from __future__ import annotations

import numpy as np

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
