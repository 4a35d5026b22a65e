"""Scene data model: struct-of-arrays NamedTuples.

The same containers and field names as the JAX package's
``scene/structs.py`` (reference: src/sceneStructs.h:15-85). Where the JAX
package kept everything as pytrees, here the split is by size:

- ``Camera``, ``GeomSoA`` and ``MaterialSoA`` are a handful of rows and
  stay numpy arrays on the host. The integrator reads the geoms as Python
  scalars (one static test per geom), just as the JAX package keeps such
  small leaves concrete. Materials and the camera may also be tensors
  (``convert.materials_to_torch``, ``ops.camera.derive_camera``), which is
  how gradients reach them.
- ``MeshSoA`` and the cluster table (``ops.cluster.ClusterMesh``) are
  tensors on the render device once the scene is loaded or converted
  (``convert.scene_from_numpy``); the loaders build them in numpy first.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

# Geometry type enum (reference: sceneStructs.h GeomType)
GEOM_SPHERE = 0
GEOM_CUBE = 1


class Camera(NamedTuple):
    """Pinhole camera (reference: sceneStructs.h Camera, scene.cpp:175-234)."""

    resolution: np.ndarray  # [2] int32 (x, y)
    position: np.ndarray  # [3] f32
    look_at: np.ndarray  # [3] f32
    view: np.ndarray  # [3] f32, normalized look direction
    up: np.ndarray  # [3] f32
    right: np.ndarray  # [3] f32
    fov: np.ndarray  # [2] f32 degrees (x, y)
    pixel_length: np.ndarray  # [2] f32


class GeomSoA(NamedTuple):
    """Analytic geometry (cubes/spheres) with per-geom 4x4 transforms."""

    type: np.ndarray  # [G] int32 (GEOM_SPHERE | GEOM_CUBE)
    material_id: np.ndarray  # [G] int32
    transform: np.ndarray  # [G, 4, 4] f32
    inverse_transform: np.ndarray  # [G, 4, 4] f32
    inv_transpose: np.ndarray  # [G, 4, 4] f32
    translation: np.ndarray = None  # [G, 3] f32
    rotation: np.ndarray = None  # [G, 3] f32 degrees
    scale: np.ndarray = None  # [G, 3] f32

    @property
    def count(self) -> int:
        return int(self.type.shape[0])


class MaterialSoA(NamedTuple):
    """Materials as SoA (reference: sceneStructs.h Material)."""

    color: np.ndarray  # [M, 3] f32
    specular_exponent: np.ndarray  # [M] f32
    specular_color: np.ndarray  # [M, 3] f32
    has_reflective: np.ndarray  # [M] f32 (probability)
    has_refractive: np.ndarray  # [M] f32 (probability)
    index_of_refraction: np.ndarray  # [M] f32
    emittance: np.ndarray  # [M] f32
    transmittance: np.ndarray  # [M, 3] f32

    @property
    def count(self) -> int:
        return int(self.emittance.shape[0])


class MeshSoA(NamedTuple):
    """Triangle mesh, vertices and normals pre-gathered per triangle
    (reference: scene.cpp:620-712). ``material_id`` is already offset
    into the global material table."""

    v0: np.ndarray  # [T, 3] f32
    v1: np.ndarray  # [T, 3] f32
    v2: np.ndarray  # [T, 3] f32
    n0: np.ndarray  # [T, 3] f32
    n1: np.ndarray  # [T, 3] f32
    n2: np.ndarray  # [T, 3] f32
    material_id: np.ndarray  # [T] int32
    shape_id: np.ndarray  # [T] int32
    shape_bbox_min: np.ndarray  # [S, 3] f32 (scene.cpp:692-711)
    shape_bbox_max: np.ndarray  # [S, 3] f32

    @property
    def count(self) -> int:
        return int(self.material_id.shape[0])


def concat_materials(a: MaterialSoA, b: MaterialSoA) -> MaterialSoA:
    """Append OBJ materials after scene materials (scene.cpp:816-820)."""
    return MaterialSoA(
        *(np.concatenate([np.asarray(x), np.asarray(y)], axis=0)
          for x, y in zip(a, b))
    )


class RenderState(NamedTuple):
    """Per-render bookkeeping (reference: sceneStructs.h RenderState)."""

    iterations: int
    trace_depth: int
    image_name: str


class SceneData(NamedTuple):
    """Everything loaded from a scene file + optional OBJ.

    ``mesh`` / ``cmesh`` are None for analytic-only scenes. There is no KD
    table: the KD intersector is not ported yet.
    """

    camera: Camera
    geoms: GeomSoA
    materials: MaterialSoA
    state: RenderState
    mesh: Optional[MeshSoA] = None
    cmesh: Optional["ClusterMesh"] = None  # noqa: F821 — ops.cluster
