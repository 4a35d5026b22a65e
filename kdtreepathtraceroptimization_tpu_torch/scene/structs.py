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
- ``MeshSoA``, the KD table (``KDFlat``) and the cluster table
  (``ops.cluster.ClusterMesh``) are tensors on the render device once the
  scene is loaded or converted (``convert.scene_from_numpy``); the loaders
  and the KD build (``accel/kdtree.py``) make them in numpy first.
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


class KDNodes(NamedTuple):
    """Flat KD node table in DFS pre-order (NodeBare analog,
    KDnode.h:64-82): left child at id + 1, a skip link per node."""

    axis: np.ndarray  # [M] int32, -1 = leaf
    split_pos: np.ndarray  # [M] f32 (bbox center on axis; 0 for leaves)
    bbox_min: np.ndarray  # [M, 3] f32
    bbox_max: np.ndarray  # [M, 3] f32
    left: np.ndarray  # [M] int32 (= id+1 for internal, -1 leaf)
    right: np.ndarray  # [M] int32 (-1 if absent)
    skip: np.ndarray  # [M] int32 pre-order escape link (M = done)
    parent: np.ndarray  # [M] int32 (-1 for root)
    tri_start: np.ndarray  # [M] int32 into the leaf-contiguous tri array
    tri_count: np.ndarray  # [M] int32 (0 for internal nodes)

    @property
    def count(self) -> int:
        return int(self.axis.shape[0])


class KDTris(NamedTuple):
    """Leaf-contiguous pre-gathered triangles (TriBare analog). A triangle
    in several leaves appears once per leaf; each leaf's block is padded
    to a multiple of the fat rows' inline cap with all-zero triangles."""

    v0: np.ndarray  # [T', 3]
    v1: np.ndarray
    v2: np.ndarray
    n0: np.ndarray
    n1: np.ndarray
    n2: np.ndarray
    material_id: np.ndarray  # [T'] int32
    orig_index: np.ndarray  # [T'] int32: index into the source mesh, -1 = pad

    @property
    def count(self) -> int:
        return int(self.material_id.shape[0])


class FatRows(NamedTuple):
    """The traversal table: one f32 row per traversal step, node header and
    up to ``inline_cap`` leaf triangles together; leaves with more chain
    into continuation rows appended after the node rows.

    Row layout (width 12 + 9 * inline_cap):
      [0]     axis        (>= 0 internal; -1 leaf / continuation)
      [1:4]   bbox_min    [4:7] bbox_max
      [7]     skip        (pre-order escape; n_rows = done)
      [8]     next        (internal: left child; leaf: continuation or -1)
      [9]     right       (internal: right child; else -1)
      [10]    tri_base    (KDTris index of inline slot 0)
      [11]    inline_n    (valid inline slots, 0..inline_cap)
      [12:]   inline tris, component-major: group g of inline_cap floats
              holds component g (v0x v0y v0z v1x ... v2z) of every slot;
              zero-padded (a degenerate triangle never hits)

    Integer ids are stored as f32: exact up to 2^24 rows and triangles.
    """

    rows: np.ndarray  # [M', 12 + 9 * inline_cap] f32
    inline_cap: int

    @property
    def count(self) -> int:
        return int(self.rows.shape[0])


class OctantRows(NamedTuple):
    """Eight near-first pre-order layouts of the fat-row table, one per
    ray-direction octant (children swapped so the near child is the
    pre-order successor), so the stackless walk visits near subtrees
    first. A ray enters at ``octant * layout_size``; links are absolute
    into the [8 * M'] table and ``8 * layout_size`` is done."""

    rows: np.ndarray  # [8 * M', 12 + 9 * cap] f32 (FatRows' layout)
    layout_size: int  # M' (rows per octant layout)
    inline_cap: int


class KDFlat(NamedTuple):
    """Everything the KD walk needs. ``packed`` is the [T', 19] record of
    ``tris`` (``ops.mesh.pack_tris``), built when the table moves to a
    device (``convert.scene_from_numpy``)."""

    nodes: KDNodes
    tris: KDTris
    max_depth: int  # deepest level actually produced
    root_bbox_min: np.ndarray  # [3]
    root_bbox_max: np.ndarray  # [3]
    fat: Optional[FatRows] = None
    oct: Optional[OctantRows] = None
    packed: Optional["torch.Tensor"] = None  # noqa: F821


class SceneData(NamedTuple):
    """Everything loaded from a scene file + optional OBJ.

    ``mesh`` / ``kd`` / ``cmesh`` are None for analytic-only scenes.
    """

    camera: Camera
    geoms: GeomSoA
    materials: MaterialSoA
    state: RenderState
    mesh: Optional[MeshSoA] = None
    kd: Optional[KDFlat] = None
    cmesh: Optional["ClusterMesh"] = None  # noqa: F821 — ops.cluster
