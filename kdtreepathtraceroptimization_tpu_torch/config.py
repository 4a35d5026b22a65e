"""Render configuration: the JAX package's ``RenderConfig``, field for field.

Same field names and defaults as ``kdtreepathtraceroptimization_tpu.config``
so one config describes a render in either package, and the port
implements every field: all seven mesh intersectors of the JAX dispatch
(the pair list with either pair kernel, ``pair_bdiag``; the exact cluster
walk; binned; cluster rounds; every KD walk: the fat-row skip-link,
short-stack and packet walks and the thin-table skip-link, short-stack and
push-down walks; both brute forces), the wavefront reorderings
(``compaction``, ``material_sort``), the ray cache (``ray_cache``) and
the shard-local sorts (``binned_shards``). One differs: ``scan_bounces``
changes nothing (the bounce loop is always a Python loop; the JAX package
pins its two forms equal). The field
comments name the reference renderer's toggles (src/main.cpp:35-60).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render options (reference toggles, src/main.cpp:35-60)."""

    trace_depth: int = 8
    max_trace_depth: int = 8
    antialias: bool = False
    aa_jitter_scale: float = 0.002  # reference: pathtrace.cu:338
    dof_angle: float = 0.0
    focal_length: float = 8.0
    softness: float = 0.0
    enable_sss: bool = False
    enable_kd: bool = True
    short_stack: bool = False
    push_down_restart: bool = False
    pushdown_stack: int = 6
    use_bbox: bool = True
    compaction: bool = False
    # Reference parity quirk (pathtrace.cu:2386-2399): drop paths still
    # alive after the last bounce.
    partial_gather: bool = False
    material_sort: bool = False
    ray_cache: bool = False
    dtype: str = "float32"
    stack_size: int = 24
    leaf_chunk: int = 8
    max_traversal_steps: int = 4096
    fat_rows: bool = True
    tile_lanes: int = 10240
    packet_tile_lanes: int = 65536
    traversal_tiles: int = 0
    traversal_unroll: int = 4
    sort_rays: bool = True
    mxu_brute: bool = True
    packet_size: int = 0
    octant_rows: bool = True
    # Cluster intersectors: a scene with a cluster table takes one when
    # ``cluster`` is set, or when ``cluster_auto`` is set and the mesh has
    # at least ``cluster_min_tris`` triangles. ``cluster_pairs`` wins over
    # ``cluster_walk``, which wins over ``cluster_binned``.
    cluster: bool = False
    cluster_auto: bool = True
    cluster_min_tris: int = 1024
    cluster_tile: int = 1024   # rays per tile (coherence order)
    cluster_rounds: int = 64
    cluster_sort: bool = True
    cluster_binned: bool = False
    binned_rounds: int = 32
    cluster_walk: bool = False
    cluster_pairs: bool = True
    pair_slots: int = 3
    pair_tile: int = 256
    pair_bdiag: bool = False
    pair_bdiag_tile: int = 1024
    pair_narrow_div: int = 8
    # S > 1: the walk, pair and binned intersectors sort and compact each
    # row of the [S, n / S] ray view on its own (the JAX package's
    # shard-local form; results equal S = 1's but binned's, see
    # ``ops/binned.py``).
    binned_shards: int = 1
    scan_bounces: bool = True

    def __post_init__(self):
        if self.trace_depth > self.max_trace_depth:
            object.__setattr__(self, "trace_depth", self.max_trace_depth)

    @property
    def effective_depth(self) -> int:
        return min(self.trace_depth, self.max_trace_depth)
