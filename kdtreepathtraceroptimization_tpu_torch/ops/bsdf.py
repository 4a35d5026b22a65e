"""BSDF scattering — the branchless wavefront form of scatterRay.

The JAX package's ``ops/bsdf.py`` in PyTorch (reference:
src/interactions.h:195-358): every branch's direction is computed for
every lane and the priority chain picks with ``torch.where``:

  1. transmittance > 0        -> subsurface scattering
  2. has_refractive != 0      -> Fresnel split refract/reflect
  3. has_reflective != 0      -> probabilistic mirror
  4. otherwise                -> cosine-hemisphere diffuse
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from kdtreepathtraceroptimization_tpu_torch.ops import sampling, vecmath as vm
from kdtreepathtraceroptimization_tpu_torch.ops.vecmath import V3


class MaterialLanes(NamedTuple):
    """Per-ray gathered material parameters (channel-split vectors)."""

    color: V3
    specular_color: V3
    has_reflective: torch.Tensor
    has_refractive: torch.Tensor
    index_of_refraction: torch.Tensor
    emittance: torch.Tensor
    transmittance: V3


def gather_materials(materials, material_id) -> MaterialLanes:
    """The material table rows hit by each ray (pathtrace.cu:2327).

    ``materials`` is a ``MaterialSoA`` of numpy arrays or of tensors (on
    ``material_id``'s device, as ``convert.materials_to_torch`` makes
    them; gradients flow to tensors that require them). Up to 16 rows,
    each field is a chain of selects over the rows, as in the JAX package;
    larger tables gather. Misses (id < 0) clamp to row 0 — callers mask on
    hit.
    """
    mid = torch.clamp_min(material_id, 0)
    m_rows = int(materials.emittance.shape[0])

    def field(col):
        col = torch.as_tensor(col, dtype=torch.float32, device=mid.device)
        if m_rows <= 16:
            out = col[0].expand(mid.shape)
            for m in range(1, m_rows):
                out = torch.where(mid == m, col[m], out)
            return out
        return col[mid.long()]

    def field3(mat3):
        mat3 = torch.as_tensor(mat3, dtype=torch.float32, device=mid.device)
        return V3(field(mat3[:, 0]), field(mat3[:, 1]), field(mat3[:, 2]))

    return MaterialLanes(
        color=field3(materials.color),
        specular_color=field3(materials.specular_color),
        has_reflective=field(materials.has_reflective),
        has_refractive=field(materials.has_refractive),
        index_of_refraction=field(materials.index_of_refraction),
        emittance=field(materials.emittance),
        transmittance=field3(materials.transmittance),
    )


class ScatterResult(NamedTuple):
    origin: V3
    direction: V3
    is_inside: torch.Tensor  # [N] bool
    sdepth: torch.Tensor  # [N] f32


def scatter(
    origin: V3,
    direction: V3,
    is_inside,
    point: V3,
    normal: V3,
    mat: MaterialLanes,
    u,  # tuple of >= 8 [N] uniform columns
    softness: float,
) -> ScatterResult:
    """Sample the next ray (scatterRay, interactions.h:195-358).

    ``u`` columns: 0=branch pick, 1/2=diffuse, 3/4=cone jitter,
    5=reflect-vs-diffuse pick, 6=refract-vs-diffuse pick.
    """
    direction = vm.normalizev(direction)
    normal_n = vm.normalizev(normal)

    diffuse_dir = sampling.cosine_hemisphere_v(normal_n, u[1], u[2])
    diffuse_origin = point + normal_n * 1e-5

    zero = torch.zeros_like(u[0])

    # --- Branch 1: SSS (interactions.h:205-229) -------------------------
    sss_cone = sampling.rand_spherical_vec_v(0.0001, u[3], u[4])
    sss_dir = sampling.rotate_cone_sample_v(direction, sss_cone)
    # Reference quirk kept: the SSS-entry ray restarts from the *old*
    # origin (+eps), not the hit point, and sdepth = |origin - hit|.
    sss_origin = origin + sss_dir * 1e-4
    sss_sdepth = vm.safe_normv(sss_origin - point)
    sss_enter = (u[0] < 0.5) & ~is_inside

    sss_res = ScatterResult(
        origin=vm.wherev(sss_enter, sss_origin, diffuse_origin),
        direction=vm.wherev(sss_enter, sss_dir, diffuse_dir),
        is_inside=torch.where(sss_enter, True, is_inside),
        sdepth=torch.where(sss_enter, sss_sdepth, 0.0),
    )

    # --- Branch 2: refractive (interactions.h:230-310) ------------------
    fresnel = sampling.schlick_fresnel_v(direction, normal_n,
                                         mat.index_of_refraction)
    transmit_pick = u[0] < (1.0 - fresnel)

    ior_eff = torch.where(
        is_inside, mat.index_of_refraction,
        1.0 / torch.clamp_min(mat.index_of_refraction, 1e-6)
    )
    cos_nd = vm.dotv(normal_n, direction)
    k = 1.0 - ior_eff * ior_eff * (1.0 - cos_nd * cos_nd)
    will_reflect_internally = k < 0.0  # "angle < 0" (interactions.h:248-250)

    mirror_dir = vm.normalizev(vm.reflectv(direction, normal_n))
    if softness > 0.0:
        cone = sampling.rand_spherical_vec_v(0.02, u[3], u[4])
        soft_mirror = sampling.rotate_cone_sample_v(mirror_dir, cone)
    else:
        soft_mirror = mirror_dir

    refract_dir = vm.refractv(direction, normal_n, ior_eff)
    if softness > 0.0:
        cone2 = sampling.rand_spherical_vec_v(0.02, u[3], u[4])
        refract_dir_j = sampling.rotate_cone_sample_v(
            vm.normalizev(refract_dir), cone2)
    else:
        refract_dir_j = refract_dir

    # TIR sub-branch: probabilistic reflect vs diffuse
    tir_reflect = u[5] < mat.has_reflective
    tir_dir = vm.wherev(tir_reflect, soft_mirror, diffuse_dir)
    tir_origin = point + normal_n * 1e-5

    # Refract sub-branch: probabilistic refract vs diffuse
    do_refract = u[6] < mat.has_refractive
    refr_dir = vm.wherev(do_refract, refract_dir_j, diffuse_dir)
    refr_origin = vm.wherev(
        do_refract, point - normal_n * 1e-3, point + normal_n * 1e-5
    )
    refr_inside = torch.where(do_refract, ~is_inside, is_inside)

    transmit_dir = vm.wherev(will_reflect_internally, tir_dir, refr_dir)
    transmit_origin = vm.wherev(will_reflect_internally, tir_origin,
                                refr_origin)
    transmit_inside = torch.where(will_reflect_internally, is_inside,
                                  refr_inside)

    # Fresnel-reflect branch (interactions.h:304-308)
    fres_dir = mirror_dir
    fres_origin = point + normal_n * 1e-5

    refractive_res = ScatterResult(
        origin=vm.wherev(transmit_pick, transmit_origin, fres_origin),
        direction=vm.wherev(transmit_pick, transmit_dir, fres_dir),
        is_inside=torch.where(transmit_pick, transmit_inside, False),
        sdepth=zero,
    )

    # --- Branch 3: reflective (interactions.h:312-339) ------------------
    do_mirror = u[0] < mat.has_reflective
    reflective_res = ScatterResult(
        origin=vm.wherev(do_mirror, point + normal_n * 1e-4, diffuse_origin),
        direction=vm.wherev(do_mirror, soft_mirror, diffuse_dir),
        is_inside=torch.where(do_mirror, False, is_inside),
        sdepth=zero,
    )

    # --- Branch 4: diffuse (interactions.h:340-357) ---------------------
    diffuse_res = ScatterResult(
        origin=diffuse_origin,
        direction=diffuse_dir,
        is_inside=torch.zeros_like(is_inside),
        sdepth=zero,
    )

    # --- Compose the priority chain -------------------------------------
    t3 = mat.transmittance
    has_sss = (t3.x > 0.0) | (t3.y > 0.0) | (t3.z > 0.0)
    has_refr = mat.has_refractive != 0.0
    has_refl = mat.has_reflective != 0.0

    def pick(cond, a: ScatterResult, b: ScatterResult) -> ScatterResult:
        return ScatterResult(
            origin=vm.wherev(cond, a.origin, b.origin),
            direction=vm.wherev(cond, a.direction, b.direction),
            is_inside=torch.where(cond, a.is_inside, b.is_inside),
            sdepth=torch.where(cond, a.sdepth, b.sdepth),
        )

    out = pick(has_refl, reflective_res, diffuse_res)
    out = pick(has_refr, refractive_res, out)
    out = pick(has_sss, sss_res, out)
    return out
