"""Material scattering — batched twin of ``scatter`` (raytrace.wgsl:231-299).

The reference picks one of three branches per thread via serial RNG draws. Here all
three branches are computed densely for every lane and the result is selected by
mask — cheap, because shading is a handful of elementwise ops compared to
intersection.

Faithfully reproduced quirks (SURVEY.md §2):
- metal reflection direction is ``normalize(reflect(d, n)) + roughness * ball()`` and
  is NOT re-normalized (wgsl:238);
- the diffuse lobe gets an extra ``roughness * ball()`` perturbation (wgsl:285,
  quirk #5);
- ``ball()`` samples are *in* the unit sphere, not on it (quirk #1);
- dielectric: ``ri = front_face ? 1/ior : ior`` (wgsl:253-259), attenuation 1, never
  absorbed (wgsl:280);
- metal/diffuse rays pointing below the surface are absorbed (wgsl:245, 296).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from ..core.constants import NEAR_ZERO
from ..core.vec import Vec3, reflect, refract, schlick_reflectance
from .intersect import HitInfo, MaterialLanes


class ScatterResult(NamedTuple):
    direction: Vec3          # new ray direction (origin is hit.position)
    attenuation: Vec3
    absorbed: jnp.ndarray    # bool


def scatter(direction: Vec3, hit: HitInfo, mat: MaterialLanes,
            u_metal, u_trans, u_reflect, ball1: Vec3, ball2: Vec3,
            diffuse_mode: str = "reference") -> ScatterResult:
    """One scatter event for a batch of rays.

    ``u_*`` are uniform draws; ``ball1/ball2`` are unit-ball samples. Fixed draw
    slots replace the reference's serial, branch-dependent RNG consumption — the
    NumPy oracle follows the identical contract.

    ``diffuse_mode``: "reference" reproduces the quirky RTiOW-variant lobe
    (non-unit ball + roughness term); "cosine" uses textbook cosine importance
    sampling (normal + on-sphere unit vector) — an extension for BASELINE
    config 4, lower variance for Lambertian surfaces.
    """
    n = hit.normal

    # --- metal branch (wgsl:234-245) -----------------------------------------
    metal_dir = reflect(direction, n).normalize() + ball1.scale(mat.roughness)
    metal_absorbed = metal_dir.dot(n) < 0.0

    # --- dielectric branch (wgsl:249-280) -------------------------------------
    unit = direction.normalize()
    ri = jnp.where(hit.front_face, 1.0 / mat.ior, mat.ior)
    cos_theta = jnp.minimum((-unit).dot(n), 1.0)
    sin_theta = jnp.sqrt(jnp.maximum(1.0 - cos_theta * cos_theta, 0.0))
    cannot_refract = ri * sin_theta > 1.0
    use_reflect = cannot_refract | (schlick_reflectance(cos_theta, ri) > u_reflect)
    dielectric_dir = Vec3.where(use_reflect, reflect(unit, n), refract(unit, n, ri))

    # --- diffuse branch (wgsl:282-297) -----------------------------------------
    if diffuse_mode == "cosine":
        diffuse_dir = n + ball1.normalize()
    else:
        diffuse_dir = n + ball1 + ball2.scale(mat.roughness)
    near_zero = ((jnp.abs(diffuse_dir.x) < NEAR_ZERO)
                 & (jnp.abs(diffuse_dir.y) < NEAR_ZERO)
                 & (jnp.abs(diffuse_dir.z) < NEAR_ZERO))
    diffuse_dir = Vec3.where(near_zero, n, diffuse_dir)
    diffuse_absorbed = diffuse_dir.dot(n) < 0.0

    # --- stochastic branch select (wgsl:234, 249) -------------------------------
    is_metal = u_metal < mat.metallic
    is_trans = (~is_metal) & (u_trans < mat.specular_transmission)

    out_dir = Vec3.where(is_metal, metal_dir,
                         Vec3.where(is_trans, dielectric_dir, diffuse_dir))
    white = Vec3.splat(1.0)
    attenuation = Vec3.where(is_trans, white, mat.base_color)
    # Boolean algebra instead of selects (dielectric never absorbs, wgsl:280);
    # also the only form Mosaic lowers for i1 vectors.
    absorbed = ((is_metal & metal_absorbed)
                | (~is_metal & ~is_trans & diffuse_absorbed))
    return ScatterResult(direction=out_dir, attenuation=attenuation, absorbed=absorbed)
