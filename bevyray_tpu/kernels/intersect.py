"""Ray–sphere intersection — the hot kernel.

Twin of ``hit_sphere`` + ``raycast_against_range`` (raytrace.wgsl:348-383), with the
reference's exact acceptance semantics:

- **near root only**: ``t = (h - sqrt(disc)) / a`` — rays starting inside a sphere
  never hit its far wall (SURVEY.md quirk #2);
- accept iff ``disc >= 0 && t > 0.001 && t < closest`` (wgsl:353-354);
- normals always outward, never flipped (wgsl:356, quirk #3);
- ``front_face = dot(dir, normal) < 0`` (wgsl:358).

Wavefront shape: instead of one thread walking a sphere list, we test a whole ray
batch against sphere *chunks* as dense [rays × chunk] elementwise blocks (zero
gathers in the test loop), keeping a running (t, index) min. A single gather per
bounce then fetches the winning sphere's attributes. ``sphere_chunk`` bounds the
[rays × chunk] f32 pair block XLA may materialise (4.25 GB at 1080p, chunk 512).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core.constants import INF, T_MIN
from ..core.types import Materials, Spheres
from ..core.vec import Vec3


class HitInfo(NamedTuple):
    """Batched twin of the WGSL HitInfo struct (raytrace.wgsl:301-307)."""

    t: jnp.ndarray           # f32, INF on miss
    miss: jnp.ndarray        # bool
    position: Vec3
    normal: Vec3             # outward, unit
    material_id: jnp.ndarray  # i32
    front_face: jnp.ndarray  # bool


def intersect_spheres(origin: Vec3, direction: Vec3, spheres: Spheres,
                      chunk: int = 512):
    """Nearest-hit over the whole (padded) sphere table.

    Returns ``(t, index)`` with ``t = INF`` / ``index = -1`` on miss. Scans the table
    in chunks so peak live memory is [rays, chunk] regardless of scene size.
    """
    n_rays = origin.x.shape[0]
    cap = spheres.capacity
    if cap % chunk != 0:
        chunk = cap  # capacity is lane-padded; fall back to one block

    a = direction.dot(direction)                      # [N] (dirs may be non-unit)
    inv_a = 1.0 / a

    def chunk_body(carry, xs):
        best_t, best_i = carry
        ccx, ccy, ccz, cr, cvalid, cbase = xs
        # oc = center - origin (wgsl:372), pairwise [N, C]
        ocx = ccx[None, :] - origin.x[:, None]
        ocy = ccy[None, :] - origin.y[:, None]
        ocz = ccz[None, :] - origin.z[:, None]
        h = (direction.x[:, None] * ocx + direction.y[:, None] * ocy
             + direction.z[:, None] * ocz)                          # wgsl:374
        c = ocx * ocx + ocy * ocy + ocz * ocz - (cr * cr)[None, :]  # wgsl:375
        disc = h * h - a[:, None] * c                               # wgsl:376
        t = (h - jnp.sqrt(jnp.maximum(disc, 0.0))) * inv_a[:, None]  # wgsl:382
        ok = (disc >= 0.0) & (t > T_MIN) & cvalid[None, :]          # wgsl:353
        t = jnp.where(ok, t, INF)
        # min + masked index-min instead of argmin + take_along_axis: both fuse
        # into the same reduction pass and avoid a per-ray gather.
        ct = jnp.min(t, axis=1)
        lane = jax.lax.broadcasted_iota(jnp.int32, t.shape, 1)
        ci = jnp.min(jnp.where(t == ct[:, None], lane, t.shape[1]), axis=1)
        take_new = ct < best_t                                      # wgsl:354
        best_i = jnp.where(take_new, cbase + ci, best_i)
        best_t = jnp.where(take_new, ct, best_t)
        return (best_t, best_i), None

    n_chunks = cap // chunk
    xs = (
        spheres.cx.reshape(n_chunks, chunk),
        spheres.cy.reshape(n_chunks, chunk),
        spheres.cz.reshape(n_chunks, chunk),
        spheres.radius.reshape(n_chunks, chunk),
        spheres.valid.reshape(n_chunks, chunk),
        (jnp.arange(n_chunks, dtype=jnp.int32) * chunk),
    )
    init = (jnp.full((n_rays,), INF, jnp.float32), jnp.full((n_rays,), -1, jnp.int32))
    if n_chunks == 1:
        (best_t, best_i), _ = chunk_body(init, jax.tree.map(lambda v: v[0], xs))
    else:
        (best_t, best_i), _ = jax.lax.scan(chunk_body, init, xs)
    return best_t, best_i


def make_hit_info(origin: Vec3, direction: Vec3, t: jnp.ndarray, index: jnp.ndarray,
                  spheres: Spheres) -> HitInfo:
    """Gather hit attributes for the winning sphere (raycast_against_range body,
    wgsl:355-358). Values on missed lanes are well-defined garbage (masked later)."""
    miss = t >= INF
    safe_t = jnp.where(miss, 0.0, t)
    idx = jnp.clip(index, 0, spheres.capacity - 1)
    center = Vec3(spheres.cx[idx], spheres.cy[idx], spheres.cz[idx])
    position = origin + direction.scale(safe_t)       # ray_at, wgsl:130-132
    normal = (position - center).normalize()          # outward (wgsl:356)
    # Guard padding/miss lanes against 0/0 normals.
    normal = Vec3.where(miss, Vec3.full((), 0.0, 1.0, 0.0), normal)
    front_face = direction.dot(normal) < 0.0          # wgsl:358
    return HitInfo(
        t=t, miss=miss, position=position, normal=normal,
        material_id=spheres.material_id[idx], front_face=front_face,
    )


def intersect_triangles(origin: Vec3, direction: Vec3, tris, chunk: int = 512):
    """Nearest triangle hit (Möller–Trumbore), chunked like the sphere path.

    Extension primitive (the reference's roadmap, extract.rs:211-212 / 239-248;
    BASELINE config 5). Accepts t > T_MIN like the sphere test; backface hits are
    reported (two-sided), with front_face resolved by the caller from the
    geometric normal. Returns (t, index) with INF / -1 on miss.
    """
    n_rays = origin.x.shape[0]
    cap = tris.capacity
    if cap % chunk != 0:
        chunk = cap

    def chunk_body(carry, xs):
        best_t, best_i = carry
        (ax, ay, az, bx, by, bz, cx, cy, cz, valid, base) = xs
        # Edges and the Möller–Trumbore determinant, pairwise [N, C].
        e1x = bx[None, :] - ax[None, :]
        e1y = by[None, :] - ay[None, :]
        e1z = bz[None, :] - az[None, :]
        e2x = cx[None, :] - ax[None, :]
        e2y = cy[None, :] - ay[None, :]
        e2z = cz[None, :] - az[None, :]
        dx, dy, dz = (direction.x[:, None], direction.y[:, None],
                      direction.z[:, None])
        px = dy * e2z - dz * e2y
        py = dz * e2x - dx * e2z
        pz = dx * e2y - dy * e2x
        det = px * e1x + py * e1y + pz * e1z
        inv_det = 1.0 / det
        tx = origin.x[:, None] - ax[None, :]
        ty = origin.y[:, None] - ay[None, :]
        tz = origin.z[:, None] - az[None, :]
        u = (tx * px + ty * py + tz * pz) * inv_det
        qx = ty * e1z - tz * e1y
        qy = tz * e1x - tx * e1z
        qz = tx * e1y - ty * e1x
        v = (dx * qx + dy * qy + dz * qz) * inv_det
        t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
        ok = ((jnp.abs(det) > 1e-12) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
              & (t > T_MIN) & valid[None, :])
        t = jnp.where(ok, t, INF)
        ci = jnp.argmin(t, axis=1)
        ct = jnp.take_along_axis(t, ci[:, None], axis=1)[:, 0]
        take = ct < best_t
        best_i = jnp.where(take, base + ci.astype(jnp.int32), best_i)
        best_t = jnp.where(take, ct, best_t)
        return (best_t, best_i), None

    n_chunks = cap // chunk
    xs = tuple(a.reshape(n_chunks, chunk) for a in
               (tris.ax, tris.ay, tris.az, tris.bx, tris.by, tris.bz,
                tris.cx, tris.cy, tris.cz, tris.valid)) + (
        jnp.arange(n_chunks, dtype=jnp.int32) * chunk,)
    init = (jnp.full((n_rays,), INF, jnp.float32), jnp.full((n_rays,), -1, jnp.int32))
    if n_chunks == 1:
        (best_t, best_i), _ = chunk_body(init, jax.tree.map(lambda v: v[0], xs))
    else:
        (best_t, best_i), _ = jax.lax.scan(chunk_body, init, xs)
    return best_t, best_i


def triangle_hit_info(origin: Vec3, direction: Vec3, t: jnp.ndarray,
                      index: jnp.ndarray, tris) -> HitInfo:
    """Hit attributes for triangle hits: geometric normal (normalized e1×e2,
    NOT flipped toward the ray — consistent with the sphere path's
    always-outward quirk), front_face from the ray-normal sign."""
    miss = t >= INF
    safe_t = jnp.where(miss, 0.0, t)
    idx = jnp.clip(index, 0, tris.capacity - 1)
    a = Vec3(tris.ax[idx], tris.ay[idx], tris.az[idx])
    b = Vec3(tris.bx[idx], tris.by[idx], tris.bz[idx])
    c = Vec3(tris.cx[idx], tris.cy[idx], tris.cz[idx])
    normal = (b - a).cross(c - a).normalize()
    normal = Vec3.where(miss, Vec3.full((), 0.0, 1.0, 0.0), normal)
    position = origin + direction.scale(safe_t)
    return HitInfo(t=t, miss=miss, position=position, normal=normal,
                   material_id=tris.material_id[idx],
                   front_face=direction.dot(normal) < 0.0)


def merge_hits(a: HitInfo, b: HitInfo) -> HitInfo:
    """Nearest of two hit sets (sphere vs triangle pass)."""
    b_wins = b.t < a.t
    return HitInfo(
        t=jnp.where(b_wins, b.t, a.t),
        miss=a.miss & b.miss,
        position=Vec3.where(b_wins, b.position, a.position),
        normal=Vec3.where(b_wins, b.normal, a.normal),
        material_id=jnp.where(b_wins, b.material_id, a.material_id),
        front_face=jnp.where(b_wins, b.front_face, a.front_face),
    )


class MaterialLanes(NamedTuple):
    """Per-ray gathered material attributes."""

    base_color: Vec3
    metallic: jnp.ndarray
    roughness: jnp.ndarray
    ior: jnp.ndarray
    specular_transmission: jnp.ndarray
    emissive: Vec3


def gather_materials(materials: Materials, material_id: jnp.ndarray) -> MaterialLanes:
    idx = jnp.clip(material_id, 0, materials.capacity - 1)
    return MaterialLanes(
        base_color=Vec3(materials.base_r[idx], materials.base_g[idx],
                        materials.base_b[idx]),
        metallic=materials.metallic[idx],
        roughness=materials.roughness[idx],
        ior=materials.ior[idx],
        specular_transmission=materials.specular_transmission[idx],
        emissive=Vec3(materials.emissive_r[idx], materials.emissive_g[idx],
                      materials.emissive_b[idx]),
    )
