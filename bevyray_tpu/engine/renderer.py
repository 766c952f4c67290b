"""The wavefront frame step — the batched twin of the reference's per-pixel shader.

Reference control flow (raytrace.wgsl:93-224): one fragment thread per pixel runs a
sample loop, each sample runs a bounce loop with per-thread ``break``s. Here the whole
frame is a flat SoA wavefront; the bounce loop is a ``lax.while_loop`` with an active
mask (dead lanes are masked, and the loop exits early once every lane has terminated
— the batched analog of the per-thread break). Everything jits into one XLA program;
scene buffers stay resident on device across frames.

This is the renderer's only path: ``Renderer``, ``ProgressiveRenderer``,
``AdaptiveRenderer`` and the sharded step all run ``trace_samples``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core import rng
from ..core.constants import INF
from ..core.types import CameraState, RenderConfig, SceneBuffers
from ..core.vec import Vec3
from ..kernels.composite import background_gradient, composite, linear_to_gamma
from ..kernels.intersect import gather_materials, intersect_spheres, make_hit_info
from ..kernels.raygen import generate_rays, pixel_uv
from ..kernels.shade import scatter
from . import slots


class FrameResult(NamedTuple):
    image: jnp.ndarray      # [H, W, 3] f32 — final composited, gamma-space
    rt_depth: jnp.ndarray   # [H, W] f32 — sample-averaged first-hit distance
    rays_traced: jnp.ndarray   # active ray segments this frame (f32 scalar)


def _draw_ball(stream, base, first_slot):
    us = [rng.draw(stream, base + np.uint32(first_slot + k)) for k in range(5)]
    return rng.unit_ball_from_uniforms(*us)


BVH_CROSSOVER = 4096  # primitives; unmeasured on the H100 (see resolve_intersect_backend)


def resolve_intersect_backend(scene: SceneBuffers, config: RenderConfig) -> str:
    """Resolve ``'auto'`` to a concrete backend ONCE, considering all primitive
    types, so the sphere and triangle paths agree (a triangle-heavy scene must
    not brute-force its triangles just because the sphere table is small).

    The choice depends on the scene alone, on every platform: ``auto`` walks
    the BVH when one exists and a primitive table holds more than
    ``BVH_CROSSOVER`` entries. That crossover has not been priced on the
    H100 (a single smoke frame there had brute force ahead at 5,001 spheres);
    it is a placeholder until a benchmark cell sits on each side of it.
    """
    backend = config.intersect_backend
    if backend == "auto":
        cap = scene.spheres.capacity
        if scene.triangles is not None:
            cap = max(cap, scene.triangles.capacity)
        has_bvh = scene.bvh is not None or scene.tri_bvh is not None
        backend = "bvh" if (has_bvh and cap > BVH_CROSSOVER) else "brute"
    return backend


def make_intersect_fn(scene: SceneBuffers, config: RenderConfig):
    """Pick the sphere intersection backend (static decision, shapes static).

    - ``brute``: dense chunked all-pairs tests — pure elementwise work with one
      gather per bounce, for reference-scale scenes;
    - ``bvh``: flattened-BVH stack traversal (kernels/traverse.py) — wins for large
      scenes where O(n) loses to O(log n) despite the gathers.
    """
    backend = resolve_intersect_backend(scene, config)
    if backend == "bvh":
        if scene.bvh is None:
            if config.intersect_backend == "bvh":
                raise ValueError("bvh backend requested but scene has no BVH")
            backend = "brute"  # auto resolved bvh for triangles; spheres lack one
        else:
            from ..kernels.traverse import intersect_bvh

            return lambda o, d: intersect_bvh(
                o, d, scene.spheres, scene.bvh,
                max_leaf_size=config.bvh_leaf_size)
    return lambda o, d: intersect_spheres(o, d, scene.spheres, config.sphere_chunk)


def trace_sample(scene: SceneBuffers, cam: CameraState, config: RenderConfig,
                 pixel_ids: jnp.ndarray, u: jnp.ndarray, v: jnp.ndarray,
                 sample_index, frame_seed, intersect_fn=None,
                 fixed_trip_count: bool = False, live=None):
    """Trace one sample per pixel. Returns (color: Vec3 gamma-space, depth: [N],
    segments: f32 scalar).

    Twin of one iteration of ``trace_multisampled`` + ``raytrace``
    (raytrace.wgsl:159-224).

    ``fixed_trip_count``: disable the all-lanes-dead early exit. Required when
    ``intersect_fn`` contains cross-device collectives (sphere-sharded mode), where
    every peer must execute the same number of bounce iterations.

    ``live``: optional [N] bool. A lane that is not live starts dead: it traces
    no segment and returns zero color and zero depth.
    """
    if intersect_fn is None:
        intersect_fn = make_intersect_fn(scene, config)
    resolved_backend = resolve_intersect_backend(scene, config)
    stream = rng.stream_init(pixel_ids, sample_index, frame_seed)
    ju = rng.draw(stream, np.uint32(slots.JITTER_U))
    jv = rng.draw(stream, np.uint32(slots.JITTER_V))
    if config.defocus:
        lu = rng.draw(stream, np.uint32(slots.LENS_U))
        lv = rng.draw(stream, np.uint32(slots.LENS_V))
    else:
        lu = lv = None
    origin, direction = generate_rays(u, v, ju, jv, cam, config.height,
                                      lens_u=lu, lens_v=lv)

    n = pixel_ids.shape[0]
    f32 = jnp.float32

    # Mode-dependent miss depth (wgsl:177-182).
    fallback_far = cam.far + 10.0 if config.level == 1 else cam.far - 1.0

    class Carry(NamedTuple):
        bounce: jnp.ndarray
        origin: Vec3
        direction: Vec3
        ray_color: Vec3         # path throughput
        radiance: Vec3          # accumulated emitted+sky light × throughput
        active: jnp.ndarray
        first_depth: jnp.ndarray
        segments: jnp.ndarray   # running count of active ray segments traced

    init = Carry(
        bounce=jnp.int32(0),
        origin=origin,
        direction=direction,
        ray_color=Vec3.full((n,), 1.0, 1.0, 1.0),
        radiance=Vec3.full((n,), 0.0, 0.0, 0.0),
        active=jnp.ones((n,), bool) if live is None else live,
        first_depth=jnp.full((n,), INF, f32),
        segments=jnp.float32(0.0),
    )

    def cond(c: Carry):
        # wgsl:189 loop bound `bounce <= bounce_count`, plus batched early-exit once
        # every lane has broken (miss or absorb).
        in_range = c.bounce <= config.bounces
        if fixed_trip_count:
            return in_range
        return in_range & jnp.any(c.active)

    def body(c: Carry) -> Carry:
        t, idx = intersect_fn(c.origin, c.direction)
        hit = make_hit_info(c.origin, c.direction, t, idx, scene.spheres)
        if scene.triangles is not None:
            from ..kernels.intersect import (intersect_triangles, merge_hits,
                                             triangle_hit_info)
            if resolved_backend == "bvh" and scene.tri_bvh is not None:
                from ..kernels.traverse import intersect_bvh_triangles
                tt, ti = intersect_bvh_triangles(
                    c.origin, c.direction, scene.triangles, scene.tri_bvh,
                    max_leaf_size=config.bvh_leaf_size)
            else:
                tt, ti = intersect_triangles(c.origin, c.direction,
                                             scene.triangles)
            hit = merge_hits(hit, triangle_hit_info(c.origin, c.direction, tt, ti,
                                                    scene.triangles))

        # First-hit depth for compositing (wgsl:193-195).
        first_depth = jnp.where(c.bounce == 0, hit.t, c.first_depth)

        # Miss → pick up the sky (throughput × gradient) and terminate
        # (wgsl:198-201). Radiance accumulation generalizes the reference's
        # single terminal light: for emissive-free scenes it is value-identical.
        radiance = Vec3.where(c.active & hit.miss,
                              c.radiance + c.ray_color
                              * background_gradient(c.direction), c.radiance)
        active_hit = c.active & ~hit.miss

        # Scatter (wgsl:203-211).
        mat = gather_materials(scene.materials, hit.material_id)
        # Emissive surfaces add throughput-weighted radiance on hit (extension).
        radiance = Vec3.where(active_hit,
                              radiance + c.ray_color * mat.emissive, radiance)
        base = jnp.uint32(slots.RAYGEN_DRAWS) + (
            c.bounce.astype(jnp.uint32) * np.uint32(slots.DRAWS_PER_BOUNCE))
        u_metal = rng.draw(stream, base + np.uint32(slots.S_METAL))
        u_trans = rng.draw(stream, base + np.uint32(slots.S_TRANS))
        u_reflect = rng.draw(stream, base + np.uint32(slots.S_REFLECT))
        ball1 = _draw_ball(stream, base, slots.S_BALL1)
        ball2 = _draw_ball(stream, base, slots.S_BALL2)
        sc = scatter(c.direction, hit, mat, u_metal, u_trans, u_reflect,
                     ball1, ball2, diffuse_mode=config.diffuse_sampling)

        cont = active_hit & ~sc.absorbed
        ray_color = Vec3.where(cont, c.ray_color * sc.attenuation, c.ray_color)
        new_origin = Vec3.where(active_hit, hit.position, c.origin)
        new_direction = Vec3.where(active_hit, sc.direction, c.direction)

        return Carry(bounce=c.bounce + 1, origin=new_origin, direction=new_direction,
                     ray_color=ray_color, radiance=radiance, active=cont,
                     first_depth=first_depth,
                     segments=c.segments + jnp.sum(c.active.astype(jnp.float32)))

    final = jax.lax.while_loop(cond, body, init)

    # Rays that exhausted the bounce budget never picked up the sky, so their
    # radiance holds only emissive hits (0 in reference scenes — wgsl:215-217
    # blackness falls out naturally). Absorbed rays likewise.
    depth = jnp.where(final.first_depth >= INF, fallback_far, final.first_depth)
    # Per-sample gamma, then averaging across samples — faithful to the reference,
    # which averages post-gamma values (wgsl:165 sums raytrace() output, which is
    # gamma-encoded at wgsl:223).
    color = linear_to_gamma(final.radiance)
    if live is not None:
        color = Vec3.where(live, color, Vec3.full((), 0.0, 0.0, 0.0))
        depth = jnp.where(live, depth, 0.0)
    return color, depth, final.segments


def trace_samples(scene: SceneBuffers, cam: CameraState, config: RenderConfig,
                  pixel_ids: jnp.ndarray, u: jnp.ndarray, v: jnp.ndarray,
                  n_samples: int, first_sample, frame_seed, acc=None,
                  spp_map=None, intersect_fn=None,
                  fixed_trip_count: bool = False):
    """Add ``n_samples`` samples per pixel, with sample indices
    ``first_sample + k``, to ``acc = (color_sum, depth_sum, segments)``
    (zeros when None). Returns the updated sums.

    ``spp_map``: optional [N] int per-pixel sample target. The pass-local
    sample ``k`` of a pixel is traced only when ``k < spp_map[pixel]``; the
    others start dead and add nothing to any sum (``trace_sample(live=)``).
    """
    n = pixel_ids.shape[0]
    if acc is None:
        acc = (Vec3.full((n,), 0.0, 0.0, 0.0), jnp.zeros((n,), jnp.float32),
               jnp.float32(0.0))
    first = jnp.asarray(first_sample).astype(jnp.uint32)

    def body(k, acc):
        color_sum, depth_sum, seg_sum = acc
        live = None if spp_map is None else k < spp_map
        color, depth, segments = trace_sample(
            scene, cam, config, pixel_ids, u, v, first + k.astype(jnp.uint32),
            frame_seed, intersect_fn=intersect_fn,
            fixed_trip_count=fixed_trip_count, live=live)
        return (color_sum + color, depth_sum + depth, seg_sum + segments)

    return jax.lax.fori_loop(0, n_samples, body, acc)


def render_impl(scene: SceneBuffers, cam: CameraState, config: RenderConfig,
                frame_seed, raster_color: Vec3, raster_depth,
                spp_map=None) -> FrameResult:
    """One frame of ``config.samples_per_pixel`` samples per pixel, or of
    ``min(spp_map, spp)`` samples per pixel when a per-pixel target is given
    (each pixel's mean then divides by its own count)."""
    h, w = config.height, config.width
    n = h * w
    u, v = pixel_uv(w, h)
    pixel_ids = jnp.arange(n, dtype=jnp.uint32)

    if config.level == 0:
        img = Vec3(
            jnp.broadcast_to(raster_color.x, (n,)),
            jnp.broadcast_to(raster_color.y, (n,)),
            jnp.broadcast_to(raster_color.z, (n,)),
        )
        return FrameResult(image=img.to_array().reshape(h, w, 3),
                           rt_depth=jnp.zeros((h, w), jnp.float32),
                           rays_traced=jnp.float32(0.0))

    spp = config.samples_per_pixel
    color_sum, depth_sum, seg_sum = trace_samples(
        scene, cam, config, pixel_ids, u, v, spp, 0, frame_seed,
        spp_map=spp_map)
    if spp_map is None:
        inv_spp = np.float32(1.0 / spp)
    else:
        inv_spp = 1.0 / jnp.clip(spp_map, 1, spp).astype(jnp.float32)
    rt_color = color_sum.scale(inv_spp)       # wgsl:169
    rt_depth = depth_sum * inv_spp            # wgsl:170

    out = composite(config.level, rt_color, rt_depth, cam.near, cam.far,
                    raster_color, raster_depth)
    img = Vec3(jnp.broadcast_to(out.x, (n,)), jnp.broadcast_to(out.y, (n,)),
               jnp.broadcast_to(out.z, (n,)))
    return FrameResult(image=img.to_array().reshape(h, w, 3),
                       rt_depth=rt_depth.reshape(h, w),
                       rays_traced=seg_sum)


@functools.lru_cache(maxsize=32)
def _jitted_render(config: RenderConfig):
    return jax.jit(functools.partial(render_impl, config=config))


class Renderer:
    """Stateful front-end: owns a compiled frame step per static config.

    Usage::

        world = rtiow.final_scene()
        r = Renderer(RenderConfig(width=1280, height=720, samples_per_pixel=16))
        frame = r.render(world.extract(), world.camera_state(aspect=16/9), seed=1)
    """

    def __init__(self, config: RenderConfig):
        self.config = config
        self._fn = _jitted_render(config)

    def render(self, scene: SceneBuffers, cam: CameraState, seed: int,
               raster_color: Optional[Vec3] = None,
               raster_depth: Optional[jnp.ndarray] = None) -> FrameResult:
        """Render one frame. ``seed`` plays the role of the reference's per-frame
        ``thread_rng`` seed (extract.rs:72-73) but is explicit and reproducible.

        ``raster_color``/``raster_depth`` supply the rasterized layer for the hybrid
        modes; they default to the reference app's white clear color
        (main.rs:60) and reverse-Z far-plane depth.
        """
        if raster_color is None:
            raster_color = Vec3.splat(jnp.float32(1.0))
        if raster_depth is None:
            raster_depth = jnp.float32(0.0)
        return self._fn(scene=scene, cam=cam,
                        frame_seed=jnp.uint32(seed & 0xFFFFFFFF),
                        raster_color=raster_color, raster_depth=raster_depth)
