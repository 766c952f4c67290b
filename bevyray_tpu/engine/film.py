"""Progressive sample accumulation — persistent HBM state across frames.

The reference re-estimates every frame from scratch at 4 spp with no accumulation
(SURVEY.md §5 checkpoint/resume: "no accumulation buffer either"); BASELINE.json's
north star adds HBM accumulation as the first real persistent state. ``Film`` holds
running sums on device; each ``accumulate`` step traces ``spp`` fresh samples (with a
per-step sample-index offset so RNG streams never repeat) and adds them in place.

Reset-on-camera-move is host-side policy (see ``ProgressiveRenderer``): the film is
zeroed whenever the camera state changes, the standard real-time-path-tracer design.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core.types import CameraState, RenderConfig, SceneBuffers
from ..core.vec import Vec3
from ..kernels.composite import composite
from ..kernels.raygen import pixel_uv
from .renderer import FrameResult, trace_samples


class Film(NamedTuple):
    color_sum: Vec3          # [N] running sum of gamma-space sample colors
    depth_sum: jnp.ndarray   # [N]
    n_samples: jnp.ndarray   # f32 scalar — samples accumulated per pixel
    rays_traced: jnp.ndarray  # f32 scalar — total segments ever traced


def save_film(path: str, film: Film, config: Optional[RenderConfig] = None) -> None:
    """Checkpoint the accumulation state (the framework's persistent state —
    SURVEY.md §5 notes the reference has none). Plain .npz, host round-trip.
    When ``config`` is given, width/height are stored so a resume into a
    different-geometry config fails loudly instead of garbling the image."""
    extra = {}
    if config is not None:
        extra = {"width": np.int64(config.width), "height": np.int64(config.height)}
    np.savez(path, color_x=np.asarray(film.color_sum.x),
             color_y=np.asarray(film.color_sum.y),
             color_z=np.asarray(film.color_sum.z),
             depth=np.asarray(film.depth_sum),
             n_samples=np.asarray(film.n_samples),
             rays_traced=np.asarray(film.rays_traced), **extra)


def load_film(path: str, config: Optional[RenderConfig] = None) -> Film:
    z = np.load(path)
    if config is not None:
        if "width" in z:
            w, h = int(z["width"]), int(z["height"])
            if (w, h) != (config.width, config.height):
                raise ValueError(
                    f"film checkpoint {path!r} is {w}x{h} but the renderer "
                    f"config is {config.width}x{config.height}")
        elif z["color_x"].shape[0] != config.n_pixels:
            raise ValueError(
                f"film checkpoint {path!r} has {z['color_x'].shape[0]} pixels "
                f"but the renderer config expects {config.n_pixels}")
    return Film(color_sum=Vec3(jnp.asarray(z["color_x"]), jnp.asarray(z["color_y"]),
                               jnp.asarray(z["color_z"])),
                depth_sum=jnp.asarray(z["depth"]),
                n_samples=jnp.asarray(z["n_samples"]),
                rays_traced=jnp.asarray(z["rays_traced"]))


def new_film(config: RenderConfig) -> Film:
    n = config.n_pixels
    return Film(color_sum=Vec3.full((n,), 0.0, 0.0, 0.0),
                depth_sum=jnp.zeros((n,), jnp.float32),
                n_samples=jnp.float32(0.0),
                rays_traced=jnp.float32(0.0))


def accumulate_impl(film: Film, scene: SceneBuffers, cam: CameraState,
                    config: RenderConfig, frame_seed, sample_offset,
                    spp_map=None) -> Film:
    """Trace ``config.samples_per_pixel`` fresh samples (indices from
    ``sample_offset``) and add them to the film. With a per-pixel target
    ``spp_map`` a pixel takes only ``min(spp_map, spp)`` of them, and
    ``n_samples`` becomes a per-pixel count."""
    spp = config.samples_per_pixel
    u, v = pixel_uv(config.width, config.height)
    pixel_ids = jnp.arange(config.n_pixels, dtype=jnp.uint32)
    color_sum, depth_sum, rays = trace_samples(
        scene, cam, config, pixel_ids, u, v, spp, sample_offset, frame_seed,
        acc=(film.color_sum, film.depth_sum, film.rays_traced),
        spp_map=spp_map)
    took = (np.float32(spp) if spp_map is None
            else jnp.clip(spp_map, 0, spp).astype(jnp.float32))
    return Film(color_sum=color_sum, depth_sum=depth_sum,
                n_samples=film.n_samples + took, rays_traced=rays)


def resolve_impl(film: Film, cam: CameraState, config: RenderConfig,
                 raster_color: Vec3, raster_depth) -> FrameResult:
    h, w = config.height, config.width
    n = h * w
    inv = 1.0 / jnp.maximum(film.n_samples, 1.0)
    rt_color = film.color_sum.scale(inv)
    rt_depth = film.depth_sum * inv
    out = composite(config.level, rt_color, rt_depth, cam.near, cam.far,
                    raster_color, raster_depth)
    img = jnp.stack([jnp.broadcast_to(out.x, (n,)),
                     jnp.broadcast_to(out.y, (n,)),
                     jnp.broadcast_to(out.z, (n,))], axis=-1)
    return FrameResult(image=img.reshape(h, w, 3),
                       rt_depth=rt_depth.reshape(h, w),
                       rays_traced=film.rays_traced)


@functools.lru_cache(maxsize=32)
def _jitted_accumulate(config: RenderConfig):
    # Donate the film so accumulation is a true in-place HBM update.
    return jax.jit(functools.partial(accumulate_impl, config=config),
                   donate_argnames=("film",))


@functools.lru_cache(maxsize=32)
def _jitted_resolve(config: RenderConfig):
    return jax.jit(functools.partial(resolve_impl, config=config))


class ProgressiveRenderer:
    """Accumulating front-end: call ``step`` repeatedly; the estimate refines.

    The film auto-resets when the camera pose/projection changes (compared on
    host — camera state is a handful of scalars).
    """

    def __init__(self, config: RenderConfig):
        self.config = config
        self.film = new_film(config)
        self._accumulate = _jitted_accumulate(config)
        self._resolve = _jitted_resolve(config)
        self._last_cam_key = None
        self._sample_offset = 0

    def _cam_key(self, cam: CameraState):
        leaves = jax.tree.leaves(cam)
        return tuple(float(np.asarray(x)) for x in leaves)

    def reset(self) -> None:
        self.film = new_film(self.config)
        self._sample_offset = 0

    def step(self, scene: SceneBuffers, cam: CameraState, seed: int,
             raster_color: Optional[Vec3] = None,
             raster_depth=None) -> FrameResult:
        key = self._cam_key(cam)
        if key != self._last_cam_key:
            self.reset()
            self._last_cam_key = key
        self.film = self._accumulate(
            film=self.film, scene=scene, cam=cam,
            frame_seed=jnp.uint32(seed & 0xFFFFFFFF),
            sample_offset=jnp.uint32(self._sample_offset))
        self._sample_offset += self.config.samples_per_pixel
        if raster_color is None:
            raster_color = Vec3.splat(jnp.float32(1.0))
        if raster_depth is None:
            raster_depth = jnp.float32(0.0)
        return self._resolve(film=self.film, cam=cam,
                             raster_color=raster_color,
                             raster_depth=raster_depth)

    @property
    def samples_accumulated(self) -> int:
        return self._sample_offset

    # -- checkpoint / resume -----------------------------------------------------
    def save(self, path: str) -> None:
        save_film(path, self.film, self.config)

    def load(self, path: str, cam: CameraState) -> None:
        """Resume accumulation from a checkpoint taken with the same config and
        camera; subsequent steps continue the sample-index sequence exactly.
        Raises ValueError on a width/height mismatch with this config."""
        self.film = load_film(path, self.config)
        self._sample_offset = int(np.asarray(self.film.n_samples))
        self._last_cam_key = self._cam_key(cam)
