"""Adaptive sampling — variance-guided per-pixel sample allocation (extension
beyond the reference, which traces a fixed spp for every pixel).

Each pass hands the XLA step a per-pixel sample TARGET (``spp_map`` of
``film.accumulate_impl``): a lane whose sample index is at or past its pixel's
target starts dead, traces nothing and adds nothing. No compaction and no host
round-trips inside a pass. The controller is classic progressive refinement:
a warmup pass samples every pixel, then each subsequent pass re-samples only
pixels whose estimate is still noisy (relative inter-pass disagreement above
``tolerance``), so converged regions (sky, flat diffuse) stop consuming
samples while glass edges and noise-prone geometry keep refining.

Estimates stay unbiased: per-pixel sums divide by the ACTUAL per-pixel sample
counts, and the draw streams are keyed by (pixel, absolute sample index), so a
pixel's k-th sample is identical whether it was traced adaptively or
uniformly.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core.types import CameraState, RenderConfig, SceneBuffers
from ..core.vec import Vec3
from .film import accumulate_impl, new_film
from .renderer import FrameResult


class AdaptiveFilm(NamedTuple):
    color_sum: Vec3           # [N] gamma-space sums over traced samples
    depth_sum: jnp.ndarray    # [N]
    n_samples: jnp.ndarray    # [N] f32 — per-pixel sample counts
    err: jnp.ndarray          # [N] f32 — inter-pass relative disagreement
    rays_traced: jnp.ndarray  # f32 scalar


def _new_film(n: int) -> AdaptiveFilm:
    return AdaptiveFilm(color_sum=Vec3.full((n,), 0.0, 0.0, 0.0),
                        depth_sum=jnp.zeros((n,), jnp.float32),
                        n_samples=jnp.zeros((n,), jnp.float32),
                        err=jnp.full((n,), jnp.inf, jnp.float32),
                        rays_traced=jnp.float32(0.0))


def _adaptive_pass(film: AdaptiveFilm, scene: SceneBuffers, cam: CameraState,
                   config: RenderConfig, frame_seed, sample_offset, reprobe,
                   tolerance: float):
    """One pass: pixels with err >= tolerance trace config.samples_per_pixel
    fresh samples; the rest trace none. Returns the updated film.

    ``reprobe`` (traced bool): force-sample EVERY pixel this pass and fold the
    new disagreement into ``err`` — the periodic escape hatch that lets a noisy
    pixel whose pass once agreed by chance resume sampling (a stopped pixel's
    err is otherwise never re-evaluated)."""
    spp = config.samples_per_pixel
    want = (film.err >= tolerance) | reprobe
    pass_ = accumulate_impl(new_film(config), scene, cam, config, frame_seed,
                            sample_offset,
                            spp_map=jnp.where(want, spp, 0).astype(jnp.int32))
    took = pass_.n_samples
    # Inter-pass disagreement: |new pass mean − running mean| relative to the
    # running mean's luminance (plus a floor so black pixels converge).
    old_n = jnp.maximum(film.n_samples, 1.0)
    old_mean = film.color_sum.scale(1.0 / old_n)
    new_mean = pass_.color_sum.scale(1.0 / jnp.maximum(took, 1.0))
    lum = (old_mean.x + old_mean.y + old_mean.z) * (1.0 / 3.0)
    delta = (jnp.abs(new_mean.x - old_mean.x) + jnp.abs(new_mean.y - old_mean.y)
             + jnp.abs(new_mean.z - old_mean.z)) * (1.0 / 3.0)
    rel = delta / (lum + 0.05)
    # First pass (n_samples == 0): keep err at +inf so EVERY pixel gets a
    # second look; afterwards err holds the RAW latest inter-pass relative
    # disagreement (no accumulated-evidence scaling — for converging pixels
    # the pass-vs-history delta shrinks on its own as the history tightens,
    # and periodic ``reprobe`` passes re-measure pixels that stopped early).
    seen = film.n_samples > 0.0
    err = jnp.where(want & seen, rel, film.err)
    err = jnp.where(want & ~seen, jnp.inf, err)
    err = jnp.where(~want, film.err, err)

    return AdaptiveFilm(
        color_sum=film.color_sum + pass_.color_sum,
        depth_sum=film.depth_sum + pass_.depth_sum,
        n_samples=film.n_samples + took,
        err=err,
        rays_traced=film.rays_traced + pass_.rays_traced)


@functools.lru_cache(maxsize=16)
def _jitted_pass(config: RenderConfig, tolerance: float):
    return jax.jit(functools.partial(_adaptive_pass, config=config,
                                     tolerance=tolerance),
                   donate_argnames=("film",))


class AdaptiveRenderer:
    """Progressive renderer that concentrates samples where the image is still
    noisy. ``config.samples_per_pixel`` is the per-PASS budget; call ``step``
    until ``converged_fraction()`` is high enough (or a fixed pass count).

    ``tolerance``: a pixel stops sampling once its relative inter-pass
    disagreement drops BELOW this. 0 never stops any pixel (uniform
    progressive rendering).

    ``reprobe_every``: every this-many passes, one pass force-samples every
    pixel and re-measures its disagreement, so a noisy pixel that stopped on
    one coincidentally-agreeing pass recovers instead of under-sampling
    forever. Genuinely converged pixels re-freeze immediately (their fresh
    disagreement lands back under tolerance), so the sample-density SHAPE is
    unchanged — re-probe passes just add a uniform floor. 0 disables.
    """

    def __init__(self, config: RenderConfig, tolerance: float = 0.02,
                 reprobe_every: int = 4):
        self.config = config
        self.tolerance = float(tolerance)
        self.reprobe_every = int(reprobe_every)
        self.film = _new_film(config.n_pixels)
        self._fn = _jitted_pass(config, self.tolerance)
        self._sample_offset = 0
        self._pass_count = 0
        self._last_cam_key = None

    def reset(self) -> None:
        self.film = _new_film(self.config.n_pixels)
        self._sample_offset = 0
        self._pass_count = 0

    def step(self, scene: SceneBuffers, cam: CameraState, seed: int) -> None:
        # Accumulated samples are only valid for one viewpoint — reset on
        # camera change, like ProgressiveRenderer.
        cam_key = tuple(float(np.asarray(x)) for x in jax.tree.leaves(cam))
        if cam_key != self._last_cam_key:
            self.reset()
            self._last_cam_key = cam_key
        reprobe = (self.reprobe_every > 0 and self._pass_count > 0
                   and self._pass_count % self.reprobe_every == 0)
        self.film = self._fn(film=self.film, scene=scene, cam=cam,
                             frame_seed=jnp.uint32(seed & 0xFFFFFFFF),
                             sample_offset=jnp.uint32(self._sample_offset),
                             reprobe=jnp.bool_(reprobe))
        self._sample_offset += self.config.samples_per_pixel
        self._pass_count += 1

    def save(self, path: str) -> None:
        """Checkpoint the adaptive state (.npz) — resumable mid-refinement."""
        f = self.film
        np.savez(path, color_x=np.asarray(f.color_sum.x),
                 color_y=np.asarray(f.color_sum.y),
                 color_z=np.asarray(f.color_sum.z),
                 depth=np.asarray(f.depth_sum),
                 n_samples=np.asarray(f.n_samples), err=np.asarray(f.err),
                 rays_traced=np.asarray(f.rays_traced),
                 sample_offset=np.int64(self._sample_offset),
                 pass_count=np.int64(self._pass_count),
                 width=np.int64(self.config.width),
                 height=np.int64(self.config.height),
                 cam_key=np.asarray(self._last_cam_key or [], np.float64))

    def load(self, path: str) -> None:
        z = np.load(path)
        if (int(z["width"]), int(z["height"])) != (self.config.width,
                                                   self.config.height):
            raise ValueError(
                f"adaptive checkpoint {path!r} is {int(z['width'])}x"
                f"{int(z['height'])} but the config is "
                f"{self.config.width}x{self.config.height}")
        self.film = AdaptiveFilm(
            color_sum=Vec3(jnp.asarray(z["color_x"]),
                           jnp.asarray(z["color_y"]),
                           jnp.asarray(z["color_z"])),
            depth_sum=jnp.asarray(z["depth"]),
            n_samples=jnp.asarray(z["n_samples"]),
            err=jnp.asarray(z["err"]),
            rays_traced=jnp.asarray(z["rays_traced"]))
        self._sample_offset = int(z["sample_offset"])
        self._pass_count = (int(z["pass_count"]) if "pass_count" in z
                            else self._sample_offset
                            // max(self.config.samples_per_pixel, 1))
        # Resuming under the SAME camera continues; a different camera at the
        # next step() correctly resets (the film is viewpoint-specific).
        ck = z["cam_key"] if "cam_key" in z else np.array([])
        self._last_cam_key = tuple(float(v) for v in ck) if ck.size else None

    def converged_fraction(self) -> float:
        return float(jnp.mean(self.film.err < self.tolerance))

    def samples_map(self) -> np.ndarray:
        return np.asarray(self.film.n_samples).reshape(self.config.height,
                                                       self.config.width)

    def resolve(self, cam: CameraState, raster_color: Optional[Vec3] = None,
                raster_depth=None) -> FrameResult:
        # film.resolve_impl's inv = 1/max(n, 1) math broadcasts over the
        # per-pixel n_samples array unchanged — reuse it (and its jit cache).
        from .film import Film, _jitted_resolve
        if raster_color is None:
            raster_color = Vec3.splat(jnp.float32(1.0))
        if raster_depth is None:
            raster_depth = jnp.float32(0.0)
        film = Film(color_sum=self.film.color_sum,
                    depth_sum=self.film.depth_sum,
                    n_samples=self.film.n_samples,
                    rays_traced=self.film.rays_traced)
        return _jitted_resolve(self.config)(film=film, cam=cam,
                                            raster_color=raster_color,
                                            raster_depth=raster_depth)
