"""Edge-aware à-trous denoising — a post-process extension beyond the
reference (which displays the raw 4-spp estimate every frame).

This is the classic à-trous wavelet filter used by real-time path tracers
(SVGF-family): a 5×5 B3-spline kernel applied at doubling strides, with
bilateral weights that stop the filter at color and depth edges. The depth
guide comes for free — every frame already carries ``rt_depth``
(raytrace.wgsl's depth output). Pure jnp and fully jittable: the 25 taps per
iteration compile to shifted adds (``jnp.roll`` + edge masks), which XLA fuses
into a handful of elementwise passes — no gathers.

Extension contract: not in the render path at all unless explicitly invoked
(CLI ``--denoise N`` or a direct call); ``iterations=0`` returns the input
unchanged.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

# B3-spline 1D taps (1/16)·[1 4 6 4 1] — the standard à-trous kernel.
_TAPS = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)


def _shift2d(x, dy, dx):
    """Shift with edge-clamp semantics (replicate border): roll, then overwrite
    the wrapped band with the nearest valid row/column."""
    if dy:
        x = jnp.roll(x, dy, axis=0)
        if dy > 0:
            x = x.at[:dy].set(x[dy:dy + 1])
        else:
            x = x.at[dy:].set(x[dy - 1:dy])
    if dx:
        x = jnp.roll(x, dx, axis=1)
        if dx > 0:
            x = x.at[:, :dx].set(x[:, dx:dx + 1])
        else:
            x = x.at[:, dx:].set(x[:, dx - 1:dx])
    return x


def atrous_denoise(image: jnp.ndarray, depth: jnp.ndarray, *,
                   iterations: int = 3, sigma_color: float = 0.25,
                   sigma_depth: float = 0.5) -> jnp.ndarray:
    """Denoise ``image`` [H, W, 3] guided by ``depth`` [H, W].

    ``sigma_color`` is in gamma-space color units; ``sigma_depth`` in world
    units, scaled by the iteration's stride so coarse passes tolerate the
    depth gradient across smooth surfaces. Misses (depth beyond the far
    fallback) form their own edge region, so the sky never bleeds into
    silhouettes.
    """
    if iterations <= 0:
        return image
    img = jnp.asarray(image, jnp.float32)
    z = jnp.asarray(depth, jnp.float32)
    inv_2sc2 = 1.0 / (2.0 * sigma_color * sigma_color)

    for it in range(iterations):
        stride = 1 << it
        if 2 * stride >= min(img.shape[0], img.shape[1]):
            break   # taps would reach past the image — coarser passes are moot
        sz = sigma_depth * stride
        inv_2sz2 = 1.0 / (2.0 * sz * sz)
        acc = jnp.zeros_like(img)
        wsum = jnp.zeros_like(z)
        for iy, ty in enumerate(_TAPS):
            for ix, tx in enumerate(_TAPS):
                dy, dx = (iy - 2) * stride, (ix - 2) * stride
                cq = _shift2d(img, dy, dx)
                zq = _shift2d(z, dy, dx)
                dc2 = jnp.sum((img - cq) ** 2, axis=-1)
                dz2 = (z - zq) ** 2
                w = (ty * tx) * jnp.exp(-(dc2 * inv_2sc2 + dz2 * inv_2sz2))
                acc = acc + cq * w[..., None]
                wsum = wsum + w
        img = acc / jnp.maximum(wsum, 1e-8)[..., None]
    return img


@functools.lru_cache(maxsize=8)
def jitted_denoise(iterations: int, sigma_color: float, sigma_depth: float):
    return jax.jit(functools.partial(atrous_denoise, iterations=iterations,
                                     sigma_color=sigma_color,
                                     sigma_depth=sigma_depth))
