"""Random number generation.

Two layers:

1. ``pcg_step`` / ``next_float`` — a bit-exact reimplementation of the reference's
   serial PCG hash (``assets/shaders/random.wgsl:8-15`` and ``:3-6``). Used by unit
   tests to prove hash parity and as the mixing primitive below.

2. A **counter-based (stateless) stream** built from the same PCG mix. The reference
   threads one mutable ``rng_state`` through a pixel's whole trace, which serializes
   draws; in a batched wavefront every lane must know its random numbers without
   sequencing, so each draw is ``hash(stream, draw_index)``. The engine assigns
   every (pixel, sample, bounce) a fixed *slot budget* so the NumPy oracle and the
   JAX renderer consume identical uniforms and produce bit-comparable images.

Unit-ball sampling: the reference rejection-samples (``random.wgsl:17-26``, an
unbounded loop). That is hostile to SIMD, so we draw an exactly-equal distribution
(uniform in the unit ball) with a fixed draw count: isotropic Gaussian direction
(Box–Muller) times a cube-root radius. Note the reference's ``randomUnitVec3`` is NOT
normalized (``random.wgsl:28-30``) — quirk #1 in SURVEY.md §2 — and neither is ours.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from .constants import PI
from .vec import Vec3

_U32 = jnp.uint32
_F32 = jnp.float32

# 1 / 2^32 as float32 — f32(0xffffffff) rounds up to 2^32, so the WGSL divide
# ``f32(state) / f32(0xffffffffu)`` is exactly a scale by 2^-32 (random.wgsl:5).
_INV_2POW32 = np.float32(1.0 / 4294967296.0)

# Mixing constants for the counter-based streams (splitmix64 / murmur3 fractions).
_GOLD = np.uint32(0x9E3779B9)
_MIX1 = np.uint32(0x85EBCA6B)
_MIX2 = np.uint32(0xC2B2AE35)


def pcg_step(state):
    """One PCG advance+output, bit-exact vs ``random.wgsl:8-15``.

    Works on JAX or NumPy uint32 arrays (both wrap on overflow for uint32).
    """
    old = state + np.uint32(747796405) + np.uint32(2891336453)
    word = ((old >> ((old >> np.uint32(28)) + np.uint32(4))) ^ old) * np.uint32(277803737)
    return (word >> np.uint32(22)) ^ word


def to_float01(state):
    """u32 → f32 in [0, 1): ``f32(state) * 2^-32`` (random.wgsl:3-6).

    The JAX path avoids a direct uint32→float32 cast (no Mosaic lowering) by
    splitting into a 24-bit high part and 8-bit low part; ``hi*256`` is exact and
    the sum rounds once, so the result is bit-identical to the direct cast.
    """
    if isinstance(state, (np.ndarray, np.generic)):
        return state.astype(np.float32) * _INV_2POW32
    hi = (state >> np.uint32(8)).astype(jnp.int32).astype(jnp.float32)
    lo = (state & np.uint32(0xFF)).astype(jnp.int32).astype(jnp.float32)
    return (hi * np.float32(256.0) + lo) * _INV_2POW32


def next_float(state):
    """Serial API mirroring ``rngNextFloat`` (random.wgsl:3-6): advance, then map."""
    state = pcg_step(state)
    return state, to_float01(state)


# ---------------------------------------------------------------------------
# Counter-based streams
# ---------------------------------------------------------------------------

def stream_init(pixel_id, sample_index, frame_seed):
    """Derive a per-(pixel, sample, frame) stream word.

    All args uint32 arrays/scalars. Double PCG application gives full avalanche over
    the linearly-combined inputs.
    """
    base = (pixel_id * _GOLD) ^ (sample_index * _MIX1) ^ frame_seed
    return pcg_step(pcg_step(base))


def draw(stream, slot):
    """Uniform f32 in [0,1) for draw-slot ``slot`` of ``stream`` (no state carried)."""
    with np.errstate(over="ignore"):   # uint32 wraparound is the point
        mixed = pcg_step(pcg_step(stream ^ (_as_u32(slot) * _MIX2)))
    return to_float01(mixed)


def _as_u32(v):
    if isinstance(v, (int, np.integer)):
        return np.uint32(v)
    return v


# ---------------------------------------------------------------------------
# Unit-ball sampling (fixed draw count)
# ---------------------------------------------------------------------------

BALL_DRAWS = 5


def unit_ball_from_uniforms(u1, u2, u3, u4, u5) -> Vec3:
    """Uniform point in the unit ball from 5 uniforms (JAX arrays).

    Distributionally identical to the reference's rejection sampler
    (``random.wgsl:17-26``) but with a fixed op count: Gaussian direction via
    Box–Muller, radius via inverse-CDF (cube root).
    """
    u1 = jnp.maximum(u1, 1e-10)
    u3 = jnp.maximum(u3, 1e-10)
    r1 = jnp.sqrt(-2.0 * jnp.log(u1))
    r3 = jnp.sqrt(-2.0 * jnp.log(u3))
    two_pi = np.float32(2.0 * PI)
    g = Vec3(r1 * jnp.cos(two_pi * u2), r1 * jnp.sin(two_pi * u2), r3 * jnp.cos(two_pi * u4))
    inv_len = 1.0 / jnp.maximum(g.length(), 1e-20)
    # cbrt for u >= 0 via exp(log(u)/3), the same formula as the NumPy twin
    # below, which keeps the renderer and the oracle comparable.
    radius = jnp.exp(jnp.log(jnp.maximum(u5, 1e-30)) * np.float32(1.0 / 3.0))
    return g.scale(inv_len * radius)


def unit_ball_from_uniforms_np(u1, u2, u3, u4, u5):
    """float32 NumPy twin of :func:`unit_ball_from_uniforms` for the oracle.

    Returns an ``(..., 3)`` float32 array. Must stay formula-identical to the JAX
    version so golden tests compare bit-near images.
    """
    u1 = np.maximum(np.float32(u1), np.float32(1e-10))
    u3 = np.maximum(np.float32(u3), np.float32(1e-10))
    r1 = np.sqrt(np.float32(-2.0) * np.log(u1))
    r3 = np.sqrt(np.float32(-2.0) * np.log(u3))
    two_pi = np.float32(2.0 * PI)
    gx = r1 * np.cos(two_pi * np.float32(u2))
    gy = r1 * np.sin(two_pi * np.float32(u2))
    gz = r3 * np.cos(two_pi * np.float32(u4))
    g = np.stack([gx, gy, gz], axis=-1).astype(np.float32)
    length = np.sqrt((g * g).sum(-1, keepdims=True)).astype(np.float32)
    inv_len = np.float32(1.0) / np.maximum(length, np.float32(1e-20))
    radius = np.exp(np.log(np.maximum(np.float32(u5), np.float32(1e-30)))
                    * np.float32(1.0 / 3.0))[..., None].astype(np.float32)
    return (g * inv_len * radius).astype(np.float32)
