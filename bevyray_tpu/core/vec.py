"""Structure-of-arrays 3-vector math.

Design note: the reference stores rays/normals as ``vec3<f32>`` values in
per-thread registers (``raytrace.wgsl:125-128``). A batched wavefront with a
trailing axis of size 3 would stride every component access; we therefore keep each
component as its own full array (SoA), so every vector op is a plain elementwise op
over contiguous arrays. ``Vec3`` is a NamedTuple and thus a JAX pytree:
it can flow through ``jit``/``scan``/``vmap`` untouched.
"""

from __future__ import annotations

from typing import NamedTuple, Union

import jax
import jax.numpy as jnp

Scalar = Union[float, jnp.ndarray]


class Vec3(NamedTuple):
    """Three same-shaped arrays acting as a batch of 3D vectors."""

    x: jnp.ndarray
    y: jnp.ndarray
    z: jnp.ndarray

    # -- constructors ----------------------------------------------------------
    @staticmethod
    def splat(v: Scalar) -> "Vec3":
        v = jnp.asarray(v, jnp.float32)
        return Vec3(v, v, v)

    @staticmethod
    def full(shape, x: float, y: float, z: float, dtype=jnp.float32) -> "Vec3":
        return Vec3(
            jnp.full(shape, x, dtype),
            jnp.full(shape, y, dtype),
            jnp.full(shape, z, dtype),
        )

    @staticmethod
    def from_array(a) -> "Vec3":
        """Build from an array whose last axis is 3."""
        a = jnp.asarray(a, jnp.float32)
        return Vec3(a[..., 0], a[..., 1], a[..., 2])

    def to_array(self) -> jnp.ndarray:
        return jnp.stack([self.x, self.y, self.z], axis=-1)

    # -- arithmetic -------------------------------------------------------------
    def __add__(self, o: "Vec3") -> "Vec3":
        return Vec3(self.x + o.x, self.y + o.y, self.z + o.z)

    def __sub__(self, o: "Vec3") -> "Vec3":
        return Vec3(self.x - o.x, self.y - o.y, self.z - o.z)

    def __neg__(self) -> "Vec3":
        return Vec3(-self.x, -self.y, -self.z)

    def __mul__(self, o: Union["Vec3", Scalar]) -> "Vec3":
        if isinstance(o, Vec3):
            return Vec3(self.x * o.x, self.y * o.y, self.z * o.z)
        return Vec3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    def scale(self, s: Scalar) -> "Vec3":
        return Vec3(self.x * s, self.y * s, self.z * s)

    # -- geometry ---------------------------------------------------------------
    def dot(self, o: "Vec3") -> jnp.ndarray:
        return self.x * o.x + self.y * o.y + self.z * o.z

    def cross(self, o: "Vec3") -> "Vec3":
        return Vec3(
            self.y * o.z - self.z * o.y,
            self.z * o.x - self.x * o.z,
            self.x * o.y - self.y * o.x,
        )

    def length_squared(self) -> jnp.ndarray:
        return self.dot(self)

    def length(self) -> jnp.ndarray:
        return jnp.sqrt(self.length_squared())

    def normalize(self) -> "Vec3":
        # rsqrt maps to a single fast VPU op; matches WGSL normalize() semantics for
        # nonzero vectors (zero vectors produce inf/nan, same as the reference).
        return self.scale(jax.lax.rsqrt(self.length_squared()))

    @staticmethod
    def where(mask: jnp.ndarray, a: "Vec3", b: "Vec3") -> "Vec3":
        return Vec3(
            jnp.where(mask, a.x, b.x),
            jnp.where(mask, a.y, b.y),
            jnp.where(mask, a.z, b.z),
        )


def reflect(v: Vec3, n: Vec3) -> Vec3:
    """Mirror reflection, ``raytrace.wgsl:400-402``: v - 2 (v.n) n."""
    return v - n.scale(2.0 * v.dot(n))


def refract(v: Vec3, n: Vec3, etai_over_etat: Scalar) -> Vec3:
    """Snell refraction, ``raytrace.wgsl:404-409``. ``v`` must be unit-length."""
    cos_theta = jnp.minimum((-v).dot(n), 1.0)
    r_out_perp = (v + n.scale(cos_theta)).scale(etai_over_etat)
    r_out_parallel = n.scale(-jnp.sqrt(jnp.abs(1.0 - r_out_perp.length_squared())))
    return r_out_perp + r_out_parallel


def schlick_reflectance(cosine: jnp.ndarray, refraction_index: jnp.ndarray) -> jnp.ndarray:
    """Schlick's approximation, ``raytrace.wgsl:411-416``."""
    r0 = (1.0 - refraction_index) / (1.0 + refraction_index)
    r0 = r0 * r0
    one_minus = 1.0 - cosine
    # pow(x, 5) expanded to multiplies — cheaper than transcendental pow on the VPU.
    p5 = one_minus * one_minus
    p5 = p5 * p5 * one_minus
    return r0 + (1.0 - r0) * p5
