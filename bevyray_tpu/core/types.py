"""Device-side data model (pytrees) and static render configuration.

The reference ships scene data to the GPU as three storage buffers — models,
materials, BVH nodes (``src/raytracing/extract.rs:252-262``, consumed at
``assets/shaders/raytrace.wgsl:56-87``). We keep the same three logical tables but as
**SoA of flat arrays padded to lane multiples**, resident on device across frames
(the reference re-uploads everything every frame, its acknowledged inefficiency —
``README.md:17``; we deliberately fix that).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import jax.numpy as jnp
import numpy as np

from .vec import Vec3

# All scene tables are padded to a multiple of this many entries, so that a scene
# that grows by a few primitives keeps its shapes and its compiled programs.
LANE = 128


class Spheres(NamedTuple):
    """Analytic sphere table (reference ``Model``: extract.rs:213-218, wgsl:56-61)."""

    cx: jnp.ndarray          # [S] f32 centers
    cy: jnp.ndarray
    cz: jnp.ndarray
    radius: jnp.ndarray      # [S] f32
    material_id: jnp.ndarray  # [S] i32
    valid: jnp.ndarray       # [S] bool — False for padding lanes

    @property
    def capacity(self) -> int:
        return self.cx.shape[0]

    def center(self) -> Vec3:
        return Vec3(self.cx, self.cy, self.cz)


class Materials(NamedTuple):
    """Material table (reference ``RaytraceMaterial``: extract.rs:181-189, wgsl:63-77).

    ``base_*`` is linear-space color; ``roughness`` is Bevy's perceptual_roughness
    passed through unconverted (extract.rs:203). ``reflectance`` is carried but unused
    by the shading model, same as the reference (wgsl:72).
    """

    base_r: jnp.ndarray
    base_g: jnp.ndarray
    base_b: jnp.ndarray
    metallic: jnp.ndarray
    roughness: jnp.ndarray
    reflectance: jnp.ndarray
    ior: jnp.ndarray
    specular_transmission: jnp.ndarray
    emissive_r: jnp.ndarray
    emissive_g: jnp.ndarray
    emissive_b: jnp.ndarray

    @property
    def capacity(self) -> int:
        return self.base_r.shape[0]

    def base_color(self) -> Vec3:
        return Vec3(self.base_r, self.base_g, self.base_b)


class Triangles(NamedTuple):
    """World-space triangle table (extension; the reference plans this layout at
    extract.rs:211-212 / 239-248). SoA of vertex components, lane-padded."""

    ax: jnp.ndarray
    ay: jnp.ndarray
    az: jnp.ndarray
    bx: jnp.ndarray
    by: jnp.ndarray
    bz: jnp.ndarray
    cx: jnp.ndarray
    cy: jnp.ndarray
    cz: jnp.ndarray
    material_id: jnp.ndarray  # i32
    valid: jnp.ndarray        # bool

    @property
    def capacity(self) -> int:
        return self.ax.shape[0]


def make_triangles_np(verts_a: np.ndarray, verts_b: np.ndarray, verts_c: np.ndarray,
                      material_ids: np.ndarray,
                      capacity: Optional[int] = None) -> Triangles:
    """[T,3] per-corner world-space vertex arrays → padded device table."""
    n = verts_a.shape[0]
    cap = capacity or pad_to(max(n, 1))
    if cap < n:
        raise ValueError(f"capacity {cap} < triangle count {n}")

    def pad_f(a):
        out = np.full((cap,), 1e6, np.float32)
        out[:n] = a.astype(np.float32)
        return jnp.asarray(out)

    mid = np.zeros((cap,), np.int32)
    mid[:n] = material_ids.astype(np.int32)
    valid = np.zeros((cap,), bool)
    valid[:n] = True
    return Triangles(
        ax=pad_f(verts_a[:, 0]), ay=pad_f(verts_a[:, 1]), az=pad_f(verts_a[:, 2]),
        bx=pad_f(verts_b[:, 0]), by=pad_f(verts_b[:, 1]), bz=pad_f(verts_b[:, 2]),
        cx=pad_f(verts_c[:, 0]), cy=pad_f(verts_c[:, 1]), cz=pad_f(verts_c[:, 2]),
        material_id=jnp.asarray(mid), valid=jnp.asarray(valid),
    )


class BvhNodes(NamedTuple):
    """Flattened BVH2 (reference ``BVHNode``: extract.rs:229-237, wgsl:79-87).

    ``index`` is the first model index when ``count > 0`` (leaf), else the first of
    two adjacent children. ``n_nodes`` is the live prefix length (arrays are padded).
    """

    min_x: jnp.ndarray
    min_y: jnp.ndarray
    min_z: jnp.ndarray
    max_x: jnp.ndarray
    max_y: jnp.ndarray
    max_z: jnp.ndarray
    index: jnp.ndarray   # i32
    count: jnp.ndarray   # i32
    n_nodes: jnp.ndarray  # i32 scalar
    # Multi-prim leaves (obvhs model_count, wgsl:311): leaf k's ORIGINAL prim
    # id is prim_ids[index + k] — an indirection instead of the reference's
    # model-array reorder, so primitive tables stay in extraction order.
    # None for 1-prim-leaf trees, where index is the prim id directly.
    prim_ids: Optional[jnp.ndarray] = None  # i32, padded


class SceneBuffers(NamedTuple):
    spheres: Spheres
    materials: Materials
    bvh: Optional[BvhNodes]
    triangles: Optional[Triangles] = None
    tri_bvh: Optional[BvhNodes] = None


class CameraState(NamedTuple):
    """Per-frame dynamic camera uniforms (reference ``CameraExtract``:
    extract.rs:83-97, wgsl:35-47). All entries are f32 scalars / scalar Vec3s so the
    jitted frame step never retraces on camera motion."""

    position: Vec3
    direction: Vec3   # unit forward
    up: Vec3          # unit up
    fov: jnp.ndarray      # vertical fov, radians (Bevy default π/4)
    near: jnp.ndarray
    far: jnp.ndarray
    aspect: jnp.ndarray   # width / height
    aperture: jnp.ndarray       # thin-lens diameter; 0 = pinhole (extension)
    focus_distance: jnp.ndarray


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static (trace-time) render settings.

    Mirrors ``RaytracedCamera { level, sample_count, bounces }`` (mod.rs:86-91) plus
    the framebuffer size. These values shape the compiled program (loop trip counts,
    branch structure), hence static.
    """

    width: int
    height: int
    samples_per_pixel: int = 4   # main.rs:68
    bounces: int = 4             # main.rs:69
    level: int = 2               # Raytracing::FallbackRaytraced (main.rs:67)
    sphere_chunk: int = 512      # spheres processed per inner block in the brute path
    intersect_backend: str = "auto"  # "auto" | "brute" | "bvh"
    defocus: bool = False        # thin-lens blur (uses cam.aperture/focus_distance)
    diffuse_sampling: str = "reference"  # "reference" | "cosine"
    # Max prims per BVH leaf for the traversal backend (obvhs multi-prim
    # leaves, raytrace.wgsl:311 MAX_MODELS_PER_NODE). Shapes the compiled
    # leaf-test loop; the scene's BVH must be built with the SAME value
    # (World.extract(bvh_leaf_size=...)) — a smaller build is fine (counts
    # never exceed it), a larger one silently skips prims.
    bvh_leaf_size: int = 1

    def __post_init__(self):
        # Fail at construction with actionable messages — these values shape
        # the compiled program, so a bad one otherwise surfaces as an opaque
        # trace-time shape error deep inside jit.
        if self.width < 1 or self.height < 1:
            raise ValueError(f"frame size {self.width}x{self.height} must be "
                             "at least 1x1")
        if self.samples_per_pixel < 1:
            raise ValueError(f"samples_per_pixel {self.samples_per_pixel} "
                             "must be >= 1")
        if self.bounces < 0:
            raise ValueError(f"bounces {self.bounces} must be >= 0")
        if self.level not in (0, 1, 2, 3):
            raise ValueError(f"level {self.level} must be one of 0..3 "
                             "(Raytracing enum)")
        if self.sphere_chunk < 1:
            raise ValueError(f"sphere_chunk {self.sphere_chunk} must be >= 1")
        if self.bvh_leaf_size < 1:
            raise ValueError(f"bvh_leaf_size {self.bvh_leaf_size} must be "
                             ">= 1")
        for field, allowed in (("intersect_backend", ("auto", "brute", "bvh")),
                               ("diffuse_sampling", ("reference", "cosine"))):
            v = getattr(self, field)
            if v not in allowed:
                raise ValueError(f"{field}={v!r} must be one of {allowed}")

    @property
    def n_pixels(self) -> int:
        return self.width * self.height


def pad_to(n: int, multiple: int = LANE) -> int:
    return int(-(-n // multiple) * multiple)


def make_spheres_np(centers: np.ndarray, radii: np.ndarray, material_ids: np.ndarray,
                    capacity: Optional[int] = None) -> Spheres:
    """Build a padded device sphere table from host arrays.

    Padding lanes get ``valid=False`` and are parked far away with zero radius so any
    arithmetic on them stays finite.
    """
    n = centers.shape[0]
    cap = capacity or pad_to(max(n, 1))
    if cap < n:
        raise ValueError(f"capacity {cap} < sphere count {n}")

    def pad_f(a, fill):
        out = np.full((cap,), fill, np.float32)
        out[:n] = a.astype(np.float32)
        return jnp.asarray(out)

    def pad_i(a, fill):
        out = np.full((cap,), fill, np.int32)
        out[:n] = a.astype(np.int32)
        return jnp.asarray(out)

    valid = np.zeros((cap,), bool)
    valid[:n] = True
    return Spheres(
        cx=pad_f(centers[:, 0], 1e6), cy=pad_f(centers[:, 1], 1e6), cz=pad_f(centers[:, 2], 1e6),
        radius=pad_f(radii, 0.0),
        material_id=pad_i(material_ids, 0),
        valid=jnp.asarray(valid),
    )


def make_materials_np(table: np.ndarray, capacity: Optional[int] = None) -> Materials:
    """``table``: [M, 11] float32 columns (base_r,g,b, metallic, roughness,
    reflectance, ior, specular_transmission, emissive_r,g,b)."""
    m = table.shape[0]
    cap = capacity or pad_to(max(m, 1))
    out = np.zeros((cap, 11), np.float32)
    out[:m] = table.astype(np.float32)
    cols = [jnp.asarray(out[:, i]) for i in range(11)]
    return Materials(*cols)
