"""bevyray_tpu — a hybrid raster/path-traced rendering framework in JAX/XLA.

A ground-up JAX rebuild of the capabilities of GrandmasterB42/bevyray (a Bevy
Rust+WGSL "Ray Tracing in One Weekend" post-process renderer). See SURVEY.md for the
reference's structure and PERF.md for how its speed is measured.

Public surface (mirrors the reference's, src/raytracing/mod.rs:86-106):

    from bevyray_tpu import (Raytracing, RaytracedCamera, RaytracedSphere,
                             StandardMaterial, Transform, World, Renderer,
                             RenderConfig)
"""

from .core.types import CameraState, RenderConfig, SceneBuffers
from .core.vec import Vec3
from .engine.renderer import FrameResult, Renderer
from .scene.components import (PerspectiveProjection, RaytracedCamera,
                               RaytracedMesh, RaytracedSphere, Raytracing,
                               StandardMaterial, Transform, cube_mesh)
from .scene.world import World
from .scene import rtiow

__all__ = [
    "CameraState", "FrameResult", "PerspectiveProjection", "RaytracedCamera",
    "RaytracedMesh", "RaytracedSphere", "Raytracing", "RenderConfig", "Renderer",
    "SceneBuffers", "StandardMaterial", "Transform", "Vec3", "World", "cube_mesh",
    "rtiow",
]

__version__ = "0.1.0"
