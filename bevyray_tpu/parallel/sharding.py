"""Multi-chip rendering: SPMD sharding of the frame step over a device mesh.

The reference is strictly single-GPU (SURVEY.md §2 parallelism inventory); scaling it
is new design — ``jax.sharding.Mesh`` + ``shard_map`` with XLA collectives (NCCL
over NVLink between GPUs), never host-side ray splitting. The cards of one host
are joined all to all, so the mesh shape follows the algorithm alone.

Mesh axes and what they shard (the renderer's analogs of the classic parallelism
kinds):

- ``sp`` — *spatial/sequence parallel*: pixel rows. Zero-communication data
  parallelism over the image; the natural first axis (SURVEY.md §5 long-context
  analog: the "long axis" here is pixels × samples).
- ``dp`` — *data parallel over samples*: each peer traces ``spp / dp`` samples of
  every pixel with disjoint sample indices; one ``psum`` merges radiance sums.
- ``tp`` — *tensor parallel over the sphere table*: each peer intersects its slice
  of the scene; a ``pmin`` pair reduces (t, index) to the global nearest hit. This
  splits the O(rays × spheres) hot loop, the analog of sharding a matmul's
  contraction dimension.

There is no pipeline or expert axis — the frame step has neither a layer sequence
nor routed experts; SURVEY.md §2 records that none exist in the reference either.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..core.constants import INF
from ..core.types import CameraState, RenderConfig, SceneBuffers, Spheres
from ..core.vec import Vec3
from ..engine.renderer import FrameResult, trace_samples
from ..kernels.composite import composite
from ..kernels.intersect import intersect_spheres
from ..kernels.raygen import pixel_uv

AXES = ("sp", "dp", "tp")


def make_mesh(sp: int = 1, dp: int = 1, tp: int = 1,
              devices: Optional[list] = None) -> Mesh:
    """Build an (sp, dp, tp) mesh. Axis sizes must multiply to the device count."""
    n = sp * dp * tp
    devs = devices if devices is not None else jax.devices()[:n]
    if len(devs) != n:
        raise ValueError(f"need {n} devices, have {len(devs)}")
    return Mesh(np.asarray(devs).reshape(sp, dp, tp), AXES)


def default_mesh_shape(n_devices: int):
    """Factor a device count into (sp, dp, tp).

    Spatial parallelism is communication-free, so it gets the leftovers; dp and tp
    each get a factor of 2 when available (n≥8 for tp) so all collective paths are
    exercised.
    """
    tp = 2 if (n_devices % 2 == 0 and n_devices >= 8) else 1
    rem = n_devices // tp
    dp = 2 if rem % 2 == 0 else 1
    sp = rem // dp
    return sp, dp, tp


def _tp_intersect_fn(scene: SceneBuffers, config: RenderConfig, tp: int):
    """Sphere-table-sharded intersection with a cross-device nearest-hit reduce."""
    cap = scene.spheres.capacity
    assert cap % tp == 0, f"sphere capacity {cap} must divide tp={tp}"
    chunk_len = cap // tp

    def fn(o: Vec3, d: Vec3):
        tp_i = jax.lax.axis_index("tp")
        offset = tp_i * chunk_len
        sl = lambda a: jax.lax.dynamic_slice_in_dim(a, offset, chunk_len)
        local = Spheres(cx=sl(scene.spheres.cx), cy=sl(scene.spheres.cy),
                        cz=sl(scene.spheres.cz), radius=sl(scene.spheres.radius),
                        material_id=sl(scene.spheres.material_id),
                        valid=sl(scene.spheres.valid))
        t, i = intersect_spheres(o, d, local, min(config.sphere_chunk, chunk_len))
        i = jnp.where(i >= 0, i + offset, -1)
        # Global nearest hit: min over t, then lowest index among the winners
        # (deterministic tie-break).
        t_min = jax.lax.pmin(t, "tp")
        i_cand = jnp.where((t == t_min) & (i >= 0), i, jnp.int32(2**31 - 1))
        i_min = jax.lax.pmin(i_cand, "tp")
        i_min = jnp.where(t_min >= INF, -1, i_min)
        return t_min, i_min

    return fn


def render_frame_sharded(mesh: Mesh, scene: SceneBuffers, cam: CameraState,
                         config: RenderConfig, frame_seed,
                         raster_color: Optional[Vec3] = None,
                         raster_depth=None) -> FrameResult:
    """Render one frame SPMD over ``mesh``. Host-side convenience wrapper around
    :func:`make_sharded_step`."""
    step = make_sharded_step(mesh, config)
    if raster_color is None:
        raster_color = Vec3.splat(jnp.float32(1.0))
    if raster_depth is None:
        raster_depth = jnp.float32(0.0)
    return step(scene, cam, jnp.uint32(frame_seed), raster_color, raster_depth)


@functools.lru_cache(maxsize=16)
def _sharded_step_cached(mesh: Mesh, config: RenderConfig):
    sp, dp, tp = (mesh.shape[a] for a in AXES)
    n = config.n_pixels
    if n % sp != 0:
        raise ValueError(f"pixel count {n} must be divisible by sp={sp}")
    if config.samples_per_pixel % dp != 0:
        raise ValueError(
            f"spp {config.samples_per_pixel} must be divisible by dp={dp}")
    local_spp = config.samples_per_pixel // dp

    def body(scene, cam, u, v, pixel_ids, frame_seed):
        intersect_fn = (_tp_intersect_fn(scene, config, tp) if tp > 1 else None)
        dp_i = jax.lax.axis_index("dp")

        color_sum, depth_sum, seg_sum = trace_samples(
            scene, cam, config, pixel_ids, u, v, local_spp, dp_i * local_spp,
            frame_seed, intersect_fn=intersect_fn, fixed_trip_count=(tp > 1))
        n_local = u.shape[0]

        # Merge partial sample sums across the dp axis (one collective).
        color_sum = Vec3(*(jax.lax.psum(c, "dp") for c in color_sum))
        depth_sum = jax.lax.psum(depth_sum, "dp")
        seg_sum = jax.lax.psum(jax.lax.psum(seg_sum, "dp"), "sp")

        inv_spp = np.float32(1.0 / config.samples_per_pixel)
        rt_color = color_sum.scale(inv_spp)
        rt_depth = depth_sum * inv_spp
        rt = jnp.stack([jnp.broadcast_to(rt_color.x, (n_local,)),
                        jnp.broadcast_to(rt_color.y, (n_local,)),
                        jnp.broadcast_to(rt_color.z, (n_local,))], axis=-1)
        return rt, rt_depth, seg_sum

    sharded = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(), P(), P("sp"), P("sp"), P("sp"), P()),
        out_specs=(P("sp"), P("sp"), P()),
        # The bounce-loop carry starts replicated (camera origin) and becomes
        # device-varying after the first intersection; the static
        # varying-manual-axes check can't express that, so it's disabled. The
        # collectives (psum over dp, pmin over tp) are explicit and correct.
        check_vma=False,
    )

    @jax.jit
    def step(scene, cam, frame_seed, raster_color, raster_depth):
        u, v = pixel_uv(config.width, config.height)
        pixel_ids = jnp.arange(n, dtype=jnp.uint32)
        rt, rt_depth, seg_sum = sharded(scene, cam, u, v, pixel_ids, frame_seed)
        # Composite outside shard_map: raster inputs may be per-pixel arrays
        # (engine/raster.py), which have no consistent in_spec against sharded pixels
        # — here XLA partitions the elementwise op under whatever sharding the
        # raster layer already carries.
        out = composite(config.level, Vec3(rt[:, 0], rt[:, 1], rt[:, 2]),
                        rt_depth, cam.near, cam.far, raster_color, raster_depth)
        img = jnp.stack([jnp.broadcast_to(out.x, (n,)),
                         jnp.broadcast_to(out.y, (n,)),
                         jnp.broadcast_to(out.z, (n,))], axis=-1)
        return FrameResult(
            image=img.reshape(config.height, config.width, 3),
            rt_depth=rt_depth.reshape(config.height, config.width),
            rays_traced=seg_sum)

    return step


def make_sharded_step(mesh: Mesh, config: RenderConfig):
    """Compile (once per mesh×config) the SPMD frame step."""
    return _sharded_step_cached(mesh, config)
