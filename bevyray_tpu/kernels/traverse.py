"""Flattened-BVH traversal — batched twin of ``raycast`` (raytrace.wgsl:313-346).

Each ray walks the flattened BVH with a bounded per-lane stack (the reference uses a
fixed 32-entry stack, wgsl:310; overflow silently truncates traversal — SURVEY.md
quirk #9 — reproduced here). The batch iterates in lock-step under a
``lax.while_loop`` until every lane's stack is empty.

This is gather-heavy and divergent: every lane walks in lockstep until the last
lane's stack is empty (SURVEY.md §7 "hard parts" #1). It exists for (a) feature
parity, (b) correctness cross-checks against the dense brute-force path, and (c)
large scenes where O(n) brute force loses to O(log n) traversal despite the gathers.
For the reference's ~500-sphere scenes the dense path (intersect.py) is used;
``engine.renderer`` picks per scene size.

Multi-prim leaves (``max_leaf_size`` > 1, obvhs MAX_MODELS_PER_NODE —
wgsl:311/:348-362): supported for node-ABI parity, but measured a LOSS on this
lockstep walk (20k spheres / 65k rays, CPU, round 5: K=1 1.74 s, K=2 2.03 s,
K=4 2.40 s, K=8 3.42 s) — every lane pays the K-prim leaf loop on every
iteration whether or not it sits at a leaf, while the saved tree depth only
shortens the walk ~logarithmically. On a divergence-free GPU wavefront the
trade goes the other way; here K=1 stays the default.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.constants import INF, T_MIN
from ..core.types import BvhNodes, Spheres
from ..core.vec import Vec3

STACK_SIZE = 32  # raytrace.wgsl:310


def _slab_entry_distance(origin: Vec3, inv_dir: Vec3, bmin: Vec3, bmax: Vec3):
    """Branchless slab test returning entry distance (ray_bounding_dst,
    wgsl:387-398): 0 if origin inside, INF on miss."""
    tx1 = (bmin.x - origin.x) * inv_dir.x
    tx2 = (bmax.x - origin.x) * inv_dir.x
    ty1 = (bmin.y - origin.y) * inv_dir.y
    ty2 = (bmax.y - origin.y) * inv_dir.y
    tz1 = (bmin.z - origin.z) * inv_dir.z
    tz2 = (bmax.z - origin.z) * inv_dir.z
    t_near = jnp.maximum(jnp.maximum(jnp.minimum(tx1, tx2), jnp.minimum(ty1, ty2)),
                         jnp.minimum(tz1, tz2))
    t_far = jnp.minimum(jnp.minimum(jnp.maximum(tx1, tx2), jnp.maximum(ty1, ty2)),
                        jnp.maximum(tz1, tz2))
    hit = (t_far >= t_near) & (t_far > 0.0)
    return jnp.where(hit, jnp.where(t_near > 0.0, t_near, 0.0), INF)


def _sphere_t(origin: Vec3, direction: Vec3, a, inv_a, cx, cy, cz, r):
    """Near-root-only sphere distance (hit_sphere, wgsl:371-383); INF if invalid."""
    ocx = cx - origin.x
    ocy = cy - origin.y
    ocz = cz - origin.z
    h = direction.x * ocx + direction.y * ocy + direction.z * ocz
    c = ocx * ocx + ocy * ocy + ocz * ocz - r * r
    disc = h * h - a * c
    t = (h - jnp.sqrt(jnp.maximum(disc, 0.0))) * inv_a
    ok = (disc >= 0.0) & (t > T_MIN)
    return jnp.where(ok, t, INF)


def _tri_leaf_t(origin: Vec3, direction: Vec3, tris, prim):
    """Möller–Trumbore distance for gathered triangle ``prim`` per lane (same
    acceptance as kernels.intersect.intersect_triangles); INF on miss."""
    ax, ay, az = tris.ax[prim], tris.ay[prim], tris.az[prim]
    e1x = tris.bx[prim] - ax
    e1y = tris.by[prim] - ay
    e1z = tris.bz[prim] - az
    e2x = tris.cx[prim] - ax
    e2y = tris.cy[prim] - ay
    e2z = tris.cz[prim] - az
    dx, dy, dz = direction.x, direction.y, direction.z
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = px * e1x + py * e1y + pz * e1z
    inv_det = 1.0 / det
    tx = origin.x - ax
    ty = origin.y - ay
    tz = origin.z - az
    u = (tx * px + ty * py + tz * pz) * inv_det
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    ok = ((jnp.abs(det) > 1e-12) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
          & (t > T_MIN) & tris.valid[prim])
    return jnp.where(ok, t, INF)


def intersect_bvh_triangles(origin: Vec3, direction: Vec3, tris, bvh: BvhNodes,
                            stack_size: int = STACK_SIZE,
                            max_leaf_size: int = 1):
    """Nearest triangle hit via BVH traversal (the reference's planned ModelBVH,
    extract.rs:239-248) — same bounded-stack walk as the sphere version with a
    Möller–Trumbore leaf test."""
    return _intersect_bvh_generic(
        origin, direction, bvh, stack_size, max_leaf_size,
        capacity=tris.capacity,
        leaf_t=lambda prim: _tri_leaf_t(origin, direction, tris, prim))


def intersect_bvh(origin: Vec3, direction: Vec3, spheres: Spheres, bvh: BvhNodes,
                  stack_size: int = STACK_SIZE, max_leaf_size: int = 1):
    """Nearest hit via BVH traversal. Returns (t, index) like
    :func:`..kernels.intersect.intersect_spheres`."""
    a = direction.dot(direction)
    inv_a = 1.0 / a

    def leaf_t(prim):
        return _sphere_t(origin, direction, a, inv_a,
                         spheres.cx[prim], spheres.cy[prim], spheres.cz[prim],
                         spheres.radius[prim])

    return _intersect_bvh_generic(origin, direction, bvh, stack_size,
                                  max_leaf_size, capacity=spheres.capacity,
                                  leaf_t=leaf_t)


def _intersect_bvh_generic(origin: Vec3, direction: Vec3, bvh: BvhNodes,
                           stack_size: int, max_leaf_size: int, capacity: int,
                           leaf_t):
    """Shared bounded-stack BVH walk; ``leaf_t(prim_index_array)`` returns the
    per-lane hit distance for one primitive (INF on miss)."""
    n = origin.x.shape[0]
    lanes = jnp.arange(n)

    inv_dir = Vec3(1.0 / direction.x, 1.0 / direction.y, 1.0 / direction.z)

    # stack[:, 0] = 0 (root), stack_index = 1 — wgsl:316-318.
    stack0 = jnp.zeros((n, stack_size), jnp.int32)
    sp0 = jnp.ones((n,), jnp.int32)
    best_t0 = jnp.full((n,), INF, jnp.float32)
    best_i0 = jnp.full((n,), -1, jnp.int32)

    def cond(state):
        _, sp, _, _ = state
        return jnp.any((sp > 0) & (sp < stack_size))   # wgsl:320

    def body(state):
        stack, sp, best_t, best_i = state
        active = (sp > 0) & (sp < stack_size)
        spm1 = jnp.maximum(sp - 1, 0)
        node = jnp.take_along_axis(stack, spm1[:, None], axis=1)[:, 0]
        node = jnp.where(active, node, 0)
        sp = jnp.where(active, spm1, sp)

        count = bvh.count[node]
        first = bvh.index[node]
        is_leaf = active & (count > 0)

        # --- leaf: test prims [first, first+count) (wgsl:348-362). With
        # multi-prim leaves the slot resolves through the prim_ids
        # indirection (obvhs reorders the model array instead; same ABI
        # semantics, extraction-order tables preserved) -----------------------
        new_t, new_i = best_t, best_i
        for k in range(max_leaf_size):
            if bvh.prim_ids is None:
                prim = jnp.clip(first + k, 0, capacity - 1)
            else:
                slot = jnp.clip(first + k, 0, bvh.prim_ids.shape[0] - 1)
                prim = jnp.clip(bvh.prim_ids[slot], 0, capacity - 1)
            t = leaf_t(prim)
            ok = is_leaf & (k < count) & (t < new_t)
            new_i = jnp.where(ok, prim, new_i)
            new_t = jnp.where(ok, t, new_t)

        # --- inner: push children whose slab distance beats best (wgsl:328-341)
        is_inner = active & (count == 0)
        c1 = jnp.clip(first, 0, bvh.min_x.shape[0] - 1)
        c2 = jnp.clip(first + 1, 0, bvh.min_x.shape[0] - 1)

        def child_dist(ci):
            bmin = Vec3(bvh.min_x[ci], bvh.min_y[ci], bvh.min_z[ci])
            bmax = Vec3(bvh.max_x[ci], bvh.max_y[ci], bvh.max_z[ci])
            return _slab_entry_distance(origin, inv_dir, bmin, bmax)

        d1 = child_dist(c1)
        d2 = child_dist(c2)
        push1 = is_inner & (d1 < INF) & (d1 < new_t)
        push2 = is_inner & (d2 < INF) & (d2 < new_t)

        # Two sequential scatters with per-lane positions; pushes past the stack
        # top are dropped, reproducing the reference's silent truncation.
        pos1 = jnp.where(push1 & (sp < stack_size), sp, stack_size)
        stack = stack.at[lanes, pos1].set(c1, mode="drop")
        sp = sp + push1.astype(jnp.int32)
        pos2 = jnp.where(push2 & (sp < stack_size), sp, stack_size)
        stack = stack.at[lanes, pos2].set(c2, mode="drop")
        sp = sp + push2.astype(jnp.int32)

        return stack, sp, new_t, new_i

    _, _, best_t, best_i = jax.lax.while_loop(
        cond, body, (stack0, sp0, best_t0, best_i0))
    return best_t, best_i
