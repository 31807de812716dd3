"""BVH acceleration (reference: include/bvh/BVHAcceleration.hpp,
src/BVHAcceleration.cpp).

Reference algorithm: recursive binary build, median split along the
longest centroid-extent axis, 1-primitive leaves with a 2-primitive
special case (BVHAcceleration.cpp:142-198); nodes carry cumulative
surface area for area-weighted light sampling (:200-232); traversal
prunes by slab AABB test and takes the nearer of both children
(:103-140).

Redesign — divergent pointer-chasing traversal is the wrong shape for
whole-array programs, so the BVH serves two roles here:

  1. `build_bvh` (host, NumPy): the reference's exact build, flattened
     to arrays. `leaf_order` extracts the DFS primitive order — spatially
     coherent, so consecutive triangles cluster tightly.
  2. `chunk_bounds` + the chunk-culling hook in ops/intersect.py: after
     reordering triangles into leaf order, every fixed-size chunk gets a
     tight AABB; a whole (ray-block x chunk) tile is SKIPPED when no ray
     in the block enters the chunk's box (`lax.cond` at scan-chunk
     granularity). This is a vectorized two-level BVH: the "top level"
     is the chunk grid, the "bottom level" is the brute-force masked
     min inside a chunk — no per-ray divergence anywhere.

`bvh_nearest_leaf` provides the classic per-ray stack traversal (under
`vmap` + `while_loop`) for parity testing and host-side queries.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np

import jax
import jax.numpy as jnp

# float32 dots on the GPU may otherwise run in TF32
_HI = jax.lax.Precision.HIGHEST


class FlatBVH(NamedTuple):
    """Flattened binary BVH (node 0 = root)."""

    bb_min: np.ndarray   # (M,3) f32
    bb_max: np.ndarray   # (M,3)
    left: np.ndarray     # (M,) i32 child index, -1 at leaves
    right: np.ndarray    # (M,) i32
    prim: np.ndarray     # (M,) i32 primitive index, -1 at internal nodes
    area: np.ndarray     # (M,) f32 cumulative primitive surface area


def primitive_bounds(v0, v1, v2) -> Tuple[np.ndarray, np.ndarray]:
    """Per-triangle AABBs (Bounds3 union of the three vertices)."""
    bb_min = np.minimum(np.minimum(v0, v1), v2).astype(np.float32)
    bb_max = np.maximum(np.maximum(v0, v1), v2).astype(np.float32)
    return bb_min, bb_max


def triangle_areas(v0, v1, v2) -> np.ndarray:
    """0.5*|e1 x e2| (Triangle.cpp:259-266)."""
    return 0.5 * np.linalg.norm(
        np.cross(v1 - v0, v2 - v0), axis=-1
    ).astype(np.float32)


def build_bvh(bb_min: np.ndarray, bb_max: np.ndarray, areas: np.ndarray,
              use_native: bool = True) -> FlatBVH:
    """Median-split build over primitive AABBs (BVHAcceleration.cpp:142-198:
    split axis = longest centroid extent, sort + halve, leaf = 1 prim,
    2-prim special case). Uses the C++ builder (native/srt_native.cpp)
    when available — bit-identical output, ~100x faster for large meshes."""
    if use_native and bb_min.shape[0] > 0:
        from software_rasterizer_tpu.utils.native import build_bvh_native

        out = build_bvh_native(
            np.asarray(bb_min, np.float32),
            np.asarray(bb_max, np.float32),
            np.asarray(areas, np.float32),
        )
        if out is not None:
            return FlatBVH(*out)
    n = bb_min.shape[0]
    if n == 0:
        z = np.zeros((1, 3), np.float32)
        return FlatBVH(z, z, np.full(1, -1, np.int32), np.full(1, -1, np.int32),
                       np.full(1, -1, np.int32), np.zeros(1, np.float32))
    centroids = (bb_min + bb_max) * 0.5

    nodes_min, nodes_max, left, right, prim, area = [], [], [], [], [], []

    def new_node():
        nodes_min.append(None); nodes_max.append(None)
        left.append(-1); right.append(-1); prim.append(-1); area.append(0.0)
        return len(left) - 1

    def build(idxs: np.ndarray) -> int:
        ni = new_node()
        if len(idxs) == 1:
            p = int(idxs[0])
            nodes_min[ni], nodes_max[ni] = bb_min[p], bb_max[p]
            prim[ni] = p
            area[ni] = float(areas[p])
            return ni
        if len(idxs) == 2:
            l = build(idxs[:1]); r = build(idxs[1:])
        else:
            c = centroids[idxs]
            axis = int(np.argmax(c.max(0) - c.min(0)))
            order = idxs[np.argsort(c[:, axis], kind="stable")]
            mid = len(order) // 2
            l = build(order[:mid]); r = build(order[mid:])
        left[ni], right[ni] = l, r
        nodes_min[ni] = np.minimum(nodes_min[l], nodes_min[r])
        nodes_max[ni] = np.maximum(nodes_max[l], nodes_max[r])
        area[ni] = area[l] + area[r]
        return ni

    import sys

    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 4 * n + 100))
    try:
        build(np.arange(n))
    finally:
        sys.setrecursionlimit(old)

    return FlatBVH(
        np.asarray(nodes_min, np.float32),
        np.asarray(nodes_max, np.float32),
        np.asarray(left, np.int32),
        np.asarray(right, np.int32),
        np.asarray(prim, np.int32),
        np.asarray(area, np.float32),
    )


def leaf_order(bvh: FlatBVH) -> np.ndarray:
    """DFS left-to-right primitive order — the spatial-coherence
    permutation used to reorder triangles before chunking."""
    out, stack = [], [0]
    while stack:
        ni = stack.pop()
        if bvh.prim[ni] >= 0:
            out.append(bvh.prim[ni])
        else:
            stack.append(int(bvh.right[ni]))
            stack.append(int(bvh.left[ni]))
    return np.asarray(out, np.int64)


def chunk_bounds(v0, v1, v2, valid, chunk: int):
    """Per-chunk AABBs over (leaf-ordered) triangles. Arrays (F,3) with F
    a multiple of `chunk`; invalid (padding) triangles are excluded.
    Returns (nc,3) mins and maxs (degenerate +inf/-inf for empty chunks,
    which the slab test rejects)."""
    f = v0.shape[0]
    nc = f // chunk
    m3 = valid[:, None]
    lo = np.where(m3, np.minimum(np.minimum(v0, v1), v2), np.inf)
    hi = np.where(m3, np.maximum(np.maximum(v0, v1), v2), -np.inf)
    return (
        lo.reshape(nc, chunk, 3).min(1).astype(np.float32),
        hi.reshape(nc, chunk, 3).max(1).astype(np.float32),
    )


def slab_test(orig, d, bb_min, bb_max):
    """Vectorized Bounds3::intersect slab test (Bounds3.cpp:31-80):
    conservative ray-AABB overlap for rays (N,3) x boxes (B,3).
    Returns (N,B) bool (t_exit >= max(t_enter, 0))."""
    inv = 1.0 / jnp.where(d == 0.0, 1e-30, d)          # (N,3)
    t0 = (bb_min[None] - orig[:, None]) * inv[:, None]  # (N,B,3)
    t1 = (bb_max[None] - orig[:, None]) * inv[:, None]
    tmin = jnp.minimum(t0, t1).max(-1)
    tmax = jnp.maximum(t0, t1).min(-1)
    return tmax >= jnp.maximum(tmin, 0.0)


def bvh_nearest_leaf(bvh_dev, orig, d, max_depth: int = 64):
    """Per-ray stack traversal returning candidate-leaf pruning parity
    with the reference's recursive walk: the nearest primitive index is
    resolved by intersecting the primitive at every visited leaf — here
    we return, per ray, the visitation-masked leaf set folded to the
    minimum slab-entry leaf (used by parity tests; production tracing
    uses the chunked path in ops/intersect.py).

    bvh_dev: FlatBVH as device arrays. Returns (N,) i32 primitive index
    of the nearest-AABB leaf (-1 if the root is missed).
    """
    bb_min, bb_max = bvh_dev.bb_min, bvh_dev.bb_max
    left, right, prim = bvh_dev.left, bvh_dev.right, bvh_dev.prim

    def one(o, dd):
        inv = 1.0 / jnp.where(dd == 0.0, 1e-30, dd)

        def node_t(ni):
            t0 = (bb_min[ni] - o) * inv
            t1 = (bb_max[ni] - o) * inv
            tmin = jnp.minimum(t0, t1).max()
            tmax = jnp.maximum(t0, t1).min()
            hit = tmax >= jnp.maximum(tmin, 0.0)
            return jnp.where(hit, jnp.maximum(tmin, 0.0), jnp.inf)

        stack = jnp.full((max_depth,), -1, jnp.int32).at[0].set(0)

        def cond(s):
            _, _, sp, _ = s
            return sp > 0

        def body(s):
            best_t, best_p, sp, stack = s
            sp = sp - 1
            ni = stack[sp]
            t = node_t(ni)
            is_leaf = prim[ni] >= 0
            use = (t < best_t) & (t < jnp.inf)
            best_t = jnp.where(is_leaf & use, t, best_t)
            best_p = jnp.where(is_leaf & use, prim[ni], best_p)
            push = use & ~is_leaf
            stack = stack.at[sp].set(jnp.where(push, right[ni], -1))
            sp1 = jnp.where(push, sp + 1, sp)
            stack = stack.at[sp1].set(jnp.where(push, left[ni], stack[sp1]))
            sp2 = jnp.where(push, sp1 + 1, sp1)
            return best_t, best_p, sp2, stack

        best_t, best_p, _, _ = jax.lax.while_loop(
            cond, body, (jnp.inf, jnp.int32(-1), jnp.int32(1), stack)
        )
        return best_p

    return jax.vmap(one)(orig, d)


def bvh_sample_area(bvh_dev, u):
    """BVHAcceleration::sample cumulative-area descend
    (BVHAcceleration.cpp:200-232): target = u * root.area; internal nodes
    branch left when target < left.area, else subtract left.area and go
    right — selecting each leaf with probability leaf_area / root_area.

    bvh_dev: FlatBVH as device arrays; u: (N,) uniforms in [0,1).
    Returns (prim (N,) i32, pdf (N,) f32) where pdf is the reference's
    composed value: obj_pdf(=1/leaf_area) * leaf_area / root_area =
    1/root_area (the cancellation the reference computes explicitly).
    """
    left, right, prim, area = (
        bvh_dev.left, bvh_dev.right, bvh_dev.prim, bvh_dev.area,
    )

    def one(ui):
        target = ui * area[0]

        def cond(s):
            ni, _ = s
            return prim[ni] < 0

        def body(s):
            ni, tgt = s
            l, r = left[ni], right[ni]
            la = area[l]
            go_left = tgt < la
            return (
                jnp.where(go_left, l, r),
                jnp.where(go_left, tgt, tgt - la),
            )

        ni, _ = jax.lax.while_loop(cond, body, (jnp.int32(0), target))
        return prim[ni]

    prims = jax.vmap(one)(u)
    pdf = jnp.where(area[0] > 0, 1.0 / jnp.maximum(area[0], 1e-30), 0.0)
    return prims, jnp.full(u.shape, pdf)


def bvh_nearest_hit(bvh_dev, v0, v1, v2, orig, d, max_depth: int = 64):
    """TRUE per-ray nearest-hit traversal (BVHAcceleration::intersection,
    BVHAcceleration.cpp:103-140): at every visited LEAF the primitive is
    intersected (Moller-Trumbore, reference thresholds |det|>=1e-6,
    t>=1e-6) and the best hit is kept; subtrees are pruned by the slab
    test AND by the running best-t (strictly tighter than the reference's
    prune, identical result set). Exact vs the brute-force sweep — see
    tests/test_bvh.py.

    v0/v1/v2: (F,3) triangle vertices in bvh primitive order ("prim"
    indexes into these). Returns (t (N,), prim (N,) i32; -1/BIG on miss).
    """
    bb_min, bb_max = bvh_dev.bb_min, bvh_dev.bb_max
    left, right, prim = bvh_dev.left, bvh_dev.right, bvh_dev.prim
    BIGF = jnp.float32(1e30)

    def one(o, dd):
        inv = 1.0 / jnp.where(dd == 0.0, 1e-30, dd)

        def node_entry(ni):
            t0 = (bb_min[ni] - o) * inv
            t1 = (bb_max[ni] - o) * inv
            tmin = jnp.minimum(t0, t1).max()
            tmax = jnp.maximum(t0, t1).min()
            hit = tmax >= jnp.maximum(tmin, 0.0)
            return jnp.where(hit, jnp.maximum(tmin, 0.0), BIGF)

        def mt(p):
            e1 = v1[p] - v0[p]
            e2 = v2[p] - v0[p]
            pv = jnp.cross(dd, e2)
            det = jnp.dot(e1, pv, precision=_HI)
            invd = 1.0 / jnp.where(jnp.abs(det) < 1e-6, 1.0, det)
            tv = o - v0[p]
            uu = jnp.dot(tv, pv, precision=_HI) * invd
            qv = jnp.cross(tv, e1)
            vv = jnp.dot(dd, qv, precision=_HI) * invd
            tt = jnp.dot(e2, qv, precision=_HI) * invd
            ok = (
                (jnp.abs(det) >= 1e-6)
                & (uu >= 0.0) & (uu <= 1.0)
                & (vv >= 0.0) & (uu + vv <= 1.0)
                & (tt >= 1e-6)
            )
            return jnp.where(ok, tt, BIGF)

        stack = jnp.full((max_depth,), -1, jnp.int32).at[0].set(0)

        def cond(s):
            _, _, sp, _ = s
            return sp > 0

        def body(s):
            best_t, best_p, sp, stack = s
            sp = sp - 1
            ni = stack[sp]
            entry = node_entry(ni)
            visit = entry < best_t
            is_leaf = prim[ni] >= 0
            # leaf: intersect the primitive
            t_leaf = jax.lax.cond(
                visit & is_leaf, lambda: mt(prim[ni]), lambda: BIGF
            )
            better = t_leaf < best_t
            best_t = jnp.where(better, t_leaf, best_t)
            best_p = jnp.where(better, prim[ni], best_p)
            # internal: push children
            push = visit & ~is_leaf
            stack = stack.at[sp].set(jnp.where(push, right[ni], -1))
            sp1 = jnp.where(push, sp + 1, sp)
            stack = stack.at[sp1].set(jnp.where(push, left[ni], stack[sp1]))
            sp2 = jnp.where(push, sp1 + 1, sp1)
            return best_t, best_p, sp2, stack

        best_t, best_p, _, _ = jax.lax.while_loop(
            cond, body, (BIGF, jnp.int32(-1), jnp.int32(1), stack)
        )
        return best_t, jnp.where(best_t < BIGF, best_p, -1)

    return jax.vmap(one)(orig, d)
