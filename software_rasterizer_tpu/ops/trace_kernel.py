"""Chunk-culled nearest-triangle trace as one Pallas kernel (Triton route).

The winner search every ray integrator runs (reference:
BVHAcceleration::intersection + Triangle Moller-Trumbore,
Triangle.cpp:104-145) over BVH-leaf-ordered triangles:

  * one program per block of `block` rays, each ray held in registers;
  * an in-kernel loop over fixed-size triangle chunks; per chunk one
    scalar AABB (its ops/bvh.slab_test) against the whole ray block —
    a chunk no ray of the block enters is skipped, which is what makes
    scenes of 10^5+ triangles cheap for coherent ray blocks;
  * inside a visited chunk, a scalar loop over triangles whose rows
    ([v0 | e1 | e2], 9 floats) are broadcast loads served by L1/L2,
    evaluated with the same float32 Moller-Trumbore formula as
    ops/intersect._mt_chunk on the CUDA cores (no tensor-core product:
    TF32 could not keep the winner exact).

Returns the same (hit, idx, t) as ops/intersect._intersect_tri_raw:
the nearest t, ties resolved to the lowest triangle index.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

BIG = 1e30
TRACE_CHUNK = 64    # triangles per cull chunk
TRACE_BLOCK = 128   # rays per program (one ray per thread at 4 warps)


def chunk_bounds(v0, v1, v2, valid, chunk: int):
    """Per-chunk AABBs over BVH-leaf-ordered triangles. Returns (lo (nc,3),
    hi (nc,3)); invalid rows contribute nothing (an all-invalid chunk gets
    an inverted box that fails every slab test)."""
    f = v0.shape[0]
    pad = (-f) % chunk
    if pad:
        v0, v1, v2 = (jnp.pad(a, ((0, pad), (0, 0))) for a in (v0, v1, v2))
        valid = jnp.pad(valid, (0, pad))
    nc = (f + pad) // chunk
    m = valid[:, None]
    lo = jnp.where(m, jnp.minimum(jnp.minimum(v0, v1), v2), BIG)
    hi = jnp.where(m, jnp.maximum(jnp.maximum(v0, v1), v2), -BIG)
    return lo.reshape(nc, chunk, 3).min(1), hi.reshape(nc, chunk, 3).max(1)


def edge_rows(v0, v1, v2, valid):
    """(F, 9) [v0 | e1 | e2] rows; invalid triangles are all-zero rows,
    whose det = 0 fails the |det| >= 1e-6 test without a mask input."""
    rows = jnp.concatenate([v0, v1 - v0, v2 - v0], axis=1)
    return jnp.where(valid[:, None], rows, 0.0)


def _trace_kernel(ox_ref, oy_ref, oz_ref, dx_ref, dy_ref, dz_ref, tri_ref,
                  box_ref, t_ref, i_ref, *, chunk: int, n_chunks: int):
    ox, oy, oz = ox_ref[...], oy_ref[...], oz_ref[...]
    dx, dy, dz = dx_ref[...], dy_ref[...], dz_ref[...]
    # slab-test reciprocals (ops/bvh.slab_test)
    ix = 1.0 / jnp.where(dx == 0.0, 1e-30, dx)
    iy = 1.0 / jnp.where(dy == 0.0, 1e-30, dy)
    iz = 1.0 / jnp.where(dz == 0.0, 1e-30, dz)

    def tri_step(k, carry):
        bt, bi = carry
        r = k * 9
        v0x, v0y, v0z = tri_ref[r], tri_ref[r + 1], tri_ref[r + 2]
        e1x, e1y, e1z = tri_ref[r + 3], tri_ref[r + 4], tri_ref[r + 5]
        e2x, e2y, e2z = tri_ref[r + 6], tri_ref[r + 7], tri_ref[r + 8]
        # ops/intersect._mt_chunk, term for term
        px = dy * e2z - dz * e2y
        py = dz * e2x - dx * e2z
        pz = dx * e2y - dy * e2x
        det = e1x * px + e1y * py + e1z * pz
        inv = 1.0 / jnp.where(jnp.abs(det) < 1e-6, 1.0, det)
        tx, ty, tz = ox - v0x, oy - v0y, oz - v0z
        u = (tx * px + ty * py + tz * pz) * inv
        qx = ty * e1z - tz * e1y
        qy = tz * e1x - tx * e1z
        qz = tx * e1y - ty * e1x
        v = (dx * qx + dy * qy + dz * qz) * inv
        t = (e2x * qx + e2y * qy + e2z * qz) * inv
        ok = ((jnp.abs(det) >= 1e-6) & (u >= 0.0) & (u <= 1.0)
              & (v >= 0.0) & (u + v <= 1.0) & (t >= 1e-6))
        better = ok & (t < bt)   # strict: ties keep the lower index
        return jnp.where(better, t, bt), jnp.where(better, k, bi)

    def chunk_step(c, carry):
        b = c * 6
        t0x, t1x = (box_ref[b] - ox) * ix, (box_ref[b + 3] - ox) * ix
        t0y, t1y = (box_ref[b + 1] - oy) * iy, (box_ref[b + 4] - oy) * iy
        t0z, t1z = (box_ref[b + 2] - oz) * iz, (box_ref[b + 5] - oz) * iz
        tmin = jnp.maximum(jnp.maximum(jnp.minimum(t0x, t1x),
                                       jnp.minimum(t0y, t1y)),
                           jnp.minimum(t0z, t1z))
        tmax = jnp.minimum(jnp.minimum(jnp.maximum(t0x, t1x),
                                       jnp.maximum(t0y, t1y)),
                           jnp.maximum(t0z, t1z))
        enters = jnp.max((tmax >= jnp.maximum(tmin, 0.0)).astype(jnp.int32))
        start = c * chunk
        stop = jnp.where(enters > 0, start + chunk, start)
        return jax.lax.fori_loop(start, stop, tri_step, carry)

    init = (jnp.full(ox.shape, BIG, jnp.float32),
            jnp.full(ox.shape, -1, jnp.int32))
    bt, bi = jax.lax.fori_loop(0, n_chunks, chunk_step, init)
    t_ref[...] = bt
    i_ref[...] = bi


@functools.partial(jax.jit, static_argnames=("chunk", "block"))
def trace_nearest(edges, chunk_lo, chunk_hi, orig, d, chunk: int = TRACE_CHUNK,
                  block: int = TRACE_BLOCK):
    """Nearest triangle per ray. edges: (F, 9) from `edge_rows`; chunk_lo/hi:
    (ceil(F/chunk), 3) from `chunk_bounds` at the same `chunk`; orig/d:
    (N, 3). Returns (hit (N,) bool, idx (N,) i32 (-1 on miss), t (N,) f32
    (BIG on miss))."""
    n = orig.shape[0]
    n_chunks = chunk_lo.shape[0]
    pad_f = n_chunks * chunk - edges.shape[0]
    if pad_f:
        edges = jnp.pad(edges, ((0, pad_f), (0, 0)))
    pad_n = (-n) % block
    o = jnp.pad(orig, ((0, pad_n), (0, 0)))
    dd = jnp.pad(d, ((0, pad_n), (0, 0)), constant_values=1.0)
    box = jnp.concatenate([chunk_lo, chunk_hi], axis=1)
    ray_spec = pl.BlockSpec((block,), lambda i: (i,))
    whole = pl.BlockSpec()
    t, idx = pl.pallas_call(
        functools.partial(_trace_kernel, chunk=chunk, n_chunks=n_chunks),
        out_shape=(jax.ShapeDtypeStruct((n + pad_n,), jnp.float32),
                   jax.ShapeDtypeStruct((n + pad_n,), jnp.int32)),
        grid=((n + pad_n) // block,),
        in_specs=[ray_spec] * 6 + [whole, whole],
        out_specs=(ray_spec, ray_spec),
        compiler_params=pltriton.CompilerParams(num_warps=4, num_stages=1),
        name="trace_nearest",
    )(o[:, 0], o[:, 1], o[:, 2], dd[:, 0], dd[:, 1], dd[:, 2],
      edges.reshape(-1), box.reshape(-1))
    t, idx = t[:n], idx[:n]
    hit = t < BIG
    return hit, jnp.where(hit, idx, -1), t
