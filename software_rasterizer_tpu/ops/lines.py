"""Wireframe / line rasterization (reference: Bresenham drawLine,
Render.cpp:112-186; rasterizeWireframe edge colors, Rasterizer.cpp:4-9).

Array formulation: instead of the sequential Bresenham walk, each
edge is sampled at S = max(H, W) parametric points and scattered — every
pixel Bresenham would touch is hit (sampling density >= 1 px per step),
which reproduces the same stroked lines without a data-dependent loop.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from software_rasterizer_tpu.ops.raster import raster_vertex_stage


@functools.partial(jax.jit, static_argnames=("height", "width"))
def draw_lines(p0, p1, colors, valid, height: int, width: int):
    """Scatter line segments into an (H,W,3) image.

    p0/p1: (E,3) screen-space endpoints; colors: (E,3); valid: (E,).
    Returns (image, zbuf) with z from linear interpolation along the edge.
    """
    s = max(height, width)
    t = jnp.linspace(0.0, 1.0, s, dtype=jnp.float32)[None, :, None]  # (1,S,1)
    pts = p0[:, None, :] * (1.0 - t) + p1[:, None, :] * t            # (E,S,3)
    xi = jnp.round(pts[..., 0]).astype(jnp.int32)
    yi = jnp.round(pts[..., 1]).astype(jnp.int32)
    zz = pts[..., 2]
    ok = (
        valid[:, None]
        & (xi >= 0) & (xi < width)
        & (yi >= 0) & (yi < height)
    )
    flat = jnp.where(ok, yi * width + xi, height * width)  # clip bucket
    col = jnp.broadcast_to(colors[:, None, :], pts.shape)

    img = jnp.zeros((height * width + 1, 3), jnp.float32)
    img = img.at[flat.reshape(-1)].set(col.reshape(-1, 3), mode="drop")
    zb = jnp.full((height * width + 1,), jnp.inf, jnp.float32)
    zb = zb.at[flat.reshape(-1)].min(
        jnp.where(ok, zz, jnp.inf).reshape(-1), mode="drop"
    )
    return (
        img[:-1].reshape(height, width, 3),
        zb[:-1].reshape(height, width),
    )


@functools.partial(jax.jit, static_argnames=("height", "width"))
def rasterize_wireframe(geom, frame, height: int, width: int):
    """LINES primitive for a scene: all triangle edges, colored by vertex
    color per edge (Rasterizer.cpp:4-9 passes m_color[k] per edge)."""
    pos, _ = raster_vertex_stage(
        geom.positions, geom.normals, geom.vertex_mesh,
        frame.ndc_mvp, frame.normal_mat, frame.z_scale, frame.z_offset,
    )
    tri = pos[geom.faces]          # (F,3,3)
    col = geom.colors[geom.faces]  # (F,3,3)
    # edges: (b,a), (b,c), (a,c) with colors m_color[0..2]
    p0 = jnp.concatenate([tri[:, 1], tri[:, 1], tri[:, 0]])
    p1 = jnp.concatenate([tri[:, 0], tri[:, 2], tri[:, 2]])
    c = jnp.concatenate([col[:, 0], col[:, 1], col[:, 2]])
    v = jnp.concatenate([geom.face_valid] * 3)
    return draw_lines(p0, p1, c, v, height, width)
