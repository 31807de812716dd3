"""Triangle rasterization as deterministic array programs.

Reference behavior (src/Rasterizer.cpp): screen-space bbox scan, 8-wide
barycentric inside-test with strict (0,1) bounds, z-buffer `<` test,
interpolate N/uv/color, shade, masked write-back. The reference
parallelizes rows with TBB and pixels with AVX2 and resolves the z-buffer
with read-modify-write races per row.

Redesign (SURVEY.md 7.1):
  * barycentric coordinates are AFFINE in (x, y): each triangle
    contributes two rows of a (3 -> 2F) linear map, evaluated for a
    whole pixel tile as exact float32 broadcast FMAs;
  * interpolated depth is likewise affine in (x, y);
  * the z-buffer becomes a deterministic per-pixel argmin over candidate
    fragments (no write races, device-count invariant);
  * shading is DEFERRED: only the winning fragment per pixel is shaded
    (the reference shades every fragment that passes the z test).

The pixel grid is tiled (tile_h, tile_w) and triangles stream through in
chunks under `lax.scan`, carrying the running (best_z, best_index).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from software_rasterizer_tpu.ops import shading as sh

INF = jnp.float32(jnp.inf)


def hom_transform(mats, points):
    """Per-point 4x4 transform with perspective divide.

    mats: (N,4,4) already gathered per point; points: (N,3) -> (N,3).
    """
    # HIGHEST: a float32 product may otherwise run in TF32 on the GPU,
    # which would move every post-projective vertex both pipelines use
    h = jnp.einsum("nij,nj->ni", mats[:, :, :3], points,
                   precision=jax.lax.Precision.HIGHEST) + mats[:, :, 3]
    return h[:, :3] / h[:, 3:4]


def raster_vertex_stage(positions, normals, vertex_mesh, ndc_mvp, normal_mat, z_scale, z_offset):
    """Scene::loadTriangleStream vertex math (Scene.cpp:937-947) on device:
    NDC*P*V*M with divide, z remap, transpose(inverse(M)) normals with the
    vec4(n,1)/w quirk. Returns (positions', normals')."""
    m = ndc_mvp[vertex_mesh]            # (V,4,4)
    pos = hom_transform(m, positions)
    pos = pos.at[:, 2].set(pos[:, 2] * z_scale + z_offset)
    nm = normal_mat[vertex_mesh]
    nrm = hom_transform(nm, normals)
    return pos, nrm


def triangle_setup(tri_xy: jnp.ndarray, tri_z: jnp.ndarray):
    """Per-triangle affine coefficients.

    tri_xy: (F,3,2) screen xy; tri_z: (F,3).
    Returns (coef, zrow): coef (F,2,3) with rows alpha,beta as affine
    functions of (x,y,1); zrow (F,3) affine depth. Degenerate triangles
    (zero area) produce inf/nan coefficients which the strict (0,1)
    inside test rejects naturally.
    """
    ax, ay = tri_xy[:, 0, 0], tri_xy[:, 0, 1]
    bx, by = tri_xy[:, 1, 0], tri_xy[:, 1, 1]
    cx, cy = tri_xy[:, 2, 0], tri_xy[:, 2, 1]
    # areaABC = AB x AC (Rasterizer.cpp:61)
    d = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)
    inv_d = 1.0 / d
    # alpha = areaPBC/areaABC, expanded to affine form in (x, y, 1)
    row_a = jnp.stack([(by - cy), (cx - bx), bx * cy - cx * by], axis=-1) * inv_d[:, None]
    row_b = jnp.stack([(cy - ay), (ax - cx), cx * ay - ax * cy], axis=-1) * inv_d[:, None]
    coef = jnp.stack([row_a, row_b], axis=1)  # (F,2,3)
    row_g = -row_a - row_b + jnp.array([0.0, 0.0, 1.0], coef.dtype)
    zrow = (
        tri_z[:, 0:1] * row_a + tri_z[:, 1:2] * row_b + tri_z[:, 2:3] * row_g
    )  # (F,3)
    return coef, zrow


def _tile_pixels(ty, tx, tile_h, tile_w, dtype=jnp.float32, row0=0):
    """Pixel coordinate block (P,3) of (x, y, 1) for tile (ty,tx).

    Reference quirk: fragments are sampled at INTEGER pixel coords, not
    centers (Rasterizer.cpp:285-287). `row0` offsets y to ABSOLUTE
    screen rows (framebuffer row-sharding: every per-pixel f32 op sees
    the same operands as the monolithic render, so shards are
    bit-exact)."""
    yy = (
        jax.lax.broadcasted_iota(jnp.int32, (tile_h, tile_w), 0)
        + ty * tile_h + row0
    )
    xx = jax.lax.broadcasted_iota(jnp.int32, (tile_h, tile_w), 1) + tx * tile_w
    px = jnp.stack(
        [xx.astype(dtype), yy.astype(dtype), jnp.ones((tile_h, tile_w), dtype)],
        axis=-1,
    )
    return px.reshape(-1, 3)


def rasterize_tiles(
    coef: jnp.ndarray,
    zrow: jnp.ndarray,
    keep: jnp.ndarray,
    height: int,
    width: int,
    tile: Tuple[int, int] = (128, 128),
    chunk: int = 512,
    tri_bbox: jnp.ndarray = None,
    row0=0,
):
    """Deterministic min-z coverage resolve.

    coef: (F,2,3), zrow: (F,3), keep: (F,) bool (valid & front-facing).
    Returns best_idx (H,W) i32 (-1 where uncovered), best_z (H,W) f32.
    F must be a multiple of `chunk` (pad with keep=False). `row0`
    (traced scalar ok) renders rows [row0, row0+height) of the absolute
    screen — the framebuffer-sharding hook.

    Depth resolve: per chunk, two single-op min-reduces (min z, then the
    lowest lane among equal-z slots) — exact and far cheaper than one
    variadic (min, argmin) reduce.
    """
    f = coef.shape[0]
    chunk = min(chunk, f)
    if f % chunk:
        pad = chunk - f % chunk
        coef = jnp.pad(coef, ((0, pad), (0, 0), (0, 0)))
        zrow = jnp.pad(zrow, ((0, pad), (0, 0)))
        keep = jnp.pad(keep, (0, pad))
        if tri_bbox is not None:
            tri_bbox = jnp.pad(tri_bbox, ((0, pad), (0, 0)))
        f += pad
    n_chunks = f // chunk
    cull = tri_bbox is not None and n_chunks > 1
    if cull:
        # per-chunk screen bbox over kept triangles (the raster analog of
        # ops/bvh.py chunk culling: one scalar overlap test skips a whole
        # (tile x chunk) block)
        kb = keep[:, None]
        blo = jnp.where(kb, tri_bbox[:, 0:2], jnp.inf).reshape(n_chunks, chunk, 2).min(1)
        bhi = jnp.where(kb, tri_bbox[:, 2:4], -jnp.inf).reshape(n_chunks, chunk, 2).max(1)
    tile_h, tile_w = tile
    gh = -(-height // tile_h)
    gw = -(-width // tile_w)
    p = tile_h * tile_w

    # (3,F,2) matmul operand: column pairs are [alpha_t, beta_t]
    ab_mat = coef.transpose(2, 0, 1)                      # (3,F,2)
    z_mat = zrow.T                                        # (3,F)
    neg_inf_z = jnp.where(keep, 0.0, INF)                 # additive kill

    row0_i = jnp.asarray(row0, jnp.int32)

    def tile_fn(tidx):
        ty, tx = tidx // gw, tidx % gw
        px = _tile_pixels(ty, tx, tile_h, tile_w, row0=row0_i)  # (P,3)

        px_x = px[:, 0:1]                                 # (P,1)
        px_y = px[:, 1:2]

        def chunk_compute(carry, sl):
            best_z, best_i = carry
            ab = jax.lax.dynamic_slice(ab_mat, (0, sl, 0), (3, chunk, 2))
            zc = jax.lax.dynamic_slice(z_mat, (0, sl), (3, chunk))
            kz = jax.lax.dynamic_slice(neg_inf_z, (sl,), (chunk,))
            # K=3 affine evals as exact f32 broadcast FMAs ((P,1) x
            # (1,C) planes). A matrix-unit product here would be mostly
            # idle at K=3, and a reduced-precision pass (bf16 or TF32)
            # would quantize z at the reference z-remap offset ~90,
            # destroying fine depth separation.
            alpha = px_x * ab[0, :, 0][None] + px_y * ab[1, :, 0][None] + ab[2, :, 0][None]
            beta = px_x * ab[0, :, 1][None] + px_y * ab[1, :, 1][None] + ab[2, :, 1][None]
            gamma = 1.0 - alpha - beta
            inside = (
                (alpha > 0) & (alpha < 1)
                & (beta > 0) & (beta < 1)
                & (gamma > 0) & (gamma < 1)
            )
            z = px_x * zc[0][None] + px_y * zc[1][None] + zc[2][None] + kz[None, :]
            score = jnp.where(inside, z, INF)
            # barrier: both reduces must read the SAME score values (XLA
            # may otherwise recompute the producer chain per consumer
            # with different fusions, breaking the equality match)
            score = jax.lax.optimization_barrier(score)
            # exact two-pass resolve: min z, then min lane among equal-z
            # slots (single-op reduces; a variadic (min, argmin) costs
            # ~30x, and truncated-key packing loses depth resolution)
            c_best = jnp.min(score, axis=1)
            lane = jax.lax.broadcasted_iota(jnp.int32, score.shape, 1)
            c_arg = jnp.min(
                jnp.where(score == c_best[:, None], lane, jnp.int32(0x7FFFFFFF)),
                axis=1,
            ) + sl
            better = c_best < best_z                      # strict `<` z test
            best_z = jnp.where(better, c_best, best_z)
            best_i = jnp.where(better, c_arg, best_i)
            return (best_z, best_i)

        tx0 = (tx * tile_w).astype(jnp.float32)
        ty0 = (ty * tile_h + row0_i).astype(jnp.float32)

        def chunk_body(carry, ci):
            sl = ci * chunk
            if cull:
                overlap = (
                    (blo[ci, 0] <= tx0 + (tile_w - 1))
                    & (blo[ci, 1] <= ty0 + (tile_h - 1))
                    & (bhi[ci, 0] >= tx0)
                    & (bhi[ci, 1] >= ty0)
                )
                carry = jax.lax.cond(
                    overlap, lambda c: chunk_compute(c, sl), lambda c: c, carry
                )
            else:
                carry = chunk_compute(carry, sl)
            return carry, None

        init = (jnp.full((p,), INF), jnp.full((p,), -1, jnp.int32))
        (best_z, best_i), _ = jax.lax.scan(
            chunk_body, init, jnp.arange(n_chunks, dtype=jnp.int32)
        )
        best_i = jnp.where(best_z < INF, best_i, -1)
        return best_z.reshape(tile_h, tile_w), best_i.reshape(tile_h, tile_w)

    bz, bi = jax.lax.map(tile_fn, jnp.arange(gh * gw, dtype=jnp.int32))
    bz = bz.reshape(gh, gw, tile_h, tile_w).transpose(0, 2, 1, 3).reshape(gh * tile_h, gw * tile_w)
    bi = bi.reshape(gh, gw, tile_h, tile_w).transpose(0, 2, 1, 3).reshape(gh * tile_h, gw * tile_w)
    return bi[:height, :width], bz[:height, :width]


def interpolate_fragments(best_idx, coef, tri_attrs):
    """Recompute barycentrics for the winning triangle per pixel and
    interpolate vertex attributes.

    tri_attrs: dict name -> (F,3,K) per-corner attributes.
    Returns dict name -> (H,W,K), plus (alpha,beta,gamma).
    """
    h, w = best_idx.shape
    t = jnp.maximum(best_idx, 0)
    yy = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0).astype(jnp.float32)
    xx = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1).astype(jnp.float32)
    c = coef[t]  # (H,W,2,3)
    alpha = c[..., 0, 0] * xx + c[..., 0, 1] * yy + c[..., 0, 2]
    beta = c[..., 1, 0] * xx + c[..., 1, 1] * yy + c[..., 1, 2]
    gamma = 1.0 - alpha - beta
    out = {}
    for name, a in tri_attrs.items():
        av = a[t]  # (H,W,3,K)
        out[name] = (
            alpha[..., None] * av[..., 0, :]
            + beta[..., None] * av[..., 1, :]
            + gamma[..., None] * av[..., 2, :]
        )
    return out, (alpha, beta, gamma)


def face_cull_mask(tri_pos, eye, face_valid):
    """Backface cull: skip when dot(geometric_normal, eye) > 0
    (Rasterizer.cpp:203; getFaceNormal PerGeometry, Triangle.cpp:148-150)."""
    e1 = tri_pos[:, 1] - tri_pos[:, 0]
    e2 = tri_pos[:, 2] - tri_pos[:, 0]
    fn = jnp.cross(e1, e2)
    fn = fn / jnp.maximum(jnp.linalg.norm(fn, axis=-1, keepdims=True), 1e-20)
    return face_valid & (jnp.sum(fn * eye, axis=-1) <= 0)


@functools.partial(
    jax.jit,
    static_argnames=("height", "width", "tile", "chunk", "cull",
                     "active_types"),
)
def render_raster_frame(
    geom,
    frame,
    height: int,
    width: int,
    tile: Tuple[int, int] = (128, 128),
    chunk: int = 512,
    cull: bool = True,
    active_types=None,
    row0=0,
):
    """Full raster pipeline: vertex stage -> coverage/z resolve -> deferred
    fragment shading. Returns (image (H,W,3) f32 in [0,1] pre-clamp, zbuf).

    `row0` (traced scalar ok) renders the absolute screen rows
    [row0, row0+height): every per-pixel op sees the same f32 operands
    as the monolithic frame, so a row-sharded render reassembles
    BIT-EXACTLY (parallel/render.sharded_raster_render; the
    analog of the reference's TBB row partitioning,
    Rasterizer.cpp:217-236).

    geom: models.scene.RasterGeometry; frame: models.scene.RasterFrame.
    `active_types`: static tuple of the ShaderType values used by the
    scene's meshes (pass from the host; None evaluates all five).

    Per-pixel winner attributes come from ONE row-gather of a packed
    (F, 32) fragment table (coef + per-corner normal/uv/color + shader
    and texture ids) instead of a dozen per-column gathers.
    """
    pos, nrm = raster_vertex_stage(
        geom.positions, geom.normals, geom.vertex_mesh,
        frame.ndc_mvp, frame.normal_mat, frame.z_scale, frame.z_offset,
    )
    tri_pos = pos[geom.faces]      # (F,3,3)
    tri_nrm = nrm[geom.faces]
    tri_uv = geom.uvs[geom.faces]
    tri_col = geom.colors[geom.faces]
    f = tri_pos.shape[0]

    keep = face_cull_mask(tri_pos, frame.eye, geom.face_valid) if cull else geom.face_valid
    coef, zrow = triangle_setup(tri_pos[..., :2], tri_pos[..., 2])
    xy = tri_pos[..., :2]
    tri_bbox = jnp.concatenate([xy.min(axis=1), xy.max(axis=1)], axis=1)  # (F,4)
    shader_type_f = geom.shader_type[geom.face_mesh].astype(jnp.float32)
    tex_id_f = geom.tex_id[geom.face_mesh].astype(jnp.float32)

    row0_i = jnp.asarray(row0, jnp.int32)
    yy = (
        row0_i + jax.lax.broadcasted_iota(jnp.int32, (height, width), 0)
    ).astype(jnp.float32)
    xx = jax.lax.broadcasted_iota(jnp.int32, (height, width), 1).astype(jnp.float32)

    best_idx, best_z = rasterize_tiles(
        coef, zrow, keep, height, width, tile, chunk, tri_bbox,
        row0=row0_i,
    )
    covered = best_idx >= 0

    frag_table = jnp.concatenate([
        coef.reshape(f, 6),                       # 0:6   alpha/beta rows
        tri_nrm.reshape(f, 9),                    # 6:15  per-corner normals
        tri_uv.reshape(f, 6),                     # 15:21 per-corner uvs
        tri_col.reshape(f, 9),                    # 21:30 per-corner colors
        shader_type_f[:, None],                   # 30
        tex_id_f[:, None],                        # 31
    ], axis=1)                                    # (F, 32)

    rows = frag_table[jnp.maximum(best_idx, 0)]   # (H,W,32) one row-gather
    c = rows[..., 0:6].reshape(height, width, 2, 3)
    alpha = c[..., 0, 0] * xx + c[..., 0, 1] * yy + c[..., 0, 2]
    beta = c[..., 1, 0] * xx + c[..., 1, 1] * yy + c[..., 1, 2]
    gamma = 1.0 - alpha - beta

    def interp(sl, k):
        av = rows[..., sl].reshape(height, width, 3, k)
        return (
            alpha[..., None] * av[..., 0, :]
            + beta[..., None] * av[..., 1, :]
            + gamma[..., None] * av[..., 2, :]
        )

    normal = interp(slice(6, 15), 3)
    uv = interp(slice(15, 21), 2)
    color = interp(slice(21, 30), 3)
    shader_type = jnp.round(rows[..., 30]).astype(jnp.int32)
    tex_id = jnp.round(rows[..., 31]).astype(jnp.int32)

    position = jnp.stack([xx, yy, best_z], axis=-1)
    rgb = sh.shade_fragments(
        shader_type,
        frame.eye,
        position,
        normal,
        uv,
        color,
        tex_id,
        geom.textures,
        geom.tex_wh,
        frame.light_pos,
        frame.light_int,
        active_types=active_types,
    )
    image = jnp.where(covered[..., None], rgb, 0.0)
    zbuf = jnp.where(covered, best_z, INF)
    return image, zbuf


@functools.partial(jax.jit, static_argnames=("height", "width", "tile", "chunk"))
def render_colored_triangles(
    tri_pos, tri_col, face_valid, height: int, width: int,
    tile: Tuple[int, int] = (128, 128), chunk: int = 128,
):
    """Raw-coordinates demo path (README 0x02): screen-space triangles with
    interpolated vertex colors and a z-buffer, no lighting.

    tri_pos: (F,3,3) screen xyz; tri_col: (F,3,3).
    """
    coef, zrow = triangle_setup(tri_pos[..., :2], tri_pos[..., 2])
    best_idx, best_z = rasterize_tiles(coef, zrow, face_valid, height, width, tile, chunk)
    covered = best_idx >= 0
    attrs, _ = interpolate_fragments(best_idx, coef, {"color": tri_col})
    image = jnp.where(covered[..., None], attrs["color"], 0.0)
    return image, jnp.where(covered, best_z, INF)
