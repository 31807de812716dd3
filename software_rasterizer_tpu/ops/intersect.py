"""Ray-scene intersection (reference: Triangle.cpp:104-145 Moller-Trumbore,
Sphere.cpp:106-146 analytic quadratic, Scene.cpp:349-396 nearest-hit).

The reference's per-mesh BVH + TBB parallel_reduce over objects becomes
a masked min-reduction over ALL primitives, streamed in chunks (no
divergent traversal). Triangles arrive in BVH-leaf order, so a chunk's
AABB is tight and a whole (ray block x chunk) tile is skipped when no
ray of the block enters it. Two implementations of that sweep exist:
the plain-XLA `_intersect_tri_raw` and the Pallas kernel of
ops/trace_kernel.py; `_trace_backend` picks one by triangle count.

The scene arrives as an `RTScene` — transformed, SoA, device-resident —
built per frame by `prepare_rt_scene` (the analog of Scene::updatePosition,
Scene.cpp:882-901, minus the needless per-frame BVH rebuild).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from software_rasterizer_tpu.ops.raster import hom_transform
from software_rasterizer_tpu.ops.texture_ops import fetch_nearest
from software_rasterizer_tpu.ops.trace_kernel import (
    TRACE_CHUNK,
    chunk_bounds,
    edge_rows,
    trace_nearest,
)

BIG = jnp.float32(1e30)

# Padded triangle count from which a GPU trace runs the Pallas kernel
# instead of the XLA chunk sweep. Measured end to end on an H100
# (tools/trace_crossover.py, PERF.md): at 36 triangles (one sweep chunk)
# the kernel is 9% slower on path and 25% faster on whitted; from 5,120
# triangles up it wins both, by 1.3-1.7x on path and by 27x on whitted
# at 327,680. The threshold sits above one 512-triangle sweep chunk.
KERNEL_MIN_TRIS = 1024


def _trace_backend(f_pad: int) -> str:
    """"kernel" (ops/trace_kernel.trace_nearest) or "xla"
    (`_intersect_tri_raw`), by the static padded triangle count. Only a
    GPU runs the kernel; the CPU, used for tests, always sweeps in XLA."""
    if jax.default_backend() == "gpu" and f_pad >= KERNEL_MIN_TRIS:
        return "kernel"
    return "xla"


class RTScene(NamedTuple):
    """Device-resident transformed scene (post P*V*M, perspective-divided —
    the reference traces rays in this space, Triangle.cpp:215-231)."""

    v0: jnp.ndarray        # (F,3)
    v1: jnp.ndarray        # (F,3)
    v2: jnp.ndarray        # (F,3)
    n0: jnp.ndarray        # (F,3) normalized vertex normals
    n1: jnp.ndarray
    n2: jnp.ndarray
    uv0: jnp.ndarray       # (F,2)
    uv1: jnp.ndarray
    uv2: jnp.ndarray
    tri_mat: jnp.ndarray   # (F,) i32
    tri_tex: jnp.ndarray   # (F,) i32 (-1 none)
    tri_obj: jnp.ndarray   # (F,) i32
    tri_valid: jnp.ndarray  # (F,) bool
    sph_c: jnp.ndarray     # (S,3) transformed centers
    sph_r: jnp.ndarray     # (S,) transformed radii
    sph_mat: jnp.ndarray   # (S,) i32
    sph_obj: jnp.ndarray   # (S,) i32
    sph_valid: jnp.ndarray  # (S,) bool
    mat_type: jnp.ndarray  # (M,) i32
    mat_ka: jnp.ndarray    # (M,3)
    mat_kd: jnp.ndarray
    mat_ks: jnp.ndarray
    mat_spec: jnp.ndarray  # (M,)
    mat_ior: jnp.ndarray   # (M,)
    mat_emit: jnp.ndarray  # (M,3)
    emitter_center: jnp.ndarray  # (O,3) bbox centers per object
    emitter_radius: jnp.ndarray  # (O,) |bbox diagonal|/2
    emitter_mask: jnp.ndarray    # (O,) bool emissive object
    emitter_order: jnp.ndarray   # (O,) i32 object ids, emissive first
    n_emitters: jnp.ndarray      # () i32
    emitter_cr: jnp.ndarray      # (O,4) [center, radius] rows in emitter
                                 # order — one-hot join operand for the
                                 # per-lane emitter pick
    prim_attr: jnp.ndarray       # (P_pad, 40) per-primitive attribute rows
                                 # (tris then spheres; see _pack_prim_attr)
    prim_shadow: jnp.ndarray     # (P_pad, 12) [v0|v1|v2|emit] rows — the
                                 # minimal epilogue table for emit-only
                                 # shadow traces (nearest_emit_hit)
    prim_cls: jnp.ndarray        # (P_pad, 8) [mat_type, ior, 0...] rows —
                                 # classify_hit's winner-class join (one
                                 # row gather instead of one per column)
    tri_edges: jnp.ndarray       # (F, 9) [v0|e1|e2] rows for the trace
                                 # kernel (ops/trace_kernel.edge_rows)
    chunk_lo: jnp.ndarray        # (nc,3) per-chunk AABBs (TRACE_CHUNK tris,
    chunk_hi: jnp.ndarray        # BVH-leaf order) for the kernel's cull
    textures: jnp.ndarray
    tex_wh: jnp.ndarray
    background: jnp.ndarray      # (3,)
    eye: jnp.ndarray             # (3,)
    # (K,Hm,Wm) i32 packed atlas (texture_ops.pack_atlas); (1,1,1) zeros
    # when the geometry predates the field — fetch falls back to the u8
    # row gather in that case (see nearest_hit)
    tex_packed: jnp.ndarray = jnp.zeros((1, 1, 1), jnp.int32)


def prepare_rt_scene(geom, frame) -> RTScene:
    """Transform geometry into trace space (Scene::updatePosition analog).

    geom: models.scene.RTGeometry; frame: models.scene.RTFrame.
    Runs on device inside jit; cheap relative to tracing.
    """
    m = frame.mvp[geom.vertex_mesh]
    pos = hom_transform(m, geom.positions)
    nm = frame.normal_mat3[geom.vertex_mesh]
    # HIGHEST: a float32 product may otherwise run in TF32 on the GPU
    nrm = jnp.einsum("vij,vj->vi", nm, geom.normals,
                     precision=jax.lax.Precision.HIGHEST)
    nrm = nrm / jnp.maximum(jnp.linalg.norm(nrm, axis=-1, keepdims=True), 1e-20)

    tv = pos[geom.faces]   # (F,3,3)
    tn = nrm[geom.faces]
    tuv = geom.uvs[geom.faces]

    sc = hom_transform(frame.sph_mvp, geom.sph_center)
    sr = geom.sph_radius * frame.sph_scale

    # per-object emitter bounding spheres (sampleLight, Scene.cpp:398-476):
    # bbox center + |diagonal|/2 over each object's transformed extent
    n_obj = geom.obj_emissive.shape[0]
    obj_ids = jnp.arange(n_obj, dtype=jnp.int32)

    def obj_bounds(o):
        tmask = (geom.tri_obj == o) & geom.face_valid
        t3 = tmask[:, None, None]
        lo_t = jnp.min(jnp.where(t3, tv, BIG), axis=(0, 1))
        hi_t = jnp.max(jnp.where(t3, tv, -BIG), axis=(0, 1))
        smask = (geom.sph_obj == o) & geom.sph_valid
        lo_s = jnp.min(jnp.where(smask[:, None], sc - sr[:, None], BIG), axis=0)
        hi_s = jnp.max(jnp.where(smask[:, None], sc + sr[:, None], -BIG), axis=0)
        lo = jnp.minimum(lo_t, lo_s)
        hi = jnp.maximum(hi_t, hi_s)
        return (lo + hi) * 0.5, jnp.linalg.norm(hi - lo) * 0.5

    centers, radii = jax.vmap(obj_bounds)(obj_ids)

    _clo, _chi = chunk_bounds(
        tv[:, 0], tv[:, 1], tv[:, 2], geom.face_valid, TRACE_CHUNK
    )
    mt = geom.materials
    emitter_order = jnp.argsort(
        ~jnp.asarray(geom.obj_emissive), stable=True
    ).astype(jnp.int32)
    emitter_cr = jnp.concatenate(
        [centers[emitter_order], radii[emitter_order][:, None]], axis=1
    )
    # STATIC emitter-count trim: obj_emissive is host data in every real
    # flow (geometry is built by Scene.rt_geometry and closed over, not
    # traced), so the emitter table can be cut to the true emitter rows
    # — a STATIC shape integrators branch on. The 1-emitter case (the
    # demo scenes and Cornell) then skips the per-sample emitter-pick
    # machinery entirely (ops/whitted.whitted_phong_direct). Falls back
    # to the full table if the geometry ever IS traced.
    try:
        n_emit_static = int(np.asarray(geom.obj_emissive).sum())
        emitter_cr = emitter_cr[:max(n_emit_static, 1)]
    except Exception:
        pass  # traced geometry: keep the full (padded) table

    # packed per-primitive attribute table (tris then spheres) — one
    # one-hot join (or one row gather) replaces ~12 per-winner gathers
    f = tv.shape[0]
    tri_kd = mt.kd[geom.tri_mat]
    tri_emit = mt.emission[geom.tri_mat]
    zeros_f = jnp.zeros((f, 1))
    tri_rows = jnp.concatenate([
        tv[:, 0], tv[:, 1], tv[:, 2],                      # 0:9   v0 v1 v2
        tn[:, 0], tn[:, 1], tn[:, 2],                      # 9:18  n0 n1 n2
        tuv[:, 0], tuv[:, 1], tuv[:, 2],                   # 18:24 uv0..2
        tri_kd, tri_emit,                                  # 24:30 kd, emit
        mt.type[geom.tri_mat][:, None].astype(jnp.float32),  # 30 mat type
        mt.ior[geom.tri_mat][:, None],                     # 31 ior
        geom.tri_mat[:, None].astype(jnp.float32),         # 32 mat id
        geom.tri_tex[:, None].astype(jnp.float32),         # 33 tex id
        geom.tri_obj[:, None].astype(jnp.float32),         # 34 obj id
        zeros_f,                                           # 35 is_sphere
        zeros_f, zeros_f, zeros_f, zeros_f,                # 36:40 pad
    ], axis=1)
    ns = sc.shape[0]
    zeros_s = jnp.zeros((ns, 1))
    sph_rows = jnp.concatenate([
        sc, jnp.zeros((ns, 6)),                            # 0:3 center
        jnp.zeros((ns, 15)),
        mt.kd[geom.sph_mat], mt.emission[geom.sph_mat],    # 24:30
        mt.type[geom.sph_mat][:, None].astype(jnp.float32),
        mt.ior[geom.sph_mat][:, None],
        geom.sph_mat[:, None].astype(jnp.float32),
        jnp.full((ns, 1), -1.0),                           # 33 tex id
        geom.sph_obj[:, None].astype(jnp.float32),
        jnp.ones((ns, 1)),                                 # 35 is_sphere
        sr[:, None],                                       # 36 radius
        zeros_s, zeros_s, zeros_s,
    ], axis=1)
    prim_attr = jnp.concatenate([tri_rows, sph_rows], axis=0)
    prim_cls = jnp.concatenate([
        jnp.stack([
            mt.type[geom.tri_mat].astype(jnp.float32),
            mt.ior[geom.tri_mat],
        ], axis=1),
        jnp.stack([
            mt.type[geom.sph_mat].astype(jnp.float32),
            mt.ior[geom.sph_mat],
        ], axis=1),
    ], axis=0)
    prim_cls = jnp.pad(prim_cls, ((0, 0), (0, 6)))
    prim_shadow = jnp.concatenate([
        jnp.concatenate([tv[:, 0], tv[:, 1], tv[:, 2], tri_emit], axis=1),
        jnp.concatenate(
            [jnp.zeros((ns, 9)),
             jnp.where(geom.sph_valid[:, None],
                       mt.emission[geom.sph_mat], 0.0)],
            axis=1,
        ),
    ], axis=0).astype(jnp.float32)

    return RTScene(
        v0=tv[:, 0], v1=tv[:, 1], v2=tv[:, 2],
        n0=tn[:, 0], n1=tn[:, 1], n2=tn[:, 2],
        uv0=tuv[:, 0], uv1=tuv[:, 1], uv2=tuv[:, 2],
        tri_mat=geom.tri_mat, tri_tex=geom.tri_tex, tri_obj=geom.tri_obj,
        tri_valid=geom.face_valid,
        sph_c=sc, sph_r=sr, sph_mat=geom.sph_mat, sph_obj=geom.sph_obj,
        sph_valid=geom.sph_valid,
        mat_type=mt.type, mat_ka=mt.ka, mat_kd=mt.kd, mat_ks=mt.ks,
        mat_spec=mt.spec_exp, mat_ior=mt.ior, mat_emit=mt.emission,
        emitter_center=centers, emitter_radius=radii,
        emitter_mask=jnp.asarray(geom.obj_emissive),
        emitter_order=emitter_order,
        n_emitters=jnp.sum(jnp.asarray(geom.obj_emissive).astype(jnp.int32)),
        emitter_cr=emitter_cr,
        prim_attr=prim_attr,
        prim_shadow=prim_shadow,
        prim_cls=prim_cls,
        tri_edges=edge_rows(tv[:, 0], tv[:, 1], tv[:, 2], geom.face_valid),
        chunk_lo=_clo, chunk_hi=_chi,
        textures=geom.textures, tex_wh=geom.tex_wh,
        background=frame.background, eye=frame.eye,
        tex_packed=jnp.asarray(
            getattr(geom, "tex_packed", np.zeros((1, 1, 1), np.int32))
        ),
    )


class Hit(NamedTuple):
    """Intersection record SoA (reference: Intersection.hpp:12-29, with
    the winner's material constants pre-joined so integrators need no
    further table lookups)."""

    hit: jnp.ndarray        # (N,) bool
    t: jnp.ndarray          # (N,) f32 (BIG when miss)
    is_sphere: jnp.ndarray  # (N,) bool
    prim: jnp.ndarray       # (N,) i32 primitive index
    bary_u: jnp.ndarray     # (N,) f32 (triangles)
    bary_v: jnp.ndarray     # (N,)
    coords: jnp.ndarray     # (N,3)
    normal: jnp.ndarray     # (N,3) interpolated/analytic, normalized
    color: jnp.ndarray      # (N,3) getDiffuseColor (tex/Kd); 0 for spheres
    emit: jnp.ndarray       # (N,3)
    mat: jnp.ndarray        # (N,) i32
    obj: jnp.ndarray        # (N,) i32
    kd: jnp.ndarray         # (N,3) material Kd of the winner
    mat_type: jnp.ndarray   # (N,) i32 MaterialType of the winner
    ior: jnp.ndarray        # (N,) f32
    # texture identity of the winner and its interpolated uv. -1 for
    # spheres/untextured; tuv zeroed when `lite`.
    # No defaults on purpose: a constructor omitting them would produce
    # (0,)-shaped leaves that fail far from the construction site.
    tex: jnp.ndarray    # (N,) i32
    tuv: jnp.ndarray    # (N,2) f32


def _mt_chunk(orig, d, v0, v1, v2, valid):
    """Moller-Trumbore for a chunk: rays (N,3) x tris (C,3) -> (N,C) t
    (BIG on reject). Reference thresholds: |det|<1e-6 and t<1e-6 reject
    (Triangle.cpp:113,129). Only t leaves the chunk loop — u/v are
    recomputed for the single winning triangle afterwards (`_mt_uv`), so
    the whole chunk chain fuses into one masked min-reduction with no
    (N,C) materialization.

    Component-SoA form: every intermediate is an (N,C) plane; the
    3-vectors are unrolled into scalar planes rather than kept as a
    minor axis of size 3.
    """
    ox, oy, oz = orig[:, 0:1], orig[:, 1:2], orig[:, 2:3]      # (N,1)
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    e1 = v1 - v0                                               # (C,3)
    e2 = v2 - v0
    e1x, e1y, e1z = e1[None, :, 0], e1[None, :, 1], e1[None, :, 2]  # (1,C)
    e2x, e2y, e2z = e2[None, :, 0], e2[None, :, 1], e2[None, :, 2]
    v0x, v0y, v0z = v0[None, :, 0], v0[None, :, 1], v0[None, :, 2]

    # p = d x e2
    px = dy * e2z - dz * e2y                                   # (N,C)
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    inv = 1.0 / jnp.where(jnp.abs(det) < 1e-6, 1.0, det)

    tx, ty, tz = ox - v0x, oy - v0y, oz - v0z                  # tvec (N,C)
    u = (tx * px + ty * py + tz * pz) * inv

    # q = tvec x e1
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv
    t = (e2x * qx + e2y * qy + e2z * qz) * inv

    ok = (
        (jnp.abs(det) >= 1e-6)
        & (u >= 0.0) & (u <= 1.0)
        & (v >= 0.0) & (u + v <= 1.0)
        & (t >= 1e-6)
        & valid[None, :]
    )
    return jnp.where(ok, t, BIG)


def _mt_uv(orig, d, v0, v1, v2):
    """Exact (u, v, t) of rays (N,3) against their per-ray winning
    triangle (N,3) — the O(N) epilogue of `intersect_triangles`."""
    e1 = v1 - v0
    e2 = v2 - v0
    p = jnp.cross(d, e2)
    det = jnp.sum(e1 * p, axis=-1)
    inv = 1.0 / jnp.where(jnp.abs(det) < 1e-6, 1.0, det)
    tvec = orig - v0
    u = jnp.sum(tvec * p, axis=-1) * inv
    q = jnp.cross(tvec, e1)
    v = jnp.sum(d * q, axis=-1) * inv
    t = jnp.sum(e2 * q, axis=-1) * inv
    return u, v, t


def _intersect_tri_raw(orig, d, v0, v1, v2, valid, chunk: int = 512,
                       cull_chunks: bool = True):
    """Winner search only: returns (hit (N,) bool, idx (N,) i32 -1 miss,
    t (N,) f32 BIG miss — the CHUNK-FORMULA winner t, see _trace_tris).
    The (u, v, t) epilogue is the caller's (so `nearest_hit` can batch it
    into the one-hot attribute matmul instead of per-array gathers).

    `cull_chunks`: two-level vectorized BVH (ops/bvh.py) — when no ray of
    this block enters a chunk's AABB, the whole (rays x chunk) tile is
    skipped with `lax.cond`. Exact: the slab test is conservative, so
    skipped chunks contain no hits. Pays off when triangles are in
    spatially-coherent (BVH leaf) order and the scene spans many chunks.
    """
    f = v0.shape[0]
    chunk = min(chunk, f)
    if f % chunk:
        pad = chunk - f % chunk
        v0 = jnp.pad(v0, ((0, pad), (0, 0)))
        v1 = jnp.pad(v1, ((0, pad), (0, 0)))
        v2 = jnp.pad(v2, ((0, pad), (0, 0)))
        valid = jnp.pad(valid, (0, pad))
        f += pad
    n_chunks = f // chunk
    n = orig.shape[0]
    cull = cull_chunks and n_chunks > 1

    if cull:
        from software_rasterizer_tpu.ops.bvh import slab_test

        chunk_lo, chunk_hi = chunk_bounds(v0, v1, v2, valid, chunk)

    def compute(carry, s):
        bt, bi = carry
        t = _mt_chunk(
            orig, d,
            jax.lax.dynamic_slice(v0, (s, 0), (chunk, 3)),
            jax.lax.dynamic_slice(v1, (s, 0), (chunk, 3)),
            jax.lax.dynamic_slice(v2, (s, 0), (chunk, 3)),
            jax.lax.dynamic_slice(valid, (s,), (chunk,)),
        )
        # two single-op reduces (min t, then min lane among the equal-t
        # slots) — exact, and cheaper than one variadic (min, argmin)
        # reduce. The barrier pins t to ONE materialization, so both
        # reduces read the same values and XLA does not duplicate the
        # 40-op chain into each reduce's fusion.
        t = jax.lax.optimization_barrier(t)
        ct = jnp.min(t, axis=1)
        lane = jax.lax.broadcasted_iota(jnp.int32, t.shape, 1)
        ca = jnp.min(
            jnp.where(t == ct[:, None], lane, jnp.int32(0x7FFFFFFF)), axis=1
        )
        better = ct < bt
        return (jnp.where(better, ct, bt), jnp.where(better, ca + s, bi))

    def body(carry, ci):
        s = ci * chunk
        if cull:
            any_hit = jnp.any(
                slab_test(orig, d, chunk_lo[ci][None], chunk_hi[ci][None])
            )
            carry = jax.lax.cond(
                any_hit, lambda c: compute(c, s), lambda c: c, carry
            )
        else:
            carry = compute(carry, s)
        return carry, None

    init = (jnp.full((n,), BIG), jnp.full((n,), -1, jnp.int32))
    (bt, i), _ = jax.lax.scan(body, init, jnp.arange(n_chunks, dtype=jnp.int32))
    hit = bt < BIG
    return hit, jnp.where(hit, i, -1), bt


def intersect_triangles(orig, d, v0, v1, v2, valid, chunk: int = 512,
                        cull_chunks: bool = True):
    """Nearest triangle per ray via chunked masked min.

    Returns (t, idx, u, v) each (N,); idx = -1 / t = BIG on miss."""
    hit, i, _ = _intersect_tri_raw(orig, d, v0, v1, v2, valid, chunk,
                                   cull_chunks)
    c = jnp.maximum(i, 0)
    u, v, t = _mt_uv(orig, d, v0[c], v1[c], v2[c])
    return jnp.where(hit, t, BIG), i, u, v


def intersect_spheres(orig, d, centers, radii, valid, t_min: float = 0.0):
    """Nearest sphere per ray (Sphere.cpp:106-146 numerically-stable roots).

    Returns (t, idx) each (N,); t = BIG on miss. t_min=0 reproduces the
    reference's strict t0 > 0 acceptance.
    """
    lx = orig[:, 0:1] - centers[None, :, 0]           # (N,S) planes
    ly = orig[:, 1:2] - centers[None, :, 1]
    lz = orig[:, 2:3] - centers[None, :, 2]
    a = jnp.sum(d * d, axis=-1)[:, None]              # (N,1)
    b = 2.0 * (d[:, 0:1] * lx + d[:, 1:2] * ly + d[:, 2:3] * lz)
    c = lx * lx + ly * ly + lz * lz - (radii * radii)[None]
    disc = b * b - 4.0 * a * c
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    # copysign(sq, b): +sq when b >= 0 (copysign(x, +0) is +x)
    q = -0.5 * (b + jnp.where(b >= 0, sq, -sq))
    q = jnp.where(q == 0.0, 1e-30, q)
    x0 = q / a
    x1 = c / q
    both = (x0 > t_min) & (x1 > t_min)
    t = jnp.where(both, jnp.minimum(x0, x1), jnp.where(x0 > t_min, x0, x1))
    ok = (disc >= 0.0) & (t > t_min) & valid[None]
    t = jnp.where(ok, t, BIG)
    bt = jnp.min(t, axis=1)
    bi = jnp.argmin(t, axis=1).astype(jnp.int32)
    return bt, jnp.where(bt < BIG, bi, -1)


def _onehot_rows(idx, table, precision=jax.lax.Precision.HIGHEST):
    """table[idx] as a one-hot matmul: idx (N,) i32, table (P,K) f32.

    One (N,P)@(P,K) product with an exact one-hot operand replaces a
    gather per column. HIGHEST precision keeps f32 table values,
    including integer ids, exact (a TF32 product would round them)."""
    p = table.shape[0]
    iota = jax.lax.broadcasted_iota(jnp.int32, (idx.shape[0], p), 1)
    oh = (idx[:, None] == iota).astype(jnp.float32)
    return jnp.dot(oh, table, precision=precision,
                   preferred_element_type=jnp.float32)


def _trace_tris(scene: RTScene, orig, d, chunk: int):
    """Winner search over triangles; returns (tri_hit (N,) bool, idx (N,)
    i32, t (N,) f32 — BIG on miss).

    The returned t is the sweep's winner t, NOT the exact _mt_uv
    recompute — callers needing oracle-exact t (nearest_hit,
    nearest_emit_hit) recompute it for the winner; classify_hit uses it
    only to pick triangle-vs-sphere winners."""
    if _trace_backend(scene.v0.shape[0]) == "kernel":
        return trace_nearest(scene.tri_edges, scene.chunk_lo, scene.chunk_hi,
                             orig, d)
    return _intersect_tri_raw(
        orig, d, scene.v0, scene.v1, scene.v2, scene.tri_valid, chunk
    )


def map_ray_blocks(fn, orig, d, block: int):
    """fn(orig, d) -> pytree of (N, ...) arrays, applied to `block`-lane
    slices under `lax.map`. The XLA sweep materializes (rays x chunk)
    planes, so an unblocked 1M-lane call would hold multi-GB
    intermediates; the trace kernel holds no such plane and takes the
    whole ray set in one call."""
    n = orig.shape[0]
    pad = (-n) % block
    if pad:
        orig = jnp.pad(orig, ((0, pad), (0, 0)))
        d = jnp.pad(d, ((0, pad), (0, 0)), constant_values=1.0)
    nb = (n + pad) // block
    out = jax.lax.map(
        lambda od: fn(od[0], od[1]),
        (orig.reshape(nb, block, 3), d.reshape(nb, block, 3)),
    )
    return jax.tree_util.tree_map(
        lambda a: a.reshape((nb * block,) + a.shape[2:])[:n], out
    )


class ShadowHit(NamedTuple):
    """Minimal record for emit-only visibility rays (the Whitted shadow
    test needs only whether the NEAREST hit is emissive and its t,
    Scene.cpp:522-545)."""

    hit: jnp.ndarray   # (N,) bool
    t: jnp.ndarray     # (N,) f32 (BIG on miss)
    emit: jnp.ndarray  # (N,3)


def nearest_emit_hit(scene: RTScene, orig, d, chunk: int = 512,
                     block: int = 8192) -> ShadowHit:
    """Nearest-hit with the MINIMAL epilogue: one 12-column row-gather
    ([v0|v1|v2|emit], prim_shadow) instead of the 40-column attribute
    join — shadow rays don't need normals, uv, materials, or textures.
    The exact winner t is still recomputed (_mt_uv) so the t^2-vs-dist^2
    shadow acceptance matches the scalar oracle bit-for-bit.

    On the XLA sweep large ray sets are mapped over `block`-lane blocks
    (`map_ray_blocks`)."""
    f_pad = scene.v0.shape[0]
    if _trace_backend(f_pad) == "xla" and orig.shape[0] > block:
        return map_ray_blocks(
            lambda o, dd: nearest_emit_hit(scene, o, dd, chunk, block),
            orig, d, block,
        )
    tri_hit, ti, _ = _trace_tris(scene, orig, d, chunk)
    tidx = jnp.maximum(ti, 0)
    use_onehot = f_pad + scene.sph_c.shape[0] <= 1024
    if use_onehot:
        a = _onehot_rows(tidx, scene.prim_shadow[:f_pad])
    else:
        a = scene.prim_shadow[:f_pad][tidx]
    _, _, t_tri = _mt_uv(orig, d, a[:, 0:3], a[:, 3:6], a[:, 6:9])
    tt = jnp.where(tri_hit, t_tri, BIG)

    st, si = intersect_spheres(
        orig, d, scene.sph_c, scene.sph_r, scene.sph_valid, 0.0
    )
    use_s = st < tt
    t = jnp.where(use_s, st, tt)
    sidx = jnp.maximum(si, 0)
    n_sph = scene.sph_c.shape[0]
    if n_sph <= 1024:
        # prim_shadow's sphere rows carry exactly
        # where(sph_valid, mat_emit[sph_mat], 0) at cols 9:12 — the
        # small-table one-hot join replaces a 3-gather chain
        s_emit = _onehot_rows(sidx, scene.prim_shadow[f_pad:, 9:12])
    else:
        s_emit = jnp.where(
            scene.sph_valid[sidx][:, None],
            scene.mat_emit[scene.sph_mat[sidx]], 0.0,
        )
    emit = jnp.where(use_s[:, None], s_emit, a[:, 9:12])
    return ShadowHit(hit=t < BIG, t=t, emit=emit)


def nearest_hit(scene: RTScene, orig, d, chunk: int = 512,
                sphere_t_min: float = 0.0, lite: bool = False) -> Hit:
    """Scene::traceScene (Scene.cpp:349-396): nearest over all primitives,
    then surface properties of the winner (barycentric normal/uv + diffuse
    color for triangles, analytic normal + zero color for spheres).

    `lite=True` skips the texture-fetch color path — shadow/visibility
    rays only need (hit, t, coords, normal, emit).

    Winner attributes are assembled with ONE one-hot matmul over the
    packed `prim_attr` table when the primitive count is small enough
    (the one-hot plane stays cheap); large scenes fall back to gathers.
    """
    f_pad = scene.v0.shape[0]
    tri_hit, ti, _ = _trace_tris(scene, orig, d, chunk)
    tidx = jnp.maximum(ti, 0)
    use_onehot = f_pad + scene.sph_c.shape[0] <= 1024

    n_sph = scene.sph_c.shape[0]
    merge_sph = (not use_onehot) and n_sph <= 1024
    if use_onehot:
        v012 = _onehot_rows(tidx, scene.prim_attr[:f_pad, 0:9])
    elif merge_sph:
        # ONE full-row gather serves BOTH the exact-t recompute (cols
        # 0:9 are v0|v1|v2 for triangle rows) and the winner attribute
        # join below — sphere winners override via a small one-hot, so
        # no separate 9-col gather is needed
        a_tri = scene.prim_attr[:f_pad][tidx]
        v012 = a_tri[:, 0:9]
    else:
        v012 = scene.prim_attr[:f_pad, 0:9][tidx]   # one row-gather
    v0w, v1w, v2w = v012[:, 0:3], v012[:, 3:6], v012[:, 6:9]
    tu, tv, t_tri = _mt_uv(orig, d, v0w, v1w, v2w)
    tt = jnp.where(tri_hit, t_tri, BIG)

    st, si = intersect_spheres(
        orig, d, scene.sph_c, scene.sph_r, scene.sph_valid, sphere_t_min
    )
    use_s = st < tt
    t = jnp.where(use_s, st, tt)
    hit = t < BIG
    sidx = jnp.maximum(si, 0)
    coords = orig + d * t[:, None]

    prim = jnp.where(use_s, f_pad + sidx, tidx)
    if use_onehot:
        a = _onehot_rows(prim, scene.prim_attr)
    elif merge_sph:
        # triangle winners reuse the a_tri rows gathered above; sphere
        # winners get their row from the small sphere tail of prim_attr
        # via an exact one-hot join — same table rows either way, so
        # values are bit-identical to the single prim_attr[prim] gather
        s_rows = _onehot_rows(sidx, scene.prim_attr[f_pad:])
        a = jnp.where(use_s[:, None], s_rows, a_tri)
    else:
        # ONE contiguous row-gather from the packed table instead of a
        # dozen per-column gathers at >1024 prims
        a = scene.prim_attr[prim]
    n0, n1, n2 = a[:, 9:12], a[:, 12:15], a[:, 15:18]
    uv0, uv1, uv2 = a[:, 18:20], a[:, 20:22], a[:, 22:24]
    kd = a[:, 24:27]
    emit = a[:, 27:30]
    mat_type = jnp.round(a[:, 30]).astype(jnp.int32)
    ior = a[:, 31]
    mat = jnp.round(a[:, 32]).astype(jnp.int32)
    tex = jnp.round(a[:, 33]).astype(jnp.int32)
    obj = jnp.round(a[:, 34]).astype(jnp.int32)
    sph_center = a[:, 0:3]         # sphere rows carry the center in 0:3

    # triangle surface properties (Triangle.cpp:160-177)
    w = 1.0 - tu - tv
    tn = w[:, None] * n0 + tu[:, None] * n1 + tv[:, None] * n2
    tn = tn / jnp.maximum(jnp.linalg.norm(tn, axis=-1, keepdims=True), 1e-20)
    if lite:
        tcol = jnp.zeros_like(coords)
        tuv_i = jnp.zeros((coords.shape[0], 2))
    else:
        tuv_i = w[:, None] * uv0 + tu[:, None] * uv1 + tv[:, None] * uv2
        packed = (
            scene.tex_packed
            if scene.tex_packed.shape == scene.textures.shape[:3]
            else None
        )
        tcol = jnp.where(
            (tex >= 0)[:, None],
            fetch_nearest(scene.textures, scene.tex_wh, tex, tuv_i,
                          packed=packed),
            kd,
        )

    # sphere surface properties (Sphere.cpp:148-154): normal only,
    # Properties.color stays (0,0,0) — faithful quirk (Object.hpp:36-40)
    sn = coords - sph_center
    sn = sn / jnp.maximum(jnp.linalg.norm(sn, axis=-1, keepdims=True), 1e-20)

    return Hit(
        hit=hit,
        t=t,
        is_sphere=use_s,
        prim=jnp.where(use_s, sidx, tidx),
        bary_u=tu,
        bary_v=tv,
        coords=coords,
        normal=jnp.where(use_s[:, None], sn, tn),
        color=jnp.where(use_s[:, None], 0.0, tcol),
        emit=emit,
        mat=mat,
        obj=obj,
        kd=kd,
        mat_type=mat_type,
        ior=ior,
        tex=tex,
        tuv=tuv_i,
    )


class LiteHit(NamedTuple):
    """Winner + material CLASS only — no attribute epilogue.

    classify_hit's output: enough to build the integrator's branch masks
    (miss / diffuse / specular) and to compact lanes; the full surface-
    attribute join (`surface_attrs`) then runs at the COMPACTED widths,
    so ops/whitted never pays the full-width epilogue per depth."""

    hit: jnp.ndarray       # (N,) bool
    use_s: jnp.ndarray     # (N,) bool — winner is a sphere
    tri: jnp.ndarray       # (N,) i32 triangle winner (clamped >= 0)
    sph: jnp.ndarray       # (N,) i32 sphere winner (clamped >= 0)
    t_tri: jnp.ndarray     # (N,) f32 sweep winner t (BIG on miss)
    st: jnp.ndarray        # (N,) f32 exact sphere t (BIG on miss)
    mat_type: jnp.ndarray  # (N,) i32 winner MaterialType


def classify_hit(scene: RTScene, orig, d, chunk: int = 512,
                 block: int = 8192) -> LiteHit:
    """Nearest-winner search + material class WITHOUT surface attributes.

    The triangle-vs-sphere pick compares the sweep's triangle t (the
    chunk formula) against the exact sphere t — where nearest_hit
    compares the exact _mt_uv recompute. A tri and a sphere surface
    coinciding within the sweep t's ~1e-7 relative rounding could
    therefore pick the other
    primitive; integrator-visible VALUES stay exact (surface_attrs
    recomputes the winner's t/u/v with the oracle formulas).

    On the XLA sweep large ray sets are mapped over `block`-lane blocks
    (`map_ray_blocks`)."""
    f_pad = scene.v0.shape[0]
    if _trace_backend(f_pad) == "xla" and orig.shape[0] > block:
        return map_ray_blocks(
            lambda o, dd: classify_hit(scene, o, dd, chunk, block),
            orig, d, block,
        )
    tri_hit, ti, tk = _trace_tris(scene, orig, d, chunk)
    tt = jnp.where(tri_hit, tk, BIG)
    st, si = intersect_spheres(
        orig, d, scene.sph_c, scene.sph_r, scene.sph_valid, 0.0
    )
    use_s = st < tt
    hit = jnp.where(use_s, st, tt) < BIG
    tidx = jnp.maximum(ti, 0)
    sidx = jnp.maximum(si, 0)
    prim = jnp.where(use_s, f_pad + sidx, tidx)
    cls = scene.prim_cls[prim]          # 8-col row gather (see RTScene)
    mat_type = jnp.round(cls[:, 0]).astype(jnp.int32)
    return LiteHit(hit=hit, use_s=use_s, tri=tidx, sph=sidx,
                   t_tri=tt, st=st, mat_type=mat_type)


def surface_attrs(scene: RTScene, orig, d, lh: LiteHit,
                  lite: bool = False) -> Hit:
    """The surface-property epilogue of `nearest_hit` for ALREADY
    CLASSIFIED winners (same formulas: exact _mt_uv winner recompute,
    barycentric interpolation, texture/Kd join) — so integrators can
    COMPACT lanes between the winner search and the attribute join.
    Per-lane outputs are identical to nearest_hit's wherever the
    classify pick agrees (everywhere but sweep-t knife-edges)."""
    f_pad = scene.v0.shape[0]
    use_s = lh.use_s
    prim = jnp.where(use_s, f_pad + lh.sph, lh.tri)
    if f_pad + scene.sph_c.shape[0] <= 1024:
        a = _onehot_rows(prim, scene.prim_attr)
    else:
        a = scene.prim_attr[prim]
    v0w, v1w, v2w = a[:, 0:3], a[:, 3:6], a[:, 6:9]
    tu, tv, t_tri = _mt_uv(orig, d, v0w, v1w, v2w)

    t = jnp.where(use_s, lh.st, t_tri)
    t = jnp.where(lh.hit, t, BIG)
    coords = orig + d * t[:, None]

    n0, n1, n2 = a[:, 9:12], a[:, 12:15], a[:, 15:18]
    uv0, uv1, uv2 = a[:, 18:20], a[:, 20:22], a[:, 22:24]
    kd = a[:, 24:27]
    emit = a[:, 27:30]
    mat_type = jnp.round(a[:, 30]).astype(jnp.int32)
    ior = a[:, 31]
    mat = jnp.round(a[:, 32]).astype(jnp.int32)
    tex = jnp.round(a[:, 33]).astype(jnp.int32)
    obj = jnp.round(a[:, 34]).astype(jnp.int32)
    sph_center = a[:, 0:3]

    w = 1.0 - tu - tv
    tn = w[:, None] * n0 + tu[:, None] * n1 + tv[:, None] * n2
    tn = tn / jnp.maximum(jnp.linalg.norm(tn, axis=-1, keepdims=True), 1e-20)
    if lite:
        tcol = jnp.zeros_like(coords)
        tuv_i = jnp.zeros((coords.shape[0], 2))
    else:
        tuv_i = w[:, None] * uv0 + tu[:, None] * uv1 + tv[:, None] * uv2
        packed = (
            scene.tex_packed
            if scene.tex_packed.shape == scene.textures.shape[:3]
            else None
        )
        tcol = jnp.where(
            (tex >= 0)[:, None],
            fetch_nearest(scene.textures, scene.tex_wh, tex, tuv_i,
                          packed=packed),
            kd,
        )

    sn = coords - sph_center
    sn = sn / jnp.maximum(jnp.linalg.norm(sn, axis=-1, keepdims=True), 1e-20)

    return Hit(
        hit=lh.hit,
        t=t,
        is_sphere=use_s,
        prim=jnp.where(use_s, lh.sph, lh.tri),
        bary_u=tu,
        bary_v=tv,
        coords=coords,
        normal=jnp.where(use_s[:, None], sn, tn),
        color=jnp.where(use_s[:, None], 0.0, tcol),
        emit=emit,
        mat=mat,
        obj=obj,
        kd=kd,
        mat_type=mat_type,
        ior=ior,
        tex=tex,
        tuv=tuv_i,
    )
