"""Whitted-style ray tracing integrator (reference: Scene::whittedRayTracing,
Scene.cpp:478-617).

The reference recurses to depth 5, forking reflect+refract at glass hits.
Redesigned as a LEVEL-SYNCHRONOUS WAVEFRONT — each depth level holds
a fixed-capacity queue of weighted rays (origin, dir, weight, pixel);
terminal events (miss -> background, diffuse -> sampled Phong direct
lighting) scatter weighted radiance into the framebuffer; specular hits
emit child rays which are compacted to the next level's queue. Recursion
weights: kr / (1-kr) from Fresnel, 1 for mirrors (Scene.cpp:576-614).

Faithful quirks:
  * depth cap returns BLACK, miss returns background (Scene.cpp:486-497);
  * shadow rays succeed only when the nearest hit is emissive
    (Scene.cpp:522-527). The reference traces them from the hit point
    with NO offset and stays acne-free because its shading math runs in
    DOUBLE precision (glm::dvec3 throughout Scene.cpp:500-560): the
    reconstructed hit point sits within ~1e-13 of the surface, so a
    self-intersection lands below Moller-Trumbore's t >= 1e-6 cut. At
    f32 the reconstruction error is ~1e-4 of scene scale — far ABOVE
    that cut — so we bias the shadow origin along the shading normal
    (toward the light's side) by SHADOW_BIAS. This matches the
    reference on scenes whose feature separation exceeds the bias
    (validated on the shipped demo/Cornell scenes); a real occluder
    closer than the bias along the normal would be skipped, so the
    bias is a `shadow_bias` parameter on whitted_render for
    fine-featured scenes;
  * the is_shadow test compares t^2 vs squared distance (Scene.cpp:541-545);
  * sampleLightOnCenter aims at a random emissive object's bbox-sphere
    CENTER (Scene.cpp:398-427) — deterministic given the emitter pick;
  * per-sample Phong uses material Ka/Ks/specularExponent and the hit's
    diffuse color (texture or Kd; ZERO for spheres via Properties default).
"""

from __future__ import annotations

import functools
import jax
import jax.numpy as jnp

from software_rasterizer_tpu.ops import optics
from software_rasterizer_tpu.ops.camera import camera_rays
from software_rasterizer_tpu.ops.intersect import (
    LiteHit,
    RTScene,
    classify_hit,
    surface_attrs,
)
from software_rasterizer_tpu.ops.path import compact_perm

EPSILON = 1e-5  # Scene.hpp:160

# Shadow-ray origin bias (see module docstring): lifts the origin off
# the surface by more than f32 hit-point reconstruction error (~1e-4 of
# coordinate magnitude) without skipping any real occluder the f64
# reference would see (nearest scene features sit >> 1e-3 apart).
SHADOW_BIAS = 1e-4

# canned ray for DEAD lanes: origin far outside any scene, direction
# along +z — the slab test overflows to (-inf, -inf) intervals on x/y
# and every chunk cull (XLA sweep and trace kernel alike) rejects it.
# Substituting it on dead lanes makes all-dead ray blocks skip ALL
# chunks: compaction's trace savings without its permutation traffic
# (dead-lane outputs are discarded by the callers' live masks).
MISS_ORIG = 1e9
MISS_DIR = (0.0, 0.0, 1.0)


def _neuter_dead(live, orig, d):
    """Replace dead lanes' rays with the canned miss ray."""
    lv = live[:, None]
    o = jnp.where(lv, orig, jnp.float32(MISS_ORIG))
    dd = jnp.where(lv, d, jnp.asarray(MISS_DIR, jnp.float32))
    return o, dd


def _pick_emitter_center(scene: RTScene, key, rid, salt: int = 0):
    """Random emissive object per ray; returns its bbox-sphere center
    (sampleLightOnCenter, Scene.cpp:398-427).

    The pick is keyed by the ray's stable identity `rid` (utils/rng
    lane_uniforms), NOT its local queue slot — so shards of a device mesh
    reproduce the monolithic render exactly even with many emitters."""
    from software_rasterizer_tpu.ops.intersect import _onehot_rows
    from software_rasterizer_tpu.utils.rng import lane_uniforms

    n_emissive = scene.n_emitters
    u = lane_uniforms(key, rid, salt)
    k = jnp.floor(u * jnp.maximum(n_emissive, 1).astype(jnp.float32)).astype(jnp.int32)
    k = jnp.minimum(k, jnp.maximum(n_emissive - 1, 0))
    cr = _onehot_rows(k, scene.emitter_cr)
    return cr[:, 0:3], n_emissive > 0


def whitted_phong_direct(scene: RTScene, coords, nrm, color, mat, ray_dir,
                         spp: int, key, block: int = 8192, chunk: int = 512,
                         rid=None, mask=None, shadow_bias=SHADOW_BIAS):
    """The DIFFUSE_AND_GLOSSY branch (Scene.cpp:509-574), averaged over
    `spp` emitter picks (identical picks when one emitter exists, matching
    the reference's deterministic resampling loop).

    The spp loop in the reference only varies the EMITTER PICK — given
    the pick, sampleLightOnCenter aims at the emitter's bbox-sphere
    CENTER and the Phong term is deterministic (Scene.cpp:398-427,
    512-574). So the sample sum regroups exactly by distinct emitter:
        sum_s v(pick_s)  ==  sum_o count_o * v(o)
    and the trace count drops from `spp` to the number of emitters a
    lane population actually picked (lax.cond skips unpicked ones). At
    the reference's default spp=16 with one emitter: ONE shadow trace
    instead of 16, identical math per lane (count*v vs repeated-add
    only differ in f32 rounding of the multiply).

    Takes the shading-point fields explicitly (coords/nrm/color/mat) so
    callers can COMPACT to the diffuse-hit lanes first; shadow rays use
    the emit-only epilogue (nearest_emit_hit) — visibility needs neither
    normals nor materials of the blocker. `mask` (optional (N,) bool)
    marks the lanes whose result the CALLER will actually consume:
    unmasked lanes trace the canned miss ray, so all-dead ray blocks
    (background / specular regions, spatially coherent) cull every
    chunk — their returned term is garbage the caller discards."""
    from software_rasterizer_tpu.ops.intersect import nearest_emit_hit
    from software_rasterizer_tpu.utils.rng import lane_uniforms

    from software_rasterizer_tpu.ops.intersect import _onehot_rows

    n = coords.shape[0]
    if rid is None:
        rid = jnp.arange(n, dtype=jnp.int32)
    any_emitter = scene.n_emitters > 0

    # one one-hot join replaces three per-lane material gathers
    # (ka/ks/spec_exp); the material table is tiny, so the (N, M)
    # one-hot product is cheap and exact at HIGHEST precision
    mat7 = _onehot_rows(
        mat,
        jnp.concatenate(
            [scene.mat_ka, scene.mat_ks, scene.mat_spec[:, None]], axis=1
        ),
    )
    ka, ks, spec_exp = mat7[:, 0:3], mat7[:, 3:6], mat7[:, 6]

    def eval_toward(center):
        """v(o): the deterministic Phong direct term toward `center`."""
        l = optics.normalize(center - coords)
        # bias off the surface toward the light's side (module docstring:
        # emulates the reference's f64 no-offset behavior at f32)
        side = jnp.where(
            jnp.sum(nrm * l, axis=-1, keepdims=True) >= 0.0, 1.0, -1.0
        )
        bias = shadow_bias * jnp.maximum(
            1.0, jnp.max(jnp.abs(coords), axis=-1, keepdims=True)
        )
        o_b = coords + nrm * (side * bias)
        so, sl = (o_b, l) if mask is None else _neuter_dead(mask, o_b, l)
        shadow = nearest_emit_hit(scene, so, sl, chunk)
        lit = shadow.hit & (jnp.linalg.norm(shadow.emit, axis=-1) >= EPSILON) & any_emitter
        emit = shadow.emit
        diff = jnp.maximum(0.0, jnp.sum(nrm * l, axis=-1))
        refl = optics.normalize(optics.reflect(-l, nrm))
        spec = jnp.maximum(0.0, -jnp.sum(ray_dir * refl, axis=-1)) ** spec_exp
        # reconstruct the shadow hit from the ray's ACTUAL origin o_b
        # (consistent with tests/oracle_whitted.py); dist2 collapses to
        # t^2*|l|^2 either way — the |t^2-dist2| quirk test below reads
        # the reference's own chaotic formula (Scene.cpp:541-545)
        scoords = o_b + l * shadow.t[:, None]
        dist2 = jnp.sum((o_b - scoords) ** 2, axis=-1)
        t2 = shadow.t * shadow.t
        is_shadow = jnp.abs(t2 - dist2) > 1e-6
        ambient = jnp.where(is_shadow[:, None], 0.0, emit)
        diffuse = jnp.where(is_shadow[:, None], 0.0, diff[:, None] * emit)
        specular = spec[:, None] * emit
        v = ambient * ka + color * diffuse + specular * ks
        return jnp.where(lit[:, None], v, 0.0)

    if spp == 1:
        center, _ = _pick_emitter_center(scene, key, rid, 0)
        return eval_toward(center)

    if scene.emitter_cr.shape[0] == 1:
        # STATICALLY one emitter (prepare_rt_scene trims the table to
        # the true emitter count): every per-sample pick lands on it
        # (picks are floor(u * n_e) clamped to [0, n_e-1]), so the spp
        # average collapses to v itself — no picks, no counts, ONE
        # shadow trace. Bit-equal to the resampling loop apart from the
        # count*v multiply it no longer needs (spp * v / spp == v in
        # f32 for finite v; v is finite by construction).
        return eval_toward(
            jnp.broadcast_to(scene.emitter_cr[0, 0:3], (n, 3))
        )

    # per-sample picks (elementwise math, no traces) — identical streams to
    # _pick_emitter_center(salt=s)
    n_e_f = jnp.maximum(scene.n_emitters, 1).astype(jnp.float32)
    o_cap = scene.emitter_cr.shape[0]
    oi = jnp.arange(o_cap, dtype=jnp.int32)[None, :]
    counts = jnp.zeros((n, o_cap), jnp.float32)
    for s in range(spp):
        u = lane_uniforms(key, rid, s)
        k = jnp.minimum(
            jnp.floor(u * n_e_f).astype(jnp.int32),
            jnp.maximum(scene.n_emitters - 1, 0),
        )
        counts = counts + (k[:, None] == oi).astype(jnp.float32)

    # emitter 0 is picked by SOME lane whenever any emitter exists (picks
    # land in [0, n_emitters)), so its term runs unconditionally — inline
    # and fusable, unlike a lax.cond branch whose operands XLA
    # materializes. Emitters o >= 1 keep the cond so a
    # single-emitter scene (the reference demo + Cornell) pays exactly
    # one shadow trace per depth.
    total = counts[:, 0:1] * eval_toward(
        jnp.broadcast_to(scene.emitter_cr[0, 0:3], (n, 3))
    )
    for o in range(1, o_cap):
        c_o = counts[:, o]
        picked = jnp.any(c_o > 0)
        total = total + jax.lax.cond(
            picked,
            lambda _: c_o[:, None] * eval_toward(
                jnp.broadcast_to(scene.emitter_cr[o, 0:3], (n, 3))
            ),
            lambda _: jnp.zeros((n, 3)),
            None,
        )
    return total / float(spp)


def _align_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# lanes per deferred-shading block: block compaction moves whole 2048-lane
# rows, so each compacted block keeps its spatially coherent ray population
_SHADE_BLK = 2048


def _phong_deferred(scene: RTScene, lh, orig, i_dir, is_diffuse, spp: int,
                    key, block: int, chunk: int, rid, cap_frac,
                    shadow_bias=SHADOW_BIAS):
    """whitted_phong_direct on diffuse-live 2048-lane BLOCKS only —
    including the winner ATTRIBUTE JOIN (surface_attrs: 40-col row
    gather, exact _mt_uv recompute, normal/uv interpolation, texture
    fetch), so that epilogue runs only on blocks that contain a diffuse
    hit instead of at full width.

      * block-granular gathers/scatters are contiguous-row moves, not
        per-lane permutations;
      * each compacted block holds exactly its original 2048-lane
        population, so per-block chunk culling sees identical ray sets
        (skipped chunks are provably hit-free either way). The compacted branch is ALLCLOSE-exact (1e-5), not
        bit-exact: the different program shape reassociates FMAs, which
        flips ~1% of pixels at the last ULP (tests/test_whitted_oracle
        documents this) — future golden drift at that level is
        reassociation, not a logic change;
      * a frame whose diffuse-live block count exceeds the cap falls
        back to the full-width path via lax.cond — never lossy, and
        allclose-exact vs the shade_cap=None program (the cond branch
        compiles separately, so XLA reassociates FMAs there too).

    `lh`: the depth's classify_hit result; `orig` the traced (neutered)
    ray origins. Returns (N,3) `direct`, zero outside `is_diffuse`."""
    n = is_diffuse.shape[0]
    nb = n // _SHADE_BLK

    def full(_=None):
        hit = surface_attrs(scene, orig, i_dir, lh)
        d = whitted_phong_direct(
            scene, hit.coords, hit.normal, hit.color, hit.mat, i_dir, spp,
            key, block, chunk, rid=rid, mask=is_diffuse,
            shadow_bias=shadow_bias,
        )
        return jnp.where(is_diffuse[:, None], d, 0.0)

    if cap_frac is None or n % _SHADE_BLK or nb < 64:
        return full()

    cap_b = min(nb, max(8, _align_up(int(nb * cap_frac), 8)))
    blk_live = jnp.any(is_diffuse.reshape(nb, _SHADE_BLK), axis=1)
    n_live = jnp.sum(blk_live.astype(jnp.int32))

    def compacted(_):
        bperm, nbl = compact_perm(blk_live, cap_b)
        slot_ok = jnp.arange(cap_b, dtype=jnp.int32) < nbl

        def g(x, k):
            return x.reshape((nb, _SHADE_BLK) + ((k,) if k else ()))[bperm]

        # slots >= nbl alias block 0 (compact_perm contract): their
        # lanes are masked dead, traced as canned miss rays, and their
        # deposits zeroed before scatter-back
        mask_c = (g(is_diffuse, 0) & slot_ok[:, None]).reshape(-1)
        orig_c = g(orig, 3).reshape(-1, 3)
        dir_c = g(i_dir, 3).reshape(-1, 3)
        rid_c = g(rid, 0).reshape(-1)
        lh_c = LiteHit(
            hit=g(lh.hit, 0).reshape(-1),
            use_s=g(lh.use_s, 0).reshape(-1),
            tri=g(lh.tri, 0).reshape(-1),
            sph=g(lh.sph, 0).reshape(-1),
            t_tri=g(lh.t_tri, 0).reshape(-1),
            st=g(lh.st, 0).reshape(-1),
            mat_type=g(lh.mat_type, 0).reshape(-1),
        )
        h = surface_attrs(scene, orig_c, dir_c, lh_c)
        d_c = whitted_phong_direct(
            scene, h.coords, h.normal, h.color, h.mat, dir_c, spp, key,
            block, chunk, rid=rid_c, mask=mask_c,
            shadow_bias=shadow_bias,
        )
        d_c = jnp.where(
            mask_c[:, None], d_c, 0.0
        ).reshape(cap_b, _SHADE_BLK, 3)
        # scatter rows back: live slots target their source block (the
        # compacted prefix is ascending), dead slots redirect past nb in
        # slot order — globally sorted AND unique, the fast scatter path
        tgt = jnp.where(
            slot_ok, bperm, nb + jnp.arange(cap_b, dtype=jnp.int32)
        )
        outs = [
            jnp.zeros((nb, _SHADE_BLK)).at[tgt].set(
                d_c[..., c], mode="drop",
                unique_indices=True, indices_are_sorted=True,
            )
            for c in range(3)
        ]
        return jnp.stack(outs, axis=-1).reshape(n, 3)

    return jax.lax.cond(n_live <= cap_b, compacted, full, None)


def whitted_trace(
    scene: RTScene,
    orig,
    d,
    key,
    spp: int = 1,
    max_depth: int = 5,
    block: int = 8192,
    chunk: int = 512,
    queue_factor: int = 2,
    queue_shrink: float = 0.5,
    lane_offset=0,
    with_stats: bool = False,
    pixel_ids=None,
    shade_cap=(0.375, 0.125, 0.125),
    shadow_bias=SHADOW_BIAS,
):
    """Trace one Whitted sample tree per lane. orig/d: (N,3) normalized
    camera rays. Returns (N,3) radiance, or (radiance, stats) when
    `with_stats` (stats: {"dropped_rays": i32 overflow count,
    "rays_main"/"rays_shadow": i32 live rays traced — main traces count
    live lanes, shadow traces count live-diffuse lanes per emitter
    eval}).
    (Scene::whittedRayTracing per ray; the lane set may be any subset of
    the framebuffer, which is how parallel/render.py shards the screen
    across devices — pass `lane_offset` = the shard's absolute first-lane
    index so per-ray RNG identities stay global.)

    When `with_stats`, stats also carries "dropped_px": an (N,) bool
    mask in PIXEL-index space (flat image order, NOT lane order) marking
    every root pixel whose sample tree lost at least one child to queue
    overflow — the input to `whitted_render_exact`'s second pass. The
    root pixel of a depth-d queue lane is recovered from its RNG
    identity: rid_d = 2^d * rid_0 + off with off in [2^d - 1, 2^(d+1) - 2]
    (children derive 2*rid + {1, 2}), so rid_0 = (rid_d - (2^d - 1)) >> d.

    `pixel_ids` (optional (N,) i32): each lane's IMAGE index when lanes
    are not in image order — whitted_render passes camera rays in
    (16, 128)-pixel TILE order so each 2048-lane trace block covers a
    compact screen tile instead of two full image rows, which is what
    makes per-block chunk culling fire (a row-pair block
    sees the whole scene; a tile sees a narrow frustum). pixel_ids keys
    ONLY the RNG identity (lane_offset + pixel_ids), so rendered values
    are bit-identical to image-order lanes; the returned radiance stays
    in LANE order (deposits are lane-indexed — the tile permutation is
    a pure reshape/transpose the caller applies ONCE at the end instead
    of a scatter into image order per depth).

    Child queues shrink geometrically: depth d's capacity is
    min(n * queue_factor, n * queue_shrink**d) lanes (aligned up, floor
    1024). Only specular (glass/mirror) hits spawn children; every
    specular parent reserves TWO slots (reflect half + refract half —
    a mirror's refract slot is dead, a deliberate capacity/locality
    trade documented at the allocation site), so parent capacity per
    depth is half the queue. Each child ray lost to overflow is COUNTED
    in stats["dropped_rays"] (never silent; glass parents count 2).
    queue_shrink=1.0 disables the geometric schedule (capacity doubles
    per depth up to n * queue_factor); combined with queue_factor >=
    2**max_depth this reproduces the reference's full binary recursion
    tree losslessly.

    `shade_cap`: per-depth diffuse-live BLOCK fraction for the deferred
    Phong stage (`_phong_deferred`; entry min(depth, last) applies, None
    disables). Caps are capacity knobs, not correctness knobs: a frame
    exceeding its cap shades full-width via the exact lax.cond
    fallback."""
    n = orig.shape[0]
    if with_stats and pixel_ids is None:
        # dropped_px recovery inverts the rid chain (rid_0 =
        # (rid_d - (2^d - 1)) >> d), which is only exact while rids never
        # wrap int32. rid chains elsewhere are wrap-tolerant (RNG hashing
        # only), but the EXACT patch pass must not silently degrade
        # (ADVICE r4) — reject the rare config that could wrap (e.g.
        # max_depth >= 11 at 1 Mpx). Callers passing pixel_ids assert
        # against their true pixel count (whitted_render below).
        assert n << (max_depth + 1) < 2 ** 31, (
            f"with_stats rid recovery would wrap int32: n={n}, "
            f"max_depth={max_depth}")
    img = jnp.zeros((n, 3))
    dropped = jnp.zeros((), jnp.int32)
    dropped_px = jnp.zeros((n,), bool)
    # traced-ray accounting for stats (bench roofline): LIVE lanes per
    # main trace, and live-diffuse lanes per shadow-trace EVAL (the spp
    # picks regroup by distinct emitter — whitted_phong_direct — so one
    # eval per emitter in the table; the static 1-emitter fast path and
    # most scenes run exactly one)
    rays_main = jnp.zeros((), jnp.int32)
    rays_shadow = jnp.zeros((), jnp.int32)
    shadow_evals = max(1, scene.emitter_cr.shape[0]) if spp > 1 else 1
    dep_bufs = []   # per-depth (cap_d, 3) deposits, depths 1..max
    links = []      # (perm, n_spec, half): depth-d queue -> its parents

    rid0 = (
        jnp.arange(n, dtype=jnp.int32) if pixel_ids is None
        else pixel_ids.astype(jnp.int32)
    )
    rays = {
        "orig": orig,
        "dir": d,
        "weight": jnp.ones((n, 3)),
        # stable RNG identity: absolute PIXEL id at depth 0; children
        # derive 2*rid+{1,2} (collisions only via uint32 wrap — harmless
        # for hashing, deterministic everywhere)
        "rid": lane_offset + rid0,
        "live": jnp.ones(n, bool),
    }

    for depth in range(max_depth + 1):
        cap = rays["orig"].shape[0]
        live = rays["live"]
        # dead lanes (queue slots past n_spec, refract slots of mirrors/
        # TIR) trace the canned miss ray: all-dead ray blocks cull every
        # chunk, so queue capacity costs little trace time (their hit
        # records are discarded — all consumers below mask by `live`)
        t_orig, t_dir = _neuter_dead(live, rays["orig"], rays["dir"])
        rays_main = rays_main + jnp.sum(live.astype(jnp.int32))
        # winner + material class ONLY at full width (classify_hit); the
        # attribute epilogue (40-col join, exact recompute, interp,
        # texture) runs later at COMPACTED widths
        lh = classify_hit(scene, t_orig, t_dir, chunk, block)
        weight = rays["weight"]

        # miss -> background (Scene.cpp:493-497)
        miss = live & ~lh.hit

        mat_type = lh.mat_type
        i_dir = rays["dir"]  # camera/child dirs are normalized on creation

        # DIFFUSE_AND_GLOSSY -> terminal Phong direct lighting, run at
        # diffuse-live blocks only (attribute join deferred to there too)
        is_diffuse = live & lh.hit & (mat_type == 0)
        rays_shadow = rays_shadow + shadow_evals * jnp.sum(
            is_diffuse.astype(jnp.int32)
        )
        cap_frac = (
            shade_cap[min(depth, len(shade_cap) - 1)] if shade_cap else None
        )
        direct = _phong_deferred(
            scene, lh, t_orig, i_dir, is_diffuse, spp,
            jax.random.fold_in(key, depth), block, chunk,
            rid=rays["rid"], cap_frac=cap_frac, shadow_bias=shadow_bias,
        )
        # one combined radiance deposit per depth; at depth 0 lane i is
        # slot i of the lane-order image, so a plain add replaces the
        # scatter
        deposit = jnp.where(miss[:, None], weight * scene.background, 0.0) + \
            jnp.where(is_diffuse[:, None], weight * direct, 0.0)
        if depth == 0:
            img = img + deposit
        else:
            # deeper deposits are DEFERRED into per-depth buffers and
            # folded up the PARENT CHAIN after the loop (see below) —
            # no pixel-indexed scatter ever happens. A pixel receiving
            # radiance from several depths sees a different f32 ADD
            # ORDER than depth-by-depth accumulation — reassociation
            # only, within the tests' tolerance
            dep_bufs.append(deposit)

        if depth == max_depth:
            break  # children would exceed depth cap -> contribute black

        # specular branches: compact the SPECULAR PARENTS first, then
        # build both children at the compacted width — the Fresnel/
        # reflect/refract math, the 14-col parent gather, and the child
        # arrays all run at cap_next/2 lanes, and the queue keeps
        # reflects and refracts in SEPARATE halves (reflect and refract
        # directions diverge; a layout mixing both populations into the
        # same ray blocks defeats per-block chunk culling).
        # The cost of the two-half layout: every specular parent
        # reserves a refract slot even when it is a mirror, so PARENT
        # capacity is cap_next // 2 and a frame whose specular parents
        # exceed it drops children that an exactly-counted layout could
        # have kept. Drops are COUNTED EXACTLY: each dropped parent
        # loses its reflect child plus, for glass parents, the refract
        # child (counted even if total internal reflection would have
        # killed it — its Fresnel term is never computed).
        is_spec = live & lh.hit & ((mat_type == 1) | (mat_type == 2))
        is_glass = is_spec & (mat_type == 1)
        # queue_shrink >= 1.0 disables the geometric schedule entirely:
        # capacity then doubles per depth up to n*queue_factor, so
        # queue_factor >= 2**max_depth reproduces the reference's full
        # binary recursion tree losslessly
        geo_cap = (
            n * queue_factor
            if queue_shrink >= 1.0
            else max(_align_up(int(n * queue_shrink ** (depth + 1)), 256), 1024)
        )
        cap_next = min(n * queue_factor, 2 * cap, geo_cap)
        half = cap_next // 2
        perm, n_spec = compact_perm(is_spec, half)
        # exact child-ray loss: parents compacted past `half` lose 1
        # (mirror) or 2 (glass) children
        pos = jnp.cumsum(is_spec.astype(jnp.int32)) - 1
        lost = is_spec & (pos >= half)
        dropped = dropped + jnp.sum(
            jnp.where(lost, 1 + is_glass.astype(jnp.int32), 0)
        )
        if with_stats:
            # mark the lost parents' ROOT pixels (see docstring for the
            # rid -> pixel recovery); cond-gated so the overflow-free
            # common case pays one any() reduce, no scatter
            pix = (
                (rays["rid"] - ((1 << depth) - 1)) >> depth
            ) - lane_offset
            tgt_px = jnp.where(lost, pix, n)
            dropped_px = jax.lax.cond(
                jnp.any(lost),
                lambda m: m.at[tgt_px].set(True, mode="drop"),
                lambda m: m,
                dropped_px,
            )
        slot_ok = jnp.arange(half, dtype=jnp.int32) < n_spec

        # compact the LITE state of the parents (one 14-col row gather),
        # then join their surface attributes at the compacted width —
        # the 40-col join + exact recompute + normal interpolation all
        # run at half-queue width instead of full
        # tri/sph winner indices ride the f32 pack BITCAST, not value-cast:
        # a float32 round-trip is exact only to 2^24, so the unbounded XLA
        # tier at >16.7M triangles would silently corrupt compacted
        # specular winner indices (ADVICE r4). Bit patterns survive the
        # permutation gather unchanged.
        pf = jnp.concatenate([
            t_orig, rays["dir"], weight,
            lh.st[:, None],
            jax.lax.bitcast_convert_type(lh.tri, jnp.float32)[:, None],
            jax.lax.bitcast_convert_type(lh.sph, jnp.float32)[:, None],
            lh.use_s.astype(jnp.float32)[:, None],
            lh.mat_type.astype(jnp.float32)[:, None],
        ], axis=1)[perm]                                  # (half, 14)
        links.append((perm, n_spec, half))
        p_rid = rays["rid"][perm]
        lh_c = LiteHit(
            hit=jnp.ones((half,), bool),  # every compacted parent hit
            use_s=pf[:, 12] > 0.5,
            tri=jax.lax.bitcast_convert_type(pf[:, 10], jnp.int32),
            sph=jax.lax.bitcast_convert_type(pf[:, 11], jnp.int32),
            t_tri=pf[:, 9],  # unused by surface_attrs (exact recompute)
            st=pf[:, 9],
            mat_type=jnp.round(pf[:, 13]).astype(jnp.int32),
        )
        h_c = surface_attrs(scene, pf[:, 0:3], pf[:, 3:6], lh_c, lite=True)
        c_coords = h_c.coords
        c_idir = pf[:, 3:6]
        c_nrm = h_c.normal   # already unit length
        c_w = pf[:, 6:9]
        c_ior = h_c.ior
        c_glass = jnp.round(pf[:, 13]).astype(jnp.int32) == 1

        kr = jnp.clip(optics.fresnel(c_idir, c_nrm, c_ior), 0.0, 1.0)
        refl_dir = optics.normalize(optics.reflect(c_idir, c_nrm))
        refr_raw = optics.refract(c_idir, c_nrm, c_ior)
        has_refr = (jnp.linalg.norm(refr_raw, axis=-1) > 1e-6) & (
            jnp.abs(kr - 1.0) > 1e-6
        )
        refr_dir = optics.normalize(refr_raw, eps=1e-20)

        idotn = jnp.sum(c_idir * c_nrm, axis=-1)
        refl_off_glass = jnp.where(idotn[:, None] < 0, c_nrm, -c_nrm) * EPSILON
        refr_off = jnp.where(idotn[:, None] > 0, c_nrm, -c_nrm) * EPSILON
        rdotn = jnp.sum(refl_dir * c_nrm, axis=-1)
        refl_off_mirror = jnp.where(rdotn[:, None] > 0, c_nrm, -c_nrm) * EPSILON

        rays = {
            "orig": jnp.concatenate([
                c_coords + jnp.where(c_glass[:, None], refl_off_glass,
                                     refl_off_mirror),
                c_coords + refr_off,
            ]),
            "dir": jnp.concatenate([refl_dir, refr_dir]),
            "weight": jnp.concatenate([
                c_w * jnp.where(c_glass, kr, 1.0)[:, None],
                c_w * (1.0 - kr)[:, None],
            ]),
            "rid": jnp.concatenate([p_rid * 2 + 1, p_rid * 2 + 2]),
            "live": jnp.concatenate([
                slot_ok,
                slot_ok & c_glass & has_refr,
            ]),
        }

    # fold deferred deposits UP THE PARENT CHAIN instead of scattering
    # them into pixels: a depth-d queue's two halves share their parent
    # slot (child k and k+half both map to parent lane perm[k]), so each
    # fold is a SORTED, UNIQUE scatter-add of half_d entries — the
    # sorted/unique hints let XLA skip the serialized scatter path that
    # pixel-indexed deposits would take. Dead slots (k >= n_spec) redirect past
    # the target (mode="drop"); their deposits are 0 anyway (live-masked)
    # and redirecting keeps the index stream strictly increasing. At
    # depth 0 lane i IS pixel i, so the last fold is a plain add.
    for i in range(len(dep_bufs) - 1, -1, -1):
        perm, n_spec, half = links[i]
        v = dep_bufs[i][:half] + dep_bufs[i][half:]
        parent_cap = n if i == 0 else dep_bufs[i - 1].shape[0]
        tgt = jnp.where(
            jnp.arange(half, dtype=jnp.int32) < n_spec,
            perm,
            parent_cap + jnp.arange(half, dtype=jnp.int32),
        )
        acc = img if i == 0 else dep_bufs[i - 1]
        # per-CHANNEL 1-D scatters: three 1-D sorted unique scatters
        # instead of one row scatter into an (N,3) array
        folded = jnp.stack(
            [
                acc[:, c].at[tgt].add(
                    v[:, c], mode="drop",
                    unique_indices=True, indices_are_sorted=True,
                )
                for c in range(3)
            ],
            axis=1,
        )
        if i == 0:
            img = folded
        else:
            dep_bufs[i - 1] = folded
    if with_stats:
        return img, {"dropped_rays": dropped, "rays_main": rays_main,
                     "rays_shadow": rays_shadow, "dropped_px": dropped_px}
    return img


@functools.partial(
    jax.jit,
    static_argnames=("width", "height", "spp", "max_depth", "block", "chunk",
                     "queue_factor", "queue_shrink", "with_stats",
                     "shade_cap", "shadow_bias"),
)
def whitted_render(
    scene: RTScene,
    width: int,
    height: int,
    fovy: float,
    key,
    spp: int = 1,
    max_depth: int = 5,
    block: int = 8192,
    chunk: int = 512,
    queue_factor: int = 2,
    queue_shrink: float = 0.5,
    with_stats: bool = False,
    shade_cap=(0.375, 0.125, 0.125),
    shadow_bias: float = SHADOW_BIAS,
):
    """Render one Whitted frame. Returns (H,W,3) float image (pre-clamp);
    with_stats=True returns (image, stats) — see whitted_trace.

    Camera rays are issued in (16, 128)-pixel TILE order when the frame
    divides evenly: each 2048-lane trace block then covers a compact
    screen tile instead of two full image rows, so per-block chunk
    culling sees a narrow frustum. Radiance
    values are bit-identical — RNG identities and deposits are keyed by
    absolute pixel id."""
    orig, d = camera_rays(scene.eye, fovy, width, height)
    if with_stats:
        # see whitted_trace: pixel_ids here are bounded by width*height
        assert (width * height) << (max_depth + 1) < 2 ** 31, (
            f"with_stats rid recovery would wrap int32 at "
            f"{width}x{height}, max_depth={max_depth}")
    th, tw = 16, 128
    tiled = height % th == 0 and width % tw == 0 and height * width > th * tw

    def to_tiles(a):
        # image order -> tile order: a pure reshape/transpose, NOT a
        # permutation gather
        k = a.shape[-1]
        return (
            a.reshape(height // th, th, width // tw, tw, k)
            .transpose(0, 2, 1, 3, 4).reshape(-1, k)
        )

    def from_tiles(a):
        k = a.shape[-1]
        return (
            a.reshape(height // th, width // tw, th, tw, k)
            .transpose(0, 2, 1, 3, 4).reshape(height, width, k)
        )

    if tiled:
        pid = to_tiles(
            jnp.arange(height * width, dtype=jnp.int32)[:, None]
        )[:, 0]
        orig, d = to_tiles(orig), to_tiles(d)
    else:
        pid = None

    out = whitted_trace(
        scene, orig, d, key, spp, max_depth, block, chunk, queue_factor,
        queue_shrink, with_stats=with_stats, pixel_ids=pid,
        shade_cap=shade_cap, shadow_bias=shadow_bias,
    )
    img, stats = out if with_stats else (out, None)
    img = from_tiles(img) if tiled else img.reshape(height, width, 3)
    if with_stats:
        # dropped_px is PIXEL-indexed (whitted_trace recovers root pixels
        # from rid), so it reshapes directly — no tile unpermute
        stats = dict(stats)
        stats["dropped_px"] = stats["dropped_px"].reshape(height, width)
    return (img, stats) if with_stats else img


@functools.partial(
    jax.jit,
    static_argnames=("width", "height", "spp", "max_depth", "block", "chunk",
                     "shade_cap", "shadow_bias"),
)
def _retrace_pixels(scene, width, height, fovy, key, pid, spp, max_depth,
                    block, chunk, shade_cap, shadow_bias):
    """Pass 2 of whitted_render_exact: trace the pixels in `pid` ((K,)
    i32 image indices, padded to a bucketed static width) at LOSSLESS
    queue capacity (queue_shrink=1.0 + queue_factor=2**max_depth — the
    reference's full binary recursion tree). Per-pixel values equal the
    full-capacity whole-frame render's: RNG identities and emitter picks
    key off the absolute pixel id, never the lane set."""
    orig, d = camera_rays(scene.eye, fovy, width, height)
    return whitted_trace(
        scene, orig[pid], d[pid], key, spp, max_depth, block, chunk,
        queue_factor=2 ** max_depth, queue_shrink=1.0, pixel_ids=pid,
        shade_cap=shade_cap, shadow_bias=shadow_bias,
    )


@jax.jit
def _patch_pixels(img, pid, vals, n_valid):
    """Scatter pass-2 values into the flat (N,3) frame ON DEVICE (no host
    round-trip of the full image; the patch itself is a tiny sorted
    scatter). Pad slots (>= n_valid) redirect out of range."""
    n = img.shape[0]
    tgt = jnp.where(
        jnp.arange(pid.shape[0], dtype=jnp.int32) < n_valid, pid, n
    )
    cols = [
        img[:, c].at[tgt].set(vals[:, c], mode="drop",
                              unique_indices=True)
        for c in range(3)
    ]
    return jnp.stack(cols, axis=1)


def whitted_render_exact(
    scene: RTScene,
    width: int,
    height: int,
    fovy: float,
    key,
    spp: int = 1,
    max_depth: int = 5,
    block: int = 8192,
    chunk: int = 512,
    queue_factor: int = 2,
    queue_shrink: float = 0.5,
    shade_cap=(0.375, 0.125, 0.125),
    shadow_bias: float = SHADOW_BIAS,
    bucket: int = 2048,
    return_stats: bool = False,
):
    """Overflow-EXACT Whitted render: dropped rays handled, not just
    counted.

    Pass 1 is the capacity-bounded wavefront (`whitted_render` with the
    geometric queue schedule). When its per-depth child queues overflowed
    (stats["dropped_rays"] > 0 — a specular-heavy frame exceeding the
    queue_shrink budget), pass 2 re-traces ONLY the affected root pixels
    (stats["dropped_px"]) at lossless capacity (queue_shrink=1.0,
    queue_factor=2**max_depth) and patches them into the frame. Because
    every per-pixel quantity — RNG streams, emitter picks, deposits — is
    keyed by ABSOLUTE pixel id, the patched pixels are exactly what the
    full-binary-tree whole-frame render computes, without paying its
    2^depth queues for the whole frame (the reference recurses the full
    tree per pixel, Scene.cpp:576-614).

    Host-orchestrated (two jitted passes + one 1-bit/px mask readback),
    so NOT jittable itself; the pass-2 width is padded to `bucket` lanes
    to bound recompiles. The patch scatter runs ON DEVICE
    (`_patch_pixels`).
    Returns an (H,W,3) device array; with return_stats, (image, pass-1
    stats)."""
    import numpy as np

    img, stats = whitted_render(
        scene, width, height, fovy, key, spp, max_depth, block, chunk,
        queue_factor, queue_shrink, with_stats=True, shade_cap=shade_cap,
        shadow_bias=shadow_bias,
    )
    # scalar readback first: the overflow-free common case (default
    # queue config on the shipped scenes) pays a 4-byte fetch, not the
    # 1-bit/px mask fetch
    if int(stats["dropped_rays"]) == 0:
        return (img, stats) if return_stats else img
    mask = np.asarray(stats["dropped_px"]).reshape(-1)
    pix = np.nonzero(mask)[0]
    if pix.size == 0:
        return (img, stats) if return_stats else img
    cap = -(-pix.size // bucket) * bucket
    pad = np.zeros(cap, np.int64)
    pad[: pix.size] = pix  # pad lanes re-trace pixel 0; masked in patch
    out2 = _retrace_pixels(
        scene, width, height, fovy, key, jnp.asarray(pad, jnp.int32),
        spp, max_depth, block, chunk, shade_cap, shadow_bias,
    )
    out = _patch_pixels(
        img.reshape(-1, 3), jnp.asarray(pad, jnp.int32), out2,
        jnp.asarray(pix.size, jnp.int32),
    ).reshape(height, width, 3)
    return (out, stats) if return_stats else out
