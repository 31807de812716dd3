"""Monte-Carlo path tracing integrator (reference: Scene::pathTracing,
Scene.cpp:671-866, driven by src/PathTracing.cpp).

The reference recurses per sample: shading(hit) = directNEE(hit) +
RR-gated indirect via uniform-hemisphere BRDF sampling. Redesigned as a
WAVEFRONT loop — every (pixel, sample) lane advances one
bounce per iteration under `lax.scan`; Russian roulette and all
terminal conditions become mask updates on a live-lane vector;
radiance accumulates as throughput-weighted sums. No recursion, no
divergent control flow, static shapes throughout.

RNG is counter-based `jax.random` keyed per (sample batch, bounce,
purpose), replacing the reference's shared unlocked mt19937
(Tools.cpp:295-300 — a data race; SURVEY.md 3.4).

Faithful reference semantics (per-lane, Scene.cpp citations):
  * primary miss -> background (pathTracing, :857-866);
  * direct light at an EMISSIVE hit returns the hit's diffuse COLOR
    (not its emission) (:676-680);
  * NEE: bounding-sphere light direction sampling (sampleLight,
    :429-476), pdf = cos(theta)/2pi; contribution
    emit * Fr * cos_o * cos_l / (pdf * dist^2) gated on the shadow hit
    being emissive and |t^2 - dist^2| <= 1e-4 (:682-717);
  * indirect: RR with survival p_rr BEFORE sampling (:797-798);
    wi ~ uniform hemisphere (Material.cpp:14-34); paths whose next hit
    is emissive are DISCARDED (:813-815); weight
    Fr * cos / (pdf * p_rr) (:826-830);
  * shadow/bounce ray origins offset by +1e-6*N (:689, :801);
  * pdf < epsilon (1e-5, Scene.hpp) kills the branch (:683-686, :821-824).

The RR recursion has no depth cap in the reference; `max_bounces`
truncates the 0.8^d tail (0.8^16 < 3% of lanes, each with ~0.1x
throughput — far below the Monte-Carlo noise floor at any spp).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from software_rasterizer_tpu.ops import optics, sampling
from software_rasterizer_tpu.ops.camera import camera_rays
from software_rasterizer_tpu.ops.intersect import Hit, RTScene, nearest_hit

EPSILON = 1e-5  # Scene.hpp m_epsilon


def _emissive(emit):
    return jnp.linalg.norm(emit, axis=-1) > EPSILON


def _nee_eval(scene: RTScene, hit: Hit, n, l, pdf, shadow: Hit):
    """pathTracingDirectLight evaluation (Scene.cpp:671-717) given the
    sampled light direction `l`/`pdf` and the traced shadow hit."""
    coords = hit.coords
    lit = shadow.hit & _emissive(shadow.emit)
    dist2 = jnp.sum((coords - shadow.coords) ** 2, axis=-1)
    t2 = shadow.t * shadow.t
    not_shadow = jnp.abs(t2 - dist2) <= 1e-4

    cos_o = jnp.maximum(0.0, jnp.sum(n * l, axis=-1))
    cos_l = jnp.maximum(0.0, jnp.sum(shadow.normal * (-l), axis=-1))
    fr = sampling.fr_diffuse(hit.kd, l, n)

    pdf_ok = jnp.isfinite(pdf) & (pdf >= EPSILON)
    denom = jnp.where(pdf_ok, pdf, 1.0) * jnp.maximum(dist2, 1e-30)
    nee = shadow.emit * fr * (cos_o * cos_l / denom)[:, None]
    nee = jnp.where((lit & not_shadow & pdf_ok)[:, None], nee, 0.0)

    # emissive shading point short-circuits to its diffuse color (:676-680)
    return jnp.where(_emissive(hit.emit)[:, None], hit.color, nee)


def _align_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def compact_perm(live, cap: int):
    """Stable-partition permutation WITHOUT a sort: slot k of the output
    is the k-th live lane (cumsum of liveness -> target slot, one
    scatter). O(n), where an argsort would be an O(n log n) sort.
    Returns (perm (cap,) i32,
    n_live () i32); slots >= n_live alias lane 0 and MUST be masked dead
    by the caller."""
    n = live.shape[0]
    pos = jnp.cumsum(live.astype(jnp.int32)) - 1
    n_live = jnp.sum(live.astype(jnp.int32))
    perm = jnp.zeros((cap,), jnp.int32)
    # dead lanes scatter out of range, each to a DISTINCT index (cap+i):
    # with every target unique, unique_indices=True lets XLA skip the
    # serialized duplicate-combining scatter path
    tgt = jnp.where(live, pos, cap + jnp.arange(n, dtype=jnp.int32))
    perm = perm.at[tgt].set(
        jnp.arange(n, dtype=jnp.int32), mode="drop", unique_indices=True
    )
    return perm, n_live


def path_trace(
    scene: RTScene,
    orig,
    d,
    key,
    p_rr: float = 0.8,
    max_bounces: int = 16,
    chunk: int = 512,
    compact_schedule=(1.0, 0.55, 0.3, 0.18, 0.1, 0.07),
    with_stats: bool = False,
):
    """One path-tracing sample per lane. orig/d: (N,3). Returns (N,3)
    radiance (the reference's Scene::pathTracing per camera ray), or
    (radiance, {"dropped_lanes": i32}) when `with_stats`.

    Wavefront COMPACTION: `max_bounces` is split into
    len(compact_schedule) groups; before each group the live lanes are
    compacted to `schedule[g] * N` slots (stable partition by liveness).
    Russian roulette kills ~(1-p_rr) of lanes per bounce, so the realized
    live fraction (~0.8^b, further reduced by miss/emissive kills) stays
    below the capacity curve (default: 0.8^boundary + ~10-35% margin).
    Overflowing live lanes ARE dropped — and COUNTED: stats
    ["dropped_lanes"] reports them so a scene whose survival curve beats
    the schedule (low-kill, e.g. p_rr ~ 1) is detected, never silently
    biased (VERDICT r1 "no silent caps"). Set compact_schedule=(1.0,)
    to disable (every bounce at full width, lossless)."""
    n_lanes = orig.shape[0]
    dropped = jnp.zeros((), jnp.int32)
    hit = nearest_hit(scene, orig, d, chunk)
    radiance = jnp.where((~hit.hit)[:, None], scene.background, 0.0)

    state = {
        "hit": hit,
        "live": hit.hit,
        "tp": jnp.ones((n_lanes, 3)),
        "pixel": jnp.arange(n_lanes, dtype=jnp.int32),
    }

    n_groups = min(len(compact_schedule), max_bounces)
    per_group = [max_bounces // n_groups] * n_groups
    for i in range(max_bounces % n_groups):
        per_group[i] += 1

    def bounce(carry, b):
        state, acc = carry
        hit, live, tp, pixel = (
            state["hit"], state["live"], state["tp"], state["pixel"]
        )
        cap = pixel.shape[0]
        kb = jax.random.fold_in(key, b)
        k_nee, k_rr, k_bsdf = jax.random.split(kb, 3)

        n = optics.normalize(hit.normal)
        l, pdf_l = sampling.sample_light_dir(scene, k_nee, hit.coords)

        # Russian roulette (survive iff u <= p_rr, Scene.cpp:797-798)
        survive = jax.random.uniform(k_rr, (cap,)) <= p_rr

        wi = optics.normalize(sampling.sample_uniform_hemisphere(k_bsdf, n))
        pdf = sampling.hemisphere_pdf(wi, n)
        fr = sampling.fr_diffuse(hit.kd, wi, n)
        cos_o = jnp.maximum(0.0, jnp.sum(wi * n, axis=-1))
        pdf_ok = jnp.isfinite(pdf) & (pdf >= EPSILON)

        # two trace pipelines per bounce (NEE shadow + next bounce) from
        # the same offset origin
        o2 = hit.coords + 1e-6 * n
        shadow = nearest_hit(scene, o2, l, chunk, lite=True)
        nxt = nearest_hit(scene, o2, wi, chunk)

        direct = _nee_eval(scene, hit, n, l, pdf_l, shadow)
        # lane-local accumulator: pixels are fixed within a bounce group,
        # so radiance scatters once per GROUP, not once per bounce (and
        # not at all before the first compaction)
        acc = acc + jnp.where(live[:, None], tp * direct, 0.0)
        live = (
            live
            & survive
            & pdf_ok
            & nxt.hit
            & ~_emissive(nxt.emit)  # indirect discards emitter hits (:813-815)
        )
        w = cos_o / jnp.maximum(pdf * p_rr, 1e-30)
        state = {"hit": nxt, "live": live, "tp": tp * fr * w[:, None],
                 "pixel": pixel}
        return (state, acc), None

    b0 = 0
    compacted = False
    for g in range(n_groups):
        cap = min(_align_up(int(n_lanes * compact_schedule[g]), 256), n_lanes)
        if cap < state["pixel"].shape[0]:
            perm, n_live = compact_perm(state["live"], cap)
            dropped = dropped + jnp.maximum(n_live - cap, 0)
            state = jax.tree_util.tree_map(lambda a: a[perm], state)
            # slots beyond n_live alias lane 0 — mask them dead
            state["live"] = state["live"] & (
                jnp.arange(cap, dtype=jnp.int32) < n_live
            )
            compacted = True

        acc0 = jnp.zeros((state["pixel"].shape[0], 3))
        (state, acc), _ = jax.lax.scan(
            bounce,
            (state, acc0),
            jnp.arange(b0, b0 + per_group[g], dtype=jnp.int32),
        )
        if compacted:
            radiance = radiance.at[state["pixel"]].add(acc)
        else:
            radiance = radiance + acc
        b0 += per_group[g]
    if with_stats:
        return radiance, {"dropped_lanes": dropped}
    return radiance


def _blocked_path_trace(scene, orig, d, key, p_rr, max_bounces, block, chunk,
                        block_offset=0, compact_schedule=(1.0, 0.55, 0.3, 0.18, 0.1, 0.07)):
    """path_trace mapped over fixed-size lane blocks to bound the
    (lanes x primitives) working set (the wavefront analog of the
    reference's 16x16 TBB pixel tiles, PathTracing.cpp:44-46).

    `block_offset` keys the RNG by ABSOLUTE block index so a lane range
    processed on one device of a sharded mesh reproduces the monolithic
    render bit-for-bit (parallel/render.py)."""
    n = orig.shape[0]
    if n <= block:
        return path_trace(
            scene, orig, d, jax.random.fold_in(key, block_offset),
            p_rr, max_bounces, chunk, compact_schedule,
        )
    pad = (-n) % block
    if pad:
        orig = jnp.pad(orig, ((0, pad), (0, 0)))
        d = jnp.pad(d, ((0, pad), (0, 0)), constant_values=1.0)
    nb = (n + pad) // block
    ob = orig.reshape(nb, block, 3)
    db = d.reshape(nb, block, 3)
    bids = jnp.arange(nb, dtype=jnp.int32) + block_offset

    def one(args):
        o, dd, bi = args
        return path_trace(
            scene, o, dd, jax.random.fold_in(key, bi), p_rr, max_bounces,
            chunk, compact_schedule,
        )

    out = jax.lax.map(one, (ob, db, bids))
    return out.reshape(-1, 3)[:n]


@functools.partial(
    jax.jit,
    static_argnames=(
        "width", "height", "spp", "p_rr", "max_bounces", "block", "chunk",
        "compact_schedule",
    ),
)
def path_render(
    scene: RTScene,
    width: int,
    height: int,
    fovy: float,
    key,
    spp: int = 16,
    p_rr: float = 0.8,
    max_bounces: int = 16,
    block: int = 1 << 16,
    chunk: int = 512,
    compact_schedule=(1.0, 0.55, 0.3, 0.18, 0.1, 0.07),
):
    """Render one frame: mean over `spp` stochastic samples of the same
    deterministic primary rays (PathTracing.cpp:62-77). Returns (H,W,3)
    float radiance (pre-clamp; Tools::normalizedToRGB applies at I/O)."""
    orig, d = camera_rays(scene.eye, fovy, width, height)
    acc = path_render_accumulate(
        scene, orig, d, key, jnp.zeros((width * height, 3)), 0, spp,
        p_rr=p_rr, max_bounces=max_bounces, block=block, chunk=chunk,
        compact_schedule=compact_schedule,
    )
    return (acc / float(spp)).reshape(height, width, 3)


@functools.partial(
    jax.jit,
    static_argnames=("n_samples", "p_rr", "max_bounces", "block", "chunk",
                     "compact_schedule"),
)
def path_render_accumulate(
    scene: RTScene,
    orig,
    d,
    key,
    acc,
    start_sample,
    n_samples: int,
    p_rr: float = 0.8,
    max_bounces: int = 16,
    block: int = 1 << 16,
    chunk: int = 512,
    compact_schedule=(1.0, 0.55, 0.3, 0.18, 0.1, 0.07),
):
    """Add `n_samples` fresh per-lane samples into the running sum image
    `acc` (N,3). Sample indices [start_sample, start_sample+n_samples)
    key the RNG, so progressive / resumed / spp-sharded renders reproduce
    the monolithic render exactly (SURVEY.md 5.4: the spp accumulator IS
    the checkpoint and the multi-device merge format)."""

    def body(acc, s):
        ks = jax.random.fold_in(key, start_sample + s)
        rad = _blocked_path_trace(scene, orig, d, ks, p_rr, max_bounces,
                                  block, chunk,
                                  compact_schedule=compact_schedule)
        return acc + rad, None

    acc, _ = jax.lax.scan(body, acc, jnp.arange(n_samples, dtype=jnp.int32))
    return acc
