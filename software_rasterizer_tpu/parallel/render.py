"""Sharded render drivers: `shard_map` over a ("spp", "tile") RenderMesh
(the multi-device replacement for the reference's single-node TBB tiling,
SURVEY.md 2.9 / 5.8).

Design:
  * geometry (RTScene) is REPLICATED (tiny for the reference workloads);
  * camera-ray lanes are sharded along the mesh's tile axis (whitted:
    along ALL devices — its sample loop is deterministic so the spp axis
    folds into the tile axis);
  * path tracing additionally splits the spp range across the spp axis:
    each device accumulates a partial sum-image keyed by ABSOLUTE sample
    and block indices, then one `psum` over the device interconnect
    merges the shards —
    bit-identical per-sample radiance vs. the single-device render (the
    only fp difference is the final sum's association order);
  * outputs return sharded along lanes (tile axis), so a subsequent
    device-side tonemap/encode stays distributed; `np.asarray` gathers.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from jax import shard_map

from software_rasterizer_tpu.ops.camera import camera_rays
from software_rasterizer_tpu.ops.intersect import RTScene
from software_rasterizer_tpu.ops.path import _blocked_path_trace
from software_rasterizer_tpu.ops.whitted import whitted_trace
from software_rasterizer_tpu.parallel.mesh import RenderMesh


def _replicated_specs(tree):
    return jax.tree_util.tree_map(lambda _: P(), tree)


@functools.partial(
    jax.jit,
    static_argnames=(
        "rmesh", "width", "height", "spp", "p_rr", "max_bounces", "block",
        "chunk",
    ),
)
def sharded_path_render(
    scene: RTScene,
    rmesh: RenderMesh,
    width: int,
    height: int,
    fovy: float,
    key,
    spp: int = 16,
    p_rr: float = 0.8,
    max_bounces: int = 16,
    block: int = 8192,
    chunk: int = 512,
):
    """Path-trace with lanes sharded over `tile` and the spp range over
    `spp`. Returns (H,W,3) mean radiance. Per-sample RNG streams are
    keyed by absolute (sample, lane block), so with the same `block` any
    mesh shape reproduces `ops.path.path_render`'s per-sample radiance;
    the spp psum only changes f32 association.

    Constraints (static-shape sharding): spp % n_spp == 0 and the lane
    count width*height must divide evenly into n_tile * block-aligned
    shards (pad the framebuffer or pick block accordingly).
    """
    mesh = rmesh.mesh
    n_spp, n_tile = rmesh.n_spp, rmesh.n_tile
    n = width * height
    if spp % n_spp:
        raise ValueError(f"spp={spp} not divisible by mesh spp axis {n_spp}")
    if n % n_tile:
        raise ValueError(f"{n} pixels not divisible by tile axis {n_tile}")
    lanes_per = n // n_tile
    spp_per = spp // n_spp
    if lanes_per % block and lanes_per > block:
        raise ValueError("block must divide the per-device lane count")

    orig, d = camera_rays(scene.eye, fovy, width, height)

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(_replicated_specs(scene), P("tile"), P("tile")),
        out_specs=P("tile"),
        check_vma=False,  # scan carries mix invariant inits w/ varying lanes
    )
    def run(sc, o_loc, d_loc):
        tile_i = jax.lax.axis_index("tile")
        spp_i = jax.lax.axis_index("spp")

        # absolute block offset of this device's first lane (aligns the
        # per-block RNG keys with the monolithic blocked render)
        blk0 = tile_i * max(lanes_per // block, 1)

        def body(acc, s):
            abs_s = spp_i * spp_per + s
            ks = jax.random.fold_in(key, abs_s)
            rad = _blocked_path_trace(
                sc, o_loc, d_loc, ks, p_rr, max_bounces, block, chunk,
                block_offset=blk0,
            )
            return acc + rad, None

        acc, _ = jax.lax.scan(
            body, jnp.zeros_like(o_loc), jnp.arange(spp_per, dtype=jnp.int32)
        )
        return jax.lax.psum(acc, "spp")

    img_sum = run(scene, orig, d)
    return (img_sum / float(spp)).reshape(height, width, 3)


@functools.partial(
    jax.jit,
    static_argnames=(
        "rmesh", "width", "height", "spp", "max_depth", "block", "chunk",
        "queue_factor", "queue_shrink", "with_stats", "shade_cap",
        "shadow_bias",
    ),
)
def sharded_whitted_render(
    scene: RTScene,
    rmesh: RenderMesh,
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
    shadow_bias: float = None,
):
    """Whitted render with framebuffer lanes sharded across ALL devices
    (both mesh axes flattened — the integrator is deterministic per lane,
    so there is no sample axis to split). Returns (H,W,3); with
    `with_stats`, (image, stats) where the scalar counters are psummed
    over the mesh and `dropped_px` is the full-frame (H,W) overflow mask
    (each shard's lanes are a contiguous pixel range, so the gathered
    lane-space masks concatenate directly into image order).

    Per-ray RNG identities are keyed by ABSOLUTE lane index (lane_offset),
    so every emitter pick matches the monolithic render bit-for-bit even
    with multiple emissive objects (r1 advisor finding: a shared local
    key correlated picks across shards). The full queue/overflow knob set
    (queue_shrink / shade_cap / shadow_bias) is plumbed through so the
    sharded path has the same capacity semantics as the monolith
    (r4-verdict item 4); `sharded_whitted_render_exact` adds the lossless
    recovery pass."""
    from software_rasterizer_tpu.ops.whitted import SHADOW_BIAS

    if shadow_bias is None:
        shadow_bias = SHADOW_BIAS
    mesh = rmesh.mesh
    n = width * height
    n_dev = rmesh.n_devices
    if n % n_dev:
        raise ValueError(f"{n} pixels not divisible by {n_dev} devices")
    lanes_per = n // n_dev
    n_tile = rmesh.n_tile

    orig, d = camera_rays(scene.eye, fovy, width, height)
    lane_spec = P(("spp", "tile"))
    out_specs = (
        (lane_spec, {"dropped_rays": P(), "rays_main": P(),
                     "rays_shadow": P(), "dropped_px": lane_spec})
        if with_stats else lane_spec
    )

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(_replicated_specs(scene), lane_spec, lane_spec),
        out_specs=out_specs,
        check_vma=False,
    )
    def run(sc, o_loc, d_loc):
        dev = jax.lax.axis_index("spp") * n_tile + jax.lax.axis_index("tile")
        out = whitted_trace(
            sc, o_loc, d_loc, key, spp, max_depth, block, chunk,
            queue_factor, queue_shrink, lane_offset=dev * lanes_per,
            with_stats=with_stats, shade_cap=shade_cap,
            shadow_bias=shadow_bias,
        )
        if not with_stats:
            return out
        img, stats = out
        stats = dict(stats)
        for k in ("dropped_rays", "rays_main", "rays_shadow"):
            stats[k] = jax.lax.psum(stats[k], ("spp", "tile"))
        return img, stats

    out = run(scene, orig, d)
    if not with_stats:
        return out.reshape(height, width, 3)
    img, stats = out
    stats = dict(stats)
    stats["dropped_px"] = stats["dropped_px"].reshape(height, width)
    return img.reshape(height, width, 3), stats


def sharded_whitted_render_exact(
    scene: RTScene,
    rmesh: RenderMesh,
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
    shadow_bias: float = None,
    bucket: int = 2048,
    return_stats: bool = False,
):
    """Overflow-EXACT sharded Whitted render — the distributed analog of
    `ops.whitted.whitted_render_exact` (r4-verdict item 4): pass 1 is the
    capacity-bounded sharded wavefront; when its queues overflowed, the
    dropped root pixels re-trace at LOSSLESS capacity, sharded over all
    devices (`dropped_px` is pixel-indexed, so the patch pass shards
    trivially), and patch into the frame on device. Per-pixel values
    equal the monolithic `whitted_render_exact`'s up to f32
    reassociation (every per-pixel quantity keys off the absolute pixel
    id, never the lane set — tests/test_parallel.py asserts this on an
    overflowing config)."""
    import numpy as np

    from software_rasterizer_tpu.ops.whitted import SHADOW_BIAS, _patch_pixels

    if shadow_bias is None:
        shadow_bias = SHADOW_BIAS
    img, stats = sharded_whitted_render(
        scene, rmesh, width, height, fovy, key, spp, max_depth, block,
        chunk, queue_factor, queue_shrink, with_stats=True,
        shade_cap=shade_cap, shadow_bias=shadow_bias,
    )
    if int(stats["dropped_rays"]) == 0:
        return (img, stats) if return_stats else img
    mask = np.asarray(stats["dropped_px"]).reshape(-1)
    pix = np.nonzero(mask)[0]
    if pix.size == 0:
        return (img, stats) if return_stats else img
    n_dev = rmesh.n_devices
    cap = -(-pix.size // (bucket * n_dev)) * (bucket * n_dev)
    pad = np.zeros(cap, np.int64)
    pad[: pix.size] = pix  # pad lanes re-trace pixel 0; masked in patch
    pid = jnp.asarray(pad, jnp.int32)
    out2 = _sharded_retrace(
        scene, rmesh, width, height, fovy, key, pid, spp, max_depth,
        block, chunk, shade_cap, shadow_bias,
    )
    out = _patch_pixels(
        img.reshape(-1, 3), pid, out2.reshape(-1, 3),
        jnp.asarray(pix.size, jnp.int32),
    ).reshape(height, width, 3)
    return (out, stats) if return_stats else out


@functools.partial(
    jax.jit,
    static_argnames=("rmesh", "width", "height", "spp", "max_depth",
                     "block", "chunk", "shade_cap", "shadow_bias"),
)
def _sharded_retrace(scene, rmesh, width, height, fovy, key, pid, spp,
                     max_depth, block, chunk, shade_cap, shadow_bias):
    """Pass 2 of `sharded_whitted_render_exact`: each device re-traces a
    contiguous slice of the padded dropped-pixel list at lossless queue
    capacity. pixel_ids carry the ABSOLUTE image index, so per-pixel
    values match the monolithic `_retrace_pixels` regardless of which
    device a pixel lands on."""
    orig, d = camera_rays(scene.eye, fovy, width, height)
    lane_spec = P(("spp", "tile"))

    @functools.partial(
        shard_map,
        mesh=rmesh.mesh,
        in_specs=(_replicated_specs(scene), P(), P(), lane_spec),
        out_specs=lane_spec,
        check_vma=False,
    )
    def run(sc, o_full, d_full, pid_loc):
        return whitted_trace(
            sc, o_full[pid_loc], d_full[pid_loc], key, spp, max_depth,
            block, chunk, queue_factor=2 ** max_depth, queue_shrink=1.0,
            pixel_ids=pid_loc, shade_cap=shade_cap,
            shadow_bias=shadow_bias,
        )

    return run(scene, orig, d, pid)


@functools.partial(
    jax.jit,
    static_argnames=("rmesh", "height", "width", "active_types", "cull"),
)
def sharded_raster_render(
    geom,
    frame,
    rmesh: RenderMesh,
    height: int,
    width: int,
    active_types=None,
    cull: bool = True,
):
    """Rasterize with framebuffer ROWS sharded across ALL devices (both
    mesh axes flattened — the pipeline is deterministic, so like whitted
    there is no sample axis to split). Returns (image (H,W,3), zbuf
    (H,W)), each sharded along rows.

    The multi-device analog of the reference's TBB row partitioning
    (Rasterizer.cpp:217-236): geometry (vertex stage + triangle setup +
    binning inputs) is replicated — tiny for the reference workloads —
    and each device rasterizes absolute rows [dev*sh, (dev+1)*sh) via
    `render_raster_frame(row0=...)`. Every per-pixel f32 op sees the
    same operands as the monolithic render, so reassembly is BIT-EXACT
    (asserted by tests/test_parallel.py); no communication at all until
    the caller gathers the image."""
    from software_rasterizer_tpu.ops.raster import render_raster_frame

    n_dev = rmesh.n_devices
    if height % n_dev:
        raise ValueError(f"height {height} not divisible by {n_dev} devices")
    shard_h = height // n_dev
    n_tile = rmesh.n_tile

    # the tile height must not exceed the shard height, or every device
    # rasterizes a full 128-row tile and slices its shard out
    tile = (min(128, max(8, shard_h)), 128)

    def run(g, fr):
        dev = jax.lax.axis_index("spp") * n_tile + jax.lax.axis_index("tile")
        img, zb = render_raster_frame(
            g, fr, shard_h, width, tile=tile, cull=cull,
            active_types=active_types, row0=dev * shard_h,
        )
        return img, zb

    run_sm = shard_map(
        run, mesh=rmesh.mesh,
        in_specs=(_replicated_specs(geom), _replicated_specs(frame)),
        out_specs=(P(("spp", "tile")), P(("spp", "tile"))),
        check_vma=False,
    )
    return run_sm(geom, frame)
