#!/usr/bin/env python3
"""On-card smoke test: the three render pipelines on one NVIDIA GPU.

    python chip_smoke.py          # one card: phases 1-4
    python chip_smoke.py --four   # four cards: the sharded renders only

Phases (one process, nothing caught and carried on — any failure exits
non-zero before the final line):

  1. device: JAX platform, device kind and count, and the card's name and
     power limit from nvidia-smi (run in a child that does not import JAX);
  2. correctness: the CPU-made goldens of tests/test_goldens.py, rendered
     on the card with the same calls and the same tolerances;
  3. full size: PathTracing, RayTracing and TraditionalRasterizer on the
     Cornell box at 1024x1024 through their draw() entry points;
  4. trace kernel: ops/trace_kernel against the XLA chunk sweep on the 1M
     Cornell primary rays and on 262,144 rays into the procedural
     327,680-triangle stress scene — winner agreement with every
     mismatch classified, and both timings taken in turns.

`--four` runs the sharded path (2x2 ("spp", "tile") mesh, 1024^2 @ 16
spp) against single-card path_render, and the row-sharded raster against
the single-card frame, and nothing else.

The last line of standard output is one JSON object,
{"ok": true, "device": {"platform", "kind", "count"}}. The script fails
at once when JAX finds no GPU; it never falls back to the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDENS = os.path.join(ROOT, "tests", "goldens", "cornell_goldens.npz")
FULL = 1024


def log(msg: str) -> None:
    print(msg, flush=True)


def card_name_and_power() -> str:
    """`name, power.limit` of the first card, from a child process that
    does not import JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def check_goldens(raster_img, raster_z, whitted_img, path_img, goldens):
    """The rules of tests/test_goldens.py as (name, value, limit, ok) rows.

    raster: coverage may differ on under 1% of pixels (edge slivers);
    covered pixels within rtol/atol 1e-3 (float32 reassociation).
    whitted: >= 99.5% of values within rtol/atol 5e-3 (a few shadow
    knife-edge pixels flip between backends).
    path: clipped image mean within 0.03 of the golden mean (a 48^2 @ 8
    spp Monte-Carlo estimate; the RNG stream is the same, the float32
    rounding is not)."""
    got_cov = np.isfinite(raster_z)
    want_cov = np.isfinite(goldens["raster_z"])
    cov_mismatch = float((got_cov != want_cov).mean())
    both = got_cov & want_cov
    want = goldens["raster"]
    raster_ok = bool(np.allclose(raster_img[both], want[both],
                                 rtol=1e-3, atol=1e-3))
    raster_err = float(np.abs(raster_img[both] - want[both]).max())
    close = float(np.isclose(whitted_img, goldens["whitted"],
                             rtol=5e-3, atol=5e-3).mean())
    mean = float(np.clip(path_img, 0.0, 1.0).mean())
    dmean = abs(mean - float(goldens["path_mean"]))
    return [
        ("raster_coverage_mismatch", cov_mismatch, 0.01,
         cov_mismatch < 0.01),
        ("raster_covered_max_abs_err", raster_err, 1e-3, raster_ok),
        ("whitted_close_frac", close, 0.995, close > 0.995),
        ("path_mean_abs_diff", dmean, 0.03, dmean < 0.03),
    ]


def phase_goldens(tag: str) -> None:
    import jax
    import jax.numpy as jnp

    from software_rasterizer_tpu.ops.intersect import prepare_rt_scene
    from software_rasterizer_tpu.ops.path import path_render
    from software_rasterizer_tpu.ops.raster import render_raster_frame
    from software_rasterizer_tpu.ops.whitted import whitted_render
    from software_rasterizer_tpu.scenes import build_cornell_scene

    scene = build_cornell_scene()
    scene.set_ndc_matrix(96, 96)
    geom = jax.tree_util.tree_map(jnp.asarray, scene.raster_geometry())
    img, z = render_raster_frame(geom, scene.raster_frame(), 96, 96)
    raster_img, raster_z = np.asarray(img), np.asarray(z)

    scene = build_cornell_scene()
    scene.set_ndc_matrix(64, 64)
    rt = prepare_rt_scene(scene.rt_geometry(), scene.rt_frame())
    whitted_img = np.asarray(whitted_render(
        rt, 64, 64, scene.fovy, jax.random.PRNGKey(0), spp=1, max_depth=4))

    scene = build_cornell_scene()
    scene.set_ndc_matrix(48, 48)
    rt = prepare_rt_scene(scene.rt_geometry(), scene.rt_frame())
    path_img = np.asarray(path_render(
        rt, 48, 48, scene.fovy, jax.random.PRNGKey(0), spp=8))

    rows = check_goldens(raster_img, raster_z, whitted_img, path_img,
                         np.load(GOLDENS))
    for name, value, limit, ok in rows:
        log(f"  golden {name}: {value:.6g} (limit {limit}) "
            f"{'ok' if ok else 'FAIL'}")
    failed = [r[0] for r in rows if not r[3]]
    if failed:
        raise SystemExit(f"golden comparison failed: {failed}")


def _peak_bytes(dev) -> int:
    return int(dev.memory_stats()["peak_bytes_in_use"])


def phase_full_size(tag: str, dev) -> None:
    from software_rasterizer_tpu.render import (
        PathTracing,
        RayTracing,
        TraditionalRasterizer,
    )
    from software_rasterizer_tpu.scenes import build_cornell_scene

    pipelines = [
        ("path", PathTracing(FULL, FULL, spp=16)),
        ("whitted", RayTracing(FULL, FULL, spp=16, max_depth=5)),
        ("raster", TraditionalRasterizer(FULL, FULL)),
    ]
    for name, pipe in pipelines:
        scene = build_cornell_scene()
        scene.set_ndc_matrix(FULL, FULL)
        pipe.add_scene(scene)
        t0 = time.perf_counter()
        pipe.draw()          # compile + render; ends in a host copy
        first = time.perf_counter() - t0
        pipe.clear()
        t0 = time.perf_counter()
        pipe.draw()
        warm = time.perf_counter() - t0
        frame = np.asarray(pipe.frame)
        finite = bool(np.isfinite(frame).all())
        # raster: pixels the z-buffer covers (Cornell has no point light
        # for the raster shaders, so its colors are black); ray pipelines:
        # non-black pixels
        covered = (np.isfinite(pipe.zbuffer) if name == "raster"
                   else np.abs(frame).sum(-1) > 0)
        coverage = float(covered.mean())
        mean = float(np.clip(frame, 0.0, 1.0).mean())
        log(f"  {name} {FULL}x{FULL} [{tag}]: first call (compile + "
            f"render) {first:.3f} s, compile ~{first - warm:.3f} s, warm "
            f"render {warm:.4f} s, peak_bytes_in_use {_peak_bytes(dev)}, "
            f"finite {finite}, coverage {coverage:.4f}, "
            f"clipped mean {mean:.5f}")
        if not finite or coverage <= 0.0:
            raise SystemExit(f"{name}: non-finite or empty frame")


def _time_turns(fns, args, turns):
    """Warm each fn, then time one call per entry of `turns` (fn names,
    in order); every call ends in block_until_ready."""
    import jax

    outs = {k: jax.block_until_ready(f(*args)) for k, f in fns.items()}
    times = {k: [] for k in fns}
    for k in turns:
        t0 = time.perf_counter()
        jax.block_until_ready(fns[k](*args))
        times[k].append(time.perf_counter() - t0)
    return outs, times


def _kernel_vs_xla(label: str, tag: str, rt, orig, d) -> None:
    import jax

    from software_rasterizer_tpu.ops.intersect import (
        _intersect_tri_raw,
        map_ray_blocks,
    )
    from software_rasterizer_tpu.ops.trace_kernel import trace_nearest
    from software_rasterizer_tpu.utils.trace_check import (
        classify_mismatches,
    )

    def xla(o, dd):
        return map_ray_blocks(
            lambda a, b: _intersect_tri_raw(a, b, rt.v0, rt.v1, rt.v2,
                                            rt.tri_valid, 512),
            o, dd, 8192)

    def kernel(o, dd):
        return trace_nearest(rt.tri_edges, rt.chunk_lo, rt.chunk_hi, o, dd)

    outs, times = _time_turns(
        {"xla": jax.jit(xla), "kernel": jax.jit(kernel)}, (orig, d),
        ("xla", "kernel", "kernel", "xla"))
    (hx, ix, _), (hk, ik, _) = outs["xla"], outs["kernel"]
    n_tri = int(np.asarray(rt.tri_valid).sum())
    rep = classify_mismatches(np.asarray(orig), np.asarray(d),
                              np.asarray(rt.v0), np.asarray(rt.v1),
                              np.asarray(rt.v2), np.asarray(ik),
                              np.asarray(ix))
    log(f"  trace {label}: {orig.shape[0]} rays x {n_tri} tris, hits "
        f"{int(np.asarray(hx).sum())}; winner agreement "
        f"{rep['agree_frac']:.7f} ({rep['mismatched']} mismatched: "
        f"{rep['ulp_tie']} ULP tie, {rep['knife_edge']} knife-edge, "
        f"{rep['unexplained']} unexplained)")
    log(f"  trace {label} times [{tag}] (XLA, kernel, kernel, XLA): "
        f"XLA {times['xla'][0]:.6f} s, kernel {times['kernel'][0]:.6f} s, "
        f"kernel {times['kernel'][1]:.6f} s, XLA {times['xla'][1]:.6f} s")
    if rep["unexplained"]:
        raise SystemExit(f"trace {label}: {rep['unexplained']} winner "
                         "mismatches are neither ties nor knife edges")


def phase_trace_kernel(tag: str) -> None:
    from software_rasterizer_tpu.ops.camera import camera_rays
    from software_rasterizer_tpu.ops.intersect import prepare_rt_scene
    from software_rasterizer_tpu.scenes import build_cornell_scene
    from software_rasterizer_tpu.scenes.stress import build_stress_scene

    scene = build_cornell_scene()
    scene.set_ndc_matrix(FULL, FULL)
    rt = prepare_rt_scene(scene.rt_geometry(), scene.rt_frame())
    orig, d = camera_rays(rt.eye, scene.fovy, FULL, FULL)
    _kernel_vs_xla("cornell", tag, rt, orig, d)

    scene = build_stress_scene(levels=3)
    scene.set_ndc_matrix(512, 512)
    rt = prepare_rt_scene(scene.rt_geometry(), scene.rt_frame())
    orig, d = camera_rays(rt.eye, scene.fovy, 512, 512)
    _kernel_vs_xla("stress", tag, rt, orig, d)


def phase_four(tag: str) -> None:
    import jax
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from software_rasterizer_tpu.ops.intersect import prepare_rt_scene
    from software_rasterizer_tpu.ops.path import path_render
    from software_rasterizer_tpu.ops.raster import render_raster_frame
    from software_rasterizer_tpu.parallel import (
        make_render_mesh,
        sharded_path_render,
        sharded_raster_render,
    )
    from software_rasterizer_tpu.scenes import build_cornell_scene

    rmesh = make_render_mesh(n_spp=2, n_tile=2, devices=jax.devices()[:4])
    replicated = NamedSharding(rmesh.mesh, P())
    scene = build_cornell_scene()
    scene.set_ndc_matrix(FULL, FULL)
    rt = prepare_rt_scene(scene.rt_geometry(), scene.rt_frame())
    rt_rep = jax.device_put(rt, replicated)
    for leaf in jax.tree_util.tree_leaves(rt_rep):
        if len(leaf.sharding.device_set) != 4 or \
                not leaf.sharding.is_fully_replicated:
            raise SystemExit("scene array not replicated on all 4 cards")
    log("  scene arrays replicated on 4 cards: yes")
    key = jax.random.PRNGKey(7)
    # lane blocks key the RNG: every tile shard must hold whole blocks
    block = min(1 << 16, FULL * FULL // 4)

    def mono():
        return path_render(rt, FULL, FULL, scene.fovy, key, spp=16,
                           block=block)

    def shard():
        return sharded_path_render(rt_rep, rmesh, FULL, FULL, scene.fovy,
                                   key, spp=16, block=block)

    outs, times = _time_turns({"one": mono, "four": shard}, (),
                              ("one", "four", "four", "one"))
    a, b = np.asarray(outs["one"]), np.asarray(outs["four"])
    err = np.abs(b - a)
    rel = float((err / np.maximum(np.abs(a), 1e-30)).max())
    ok = bool(np.allclose(b, a, rtol=3e-5, atol=1e-5))
    log(f"  sharded path 2x2 mesh vs one card, {FULL}^2 @ 16 spp: max abs "
        f"err {float(err.max()):.3g}, max rel err {rel:.3g}, within "
        f"rtol 3e-5 / atol 1e-5: {ok}; output on "
        f"{len(outs['four'].sharding.device_set)} cards")
    log(f"  times [{tag}] (one card, 4 cards, 4 cards, one card): "
        f"{times['one'][0]:.4f} s, {times['four'][0]:.4f} s, "
        f"{times['four'][1]:.4f} s, {times['one'][1]:.4f} s")
    if not ok:
        raise SystemExit("sharded path render differs from one card")

    geom, frame = scene.raster_geometry(), scene.raster_frame()
    active = tuple(sorted(set(int(t) for t in geom.shader_type)))
    img, zb = render_raster_frame(geom, frame, FULL, FULL,
                                  active_types=active)
    img_s, zb_s = sharded_raster_render(geom, frame, rmesh, FULL, FULL,
                                        active_types=active)
    same = (np.array_equal(np.asarray(img_s), np.asarray(img))
            and np.array_equal(np.asarray(zb_s), np.asarray(zb)))
    log(f"  sharded raster 4 row shards vs one card: bit-exact {same}")
    if not same:
        raise SystemExit("sharded raster render differs from one card")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded renders, on four cards")
    args = ap.parse_args()

    import jax

    devs = jax.devices()
    dev = devs[0]
    if dev.platform != "gpu":
        raise SystemExit(f"no GPU: JAX platform is {dev.platform!r}")
    if args.four and len(devs) < 4:
        raise SystemExit(f"--four needs 4 GPUs, JAX sees {len(devs)}")
    sys.path.insert(0, ROOT)
    import software_rasterizer_tpu  # noqa: F401  (fails outside the repo)

    card = card_name_and_power()
    log(f"phase 1 device: platform {dev.platform}, kind {dev.device_kind}, "
        f"count {len(devs)}")
    log(f"card: {card}")
    tag = card
    if args.four:
        log("four-card phase: sharded path and raster")
        phase_four(tag)
    else:
        log("phase 2 goldens")
        phase_goldens(tag)
        log("phase 3 full size")
        phase_full_size(tag, dev)
        log("phase 4 trace kernel")
        phase_trace_kernel(tag)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devs)}}), flush=True)


if __name__ == "__main__":
    main()
