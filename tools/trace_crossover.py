#!/usr/bin/env python3
"""Where does the Pallas trace kernel beat the XLA chunk sweep end to end?

On a GPU, renders the same frame with `ops.intersect._trace_tris` forced
to each backend (both programs compiled ahead of time, then timed in
turns: XLA, kernel, kernel, XLA; every call ends in block_until_ready):

  * path_render at 256x256, 2 spp, on the Cornell box (36 triangles) and
    on the procedural stress surface at 5,120 / 81,920 / 327,680
    triangles;
  * whitted_render at 256x256, depth 5, on Cornell and at 327,680;
  * the PRNG impl: path_render at 256x256, 4 spp, keyed with "rbg" and
    with "threefry2x32".

    python tools/trace_crossover.py [--out chiprun_out/crossover.json]

Prints one line per measurement, tagged with the card's name and power
limit, and writes all numbers to --out.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

W = 256


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def _turns(fns, order):
    import jax

    for f in fns.values():
        jax.block_until_ready(f())
    times = {k: [] for k in fns}
    for k in order:
        t0 = time.perf_counter()
        jax.block_until_ready(fns[k]())
        times[k].append(time.perf_counter() - t0)
    return times


def _compiled(fn, min_tris, rt, fovy, key, **kw):
    """AOT-compile fn(rt, W, W, fovy, key, **kw) with the trace dispatch
    pinned: the jit caches are cleared first, so every nested jit traces
    again under the new KERNEL_MIN_TRIS."""
    import jax

    from software_rasterizer_tpu.ops import intersect

    intersect.KERNEL_MIN_TRIS = min_tris
    jax.clear_caches()
    exe = jax.jit(
        lambda r, f, k: fn(r, W, W, f, k, **kw)
    ).lower(rt, fovy, key).compile()
    return lambda: exe(rt, fovy, key)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "crossover.json"))
    args = ap.parse_args()

    import jax

    if jax.devices()[0].platform != "gpu":
        raise SystemExit("needs a GPU")
    import software_rasterizer_tpu  # noqa: F401
    from software_rasterizer_tpu.ops.intersect import prepare_rt_scene
    from software_rasterizer_tpu.ops.path import path_render
    from software_rasterizer_tpu.ops.whitted import whitted_render
    from software_rasterizer_tpu.scenes import build_cornell_scene
    from software_rasterizer_tpu.scenes.stress import build_stress_scene

    card = _card()
    print(f"card: {card}", flush=True)
    rows = []
    scenes = [("cornell", build_cornell_scene)] + [
        (f"stress{lv}", lambda lv=lv: build_stress_scene(levels=lv))
        for lv in (0, 2, 3)
    ]
    key = jax.random.PRNGKey(0)
    for name, build in scenes:
        scene = build()
        scene.set_ndc_matrix(W, W)
        rt = prepare_rt_scene(scene.rt_geometry(), scene.rt_frame())
        n_tri = int(rt.tri_valid.sum())
        jobs = [("path", path_render, dict(spp=2))]
        if name in ("cornell", "stress3"):
            jobs.append(("whitted", whitted_render,
                         dict(spp=1, max_depth=5)))
        for pipe, fn, kw in jobs:
            fns = {
                "xla": _compiled(fn, 1 << 62, rt, scene.fovy, key, **kw),
                "kernel": _compiled(fn, 0, rt, scene.fovy, key, **kw),
            }
            t = _turns(fns, ("xla", "kernel", "kernel", "xla"))
            row = {"pipeline": pipe, "scene": name, "n_tri": n_tri,
                   "frame": f"{W}x{W}", **kw, "xla_s": t["xla"],
                   "kernel_s": t["kernel"], "card": card}
            rows.append(row)
            print(f"{pipe} {name} ({n_tri} tris) [{card}]: XLA "
                  f"{t['xla'][0]:.5f} s, kernel {t['kernel'][0]:.5f} s, "
                  f"kernel {t['kernel'][1]:.5f} s, XLA {t['xla'][1]:.5f} s",
                  flush=True)

    scene = build_cornell_scene()
    scene.set_ndc_matrix(W, W)
    rt = prepare_rt_scene(scene.rt_geometry(), scene.rt_frame())
    fns = {impl: _compiled(path_render, 1 << 62, rt, scene.fovy,
                           jax.random.key(0, impl=impl), spp=4)
           for impl in ("rbg", "threefry2x32")}
    t = _turns(fns, ("rbg", "threefry2x32", "threefry2x32", "rbg"))
    rows.append({"pipeline": "path", "scene": "cornell", "prng": t,
                 "frame": f"{W}x{W}", "spp": 4, "card": card})
    print(f"prng path cornell {W}x{W} @ 4 spp [{card}]: rbg "
          f"{t['rbg'][0]:.5f} s, threefry {t['threefry2x32'][0]:.5f} s, "
          f"threefry {t['threefry2x32'][1]:.5f} s, rbg {t['rbg'][1]:.5f} s",
          flush=True)

    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
