"""Cornell Box path tracing — the README's path-tracing walkthrough
(README.md:478-560: PathTracing render, Cornell parts, 16-2048 spp).

Usage: python examples/cornell_pt.py [--width 256] [--height 256]
       [--spp 16] [--out cornell.png] [--cpu] [--ckpt PATH]
       [--batch N]   (renders progressively in N-sample batches)
       [--config cfg.json]  (RenderConfig JSON; CLI flags override)
       [--tiles N]   (render via N restartable tile jobs with retries)
"""

import argparse
import sys
import time

sys.path.insert(0, ".")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--height", type=int, default=256)
    ap.add_argument("--spp", type=int, default=16)
    ap.add_argument("--batch", type=int, default=0,
                    help="progressive batch size (0 = single shot)")
    ap.add_argument("--out", default="cornell.png")
    ap.add_argument("--ckpt", default="", help="checkpoint path for resume")
    ap.add_argument("--config", default="", help="RenderConfig JSON file")
    ap.add_argument("--tiles", type=int, default=0,
                    help="render as N restartable tile jobs (TileJobRunner)")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    from software_rasterizer_tpu.config import RenderConfig
    from software_rasterizer_tpu.render import Primitive, pipeline_from_config
    from software_rasterizer_tpu.scenes import build_cornell_scene

    # config layer: file defaults, CLI overrides (SURVEY.md 5.6)
    if args.config:
        with open(args.config) as f:
            cfg = RenderConfig.from_json(f.read())
    else:
        cfg = RenderConfig()
    cfg.width, cfg.height, cfg.spp = args.width, args.height, args.spp
    render = pipeline_from_config(cfg, "path")
    scene = build_cornell_scene()
    render.add_scene(scene)

    t0 = time.time()
    if args.tiles:
        import numpy as np

        from software_rasterizer_tpu.ops.camera import camera_rays
        from software_rasterizer_tpu.ops.path import path_render_accumulate
        from software_rasterizer_tpu.parallel.jobs import TileJobRunner
        from software_rasterizer_tpu.utils.rng import make_key

        import jax
        import jax.numpy as jnp

        rt = render._rt_scene(scene)
        n = args.width * args.height
        orig, d = camera_rays(rt.eye, scene.fovy, args.width, args.height)
        key = make_key(cfg.seed)

        def render_tile(start, count):
            o = jax.lax.dynamic_slice(orig, (start, 0), (count, 3))
            dd = jax.lax.dynamic_slice(d, (start, 0), (count, 3))
            # per-tile key: decorrelates RNG streams across tiles
            acc = path_render_accumulate(
                rt, o, dd, jax.random.fold_in(key, start),
                jnp.zeros((count, 3)), 0, args.spp,
                p_rr=scene.rr, max_bounces=cfg.max_bounces,
                block=min(count, 1 << 16),
            )
            return np.asarray(acc) / args.spp

        # TileJobRunner needs tile_lanes | n_lanes: round the requested
        # tile count to the nearest-from-below divisor of n
        tiles = max(1, min(args.tiles, n))
        while n % tiles:
            tiles -= 1
        if tiles != args.tiles:
            print(f"# tiles {args.tiles} does not divide {n} lanes; "
                  f"using {tiles}")
        runner = TileJobRunner(n, n // tiles)
        img = runner.run(render_tile,
                         on_progress=lambda k, m: print(f"tile {k}/{m}"))
        render.frame = img.reshape(args.height, args.width, 3)
    elif args.batch:
        import os

        if args.ckpt and os.path.exists(args.ckpt):
            render.load_checkpoint(scene.name, args.ckpt)
            print(f"resumed at {render.samples_done(scene.name)} spp")
        while render.samples_done(scene.name) < args.spp:
            n = min(args.batch, args.spp - render.samples_done(scene.name))
            render.accumulate(scene.name, n)
            done = render.samples_done(scene.name)
            print(f"{done}/{args.spp} spp, {time.time() - t0:.1f}s")
            if args.ckpt:
                render.save_checkpoint(scene.name, args.ckpt)
        render.resolve(scene.name)
    else:
        render.draw(Primitive.TRIANGLES)
    dt = time.time() - t0

    n_paths = args.width * args.height * args.spp
    print(f"{args.width}x{args.height} @ {args.spp} spp in {dt:.2f}s "
          f"({n_paths / dt / 1e6:.2f} Mpaths/s incl. compile)")
    render.save(args.out)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
