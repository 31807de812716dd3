"""Textured raster demo — the reference README 0x02 scene (spot + crate,
texture shaders, two point lights), rendered to PNG.

Usage: python examples/raster_spot.py [--width 512] [--height 512]
       [--out raster_spot.png] [--degree 140] [--frames 1] [--cpu]
"""

import argparse
import sys
import time

sys.path.insert(0, ".")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--height", type=int, default=512)
    ap.add_argument("--out", default="raster_spot.png")
    ap.add_argument("--degree", type=float, default=140.0)
    ap.add_argument("--frames", type=int, default=1)
    ap.add_argument("--cpu", action="store_true", help="force CPU backend")
    ap.add_argument("--shader", default="TEXTURE",
                    choices=["NORMAL", "TEXTURE", "PHONG", "DISPLACEMENT", "BUMP"])
    args = ap.parse_args()

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    from software_rasterizer_tpu.models import Scene
    from software_rasterizer_tpu.models.lights import PointLight
    from software_rasterizer_tpu.ops.shading import ShaderType
    from software_rasterizer_tpu.render import Primitive, TraditionalRasterizer
    from software_rasterizer_tpu.utils.log import FrameMetrics, emit_metrics

    models = "/root/reference/examples/models"
    stype = ShaderType[args.shader]

    render = TraditionalRasterizer(args.width, args.height)
    scene = Scene("TestScene", eye=(0.0, 0.0, -0.9))
    scene.add_graphic_obj(f"{models}/spot/spot_triangulated_good.obj", "spot",
                          (0, 1, 0), 0.0, (0, 0, 0), (0.3, 0.3, 0.3))
    scene.add_graphic_obj(f"{models}/Crate/Crate1.obj", "Crate",
                          (0, 1, 0), 0.0, (0, 0, 0), (0.2, 0.2, 0.2))
    scene.start_loading_mesh("spot")
    scene.start_loading_mesh("Crate")
    scene.add_shader("spot_shader", f"{models}/spot/spot_texture.png", stype)
    scene.add_shader("crate_shader", f"{models}/Crate/Crate1.png", stype)
    scene.bind_shader_to_mesh("spot", "spot_shader")
    scene.bind_shader_to_mesh("Crate", "crate_shader")
    scene.add_light("Light1", PointLight((0.9, 0.9, -0.9), (100, 100, 100)))
    scene.add_light("Light2", PointLight((0.0, 0.8, 0.9), (50, 50, 50)))
    scene.set_projection_matrix(45.0, 0.1, 100.0)
    render.add_scene(scene)

    fm = FrameMetrics(args.width, args.height)
    degree = args.degree
    for i in range(args.frames):
        scene.set_model_matrix("spot", (0, 1, 0), degree, (0.28, 0.1, 0.20), (0.2,) * 3)
        scene.set_model_matrix("Crate", (0, 1, 0), degree, (0.28, -0.13, 0.15), (0.1,) * 3)
        scene.set_view_matrix((0, 0, -0.9), (0, 0, 0), (0, 1, 0))
        scene.set_projection_matrix(45.0, 0.1, 100.0)
        render.clear()
        t0 = time.perf_counter()
        render.display(Primitive.TRIANGLES)
        fm.add_frame(time.perf_counter() - t0)
        degree += 10.0

    render.save(args.out)
    emit_metrics({"demo": "raster_spot", **fm.summary()})
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
