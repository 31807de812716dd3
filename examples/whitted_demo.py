"""Whitted ray-tracing demo — the reference's main.cpp scene: glass sphere
(ior 1.49) + diffuse sphere + sphere light + textured spot cow + crate
(main.cpp:12-177).

Usage: python examples/whitted_demo.py [--width 256] [--height 256]
       [--spp 1] [--out whitted.png] [--cpu] [--frames 1]
"""

import argparse
import sys
import time

sys.path.insert(0, ".")


def build_scene():
    from software_rasterizer_tpu.models import (
        Material,
        MaterialType,
        Scene,
        SphereLight,
        SphereObject,
    )
    from software_rasterizer_tpu.ops.shading import ShaderType

    models = "/root/reference/examples/models"
    scene = Scene(
        "TestScene",
        eye=(0.0, 0.0, -0.9),
        center=(0.0, 0.0, 0.0),
        up=(0.0, 1.0, 0.0),
        background=(0.235294, 0.67451, 0.843137),
    )

    diffuse = Material(
        type=MaterialType.DIFFUSE_AND_GLOSSY,
        Ka=(0.005,) * 3, Kd=(1.0,) * 3, Ks=(0.7937,) * 3, specular_exponent=150.0,
    )
    spot = Material(
        type=MaterialType.DIFFUSE_AND_GLOSSY,
        Ka=(0.005,) * 3, Kd=(1.0,) * 3, Ks=(0.7937,) * 3, specular_exponent=150.0,
    )
    crate = Material(
        type=MaterialType.DIFFUSE_AND_GLOSSY,
        Ka=(0.005,) * 3, Kd=(1.0,) * 3, Ks=(0.7937,) * 3, specular_exponent=150.0,
    )
    light_mat = Material(
        type=MaterialType.DIFFUSE_AND_GLOSSY, Kd=(1.0,) * 3, emission=(1.0, 1.0, 1.0)
    )
    glass = Material(type=MaterialType.REFLECTION_AND_REFRACTION, ior=1.49)

    scene.add_graphic_obj(SphereObject((0, 0, 0), 1.0, glass), "refrflect")
    scene.add_graphic_obj(SphereObject((0, 0, 0), 1.0, diffuse), "diffuse")
    scene.add_graphic_obj(SphereLight((0, 0, 0), (1, 1, 1), 5.0, light_mat), "spherelight")

    scene.add_graphic_obj(f"{models}/spot/spot_triangulated_good.obj", "spot",
                          (0, 1, 0), 0.0, (0, 0, 0), (0.3,) * 3)
    scene.add_graphic_obj(f"{models}/Crate/Crate1.obj", "Crate",
                          (0, 1, 0), 0.0, (0, 0, 0), (0.2,) * 3)
    scene.start_loading_mesh("spot")
    scene.start_loading_mesh("Crate")
    scene.get_mesh_obj("spot").material = spot
    scene.get_mesh_obj("Crate").material = crate
    scene.add_shader("spot_shader", f"{models}/spot/spot_texture.png", ShaderType.TEXTURE)
    scene.add_shader("crate_shader", f"{models}/Crate/Crate1.png", ShaderType.TEXTURE)
    scene.bind_shader_to_mesh("spot", "spot_shader")
    scene.bind_shader_to_mesh("Crate", "crate_shader")
    return scene


def set_frame_matrices(scene, degree: float):
    scene.set_model_matrix("spot", (0, 1, 0), degree, (0.28, 0.1, 0.20), (0.2,) * 3)
    scene.set_model_matrix("Crate", (0, 1, 0), degree, (0.28, -0.13, 0.15), (0.1,) * 3)
    scene.set_model_matrix("refrflect", (0, 1, 0), 0, (0.0, 0.0, 0.15), (0.2,) * 3)
    scene.set_model_matrix("diffuse", (0, 1, 0), 0, (-0.25, 0.1, 0.15), (0.1,) * 3)
    scene.set_model_matrix("spherelight", (0, 1, 0), 0, (0.0, 0.3, -0.7), (0.3,) * 3)
    scene.set_view_matrix((0, 0, -0.9), (0, 0, 0), (0, 1, 0))
    scene.set_projection_matrix(45.0, 0.1, 100.0)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--height", type=int, default=256)
    ap.add_argument("--spp", type=int, default=1)
    ap.add_argument("--frames", type=int, default=1)
    ap.add_argument("--out", default="whitted.png")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    from software_rasterizer_tpu.render import Primitive
    from software_rasterizer_tpu.render.raytracer import RayTracing
    from software_rasterizer_tpu.utils.log import FrameMetrics, emit_metrics

    render = RayTracing(args.width, args.height, spp=args.spp)
    scene = build_scene()
    render.add_scene(scene)

    fm = FrameMetrics(args.width, args.height)
    degree = 0.0
    for _ in range(args.frames):
        set_frame_matrices(scene, degree)
        render.clear()
        t0 = time.perf_counter()
        render.display(Primitive.TRIANGLES)
        fm.add_frame(time.perf_counter() - t0)
        degree += 10.0
    render.save(args.out)
    emit_metrics({"demo": "whitted", **fm.summary()})
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
