"""Bunny Whitted ray tracing — the reference README's 0x03 walkthrough
scene (README.md:280-368): Stanford bunny + diffuse sphere + glass
sphere, camera at (0,0,+0.9), two point lights.

Note the reference Whitted integrator ignores `m_lights` (it samples
emissive OBJECTS only, Scene.cpp:512-527), so with no emissive object in
this scene the direct term is black and the image shows silhouettes over
the sky background — faithful to the reference's raytrace-bunny GIF.

The GIF golden contains ONLY the bunny. The README walkthrough's two
spheres sit ~0.01 NDC units from the camera in the post-projective trace
space (radius 0.1 is not projection-compressed while the 0.9 eye gap
is), so they engulf the view — rendered faithfully with --with-spheres.

Usage: python examples/bunny_whitted.py [--width 256] [--height 256]
       [--out bunny.png] [--cpu] [--with-spheres]
"""

import argparse
import sys
import time

sys.path.insert(0, ".")


def build_scene(with_spheres: bool = False):
    from software_rasterizer_tpu.models import (
        Material,
        MaterialType,
        PointLight,
        Scene,
        SphereObject,
    )

    models = "/root/reference/examples/models"
    scene = Scene(
        "BunnyScene",
        eye=(0.0, 0.0, 0.9),
        center=(0.0, 0.0, 0.0),
        up=(0.0, 1.0, 0.0),
        background=(0.843137, 0.67451, 0.235294),  # BGR literal -> RGB
    )

    diffuse = Material(
        type=MaterialType.DIFFUSE_AND_GLOSSY,
        color=(0.8, 0.7, 0.6), Kd=(0.8, 0.7, 0.6),  # BGR -> RGB
        Ka=(0.105,) * 3, Ks=(0.7937,) * 3, specular_exponent=150.0,
    )
    glass = Material(type=MaterialType.REFLECTION_AND_REFRACTION, ior=1.49)
    bunny_mat = Material(
        type=MaterialType.DIFFUSE_AND_GLOSSY,
        color=(1.0,) * 3, Kd=(1.0,) * 3, Ka=(0.015,) * 3,
        Ks=(0.7937,) * 3, specular_exponent=150.0,
    )

    if with_spheres:
        scene.add_graphic_obj(SphereObject((-0.07, 0.0, 0.0), 0.1, diffuse), "diffuse")
        scene.add_graphic_obj(SphereObject((-0.05, 0.01, 0.0), 0.1, glass), "reflect")
    scene.add_graphic_obj(f"{models}/bunny/bunny.obj", "bunny")
    scene.start_loading_mesh("bunny")
    scene.get_mesh_obj("bunny").material = bunny_mat

    scene.add_light("Light1", PointLight((0.5, -0.4, -0.9), (1, 1, 1)))
    scene.add_light("Light2", PointLight((-0.5, -0.4, -0.9), (1, 1, 1)))
    scene.set_projection_matrix(45.0, 0.1, 100.0)
    # the README walkthrough omits the demo's model transform; this one
    # reproduces the GIF's framing (bunny centered, ~2/3 frame height)
    scene.set_model_matrix("bunny", (0.0, 1.0, 0.0), 0.0,
                           (0.0, -0.04, 0.45), (0.4,) * 3)
    return scene


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--height", type=int, default=256)
    ap.add_argument("--out", default="bunny.png")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--with-spheres", action="store_true")
    args = ap.parse_args()

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    from software_rasterizer_tpu.render import Primitive
    from software_rasterizer_tpu.render.raytracer import RayTracing

    render = RayTracing(args.width, args.height, spp=1)
    scene = build_scene(args.with_spheres)
    render.add_scene(scene)

    t0 = time.time()
    render.display(Primitive.TRIANGLES)
    print(f"rendered in {time.time() - t0:.2f}s (incl. compile)")
    render.save(args.out)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
