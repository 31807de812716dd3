"""Rasterizer tests: brute-force oracle, z-buffer demo, full textured scene."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from software_rasterizer_tpu.models import Scene
from software_rasterizer_tpu.models.lights import PointLight
from software_rasterizer_tpu.ops.raster import (
    render_colored_triangles,
    render_raster_frame,
    triangle_setup,
)
from software_rasterizer_tpu.ops.shading import ShaderType
from software_rasterizer_tpu.render import Primitive, TraditionalRasterizer
from software_rasterizer_tpu.utils import transforms as tf


def _oracle_coverage(tri, H, W):
    """NumPy brute-force min-z rasterization (reference semantics)."""
    ys, xs = np.mgrid[0:H, 0:W]
    best_z = np.full((H, W), np.inf)
    best_i = np.full((H, W), -1)
    for t in range(tri.shape[0]):
        A, B, C = tri[t]
        d = (B[0] - A[0]) * (C[1] - A[1]) - (B[1] - A[1]) * (C[0] - A[0])
        a = ((B[1] - C[1]) * xs + (C[0] - B[0]) * ys + B[0] * C[1] - C[0] * B[1]) / d
        b = ((C[1] - A[1]) * xs + (A[0] - C[0]) * ys + C[0] * A[1] - A[0] * C[1]) / d
        g = 1 - a - b
        inside = (a > 0) & (a < 1) & (b > 0) & (b < 1) & (g > 0) & (g < 1)
        zz = a * tri[t, 0, 2] + b * tri[t, 1, 2] + g * tri[t, 2, 2]
        upd = inside & (zz < best_z)
        best_z[upd] = zz[upd]
        best_i[upd] = t
    return best_i, best_z


def test_zbuffer_demo_matches_oracle():
    H = W = 160
    rng = np.random.RandomState(3)
    # 8 random triangles across the screen with varying depth
    tri = rng.rand(8, 3, 3).astype(np.float32)
    tri[..., 0] *= W
    tri[..., 1] *= H
    col = rng.rand(8, 3, 3).astype(np.float32)
    img, z = render_colored_triangles(
        jnp.asarray(tri), jnp.asarray(col), jnp.ones(8, bool), H, W, tile=(32, 128)
    )
    z = np.asarray(z)
    oi, oz = _oracle_coverage(tri, H, W)
    assert ((z < np.inf) == (oi >= 0)).all()
    np.testing.assert_allclose(
        np.where(np.isfinite(z), z, 0), np.where(oi >= 0, oz, 0), atol=2e-3
    )


def test_triangle_setup_barycentric_sum():
    tri = np.array([[[10, 10, 1], [50, 12, 2], [30, 60, 3]]], np.float32)
    coef, zrow = triangle_setup(jnp.asarray(tri[..., :2]), jnp.asarray(tri[..., 2]))
    # at the centroid, alpha=beta=gamma=1/3 and z = mean
    cx, cy = tri[0, :, 0].mean(), tri[0, :, 1].mean()
    p = np.array([cx, cy, 1.0])
    a = float(np.dot(np.asarray(coef)[0, 0], p))
    b = float(np.dot(np.asarray(coef)[0, 1], p))
    assert np.isclose(a, 1 / 3, atol=1e-5) and np.isclose(b, 1 / 3, atol=1e-5)
    assert np.isclose(float(np.asarray(zrow)[0] @ p), 2.0, atol=1e-5)


@pytest.fixture(scope="module")
def demo_scene(models_dir):
    scene = Scene("TestScene", eye=(0.0, 0.0, -0.9))
    scene.add_graphic_obj(
        str(models_dir / "spot" / "spot_triangulated_good.obj"),
        "spot", (0, 1, 0), 0.0, (0.0, 0.0, 0.0), (0.3, 0.3, 0.3),
    )
    scene.add_graphic_obj(
        str(models_dir / "Crate" / "Crate1.obj"),
        "Crate", (0, 1, 0), 0.0, (0.0, 0.0, 0.0), (0.2, 0.2, 0.2),
    )
    scene.start_loading_mesh("spot")
    scene.start_loading_mesh("Crate")
    scene.add_shader(
        "spot_shader", str(models_dir / "spot" / "spot_texture.png"), ShaderType.TEXTURE
    )
    scene.add_shader(
        "crate_shader", str(models_dir / "Crate" / "Crate1.png"), ShaderType.TEXTURE
    )
    scene.bind_shader_to_mesh("spot", "spot_shader")
    scene.bind_shader_to_mesh("Crate", "crate_shader")
    scene.add_light("Light1", PointLight((0.9, 0.9, -0.9), (100, 100, 100)))
    scene.add_light("Light2", PointLight((0.0, 0.8, 0.9), (50, 50, 50)))
    scene.set_projection_matrix(45.0, 0.1, 100.0)
    return scene


def test_textured_scene_renders(demo_scene):
    render = TraditionalRasterizer(128, 128, tile=(64, 128), chunk=512)
    render.add_scene(demo_scene)
    demo_scene.set_model_matrix("spot", (0, 1, 0), 140.0, (0.28, 0.1, 0.20), (0.2,) * 3)
    demo_scene.set_model_matrix("Crate", (0, 1, 0), 40.0, (0.28, -0.13, 0.15), (0.1,) * 3)
    render.clear()
    img = render.display(Primitive.TRIANGLES)
    covered = (render.zbuffer < np.inf)
    assert covered.sum() > 100, "objects must cover some pixels"
    assert img.max() > 10, "image must not be black"
    assert np.isfinite(render.frame).all()
    # textured fragments should NOT be monochrome
    px = render.frame[covered]
    assert px.std(axis=0).max() > 0.01


def test_shader_types_change_output(demo_scene):
    # NORMAL shader visualizes normals: output differs from TEXTURE render
    render = TraditionalRasterizer(96, 96, tile=(32, 128))
    render.add_scene(demo_scene)
    demo_scene.set_model_matrix("spot", (0, 1, 0), 140.0, (0.28, 0.1, 0.20), (0.2,) * 3)
    demo_scene.set_model_matrix("Crate", (0, 1, 0), 40.0, (0.28, -0.13, 0.15), (0.1,) * 3)
    render.clear()
    tex_img = render.display().copy()
    for name in ("spot", "Crate"):
        demo_scene.get_mesh_obj(name).shader.type = int(ShaderType.NORMAL)
    render.invalidate()
    render.clear()
    normal_img = render.display()
    assert (tex_img != normal_img).any()
    # restore
    for name in ("spot", "Crate"):
        demo_scene.get_mesh_obj(name).shader.type = int(ShaderType.TEXTURE)
    render.invalidate()


def test_wireframe_runs(demo_scene):
    render = TraditionalRasterizer(96, 96)
    render.add_scene(demo_scene)
    render.clear()
    img = render.display(Primitive.LINES)
    assert (render.zbuffer < np.inf).sum() > 50


def test_backface_culling_reduces_coverage(demo_scene):
    geom = demo_scene.raster_geometry()
    frame = demo_scene.raster_frame()
    img_c, z_c = render_raster_frame(geom, frame, 96, 96, tile=(32, 128), cull=True)
    img_n, z_n = render_raster_frame(geom, frame, 96, 96, tile=(32, 128), cull=False)
    c_cov = int((np.asarray(z_c) < np.inf).sum())
    n_cov = int((np.asarray(z_n) < np.inf).sum())
    assert 0 < c_cov <= n_cov


def test_draw_batch_matches_sequential(demo_scene):
    """draw_batch (one lax.map dispatch over K frames — the amortized
    production frame loop) must be BIT-IDENTICAL per frame to draw() of
    the same matrices (deterministic pipeline, same program per frame)."""
    render = TraditionalRasterizer(128, 128, tile=(64, 128), chunk=512)
    render.add_scene(demo_scene)

    frames, goldens = [], []
    for i in range(3):
        demo_scene.set_model_matrix(
            "spot", (0, 1, 0), 140.0 + 25.0 * i, (0.28, 0.1, 0.20), (0.2,) * 3
        )
        demo_scene.set_model_matrix(
            "Crate", (0, 1, 0), 40.0 + 25.0 * i, (0.28, -0.13, 0.15), (0.1,) * 3
        )
        frames.append(demo_scene.raster_frame())
        render.clear()
        render.draw(Primitive.TRIANGLES)
        goldens.append((render.frame.copy(), render.zbuffer.copy()))

    imgs, zbufs = render.draw_batch(demo_scene, frames)
    imgs, zbufs = np.asarray(imgs), np.asarray(zbufs)
    assert imgs.shape == (3, 128, 128, 3)
    for i, (gimg, gz) in enumerate(goldens):
        assert np.array_equal(imgs[i], gimg), f"frame {i} image differs"
        assert np.array_equal(zbufs[i], gz), f"frame {i} zbuf differs"
