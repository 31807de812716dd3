"""Path tracer tests: Cornell statistical properties, progressive
accumulation determinism, and checkpoint/resume (SURVEY.md section 4:
stochastic goldens compare converged statistics, not pixels)."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from software_rasterizer_tpu.models.scene import Scene
from software_rasterizer_tpu.ops.intersect import prepare_rt_scene
from software_rasterizer_tpu.ops.path import path_render
from software_rasterizer_tpu.render.pathtracer import PathTracing
from software_rasterizer_tpu.render.pipeline import Primitive
from software_rasterizer_tpu.scenes import build_cornell_scene

W = H = 32


@pytest.fixture(scope="module")
def cornell_rt():
    scene = build_cornell_scene()
    scene.set_ndc_matrix(W, H)
    geom = scene.rt_geometry()
    return scene, prepare_rt_scene(geom, scene.rt_frame())


def test_cornell_geometry_counts():
    scene = build_cornell_scene()
    geom = scene.rt_geometry()
    assert int(geom.face_valid.sum()) == 36  # 6 quads*2 + 2 boxes*12
    assert geom.obj_emissive.sum() == 1  # only the light


def test_cornell_render_statistics(cornell_rt):
    scene, rt = cornell_rt
    raw = np.array(
        path_render(rt, W, H, scene.fovy, jax.random.PRNGKey(0), spp=32)
    )
    assert np.isfinite(raw).all()
    assert (raw >= 0).all()
    img = np.clip(raw, 0.0, 1.0)  # Tools::normalizedToRGB clamp
    # the floor (direct NEE light) outshines the ceiling band, which the
    # downward-facing emitter lights only indirectly
    assert img[H // 2 : 3 * H // 4].mean() > img[2 : H // 8].mean()
    # interior receives light: mean well above black
    interior = img[H // 3 : 2 * H // 3, W // 3 : 2 * W // 3]
    assert interior.mean() > 0.05
    # left wall is red: red channel dominates green
    left = img[H // 2, 2:5]
    assert left[:, 0].mean() > 2.0 * left[:, 1].mean()
    # right wall is green: green channel dominates red
    right = img[H // 2, W - 5 : W - 2]
    assert right[:, 1].mean() > 2.0 * right[:, 0].mean()


def test_path_render_deterministic(cornell_rt):
    scene, rt = cornell_rt
    a = path_render(rt, W, H, scene.fovy, jax.random.PRNGKey(7), spp=2)
    b = path_render(rt, W, H, scene.fovy, jax.random.PRNGKey(7), spp=2)
    np.testing.assert_array_equal(np.array(a), np.array(b))


def test_blocked_equals_unblocked(cornell_rt):
    scene, rt = cornell_rt
    a = path_render(rt, W, H, scene.fovy, jax.random.PRNGKey(3), spp=8,
                    block=1 << 16)
    b = path_render(rt, W, H, scene.fovy, jax.random.PRNGKey(3), spp=8,
                    block=W * H // 4)
    # blocked tracing only changes the lane batching, not the math, but
    # block ids key the RNG, so compare clamped statistics (the clamp
    # removes the unbounded-variance NEE fireflies, SURVEY.md 7.3)
    ca = float(jnp.mean(jnp.clip(a, 0.0, 1.0)))
    cb = float(jnp.mean(jnp.clip(b, 0.0, 1.0)))
    assert abs(ca - cb) < 0.05


def test_progressive_accumulation_matches_monolithic():
    pt = PathTracing(W, H, spp=4, seed=11)
    scene = build_cornell_scene()
    pt.add_scene(scene)
    pt.accumulate("CornellBox", 2)
    pt.accumulate("CornellBox", 2)
    progressive = pt.resolve("CornellBox").copy()
    assert pt.samples_done("CornellBox") == 4

    pt2 = PathTracing(W, H, spp=4, seed=11)
    pt2.add_scene(build_cornell_scene())
    pt2.accumulate("CornellBox", 4)
    np.testing.assert_allclose(
        progressive, pt2.resolve("CornellBox"), rtol=1e-5, atol=1e-6
    )


def test_checkpoint_roundtrip(tmp_path):
    pt = PathTracing(W, H, spp=4, seed=5)
    pt.add_scene(build_cornell_scene())
    pt.accumulate("CornellBox", 2)
    ckpt = str(tmp_path / "accum.npz")
    pt.save_checkpoint("CornellBox", ckpt)

    pt2 = PathTracing(W, H, spp=4, seed=5)
    pt2.add_scene(build_cornell_scene())
    pt2.load_checkpoint("CornellBox", ckpt)
    assert pt2.samples_done("CornellBox") == 2
    pt.accumulate("CornellBox", 2)
    pt2.accumulate("CornellBox", 2)
    np.testing.assert_allclose(
        pt.resolve("CornellBox"), pt2.resolve("CornellBox"), rtol=1e-5, atol=1e-6
    )


def test_draw_api(cornell_rt):
    pt = PathTracing(W, H, spp=2)
    pt.add_scene(build_cornell_scene())
    frame = pt.display(Primitive.TRIANGLES)
    assert frame.shape == (H, W, 3) and frame.dtype == np.uint8
    assert frame.max() > 100  # the light is visibly bright


def _oracle_vs_wavefront(rt, fovy, w, pixels, n_samp, max_b=16):
    """Per-pixel means of the wavefront integrator vs a literal scalar
    implementation of the reference recursion (tests/oracle_path.py):
    different RNG streams, so agreement within Monte-Carlo standard
    error plus a small absolute/relative slack."""
    import functools

    from software_rasterizer_tpu.ops.camera import camera_rays
    from software_rasterizer_tpu.ops.path import path_trace

    import oracle_path as op

    s = op.np_scene(rt)
    orig, d = camera_rays(rt.eye, fovy, w, w)
    orig_np, d_np = np.asarray(orig), np.asarray(d)
    lanes = [py * w + px for py, px in pixels]

    rng = np.random.default_rng(123)
    o_mean, o_se = [], []
    for lane in lanes:
        vals = np.array([
            op.path_trace_pixel(s, orig_np[lane], d_np[lane], rng,
                                p_rr=0.8, max_depth=max_b)
            for _ in range(n_samp)
        ])
        o_mean.append(vals.mean(0))
        o_se.append(vals.std(0) / np.sqrt(n_samp))

    pt = jax.jit(functools.partial(path_trace, p_rr=0.8, max_bounces=max_b))
    lo = jnp.asarray(orig_np[lanes])
    ld = jnp.asarray(d_np[lanes])
    acc = np.zeros((len(lanes), 3))
    sq = np.zeros((len(lanes), 3))
    for smp in range(n_samp):
        r = np.asarray(pt(
            rt, lo, ld, jax.random.fold_in(jax.random.PRNGKey(9), smp),
        ))
        acc += r
        sq += r * r
    w_mean = acc / n_samp
    w_se = np.sqrt(np.maximum(sq / n_samp - w_mean**2, 0.0) / n_samp)

    for i, pix in enumerate(pixels):
        se = np.sqrt(np.asarray(o_se[i]) ** 2 + w_se[i] ** 2)
        tol = 5.0 * se + 0.05 + 0.1 * np.abs(o_mean[i])
        assert np.all(np.abs(w_mean[i] - o_mean[i]) < tol), (
            f"pixel {pix}: oracle {o_mean[i]} vs wavefront {w_mean[i]}"
            f" (tol {tol})"
        )
    return np.asarray(o_mean), w_mean


def test_integrator_matches_scalar_oracle(cornell_rt):
    """Wavefront integrator vs the scalar oracle on Cornell pixels: floor,
    left wall, right wall, back wall, tall box."""
    scene, rt = cornell_rt
    _oracle_vs_wavefront(
        rt, scene.fovy, W,
        [(26, 16), (16, 4), (16, 27), (12, 16), (18, 21)], n_samp=500,
    )


def test_variance_decreases_with_spp(cornell_rt):
    """Monte-Carlo convergence: pixel noise shrinks as spp grows."""
    scene, rt = cornell_rt

    def noise(spp, key):
        a = np.array(path_render(rt, W, H, scene.fovy, jax.random.PRNGKey(key), spp=spp))
        b = np.array(path_render(rt, W, H, scene.fovy, jax.random.PRNGKey(key + 100), spp=spp))
        return np.abs(a - b).mean()

    assert noise(16, 1) < noise(1, 2)


def test_path_overflow_accounting(cornell_rt):
    """A schedule tighter than the survival curve must REPORT dropped live
    lanes; the default schedule must report zero on Cornell."""
    scene, rt = cornell_rt
    from software_rasterizer_tpu.ops.camera import camera_rays
    from software_rasterizer_tpu.ops.path import path_trace

    rt = jax.tree_util.tree_map(jnp.asarray, rt)
    orig, d = camera_rays(rt.eye, scene.fovy, 64, 64)
    key = jax.random.PRNGKey(0)
    # pathological: no Russian roulette kill (p_rr=1) and a near-zero
    # capacity (256-lane floor) after ONE bounce, when ~25% of 4096
    # lanes are still live -> guaranteed overflow
    _, stats = path_trace(rt, orig, d, key, p_rr=1.0, max_bounces=2,
                          chunk=128, compact_schedule=(1.0, 0.01),
                          with_stats=True)
    assert int(stats["dropped_lanes"]) > 0
    _, stats0 = path_trace(rt, orig, d, key, p_rr=0.8, max_bounces=8,
                           chunk=128, with_stats=True)
    assert int(stats0["dropped_lanes"]) == 0


def _textured_cornell(target_mesh: str):
    """Cornell with a 2x2 in-memory texture bound to `target_mesh`."""
    from software_rasterizer_tpu.ops.shading import ShaderType
    from software_rasterizer_tpu.scenes import build_cornell_scene
    from software_rasterizer_tpu.utils.texture import Texture

    scene = build_cornell_scene()
    tex = Texture(np.asarray(
        [[[255, 0, 0], [0, 255, 0]], [[0, 0, 255], [255, 255, 0]]],
        np.uint8,
    ))
    scene.add_shader("t", tex, ShaderType.TEXTURE)
    scene.bind_shader_to_mesh(target_mesh, "t")
    scene.set_ndc_matrix(24, 24)
    return scene


def _light_and_wall_pixels(rt, fovy, w):
    """(row, col) of one primary hit on the emitter and one on a wall."""
    from software_rasterizer_tpu.ops.camera import camera_rays
    from software_rasterizer_tpu.ops.intersect import nearest_hit

    orig, d = camera_rays(rt.eye, fovy, w, w)
    h = nearest_hit(rt, orig, d)
    emissive = np.linalg.norm(np.asarray(h.emit), axis=-1) > 1e-5
    light = int(np.flatnonzero(emissive & np.asarray(h.hit))[0])
    wall = (w // 2) * w + w // 2
    assert not emissive[wall]
    return [divmod(light, w), divmod(wall, w)]


def test_emissive_sphere_primary_hit_is_black():
    """Primary hits on an emissive SPHERE shade as Properties.color =
    (0,0,0) — the reference's sphere-color quirk (Object.hpp:36-40;
    pathTracingDirectLight returns intersection.color at an emissive
    hit, Scene.cpp:676-680) — not the sphere's Kd or its emission."""
    from software_rasterizer_tpu.models import (
        Material, MaterialType, SphereLight,
    )

    sc = Scene("spherelight", eye=(0.0, 0.0, -0.9))
    lm = Material(type=MaterialType.DIFFUSE_AND_GLOSSY, Kd=(1.0, 0.3, 0.2),
                  emission=(30.0, 30.0, 30.0))
    sc.add_graphic_obj(
        SphereLight((0.0, 0.0, 50.0), (1.0,) * 3, 20.0, lm), "light"
    )
    sc.set_ndc_matrix(16, 16)
    rt = prepare_rt_scene(sc.rt_geometry(), sc.rt_frame())
    img = np.asarray(path_render(rt, 16, 16, sc.fovy, jax.random.PRNGKey(0),
                                 spp=4, max_bounces=4))
    # the light disk covers the image center; corners see the background
    assert np.abs(img[7, 7]).max() < 1e-5, img[7, 7]
    np.testing.assert_allclose(img[0, 0], np.asarray(rt.background),
                               atol=1e-6)


def test_textured_nonemissive_wall_matches_oracle():
    """A texture on a NON-emissive surface leaves path tracing unchanged:
    texture color is consumed only at emissive hits (Scene.cpp:676-680;
    the BRDF reads material Kd, Material.cpp:60). The render is
    bit-identical to the untextured one, and the oracle agrees."""
    scene = _textured_cornell("back")
    rt = prepare_rt_scene(scene.rt_geometry(), scene.rt_frame())
    assert rt.textures.size > 3          # a REAL atlas is present
    plain = build_cornell_scene()
    plain.set_ndc_matrix(24, 24)
    rt0 = prepare_rt_scene(plain.rt_geometry(), plain.rt_frame())
    a = path_render(rt, 24, 24, scene.fovy, jax.random.PRNGKey(0), spp=2)
    b = path_render(rt0, 24, 24, scene.fovy, jax.random.PRNGKey(0), spp=2)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    _oracle_vs_wavefront(rt, scene.fovy, 24, [(12, 12)], n_samp=200)


def test_textured_emitter_shows_texel_and_matches_oracle():
    """A texture on the EMITTER is what a primary hit on it returns
    (getDiffuseColor, Scene.cpp:676-680): the light's pixel carries the
    texel (red at uv (0,0)), not its Kd — checked against the oracle."""
    scene = _textured_cornell("light")
    rt = prepare_rt_scene(scene.rt_geometry(), scene.rt_frame())
    from software_rasterizer_tpu.ops.camera import camera_rays
    from software_rasterizer_tpu.ops.intersect import nearest_hit

    pixels = _light_and_wall_pixels(rt, scene.fovy, 24)
    orig, d = camera_rays(rt.eye, scene.fovy, 24, 24)
    lane = pixels[0][0] * 24 + pixels[0][1]
    hit = nearest_hit(rt, orig[lane:lane + 1], d[lane:lane + 1])
    np.testing.assert_array_equal(np.asarray(hit.color)[0], [1.0, 0.0, 0.0])
    _oracle_vs_wavefront(rt, scene.fovy, 24, pixels, n_samp=200)
