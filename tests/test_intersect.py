"""Intersection kernels vs NumPy oracles (Moller-Trumbore, sphere quadratic)."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from software_rasterizer_tpu.ops.intersect import (
    intersect_spheres,
    intersect_triangles,
    nearest_hit,
    prepare_rt_scene,
)


def _mt_oracle(o, d, v0, v1, v2):
    """Scalar Moller-Trumbore (Triangle.cpp:104-145) in float64."""
    e1, e2 = v1 - v0, v2 - v0
    p = np.cross(d, e2)
    det = np.dot(e1, p)
    if abs(det) < 1e-6:
        return None
    inv = 1.0 / det
    tv = o - v0
    u = np.dot(tv, p) * inv
    if u < 0 or u > 1:
        return None
    q = np.cross(tv, e1)
    v = np.dot(d, q) * inv
    if v < 0 or u + v > 1:
        return None
    t = np.dot(e2, q) * inv
    if t < 1e-6:
        return None
    return t, u, v


def test_moller_trumbore_random_oracle():
    rng = np.random.RandomState(7)
    tris = rng.randn(40, 3, 3).astype(np.float32)
    origins = rng.randn(64, 3).astype(np.float32) * 2
    dirs = rng.randn(64, 3).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)

    t, idx, u, v = intersect_triangles(
        jnp.asarray(origins), jnp.asarray(dirs),
        jnp.asarray(tris[:, 0]), jnp.asarray(tris[:, 1]), jnp.asarray(tris[:, 2]),
        jnp.ones(40, bool), chunk=16,
    )
    t, idx = np.asarray(t), np.asarray(idx)
    for i in range(64):
        best = (np.inf, -1)
        for k in range(40):
            r = _mt_oracle(origins[i], dirs[i], *tris[k].astype(np.float64))
            if r and r[0] < best[0]:
                best = (r[0], k)
        if best[1] == -1:
            assert idx[i] == -1
        else:
            assert idx[i] == best[1], (i, idx[i], best)
            np.testing.assert_allclose(t[i], best[0], rtol=1e-3)


def test_sphere_intersect_analytic():
    # ray from origin along +z toward sphere at (0,0,5) r=1 -> t=4
    o = jnp.zeros((1, 3))
    d = jnp.asarray([[0.0, 0.0, 1.0]])
    t, idx = intersect_spheres(
        o, d, jnp.asarray([[0.0, 0.0, 5.0]]), jnp.asarray([1.0]), jnp.ones(1, bool)
    )
    assert np.isclose(float(t[0]), 4.0, atol=1e-5) and int(idx[0]) == 0
    # from inside: nearest positive root is the exit, t=1
    o2 = jnp.asarray([[0.0, 0.0, 5.0]])
    t2, _ = intersect_spheres(
        o2, d, jnp.asarray([[0.0, 0.0, 5.0]]), jnp.asarray([1.0]), jnp.ones(1, bool)
    )
    assert np.isclose(float(t2[0]), 1.0, atol=1e-5)
    # miss
    t3, i3 = intersect_spheres(
        o, jnp.asarray([[0.0, 1.0, 0.0]]),
        jnp.asarray([[0.0, 0.0, 5.0]]), jnp.asarray([1.0]), jnp.ones(1, bool),
    )
    assert int(i3[0]) == -1


def _tiny_scene():
    """One diffuse floor quad + one emissive sphere, built through Scene."""
    from software_rasterizer_tpu.models import Material, MaterialType, Scene, SphereLight
    from software_rasterizer_tpu.models.objects import MeshObject
    from software_rasterizer_tpu.utils.obj_loader import MeshData, MtlMaterial

    scene = Scene("tiny", eye=(0, 0, -3), background=(0.1, 0.2, 0.3))
    verts = np.array(
        [[-2, -1, -2], [2, -1, -2], [2, -1, 6], [-2, -1, 6]], np.float32
    )
    data = MeshData(
        name="floor",
        vertices=verts,
        normals=np.tile(np.array([[0, 1, 0]], np.float32), (4, 1)),
        uvs=np.zeros((4, 2), np.float32),
        colors=np.ones((4, 3), np.float32),
        faces=np.array([[0, 1, 2], [0, 2, 3]], np.int32),
        material=MtlMaterial(),
        bbox_min=verts.min(0),
        bbox_max=verts.max(0),
        had_normals=True,
    )
    floor = MeshObject(data, Material(
        type=MaterialType.DIFFUSE_AND_GLOSSY,
        Ka=(0.005,) * 3, Kd=(1.0,) * 3, Ks=(0.7937,) * 3, specular_exponent=150.0,
    ))
    scene.add_graphic_obj(floor, "floor")
    light = SphereLight(center=(0, 3, 1), intensity=(1, 1, 1), radius=0.5,
                        material=Material(Kd=(1.0,) * 3, emission=(5.0, 5.0, 5.0)))
    scene.add_graphic_obj(light, "light")
    # identity view/projection for a world==trace-space test scene
    scene.view = np.eye(4, dtype=np.float32)
    scene.projection = np.eye(4, dtype=np.float32)
    return scene


def test_nearest_hit_properties():
    scene = _tiny_scene()
    rt = prepare_rt_scene(scene.rt_geometry(pad_faces_to=8), scene.rt_frame())
    # straight down from above the floor
    o = jnp.asarray([[0.5, 2.0, 1.0], [0.0, 5.0, 1.0], [0.0, -5.0, 1.0]])
    d = jnp.asarray([[0.0, -1.0, 0.0], [0.0, -1.0, 0.0], [0.0, -1.0, 0.0]])
    hit = nearest_hit(rt, o, d)
    h = np.asarray(hit.hit)
    assert h[0] and h[1] and not h[2]
    # ray 0 hits floor at y=-1, t=3
    np.testing.assert_allclose(float(hit.t[0]), 3.0, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(hit.normal[0]), [0, 1, 0], atol=1e-5)
    np.testing.assert_allclose(np.asarray(hit.color[0]), [1, 1, 1], atol=1e-6)
    # ray 1 hits the emissive sphere first (top at y=3.5, t=1.5)
    np.testing.assert_allclose(float(hit.t[1]), 1.5, rtol=1e-4)
    assert np.asarray(hit.emit[1]).sum() > 0
    # sphere hits carry color 0 (Properties default quirk)
    np.testing.assert_allclose(np.asarray(hit.color[1]), 0.0, atol=1e-7)
    # emitter table: bbox sphere of the light: center (0,3,1), r = 0.5*sqrt(3)
    em = np.asarray(rt.emitter_mask)
    ec = np.asarray(rt.emitter_center)[em]
    er = np.asarray(rt.emitter_radius)[em]
    np.testing.assert_allclose(ec[0], [0, 3, 1], atol=1e-5)
    np.testing.assert_allclose(er[0], 0.5 * np.sqrt(3), rtol=1e-5)


def test_whitted_tiny_scene():
    from software_rasterizer_tpu.ops.whitted import whitted_render

    scene = _tiny_scene()
    rt = prepare_rt_scene(scene.rt_geometry(pad_faces_to=8), scene.rt_frame())
    key = jax.random.PRNGKey(0)
    img = np.asarray(
        whitted_render(rt, 32, 32, 45.0, key, spp=1, max_depth=3, block=2048, chunk=8)
    )
    assert img.shape == (32, 32, 3)
    assert np.isfinite(img).all()
    # some rays hit the floor (lit) and some miss (background)
    bg = np.array([0.1, 0.2, 0.3])
    is_bg = np.isclose(img, bg, atol=1e-5).all(axis=-1)
    assert is_bg.any() and not is_bg.all()
    lit = img[~is_bg]
    assert lit.max() > 0.01, "diffuse floor must receive light"
