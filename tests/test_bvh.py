"""BVH build/traversal/chunk-culling tests (reference algorithm:
BVHAcceleration.cpp:142-232; our role for it: SURVEY.md 7.1)."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from software_rasterizer_tpu.ops import bvh as B
from software_rasterizer_tpu.ops.intersect import intersect_triangles


def _random_tris(rng, n, spread=10.0):
    base = rng.uniform(-spread, spread, (n, 1, 3))
    tri = base + rng.normal(0, 0.4, (n, 3, 3))
    return tri.astype(np.float32)


@pytest.fixture(scope="module")
def tris():
    return _random_tris(np.random.default_rng(0), 100)


def test_build_invariants(tris):
    lo, hi = B.primitive_bounds(tris[:, 0], tris[:, 1], tris[:, 2])
    areas = B.triangle_areas(tris[:, 0], tris[:, 1], tris[:, 2])
    bvh = B.build_bvh(lo, hi, areas)
    m = bvh.left.shape[0]
    assert m == 2 * len(tris) - 1  # binary tree with 1-prim leaves
    # root bbox contains everything; cumulative area matches the sum
    np.testing.assert_allclose(bvh.bb_min[0], lo.min(0), rtol=1e-6)
    np.testing.assert_allclose(bvh.bb_max[0], hi.max(0), rtol=1e-6)
    np.testing.assert_allclose(bvh.area[0], areas.sum(), rtol=1e-4)
    for ni in range(m):
        l, r = bvh.left[ni], bvh.right[ni]
        if l >= 0:
            assert (bvh.bb_min[ni] <= bvh.bb_min[l] + 1e-6).all()
            assert (bvh.bb_max[ni] >= bvh.bb_max[r] - 1e-6).all()
            assert abs(bvh.area[ni] - bvh.area[l] - bvh.area[r]) < 1e-2


def test_leaf_order_is_permutation(tris):
    lo, hi = B.primitive_bounds(tris[:, 0], tris[:, 1], tris[:, 2])
    bvh = B.build_bvh(lo, hi, B.triangle_areas(tris[:, 0], tris[:, 1], tris[:, 2]))
    perm = B.leaf_order(bvh)
    assert sorted(perm.tolist()) == list(range(len(tris)))


def test_slab_test_matches_scalar_oracle():
    rng = np.random.default_rng(1)
    orig = rng.normal(0, 5, (64, 3)).astype(np.float32)
    d = rng.normal(size=(64, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    lo = rng.uniform(-6, 4, (32, 3)).astype(np.float32)
    hi = lo + rng.uniform(0.5, 3, (32, 3)).astype(np.float32)

    got = np.array(B.slab_test(jnp.asarray(orig), jnp.asarray(d),
                               jnp.asarray(lo), jnp.asarray(hi)))
    for i in range(64):
        for j in range(32):
            with np.errstate(divide="ignore"):
                t0 = (lo[j] - orig[i]) / d[i]
                t1 = (hi[j] - orig[i]) / d[i]
            tmin = np.minimum(t0, t1).max()
            tmax = np.maximum(t0, t1).min()
            assert got[i, j] == (tmax >= max(tmin, 0.0))


def test_bvh_nearest_leaf_vs_bruteforce(tris):
    lo, hi = B.primitive_bounds(tris[:, 0], tris[:, 1], tris[:, 2])
    bvh = B.build_bvh(lo, hi, B.triangle_areas(tris[:, 0], tris[:, 1], tris[:, 2]))
    bvh_dev = jax.tree_util.tree_map(jnp.asarray, bvh)

    rng = np.random.default_rng(2)
    orig = np.full((32, 3), -30.0, np.float32) + rng.normal(0, 1, (32, 3)).astype(np.float32)
    target = tris[rng.integers(0, len(tris), 32), 0]
    d = (target - orig).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)

    got = np.array(B.bvh_nearest_leaf(bvh_dev, jnp.asarray(orig), jnp.asarray(d)))

    # oracle: min slab-entry over all primitive boxes. Rays that GRAZE a
    # box corner (overlap margin ~0) legitimately differ between the f32
    # kernel and this oracle, so the check is margin-aware: the kernel's
    # answer must be at least as near as the best SOLIDLY-hit box.
    for i in range(32):
        with np.errstate(divide="ignore"):
            t0 = (lo - orig[i]) / d[i]
            t1 = (hi - orig[i]) / d[i]
        tmin = np.minimum(t0, t1).max(-1)
        tmax = np.maximum(t0, t1).min(-1)
        entry_raw = np.maximum(tmin, 0.0)
        margin = tmax - entry_raw
        solid = margin > 1e-3
        e_solid = entry_raw[solid].min() if solid.any() else np.inf
        if got[i] >= 0:
            assert entry_raw[got[i]] <= e_solid + 1e-3
        else:
            assert not solid.any()


def test_chunk_culling_matches_full_sweep():
    rng = np.random.default_rng(3)
    tris = _random_tris(rng, 512, spread=20.0)
    # leaf-order the triangles so chunks are coherent
    lo, hi = B.primitive_bounds(tris[:, 0], tris[:, 1], tris[:, 2])
    perm = B.leaf_order(
        B.build_bvh(lo, hi, B.triangle_areas(tris[:, 0], tris[:, 1], tris[:, 2]))
    )
    tris = tris[perm]
    v0, v1, v2 = (jnp.asarray(tris[:, k]) for k in range(3))
    valid = jnp.ones(512, bool)

    orig = jnp.asarray(rng.normal(0, 25, (256, 3)).astype(np.float32))
    d = rng.normal(size=(256, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d = jnp.asarray(d)

    f = jax.jit(lambda cc: intersect_triangles(
        orig, d, v0, v1, v2, valid, chunk=64, cull_chunks=cc
    ), static_argnums=0)
    t_a, i_a, u_a, v_a = f(True)
    t_b, i_b, u_b, v_b = f(False)
    np.testing.assert_array_equal(np.array(i_a), np.array(i_b))
    np.testing.assert_allclose(np.array(t_a), np.array(t_b), rtol=1e-6)


def test_rt_geometry_bvh_order_preserves_render():
    from software_rasterizer_tpu.ops.intersect import prepare_rt_scene
    from software_rasterizer_tpu.ops.whitted import whitted_render
    from software_rasterizer_tpu.scenes import build_cornell_scene

    imgs = []
    for order in (False, True):
        scene = build_cornell_scene()
        scene.set_ndc_matrix(32, 32)
        rt = prepare_rt_scene(scene.rt_geometry(bvh_order=order), scene.rt_frame())
        imgs.append(np.array(whitted_render(
            rt, 32, 32, scene.fovy, jax.random.PRNGKey(0), max_depth=2
        )))
    np.testing.assert_allclose(imgs[0], imgs[1], rtol=1e-5, atol=1e-6)


def test_bvh_nearest_hit_exact_vs_bruteforce():
    """The true nearest-hit traversal (primitive intersected at every
    visited leaf) must agree with the brute-force sweep exactly —
    including at scale (tessellated sheet, ~20K tris here; the stress
    bench runs >=100K)."""
    rng = np.random.RandomState(11)
    g = 100  # (g*g*2) triangles over a bumpy sheet
    xs, ys = np.meshgrid(np.linspace(-5, 5, g + 1), np.linspace(-5, 5, g + 1))
    zs = np.sin(xs) * np.cos(ys)
    verts = np.stack([xs, ys, zs], axis=-1).reshape(-1, 3).astype(np.float32)

    def vid(i, j):
        return i * (g + 1) + j

    faces = []
    for i in range(g):
        for j in range(g):
            a, b, c, d = vid(i, j), vid(i, j + 1), vid(i + 1, j), vid(i + 1, j + 1)
            faces.append((a, b, c))
            faces.append((b, d, c))
    faces = np.asarray(faces, np.int32)
    v0, v1, v2 = (verts[faces[:, k]] for k in range(3))

    areas = B.triangle_areas(v0, v1, v2)
    bb_min, bb_max = B.primitive_bounds(v0, v1, v2)
    bvh = B.build_bvh(bb_min, bb_max, areas)
    bvh_dev = jax.tree_util.tree_map(jnp.asarray, bvh)

    n = 256
    orig = (rng.rand(n, 3).astype(np.float32) - 0.5) * 8
    orig[:, 2] = 5.0
    d = rng.rand(n, 3).astype(np.float32) - 0.5
    d[:, 2] = -1.0
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)

    t_bvh, p_bvh = B.bvh_nearest_hit(
        bvh_dev, jnp.asarray(v0), jnp.asarray(v1), jnp.asarray(v2),
        jnp.asarray(orig), jnp.asarray(d), max_depth=64,
    )
    t_ref, i_ref, _, _ = intersect_triangles(
        jnp.asarray(orig), jnp.asarray(d), jnp.asarray(v0), jnp.asarray(v1),
        jnp.asarray(v2), jnp.ones(v0.shape[0], bool), chunk=512,
    )
    t_bvh, p_bvh, t_ref, i_ref = (np.asarray(a) for a in (t_bvh, p_bvh, t_ref, i_ref))
    hit_b = p_bvh >= 0
    hit_r = i_ref >= 0
    np.testing.assert_array_equal(hit_b, hit_r)
    np.testing.assert_allclose(t_bvh[hit_b], t_ref[hit_r], rtol=1e-5)
    assert hit_b.sum() > n // 2  # the scene actually gets hit
