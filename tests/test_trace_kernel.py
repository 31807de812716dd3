"""The Pallas trace kernel (ops/trace_kernel.py) against the XLA chunk
sweep (ops/intersect._intersect_tri_raw): same winner and hit set on
every case the kernel's blocking, padding and culling must handle, run
in interpret mode on the CPU; plus the triangle-count dispatch."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from software_rasterizer_tpu.ops import intersect
from software_rasterizer_tpu.ops.intersect import _intersect_tri_raw
from software_rasterizer_tpu.ops.trace_kernel import (
    BIG,
    chunk_bounds,
    edge_rows,
    trace_nearest,
)


def _scene(n_tri, n_ray, seed=11, miss=False):
    """Triangle clusters strung along x (so chunk AABBs are tight and
    culling is real) and rays travelling +z through them (or -z, away
    from every triangle, when `miss`)."""
    rng = np.random.RandomState(seed)
    spread = max(n_tri / 16.0, 2.5)
    centers = rng.rand(n_tri, 1, 3) * np.array([spread, 2.0, 2.0]) - 1.0
    tri = np.sort(centers, axis=0) + rng.rand(n_tri, 3, 3) * 0.4
    v0, v1, v2 = (jnp.asarray(tri[:, i], jnp.float32) for i in range(3))
    valid = jnp.asarray(rng.rand(n_tri) > 0.05)
    orig = rng.rand(n_ray, 3) * np.array([spread, 1.0, 1.0])
    orig -= np.array([0.0, 0.0, 4.0])
    d = rng.rand(n_ray, 3) * 0.2 + np.array([0.0, 0.0, -1.0 if miss else 1.0])
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return (v0, v1, v2, valid, jnp.asarray(orig, jnp.float32),
            jnp.asarray(d, jnp.float32))


def _compare(v0, v1, v2, valid, orig, d, chunk, block):
    lo, hi = chunk_bounds(v0, v1, v2, valid, chunk)
    hk, ik, tk = trace_nearest(edge_rows(v0, v1, v2, valid), lo, hi, orig,
                               d, chunk=chunk, block=block)
    hx, ix, tx = _intersect_tri_raw(orig, d, v0, v1, v2, valid, chunk=64)
    hk, ik, tk, hx, ix, tx = (np.asarray(a) for a in (hk, ik, tk, hx, ix, tx))
    np.testing.assert_array_equal(hk, hx)
    np.testing.assert_array_equal(ik, ix)
    # the winner's t may differ in the last ulp (the two programs fuse
    # the same float32 formula differently)
    np.testing.assert_allclose(tk, tx, rtol=1e-6)
    return hk, lo, hi


@pytest.mark.parametrize(
    "n_tri, n_ray, chunk, block",
    [
        (40, 256, 64, 128),        # one chunk
        (16 * 40, 256, 16, 128),   # many chunks, most culled per block
        (16 * 40, 300, 16, 128),   # ray count not a multiple of the block
        (16 * 40 + 5, 256, 16, 128),  # triangle count not a multiple of chunk
        (200, 512, 32, 256),       # a wider ray block
    ],
    ids=["one_chunk", "many_chunks", "ragged_rays", "ragged_tris",
         "block256"],
)
def test_kernel_matches_xla_sweep(pallas_interpret, n_tri, n_ray, chunk,
                                  block):
    hit, lo, hi = _compare(*_scene(n_tri, n_ray), chunk=chunk, block=block)
    assert hit.sum() > 0 and not hit.all()


def test_kernel_culls_chunks(pallas_interpret):
    """The many-chunk case really culls: some (ray block, chunk) pair
    has no ray entering the chunk's box."""
    from software_rasterizer_tpu.ops.bvh import slab_test

    v0, v1, v2, valid, orig, d = _scene(16 * 40, 256)
    _, lo, hi = _compare(v0, v1, v2, valid, orig, d, chunk=16, block=128)
    enters = np.asarray(slab_test(orig[:128], d[:128], lo, hi)).any(axis=0)
    assert 0 < enters.sum() < enters.size


def test_kernel_all_rays_miss(pallas_interpret):
    hit, _, _ = _compare(*_scene(16 * 40, 256, miss=True), chunk=16,
                         block=128)
    assert not hit.any()


def test_kernel_ignores_invalid_triangles(pallas_interpret):
    """Padding rows (valid=False) never win, even where they would."""
    v0, v1, v2, valid, orig, d = _scene(200, 256)
    none = jnp.zeros_like(valid)
    lo, hi = chunk_bounds(v0, v1, v2, none, 32)
    hit, idx, t = trace_nearest(edge_rows(v0, v1, v2, none), lo, hi, orig,
                                d, chunk=32, block=128)
    assert not np.asarray(hit).any()
    assert (np.asarray(idx) == -1).all() and (np.asarray(t) == BIG).all()


def test_edge_rows_and_chunk_bounds_of_padding():
    v = jnp.ones((3, 3))
    valid = jnp.asarray([True, False, False])
    rows = np.asarray(edge_rows(v, 2 * v, 3 * v, valid))
    np.testing.assert_array_equal(rows[0], [1, 1, 1, 1, 1, 1, 2, 2, 2])
    assert (rows[1:] == 0).all()
    lo, hi = chunk_bounds(v, 2 * v, 3 * v, valid, 2)
    assert lo.shape == (2, 3)
    np.testing.assert_array_equal(np.asarray(lo[0]), [1, 1, 1])
    np.testing.assert_array_equal(np.asarray(hi[0]), [3, 3, 3])
    assert (np.asarray(lo[1]) > np.asarray(hi[1])).all()  # empty: inverted


@pytest.mark.parametrize(
    "platform, f_pad, want",
    [("cpu", 1 << 20, "xla"), ("gpu", 128, "xla"), ("gpu", 1 << 20, "kernel")],
)
def test_trace_backend_dispatch(monkeypatch, platform, f_pad, want):
    """Only a GPU runs the kernel, and only from KERNEL_MIN_TRIS up."""
    monkeypatch.setattr(intersect, "KERNEL_MIN_TRIS", 4096)
    monkeypatch.setattr(intersect.jax, "default_backend", lambda: platform)
    assert intersect._trace_backend(f_pad) == want


@pytest.mark.gpu
def test_compiled_kernel_matches_xla_on_gpu(gpu):
    """The kernel as Triton compiles it for the card (chip_smoke.py runs
    the same comparison at full size)."""
    v0, v1, v2, valid, orig, d = _scene(16 * 40, 4096)
    _compare(v0, v1, v2, valid, orig, d, chunk=16, block=128)


@pytest.fixture
def kernel_dispatch(pallas_interpret, monkeypatch):
    """Every trace in the test takes the kernel path (interpret mode), as
    it would on a GPU above KERNEL_MIN_TRIS; jit caches are cleared on
    entry and exit so no other test sees programs traced under it."""
    jax.clear_caches()
    monkeypatch.setattr(intersect, "KERNEL_MIN_TRIS", 0)
    monkeypatch.setattr(intersect.jax, "default_backend", lambda: "gpu")
    yield
    jax.clear_caches()


def _cornell_render(pipeline):
    from software_rasterizer_tpu.ops.intersect import prepare_rt_scene
    from software_rasterizer_tpu.ops.path import path_render
    from software_rasterizer_tpu.ops.whitted import whitted_render
    from software_rasterizer_tpu.scenes import build_cornell_scene

    scene = build_cornell_scene()
    scene.set_ndc_matrix(16, 16)
    rt = prepare_rt_scene(scene.rt_geometry(), scene.rt_frame())
    key = jax.random.PRNGKey(0)
    if pipeline == "path":
        img = path_render(rt, 16, 16, scene.fovy, key, spp=2, max_bounces=4)
    else:
        img = whitted_render(rt, 16, 16, scene.fovy, key, spp=1,
                             max_depth=3)
    return np.asarray(img)


@pytest.fixture(scope="module")
def xla_renders():
    return {p: _cornell_render(p) for p in ("path", "whitted")}


@pytest.mark.parametrize("pipeline", ["path", "whitted"])
def test_render_through_kernel_matches_xla(xla_renders, kernel_dispatch,
                                           pipeline):
    """A whole render with every trace on the kernel equals the XLA
    render except where a ray picks another winner. Camera rays along
    the wall quads' diagonals hit both triangles of a quad at the same t
    to the ulp; when the two programs' roundings pick different ones,
    the reference's |t^2 - dist^2| shadow test (Scene.cpp:541-545) can
    turn that tie into a lit/unlit flip (6 of 256 whitted pixels here,
    all on those diagonals and the corners)."""
    got = _cornell_render(pipeline)
    want = xla_renders[pipeline]
    differs = ~np.isclose(got, want, rtol=1e-4, atol=1e-5).all(-1)
    assert differs.mean() < 0.05, differs.mean()
