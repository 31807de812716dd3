"""Direct statistical tests of `utils.rng.lane_uniforms`, the per-ray
hash RNG behind the Whitted emitter picks: uniformity and the pair
structures the integrators consume (draws of one ray at consecutive
salts, draws of adjacent rays at the same salt), its independence from
lane layout, and proof that the detector has power (it fails a known
weak single-round hash)."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from software_rasterizer_tpu.utils.rng import lane_uniforms

N = 1 << 20
KEY = jax.random.PRNGKey(1234567)


def _pair_chi2(ua, ub, bins=16):
    """Chi-square of the joint (ua, ub) occupancy on a bins x bins grid,
    normalized to a z-score vs the chi-square null (mean dof, var 2dof).
    Independent uniforms give |z| < ~3; structured pairs explode."""
    h = np.histogram2d(ua, ub, bins=bins, range=[[0, 1], [0, 1]])[0]
    e = len(ua) / float(bins * bins)
    chi2 = float(((h - e) ** 2 / e).sum())
    dof = bins * bins - 1
    return (chi2 - dof) / np.sqrt(2 * dof)


def _draws(salt, rid=None):
    if rid is None:
        rid = jnp.arange(N, dtype=jnp.int32)
    return np.asarray(lane_uniforms(KEY, rid, salt))


def _single_round(lane, ctr, seed=1234567):
    """A weak generator: ONE lowbias32 multiply round over lane^ctr."""
    x = ((lane * 0x9E3779B1) & 0xFFFFFFFF) ^ (
        (seed + ctr * 0x85EBCA6B) & 0xFFFFFFFF
    )
    x ^= x >> 16
    x = (x * 0x7FEB352D) & 0xFFFFFFFF
    x ^= x >> 16
    return (x >> 8) / float(1 << 24)


def test_lane_uniforms_marginal_uniformity():
    """Mean/variance and 1-D equidistribution at several salts."""
    for salt in (0, 3, 5):
        u = _draws(salt)
        assert u.min() >= 0.0 and u.max() < 1.0
        assert abs(u.mean() - 0.5) < 3e-3, (salt, u.mean())
        assert abs(u.std() - np.sqrt(1 / 12.0)) < 3e-3
        h = np.histogram(u, bins=64, range=(0, 1))[0]
        e = N / 64.0
        z = (((h - e) ** 2 / e).sum() - 63) / np.sqrt(2 * 63)
        assert abs(z) < 6.0, (salt, z)


def test_lane_uniforms_consecutive_salt_pairs():
    """One ray's draws at consecutive salts (the per-sample emitter picks
    of whitted_phong_direct) are jointly uniform."""
    for salt in (0, 7, 15):
        z = _pair_chi2(_draws(salt), _draws(salt + 1))
        assert abs(z) < 6.0, (salt, z)


def test_lane_uniforms_lane_adjacent_pairs():
    """Adjacent rays at the same salt (neighbouring pixels draw together
    every depth — structure here prints as image texture)."""
    for salt in (0, 8, 16):
        u = _draws(salt)
        z = _pair_chi2(u[:-1], u[1:])
        assert abs(z) < 6.0, (salt, z)


def test_lane_uniforms_invariant_under_rid_permutation():
    """A draw depends on the ray's identity only, never on its lane: the
    property that makes sharded renders match monolithic ones."""
    rid = jnp.arange(1 << 16, dtype=jnp.int32) * 7 + 3
    perm = np.random.default_rng(0).permutation(rid.shape[0])
    a = np.asarray(lane_uniforms(KEY, rid, 2))
    b = np.asarray(lane_uniforms(KEY, rid[perm], 2))
    np.testing.assert_array_equal(a[perm], b)


def test_single_round_variant_is_detected():
    """The detector must FAIL a single-round hash — proof the passing
    thresholds above are meaningful (its lane-adjacent pair z-score is
    ~245 at this N)."""
    lanes = np.arange(N, dtype=np.uint64)
    worst = 0.0
    for base in (0, 8, 16, 24):
        u = _single_round(lanes, np.uint64(base))
        worst = max(worst, abs(_pair_chi2(u[:-1], u[1:])))
    assert worst > 50.0, worst
