"""PRNG key construction.

Integrators consume `jax.random` keys; any impl works. The pipelines
default to the "rbg" generator (XLA's RngBitGenerator), which produced
the CPU goldens in tests/goldens; PERF.md records its cost against
"threefry2x32" on the GPU. Override with SRT_PRNG_IMPL=threefry2x32.
"""

from __future__ import annotations

import os


def make_key(seed: int):
    import jax

    return jax.random.key(seed, impl=os.environ.get("SRT_PRNG_IMPL", "rbg"))


def lane_uniforms(key, rid, salt: int = 0):
    """Layout-invariant per-lane uniforms in [0,1).

    `rid` (any shape, int32) is a stable per-ray identity (absolute lane /
    pixel id, not local position), so a ray produces the SAME draw no
    matter which device or queue slot holds it — this is what makes
    sharded renders bit-identical to monolithic ones (a plain
    `jax.random.uniform(key, (n_local,))` draws by LOCAL lane position and
    correlates shards). One scalar threefry draw derives a 32-bit seed
    from (key, salt); per-lane values come from a lowbias32-style integer
    mix (elementwise, cheap at wavefront widths, unlike a
    vmapped fold_in which costs a full threefry pass per draw).
    """
    import jax
    import jax.numpy as jnp

    seed = jax.random.bits(jax.random.fold_in(key, salt), (), jnp.uint32)
    x = rid.astype(jnp.uint32) ^ seed
    x = x ^ (x >> 16)
    x = x * jnp.uint32(0x7FEB352D)
    x = x ^ (x >> 15)
    x = x * jnp.uint32(0x846CA68B)
    x = x ^ (x >> 16)
    return (x >> 8).astype(jnp.float32) * jnp.float32(1.0 / (1 << 24))
