"""Device-side texture fetch (reference: TextureLoader.cpp:14-31).

Nearest texel with clamp-truncate semantics and the u==1/v==1 -> black
quirk, vectorized over fragments from a padded texture atlas.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _small_table_rows(idx, table):
    """table[idx] for a SMALL table via a one-hot contraction — a fused
    select chain instead of a per-lane gather."""
    k = table.shape[0]
    iota = jax.lax.broadcasted_iota(jnp.int32, idx.shape + (k,), idx.ndim)
    oh = (idx[..., None] == iota).astype(jnp.float32)
    return jnp.einsum(
        "...k,kc->...c", oh, table.astype(jnp.float32),
        precision=jax.lax.Precision.HIGHEST,
    )


def pack_atlas(atlas_u8):
    """(K,Hm,Wm,3) u8 -> (K,Hm,Wm) i32 with texel r|g<<8|b<<16 — the
    1-word-per-texel form `fetch_nearest(packed=...)` gathers. Works on
    numpy or jnp inputs (host packing at scene build is the cheap spot)."""
    a = atlas_u8.astype("int32") if hasattr(atlas_u8, "astype") else atlas_u8
    return a[..., 0] | (a[..., 1] << 8) | (a[..., 2] << 16)


def fetch_nearest(atlas, tex_wh, tex_id, uv, packed=None):
    """Gather texel colors.

    atlas:  (K,Hm,Wm,3) u8 padded texture stack (f32 also accepted)
    tex_wh: (K,2) i32 (width, height) valid extents
    tex_id: (...,) i32 texture index (-1 = no texture -> black)
    uv:     (...,2) f32
    packed: optional (K,Hm,Wm) i32 from `pack_atlas` — when given, the
            fetch is ONE flat 1-D i32 gather + an integer unpack instead
            of a 3-byte-row gather. Bit-identical texel values (u8 ->
            f32/255 after unpack).

    Returns (...,3) f32. Reproduces TextureLoader::getTextureColor:
    clamp uv to [0,1], x=int(u*W), y=int(v*H), out-of-range -> black.
    """
    tid = jnp.maximum(tex_id, 0)
    wh = _small_table_rows(tid, tex_wh)
    w = jnp.round(wh[..., 0]).astype(jnp.int32)
    h = jnp.round(wh[..., 1]).astype(jnp.int32)
    u = jnp.clip(uv[..., 0], 0.0, 1.0)
    v = jnp.clip(uv[..., 1], 0.0, 1.0)
    x = (u * w.astype(jnp.float32)).astype(jnp.int32)
    y = (v * h.astype(jnp.float32)).astype(jnp.int32)
    oob = (x >= w) | (y >= h) | (tex_id < 0)
    xs = jnp.minimum(x, w - 1)
    ys = jnp.minimum(y, h - 1)
    if packed is not None:
        _, hm, wm = packed.shape
        lin = (tid * hm + ys) * wm + xs
        word = packed.reshape(-1)[lin]
        out = jnp.stack(
            [(word & 255).astype(jnp.float32),
             ((word >> 8) & 255).astype(jnp.float32),
             ((word >> 16) & 255).astype(jnp.float32)],
            axis=-1,
        ) / 255.0
        return jnp.where(oob[..., None], 0.0, out)
    out = atlas[tid, ys, xs]
    if out.dtype == jnp.uint8:
        # u8 gather (4x less traffic) then the same u8 -> f32/255 the
        # loader would apply: bit-identical texel values
        out = out.astype(jnp.float32) / 255.0
    return jnp.where(oob[..., None], 0.0, out)
