"""Debug facilities (SURVEY.md 5.2).

The reference's only guards are gcc Debug flags (-ftrapv -fbounds-check,
CMakeLists.txt:44-50) — and it ships a real data race (the shared
unlocked mt19937, Tools.cpp:295-300) those flags never catch. JAX
equivalents:

  * `debug_mode()` — context manager enabling jax NaN/Inf interception
    for every computation inside (jax_debug_nans);
  * `validate_rt_scene` / `validate_raster_geometry` — host-side
    structural checks (finite geometry, index ranges, mask consistency)
    run before uploading a scene, catching loader/assembly bugs with
    actionable messages instead of silent black frames.
"""

from __future__ import annotations

import contextlib
from typing import List

import numpy as np


@contextlib.contextmanager
def debug_mode(nans: bool = True):
    """Enable NaN interception inside the block (device ops raise on the
    first NaN/Inf instead of propagating them into the frame)."""
    import jax

    old = jax.config.jax_debug_nans
    jax.config.update("jax_debug_nans", bool(nans))
    try:
        yield
    finally:
        jax.config.update("jax_debug_nans", old)


def _finite(name: str, a, errors: List[str]):
    arr = np.asarray(a)
    if arr.dtype.kind == "f" and not np.isfinite(arr).all():
        errors.append(f"{name}: {np.size(arr) - np.isfinite(arr).sum()} non-finite values")


def validate_rt_scene(rt) -> List[str]:
    """Structural checks on an RTScene; returns a list of problems."""
    errors: List[str] = []
    f = np.asarray(rt.v0).shape[0]
    for name in ("v0", "v1", "v2", "n0", "n1", "n2", "sph_c", "mat_kd", "mat_emit"):
        _finite(name, getattr(rt, name), errors)
    for name in ("tri_mat", "tri_obj"):
        idx = np.asarray(getattr(rt, name))
        if idx.shape[0] != f:
            errors.append(f"{name}: length {idx.shape[0]} != F={f}")
        if (idx < 0).any():
            errors.append(f"{name}: negative indices")
    n_mat = np.asarray(rt.mat_kd).shape[0]
    if (np.asarray(rt.tri_mat) >= n_mat).any():
        errors.append(f"tri_mat: index >= material count {n_mat}")
    valid = np.asarray(rt.tri_valid)
    if valid.dtype != np.bool_:
        errors.append("tri_valid: not boolean")
    if np.asarray(rt.n_emitters) == 0 and np.asarray(rt.emitter_mask).any():
        errors.append("emitter_mask/n_emitters inconsistent")
    return errors


def validate_raster_geometry(geom) -> List[str]:
    """Structural checks on a RasterGeometry bundle."""
    errors: List[str] = []
    v = np.asarray(geom.positions).shape[0]
    for name in ("positions", "normals", "uvs", "colors", "textures"):
        _finite(name, getattr(geom, name), errors)
    faces = np.asarray(geom.faces)
    if (faces < 0).any() or (faces >= v).any():
        errors.append(f"faces: vertex indices outside [0, {v})")
    n_mesh = np.asarray(geom.shader_type).shape[0]
    if (np.asarray(geom.face_mesh) >= n_mesh).any():
        errors.append(f"face_mesh: mesh id >= {n_mesh}")
    n_tex = np.asarray(geom.textures).shape[0]
    if (np.asarray(geom.tex_id) >= n_tex).any():
        errors.append(f"tex_id: texture id >= {n_tex}")
    return errors
