"""Scalar NumPy oracle of the reference path tracer (Scene.cpp:349-866),
implemented literally (recursive, per-ray, double precision) for
statistical validation of the wavefront integrator in ops/path.py.

Consumes a numpy-fied RTScene (geometry transform is validated separately
by test_intersect.py), so any disagreement isolates the INTEGRATOR."""

from __future__ import annotations

import numpy as np

EPS = 1e-5
BIG = 1e30


def np_scene(rt):
    return {k: np.asarray(v) for k, v in rt._asdict().items()}


def trace(s, o, d):
    """Scene::traceScene: nearest hit + surface properties (triangles only;
    Cornell has no spheres)."""
    v0, v1, v2 = s["v0"], s["v1"], s["v2"]
    e1 = v1 - v0
    e2 = v2 - v0
    p = np.cross(d[None], e2)
    det = np.sum(e1 * p, axis=-1)
    tvec = o[None] - v0
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = 1.0 / det
    u = np.sum(tvec * p, axis=-1) * inv
    q = np.cross(tvec, e1)
    v = np.sum(d[None] * q, axis=-1) * inv
    t = np.sum(e2 * q, axis=-1) * inv
    ok = (
        (np.abs(det) >= 1e-6)
        & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1)
        & (t >= 1e-6) & s["tri_valid"]
    )
    t = np.where(ok, t, BIG)
    i = int(np.argmin(t))
    if t[i] >= BIG:
        return None
    w = 1.0 - u[i] - v[i]
    n = w * s["n0"][i] + u[i] * s["n1"][i] + v[i] * s["n2"][i]
    n = n / np.linalg.norm(n)
    mat = s["tri_mat"][i]
    color = s["mat_kd"][mat]
    tex = s["tri_tex"][i]
    if tex >= 0:   # getDiffuseColor: the texel at the interpolated uv
        uv = w * s["uv0"][i] + u[i] * s["uv1"][i] + v[i] * s["uv2"][i]
        color = texel(s, tex, uv)
    return {
        "t": t[i],
        "coords": o + d * t[i],
        "normal": n,
        "color": color,
        "emit": s["mat_emit"][mat],
        "mat": mat,
    }


def texel(s, tex, uv):
    """TextureLoader::getTextureColor: clamp uv to [0,1], x=int(u*W),
    y=int(v*H), out of range -> black."""
    w, h = (int(x) for x in s["tex_wh"][tex])
    x = int(np.clip(uv[0], 0.0, 1.0) * w)
    y = int(np.clip(uv[1], 0.0, 1.0) * h)
    if x >= w or y >= h:
        return np.zeros(3)
    return s["textures"][tex, y, x].astype(np.float64) / 255.0


def sample_light(s, p, rng):
    """Scene::sampleLight (Scene.cpp:429-476)."""
    centers = s["emitter_center"][s["emitter_mask"]]
    radii = s["emitter_radius"][s["emitter_mask"]]
    if len(centers) == 0:
        return np.zeros(3), 0.0
    i = int(rng.random() * len(centers))
    c, r = centers[i], radii[i]
    baseline = (c - p) / np.linalg.norm(c - p)
    sd = rng.normal(size=3)
    sd /= np.linalg.norm(sd)
    if np.dot(sd, baseline) < 0:
        sd = -sd
    pert = rng.normal(size=3)
    pert = pert / np.linalg.norm(pert) * 1e-6
    sd = sd + pert
    sd /= np.linalg.norm(sd)
    sp = c + sd * r
    l = (sp - p) / np.linalg.norm(sp - p)
    pdf = 0.5 / np.pi * np.dot(l, baseline)
    return l, pdf


def direct_light(s, hit, wo, rng):
    """pathTracingDirectLight (Scene.cpp:671-717)."""
    n = hit["normal"] / np.linalg.norm(hit["normal"])
    if np.linalg.norm(hit["emit"]) > EPS:
        return hit["color"].copy()
    l, pdf = sample_light(s, hit["coords"], rng)
    if np.isnan(pdf) or pdf < EPS:
        return np.zeros(3)
    shadow = trace(s, hit["coords"] + 1e-6 * n, l)
    if shadow is None or np.linalg.norm(shadow["emit"]) < EPS:
        return np.zeros(3)
    dist2 = np.sum((hit["coords"] - shadow["coords"]) ** 2)
    t2 = shadow["t"] ** 2
    if abs(t2 - dist2) > 1e-4:
        return np.zeros(3)
    cos_o = max(0.0, np.dot(n, l))
    cos_l = max(0.0, np.dot(shadow["normal"], -l))
    kd = s["mat_kd"][hit["mat"]]
    fr = kd / np.pi if np.dot(l, n) > 0 else np.zeros(3)
    return shadow["emit"] * fr * cos_o * cos_l / pdf / dist2


def sample_hemisphere(n, rng):
    """Material::sample (Material.cpp:14-34) + Tools::toWorld."""
    x1, x2 = rng.random(), rng.random()
    z = abs(1.0 - 2.0 * x1)
    r = np.sqrt(max(0.0, 1.0 - z * z))
    phi = 2.0 * np.pi * x2
    local = np.array([r * np.cos(phi), r * np.sin(phi), z])
    if abs(n[0]) > abs(n[1]):
        inv = 1.0 / np.sqrt(n[0] ** 2 + n[2] ** 2)
        c = np.array([n[2] * inv, 0.0, -n[0] * inv])
    else:
        inv = 1.0 / np.sqrt(n[1] ** 2 + n[2] ** 2)
        c = np.array([0.0, n[2] * inv, -n[1] * inv])
    b = np.cross(c, n)
    return local[0] * b + local[1] * c + local[2] * n


def indirect_light(s, hit, wo, rng, p_rr, depth, max_depth):
    """pathTracingIndirectLight (Scene.cpp:789-831). `max_depth` is the
    oracle's truncation guard, mirroring the wavefront's max_bounces."""
    if depth >= max_depth:
        return np.zeros(3)
    n = hit["normal"] / np.linalg.norm(hit["normal"])
    if rng.random() > p_rr:
        return np.zeros(3)
    wi = sample_hemisphere(n, rng)
    wi = wi / np.linalg.norm(wi)
    nxt = trace(s, hit["coords"] + 1e-6 * n, wi)
    if nxt is None or np.linalg.norm(nxt["emit"]) > EPS:
        return np.zeros(3)
    kd = s["mat_kd"][hit["mat"]]
    fr = kd / np.pi if np.dot(wi, n) > 0 else np.zeros(3)
    pdf = 0.5 / np.pi if np.dot(wi, n) > 0 else 0.0
    cos_o = max(0.0, np.dot(wi, n))
    if np.isnan(pdf) or pdf < EPS:
        return np.zeros(3)
    rad = shading(s, nxt, -wi, rng, p_rr, depth + 1, max_depth)
    return rad * fr * cos_o / (pdf * p_rr)


def shading(s, hit, wo, rng, p_rr, depth, max_depth):
    """pathTracingShading (Scene.cpp:833-855)."""
    return direct_light(s, hit, wo, rng) + indirect_light(
        s, hit, wo, rng, p_rr, depth, max_depth
    )


def path_trace_pixel(s, o, d, rng, p_rr=0.8, max_depth=17):
    """Scene::pathTracing for one camera ray, one sample."""
    hit = trace(s, o, d)
    if hit is None:
        return s["background"].copy()
    return shading(s, hit, -d, rng, p_rr, 0, max_depth)
