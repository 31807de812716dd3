"""Monte-Carlo sampling primitives (reference: Material.cpp:14-47,
Scene.cpp:398-476, Triangle.cpp:187-213, Sphere.cpp:156-183).

All samplers take explicit jax PRNG keys — counter-based per
(pixel, sample, bounce), replacing the reference's SHARED UNLOCKED
mt19937 (Tools.cpp:295-300, a data race; SURVEY.md 3.4) with
device-count-invariant determinism.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from software_rasterizer_tpu.ops import optics

PI = jnp.float32(jnp.pi)
INV_PI = jnp.float32(1.0 / jnp.pi)
UNIFORM_HEMI_PDF = jnp.float32(0.5 / jnp.pi)  # Material.hpp uniform_sampling_on_sphere


def sample_uniform_hemisphere(key, n):
    """Material::sample for DIFFUSE_AND_GLOSSY (Material.cpp:14-34):
    z = |1-2*x1|, r = sqrt(1-z^2), phi = 2*pi*x2, mapped by toWorld(N).

    n: (...,3) normals. Returns wi (...,3) (NOT normalized by the
    reference either before toWorld; frame is orthonormal so it is unit).
    """
    shape = n.shape[:-1]
    k1, k2 = jax.random.split(key)
    x1 = jax.random.uniform(k1, shape)
    x2 = jax.random.uniform(k2, shape)
    z = jnp.abs(1.0 - 2.0 * x1)
    r = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))
    phi = 2.0 * PI * x2
    local = jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), z], axis=-1)
    return optics.to_world(local, n)


def hemisphere_pdf(wi, n):
    """Material::pdf (Material.cpp:41-47): 1/2pi if wi.N > 0 else 0."""
    return jnp.where(jnp.sum(wi * n, axis=-1) > 0, UNIFORM_HEMI_PDF, 0.0)


def fr_diffuse(kd, wi, n):
    """Material::fr_contribution (Material.cpp:53-63): Kd/pi if wi.N>0."""
    return jnp.where(
        (jnp.sum(wi * n, axis=-1) > 0)[..., None], kd * INV_PI, 0.0
    )


def sample_unit_sphere(key, shape):
    """glm::sphericalRand(1.0): uniform direction on the unit sphere."""
    v = jax.random.normal(key, shape + (3,))
    return v / jnp.maximum(jnp.linalg.norm(v, axis=-1, keepdims=True), 1e-20)


def pick_emissive_object(scene, key, n: int):
    """Uniformly pick one emissive object per lane (Scene.cpp:416-418).
    Returns (center (N,3), radius (N,), any_emitter scalar bool)."""
    from software_rasterizer_tpu.ops.intersect import _onehot_rows

    n_emissive = scene.n_emitters
    u = jax.random.uniform(key, (n,))
    k = jnp.floor(u * jnp.maximum(n_emissive, 1).astype(jnp.float32)).astype(jnp.int32)
    k = jnp.minimum(k, jnp.maximum(n_emissive - 1, 0))
    cr = _onehot_rows(k, scene.emitter_cr)   # gather-free emitter pick
    return cr[:, 0:3], cr[:, 3], n_emissive > 0


def sample_light_dir(scene, key, p):
    """Scene::sampleLight (Scene.cpp:429-476): bounding-sphere direction
    sampling with the hemisphere flip + 1e-6 perturbation.

    p: (N,3) shading points. Returns (light_dir (N,3), pdf (N,)).
    pdf = cos(theta)/(2 pi) with theta against the baseline direction.
    """
    n = p.shape[0]
    k_pick, k_dir, k_pert = jax.random.split(key, 3)
    center, radius, any_e = pick_emissive_object(scene, k_pick, n)
    baseline = optics.normalize(center - p)
    s = sample_unit_sphere(k_dir, (n,))
    s = jnp.where(jnp.sum(s * baseline, axis=-1, keepdims=True) < 0, -s, s)
    pert = sample_unit_sphere(k_pert, (n,)) * 1e-6
    s = optics.normalize(s + pert)
    sample_pos = center + s * radius[:, None]
    light_dir = optics.normalize(sample_pos - p)
    cos_t = jnp.sum(light_dir * baseline, axis=-1)
    pdf = UNIFORM_HEMI_PDF * cos_t
    pdf = jnp.where(any_e, pdf, 0.0)
    return light_dir, pdf


def triangle_area(v0, v1, v2):
    """0.5*|e1 x e2| (Triangle::calcArea, Triangle.cpp:259-266)."""
    return 0.5 * jnp.linalg.norm(jnp.cross(v1 - v0, v2 - v0), axis=-1)


def sample_triangle(key, v0, v1, v2, n0, n1, n2):
    """Triangle::sample (Triangle.cpp:187-213): uniform area sampling via
    the sqrt-u warp u=sqrt(x1), b=(1-u, u(1-x2), u*x2); normal is the
    barycentric-interpolated vertex normal (Tools::interpolateNormal,
    normalized). Batched over leading dims of v0..n2 ((...,3) each).

    Returns (coords (...,3), normal (...,3), pdf (...,) = 1/area).
    """
    shape = v0.shape[:-1]
    k1, k2 = jax.random.split(key)
    u = jnp.sqrt(jax.random.uniform(k1, shape))
    v = jax.random.uniform(k2, shape)
    b1 = 1.0 - u
    b2 = u * (1.0 - v)
    b3 = u * v
    coords = b1[..., None] * v0 + b2[..., None] * v1 + b3[..., None] * v2
    normal = optics.normalize(
        b1[..., None] * n0 + b2[..., None] * n1 + b3[..., None] * n2
    )
    pdf = 1.0 / jnp.maximum(triangle_area(v0, v1, v2), 1e-30)
    return coords, normal, pdf


def sample_sphere_surface(key, center, radius):
    """Sphere::sample (Sphere.cpp:156-183): the reference's (theta, phi)
    parameterization — theta = 2*pi*x1 (azimuth), phi = pi*x2 (polar),
    dir = (cos phi, sin phi cos theta, sin phi sin theta). NOTE this is
    faithfully NON-uniform over the surface (density ~ 1/sin(phi), the
    reference quirk) while its reported pdf is the uniform 1/(4 pi r^2).

    center (...,3), radius (...,). Returns (coords, normal, pdf).
    """
    shape = radius.shape
    k1, k2 = jax.random.split(key)
    theta = 2.0 * PI * jax.random.uniform(k1, shape)
    phi = PI * jax.random.uniform(k2, shape)
    d = jnp.stack(
        [jnp.cos(phi), jnp.sin(phi) * jnp.cos(theta), jnp.sin(phi) * jnp.sin(theta)],
        axis=-1,
    )
    coords = center + radius[..., None] * d
    pdf = 1.0 / jnp.maximum(4.0 * PI * radius * radius, 1e-30)
    return coords, d, pdf


def emissive_prim_areas(scene):
    """Per-primitive surface areas masked to emissive primitives
    (triangles then spheres, matching the prim_attr packing).

    Areas are computed in the traced (post-MVP) space, like the
    reference's calcArea on updatePosition'd vertices."""
    tri_emis = (
        (jnp.linalg.norm(scene.mat_emit[scene.tri_mat], axis=-1) > EPSILON_AREA)
        & scene.tri_valid
    )
    tri_area = triangle_area(scene.v0, scene.v1, scene.v2)
    sph_emis = (
        (jnp.linalg.norm(scene.mat_emit[scene.sph_mat], axis=-1) > EPSILON_AREA)
        & scene.sph_valid
    )
    sph_area = 4.0 * PI * scene.sph_r * scene.sph_r
    return (
        jnp.concatenate([jnp.where(tri_emis, tri_area, 0.0),
                         jnp.where(sph_emis, sph_area, 0.0)]),
        jnp.concatenate([scene.tri_obj, scene.sph_obj]),
    )


EPSILON_AREA = 1e-5  # Material::hasEmission threshold (Material.cpp:65-68)


def sample_light_area(scene, key, n: int):
    """Scene::sampleLight (Scene.cpp:620-669): area-weighted emissive
    sampling. The reference picks an emissive OBJECT by cumulative area,
    then samples its surface through the mesh BVH's cumulative-area
    descend (BVHAcceleration.cpp:200-232) — the composition selects each
    emissive primitive with probability area/total_area; a prefix-sum +
    searchsorted over the flat emissive-primitive table realizes the
    identical distribution without divergent descent (array form;
    see ops/bvh.bvh_sample_area for the literal descend, tested
    equivalent).

    pdf is FAITHFUL to the reference: 1/area(chosen OBJECT) — the
    author-acknowledged un-normalized scheme (Scene.hpp:113 "(wrong)").

    Returns (coords (N,3), normal (N,3), emit (N,3), pdf (N,)).
    """
    areas, prim_obj = emissive_prim_areas(scene)
    n_obj = scene.emitter_mask.shape[0]
    obj_area = jax.ops.segment_sum(areas, prim_obj, num_segments=n_obj)
    cum = jnp.cumsum(areas)
    total = cum[-1]

    k_pick, k_tri, k_sph = jax.random.split(key, 3)
    tgt = jax.random.uniform(k_pick, (n,)) * total
    prim = jnp.searchsorted(cum, tgt, side="right").astype(jnp.int32)
    prim = jnp.minimum(prim, areas.shape[0] - 1)

    f = scene.v0.shape[0]
    is_sph = prim >= f
    tidx = jnp.minimum(prim, f - 1)
    sidx = jnp.clip(prim - f, 0, scene.sph_c.shape[0] - 1)

    tc, tn, _ = sample_triangle(
        k_tri, scene.v0[tidx], scene.v1[tidx], scene.v2[tidx],
        scene.n0[tidx], scene.n1[tidx], scene.n2[tidx],
    )
    sc, sn, _ = sample_sphere_surface(k_sph, scene.sph_c[sidx], scene.sph_r[sidx])

    coords = jnp.where(is_sph[:, None], sc, tc)
    normal = jnp.where(is_sph[:, None], sn, tn)
    mat = jnp.where(is_sph, scene.sph_mat[sidx], scene.tri_mat[tidx])
    emit = scene.mat_emit[mat]
    obj = prim_obj[prim]
    pdf = 1.0 / jnp.maximum(obj_area[obj], 1e-30)
    pdf = jnp.where(total > 0, pdf, 0.0)
    return coords, normal, emit, pdf
