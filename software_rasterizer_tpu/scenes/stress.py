"""Large-scene stress workload: a seeded procedural closed surface.

The reference's scenes top out at ~6K triangles (spot 5856, bunny 4968).
This scene stands in for the reference's Stanford bunny, tessellated past
10^5 triangles, without any asset file: an icosphere subdivided to 5120
faces (about the bunny's count), then split `levels` more times by
recursive midpoint subdivision (4^k faces per source face), projected
onto the unit sphere and displaced radially by a seeded sum of smooth
waves. It exercises the SCALING path: BVH-leaf-ordered chunk culling
(ops/intersect._intersect_tri_raw cull_chunks, ops/trace_kernel) and the
per-ray BVH traversal (ops/bvh.bvh_nearest_hit) at >= 100K triangles,
with exactness checked against the unculled sweep (tests/test_stress.py)
and throughput measured by `BENCH_MODE=stress`.
"""

from __future__ import annotations

import numpy as np

from software_rasterizer_tpu.models.material import Material, MaterialType
from software_rasterizer_tpu.models.objects import MeshObject
from software_rasterizer_tpu.models.scene import Scene
from software_rasterizer_tpu.utils.obj_loader import MeshData

BASE_LEVELS = 4   # icosahedron (20 faces) split 4 times: 5120 faces


def subdivide_mesh(data: MeshData, levels: int = 1) -> MeshData:
    """Midpoint (1:4) subdivision of a triangle soup, `levels` times.

    New vertices are edge midpoints with attributes (normal/uv/color)
    averaged from the edge endpoints; shared edges are deduplicated so
    the surface stays watertight where the source was. Geometry is
    unchanged as a point set limit — this is a load generator, not a
    smoothing scheme (no Loop weights on purpose: the positions must
    stay ON the original surface so renders stay comparable)."""
    v, n, uv, col, f = (
        data.vertices, data.normals, data.uvs, data.colors, data.faces,
    )
    for _ in range(levels):
        nv = v.shape[0]
        edges = {}
        v_new = [v]
        n_new = [n]
        uv_new = [uv]
        c_new = [col]

        def midpoint(a: int, b: int) -> int:
            key = (a, b) if a < b else (b, a)
            m = edges.get(key)
            if m is None:
                m = nv + len(edges)
                edges[key] = m
            return m

        fa, fb, fc = f[:, 0], f[:, 1], f[:, 2]
        mab = np.array([midpoint(a, b) for a, b in zip(fa, fb)], np.int32)
        mbc = np.array([midpoint(a, b) for a, b in zip(fb, fc)], np.int32)
        mca = np.array([midpoint(a, b) for a, b in zip(fc, fa)], np.int32)

        pairs = np.array(sorted(edges, key=edges.get), np.int32)  # (E,2)
        for src, dst in ((v, v_new), (n, n_new), (uv, uv_new), (col, c_new)):
            dst.append((src[pairs[:, 0]] + src[pairs[:, 1]]) * 0.5)
        v = np.concatenate(v_new).astype(np.float32)
        n = np.concatenate(n_new).astype(np.float32)
        norms = np.linalg.norm(n, axis=-1, keepdims=True)
        n = n / np.maximum(norms, 1e-20)
        uv = np.concatenate(uv_new).astype(np.float32)
        col = np.concatenate(c_new).astype(np.float32)
        f = np.concatenate([
            np.stack([fa, mab, mca], 1),
            np.stack([mab, fb, mbc], 1),
            np.stack([mca, mbc, fc], 1),
            np.stack([mab, mbc, mca], 1),
        ]).astype(np.int32)
    return MeshData(
        name=data.name, vertices=v, normals=n, uvs=uv, colors=col, faces=f,
        material=data.material,
        bbox_min=v.min(0), bbox_max=v.max(0), had_normals=data.had_normals,
    )


def _icosahedron():
    p = (1.0 + 5.0 ** 0.5) / 2.0
    v = np.array([
        [-1, p, 0], [1, p, 0], [-1, -p, 0], [1, -p, 0],
        [0, -1, p], [0, 1, p], [0, -1, -p], [0, 1, -p],
        [p, 0, -1], [p, 0, 1], [-p, 0, -1], [-p, 0, 1],
    ], np.float32)
    f = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
    ], np.int32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True), f


def procedural_surface(levels: int = 3, seed: int = 0) -> MeshData:
    """Closed displaced icosphere with 5120 * 4**levels faces: unit-sphere
    vertices pushed out by 1 + 0.25 * (a seeded sum of 6 smooth waves),
    area-weighted vertex normals recomputed from the displaced faces."""
    v, f = _icosahedron()
    n_v = v.shape[0]
    data = MeshData(
        name="surface", vertices=v, normals=v.copy(),
        uvs=np.zeros((n_v, 2), np.float32),
        colors=np.ones((n_v, 3), np.float32), faces=f, material=None,
        bbox_min=v.min(0), bbox_max=v.max(0), had_normals=True,
    )
    data = subdivide_mesh(data, BASE_LEVELS + levels)
    u = data.vertices / np.linalg.norm(data.vertices, axis=-1, keepdims=True)
    rng = np.random.default_rng(seed)
    k = rng.normal(size=(6, 3)) * 2.5                 # wave vectors
    phase = rng.uniform(0.0, 2.0 * np.pi, 6)
    amp = rng.uniform(0.5, 1.0, 6) / 6.0
    h = (amp * np.sin(u @ k.T + phase)).sum(-1)
    pos = (u * (1.0 + 0.25 * h)[:, None]).astype(np.float32)
    f = data.faces
    fn = np.cross(pos[f[:, 1]] - pos[f[:, 0]], pos[f[:, 2]] - pos[f[:, 0]])
    nrm = np.zeros_like(pos)
    for c in range(3):
        np.add.at(nrm, f[:, c], fn)
    nrm /= np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-20)
    return MeshData(
        name="surface", vertices=pos, normals=nrm.astype(np.float32),
        uvs=data.uvs, colors=data.colors, faces=f, material=None,
        bbox_min=pos.min(0), bbox_max=pos.max(0), had_normals=True,
    )


def build_stress_scene(levels: int = 3, seed: int = 0) -> Scene:
    """The procedural surface (5120 * 4**levels faces; levels=3 ->
    327,680) lit by an emissive ceiling quad, framed like the README
    bunny walkthrough (eye (0,0,-3), object near the origin —
    README.md:288-375)."""
    scene = Scene(
        "SurfaceStress",
        eye=(0.0, 0.0, -3.0),
        center=(0.0, 0.0, 0.0),
        up=(0.0, 1.0, 0.0),
        background=(0.2355, 0.6735, 0.2400),
    )
    data = procedural_surface(levels, seed)
    mat = Material(type=MaterialType.DIFFUSE_AND_GLOSSY, Kd=(0.7, 0.7, 0.7))
    scene.add_graphic_obj(MeshObject(data, material=mat), "surface")
    scene.set_model_matrix(
        "surface", (0.0, 1.0, 0.0), 0.0, (0.0, 0.0, 0.0), (1.0, 1.0, 1.0)
    )
    # emissive quad above (two triangles), so integrators have a light
    lv = np.array([
        [-1.0, 2.0, -1.0], [1.0, 2.0, -1.0],
        [1.0, 2.0, 1.0], [-1.0, 2.0, 1.0],
    ], np.float32)
    ln = np.tile(np.array([[0.0, -1.0, 0.0]], np.float32), (4, 1))
    light_data = MeshData(
        name="light", vertices=lv, normals=ln,
        uvs=np.zeros((4, 2), np.float32),
        colors=np.ones((4, 3), np.float32),
        faces=np.array([[0, 1, 2], [0, 2, 3]], np.int32),
        material=None, bbox_min=lv.min(0), bbox_max=lv.max(0),
        had_normals=True,
    )
    lmat = Material(
        type=MaterialType.DIFFUSE_AND_GLOSSY, Kd=(1.0, 1.0, 1.0),
        emission=(24.0, 24.0, 24.0),
    )
    scene.add_graphic_obj(MeshObject(light_data, material=lmat), "light")
    scene.set_model_matrix(
        "light", (0.0, 1.0, 0.0), 0.0, (0.0, 0.0, 0.0), (1.0, 1.0, 1.0)
    )
    return scene
