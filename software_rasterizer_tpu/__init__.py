"""software_rasterizer_tpu — a JAX rendering framework.

A JAX/XLA implementation of the capabilities of the reference CPU
renderer "SoftRasterizer" (C++17, AVX2+TBB):

  * traditional triangle rasterization (vertex transform, barycentric
    coverage, z-buffer, 5 fragment-shader types),
  * Whitted-style recursive ray tracing (Moller-Trumbore + BVH,
    Phong direct lighting, Fresnel reflect/refract),
  * Monte Carlo path tracing (NEE + uniform-hemisphere indirect with
    Russian-roulette termination),

re-designed as array programs: scenes are SoA pytrees of device arrays,
integrators are wavefront loops (`lax.scan`) instead of recursion, and
scaling axes (framebuffer tiles, samples-per-pixel) shard over a
`jax.sharding.Mesh`.

Layout:
  models/    scene data model: meshes, spheres, materials, lights, Scene
  ops/       device kernels: raster, intersect, BVH, shading, integrators
  parallel/  device-mesh sharding, multi-host render, checkpointing
  render/    user-facing pipelines (Rasterizer / RayTracing / PathTracing)
  utils/     host-side: transforms, OBJ/MTL/texture loaders, image IO
"""

__version__ = "0.1.0"

import os as _os

#: Persistent compile cache used when JAX_COMPILATION_CACHE_DIR is unset
#: (JAX reads that variable itself): a fixed directory inside the
#: checkout, so every process of one checkout shares one cache.
DEFAULT_COMPILATION_CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    ".jax_cache",
)

if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    import jax as _jax

    _jax.config.update("jax_compilation_cache_dir",
                       DEFAULT_COMPILATION_CACHE_DIR)

from software_rasterizer_tpu.config import RenderConfig  # noqa: F401
