"""Device compute: raster/intersect/BVH kernels, shaders, integrators.

Everything here is jnp over flattened scene arrays (plus one Pallas
trace kernel, ops/trace_kernel.py) — recursion becomes `lax.scan`
wavefronts, SIMD lanes become array lanes, TBB tiles become sharded
framebuffer tiles (SURVEY.md section 2.9).
"""
