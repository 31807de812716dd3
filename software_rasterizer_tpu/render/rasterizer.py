"""TraditionalRasterizer pipeline (reference: src/Rasterizer.cpp).

Each draw(): flatten the scene's per-frame matrices (host, tiny) and run
the jitted device raster step. The geometry bundle is cached — the
animated-rotation benchmark loop (main.cpp:113-175) re-runs only the
device step with fresh matrices, so shapes stay static and jit caches.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import jax
import numpy as np

from software_rasterizer_tpu.models.scene import RasterGeometry, Scene
from software_rasterizer_tpu.ops.lines import rasterize_wireframe
from software_rasterizer_tpu.ops.raster import render_raster_frame
from software_rasterizer_tpu.render.pipeline import Primitive, RenderingPipeline


class TraditionalRasterizer(RenderingPipeline):
    def __init__(self, width: int, height: int, tile: Tuple[int, int] = (128, 128), chunk: int = 512):
        super().__init__(width, height)
        self.tile = tile
        self.chunk = chunk
        self._geom_cache: Dict[str, RasterGeometry] = {}
        self._geom_rev: Dict[str, int] = {}
        self._batch_fns: Dict[str, object] = {}

    def invalidate(self, scene_name: Optional[str] = None):
        """Drop cached geometry (call after adding/removing meshes)."""
        if scene_name is None:
            self._geom_cache.clear()
            self._batch_fns.clear()
        else:
            self._geom_cache.pop(scene_name, None)
            self._batch_fns.pop(scene_name, None)

    def _geometry(self, scene: Scene):
        entry = self._geom_cache.get(scene.name)
        if entry is None or self._geom_rev.get(scene.name) != len(scene.meshes()):
            g = scene.raster_geometry()
            active = tuple(sorted(set(int(t) for t in g.shader_type)))
            g = jax.tree_util.tree_map(jax.device_put, g)
            entry = (g, active)
            self._geom_cache[scene.name] = entry
            self._geom_rev[scene.name] = len(scene.meshes())
            # the batched-dispatch closure captures geom — rebuild it
            self._batch_fns.pop(scene.name, None)
        return entry

    def draw_batch(self, scene: Scene, frames):
        """Render K frames of one scene in ONE device dispatch.

        `frames`: list of `RasterFrame` bundles (scene.raster_frame()
        captured after each per-frame matrix update — the batched analog
        of the reference's rotate-then-draw loop, main.cpp:113-175).
        Returns (images (K,H,W,3) f32, zbufs (K,H,W) f32) as device
        arrays (np.asarray to fetch).

        Why: one dispatch per frame pays the host->device launch cost
        per frame. Batching K frames into one jitted lax.map amortizes
        it; frames are independent, and
        each (image, zbuf) pair is bit-identical to a draw() of the
        same matrices (asserted in tests/test_raster.py)."""
        import jax.numpy as jnp

        geom, active = self._geometry(scene)
        stacked = jax.tree_util.tree_map(
            lambda *a: jnp.stack([jnp.asarray(x) for x in a]), *frames
        )

        run = self._batch_fns.get(scene.name)
        if run is None:
            def run(st, geom=geom, active=active):
                return jax.lax.map(
                    lambda fr: render_raster_frame(
                        geom, fr, self.height, self.width,
                        tile=self.tile, chunk=self.chunk,
                        active_types=active,
                    ),
                    st,
                )
            run = jax.jit(run)
            self._batch_fns[scene.name] = run

        return run(stacked)

    def draw(self, primitive: Primitive = Primitive.TRIANGLES):
        if primitive not in (Primitive.LINES, Primitive.TRIANGLES):
            raise ValueError("Primitive Type is not supported!")
        for scene in self.scenes.values():
            geom, active = self._geometry(scene)
            frame = scene.raster_frame()
            if primitive == Primitive.TRIANGLES:
                image, zbuf = render_raster_frame(
                    geom, frame, self.height, self.width,
                    tile=self.tile, chunk=self.chunk, active_types=active,
                )
            else:
                image, zbuf = rasterize_wireframe(
                    geom, frame, self.height, self.width
                )
            image = np.asarray(image)
            zbuf = np.asarray(zbuf)
            # multi-scene composition via shared z-buffer (Render.hpp:250-257)
            nearer = zbuf < self.zbuffer
            self.frame = np.where(nearer[..., None], image, self.frame)
            self.zbuffer = np.minimum(zbuf, self.zbuffer)
