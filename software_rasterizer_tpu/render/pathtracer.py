"""PathTracing pipeline (reference: src/PathTracing.cpp).

draw(): per scene, transform to trace space (prepare_rt_scene) and run
the wavefront Monte-Carlo integrator (ops/path.py), averaging `spp`
samples per pixel (PathTracing.cpp:62-88).

Beyond the reference, the pipeline keeps a PROGRESSIVE ACCUMULATOR
(sum image + sample count) per scene: `accumulate()` adds sample
batches, `resolve()` divides once, and `save_checkpoint()` /
`load_checkpoint()` persist the running state — SURVEY.md 5.4's
checkpoint/resume design (the same format the multi-host spp merge
uses). The RNG is keyed by absolute sample index, so a resumed or
batched render is bit-identical to a monolithic one.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import jax
import numpy as np

from software_rasterizer_tpu.models.scene import Scene
from software_rasterizer_tpu.ops.camera import camera_rays
from software_rasterizer_tpu.ops.intersect import prepare_rt_scene
from software_rasterizer_tpu.ops.path import path_render, path_render_accumulate
from software_rasterizer_tpu.render.pipeline import Primitive, RenderingPipeline
from software_rasterizer_tpu.utils.rng import make_key


class PathTracing(RenderingPipeline):
    def __init__(self, width: int, height: int, spp: int = 16,
                 max_bounces: int = 16, block: int = 1 << 16,
                 chunk: int = 512, seed: int = 0):
        super().__init__(width, height)
        self.spp = spp
        self.max_bounces = max_bounces
        self.block = block
        self.chunk = chunk
        self.seed = seed
        self._geom_cache: Dict[str, object] = {}
        # progressive state per scene: (sum_image (N,3) device, n_samples)
        self._accum: Dict[str, Tuple[object, int]] = {}

    def set_spp(self, spp: int):
        """PathTracing::setSPP."""
        self.spp = spp

    def _geometry(self, scene: Scene):
        g = self._geom_cache.get(scene.name)
        if g is None:
            g = scene.rt_geometry()
            g = jax.tree_util.tree_map(jax.device_put, g)
            self._geom_cache[scene.name] = g
        return g

    def invalidate(self, scene_name: Optional[str] = None):
        if scene_name is None:
            self._geom_cache.clear()
            self._accum.clear()
        else:
            self._geom_cache.pop(scene_name, None)
            self._accum.pop(scene_name, None)

    def _rt_scene(self, scene: Scene):
        return prepare_rt_scene(self._geometry(scene), scene.rt_frame())

    def draw(self, primitive: Primitive = Primitive.TRIANGLES):
        if primitive not in (Primitive.LINES, Primitive.TRIANGLES):
            raise ValueError("Primitive Type is not supported!")
        for scene in self.scenes.values():
            rt = self._rt_scene(scene)
            img = path_render(
                rt, self.width, self.height, scene.fovy,
                make_key(self.seed),
                spp=self.spp, p_rr=scene.rr, max_bounces=self.max_bounces,
                block=self.block, chunk=self.chunk,
            )
            self.frame = np.array(img)

    # -- progressive / resumable accumulation (SURVEY.md 5.4) ---------------

    def accumulate(self, scene_name: str, n_samples: int):
        """Add `n_samples` fresh per-pixel samples to the running sum.
        Sample indices continue from the samples already done, so
        progressive / resumed accumulation reproduces the monolithic
        render's per-sample radiance exactly."""
        scene = self.scenes[scene_name]
        rt = self._rt_scene(scene)
        acc, done = self._accum.get(
            scene_name,
            (jax.numpy.zeros((self.width * self.height, 3)), 0),
        )
        orig, d = camera_rays(rt.eye, scene.fovy, self.width, self.height)
        acc = path_render_accumulate(
            rt, orig, d, make_key(self.seed), acc, done, n_samples,
            p_rr=scene.rr, max_bounces=self.max_bounces,
            block=self.block, chunk=self.chunk,
        )
        self._accum[scene_name] = (acc, done + n_samples)

    def samples_done(self, scene_name: str) -> int:
        return self._accum.get(scene_name, (None, 0))[1]

    def resolve(self, scene_name: str) -> np.ndarray:
        """Current mean image from the accumulator; also sets self.frame."""
        acc, done = self._accum[scene_name]
        img = np.array(acc).reshape(self.height, self.width, 3) / max(done, 1)
        self.frame = img.astype(np.float32)
        return self.frame

    def save_checkpoint(self, scene_name: str, path: str):
        acc, done = self._accum[scene_name]
        np.savez(
            path, sum_image=np.array(acc), n_samples=done,
            width=self.width, height=self.height, seed=self.seed,
        )

    def load_checkpoint(self, scene_name: str, path: str):
        z = np.load(path)
        if int(z["width"]) != self.width or int(z["height"]) != self.height:
            raise ValueError("checkpoint resolution mismatch")
        self.seed = int(z["seed"])
        self._accum[scene_name] = (
            jax.device_put(z["sum_image"].astype(np.float32)),
            int(z["n_samples"]),
        )
