"""Device-mesh construction for rendering workloads.

Axes (SURVEY.md 2.9 / 7.1 "Distribution"):

  * ``spp``  — sample-parallelism: each slice of devices computes a
    disjoint range of per-pixel sample indices; partial sum-images merge
    with one `psum` (the renderer's data-parallel axis).
  * ``tile`` — screen-space parallelism: the framebuffer's pixel lanes
    are sharded; a pure map with no communication until the final
    gather (the renderer's spatial/context-parallel axis).

On one host every card reaches every other at the same rate, so the
mesh shape follows the algorithm alone. Across hosts, lay ``spp`` over
the slower (inter-host) axis so the single psum crosses it once (jax
orders mesh axes major-to-minor over the device list).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh


@dataclasses.dataclass(frozen=True)
class RenderMesh:
    """A named 2-axis device mesh ("spp", "tile") plus helpers."""

    mesh: Mesh

    @property
    def n_spp(self) -> int:
        return self.mesh.shape["spp"]

    @property
    def n_tile(self) -> int:
        return self.mesh.shape["tile"]

    @property
    def n_devices(self) -> int:
        return self.n_spp * self.n_tile


def make_render_mesh(
    n_spp: int = 1,
    n_tile: Optional[int] = None,
    devices: Optional[Sequence] = None,
) -> RenderMesh:
    """Build a ("spp", "tile") mesh over `devices` (default: all).

    `n_tile` defaults to len(devices) // n_spp.
    """
    devices = list(devices if devices is not None else jax.devices())
    if n_tile is None:
        if len(devices) % n_spp:
            raise ValueError(f"{len(devices)} devices not divisible by spp={n_spp}")
        n_tile = len(devices) // n_spp
    n = n_spp * n_tile
    if n > len(devices):
        raise ValueError(f"mesh {n_spp}x{n_tile} needs {n} devices, have {len(devices)}")
    arr = np.asarray(devices[:n]).reshape(n_spp, n_tile)
    return RenderMesh(Mesh(arr, axis_names=("spp", "tile")))
