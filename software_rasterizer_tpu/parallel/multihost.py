"""Multi-host runtime (SURVEY.md 5.8: the distributed layer the
reference entirely lacks).

On a multi-host cluster every host runs the same program; `initialize()`
wires `jax.distributed`, after which `jax.devices()` spans all hosts and
the ("spp", "tile") RenderMesh in parallel/mesh.py shards globally —
`sharded_path_render`'s psum then spans every device. Host-local
framebuffer shards are assembled with `gather_image`.

Single-host (or single-chip) processes no-op cleanly, so the same entry
point works everywhere.
"""

from __future__ import annotations

import os
from typing import Optional


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Initialize jax.distributed from args or the standard env vars
    (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID).
    Returns True when a multi-process runtime was started."""
    import jax

    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    )
    if num_processes is None and os.environ.get("JAX_NUM_PROCESSES"):
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and os.environ.get("JAX_PROCESS_ID"):
        process_id = int(os.environ["JAX_PROCESS_ID"])

    if coordinator_address is None and num_processes in (None, 1):
        return False  # single-process: nothing to do
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return True


def process_info():
    import jax

    return {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "local_devices": len(jax.local_devices()),
        "global_devices": len(jax.devices()),
    }


def gather_image(img):
    """Assemble a (possibly host-sharded) rendered image onto every host
    as a numpy array (the golden-image merge step; DCN traffic happens
    only here, once per frame)."""
    import jax
    import numpy as np

    if jax.process_count() == 1:
        return np.asarray(img)
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(img, tiled=True))
