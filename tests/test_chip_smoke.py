"""chip_smoke.py off the card: it refuses to run without a GPU (no result
line, non-zero exit), and its golden-comparison rules accept the CPU's
own golden renders and reject a wrong one."""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_chip_smoke_fails_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert "no GPU" in r.stderr
    for line in r.stdout.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)


@pytest.fixture(scope="module")
def golden_renders():
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    import jax
    import jax.numpy as jnp

    from software_rasterizer_tpu.ops.intersect import prepare_rt_scene
    from software_rasterizer_tpu.ops.path import path_render
    from software_rasterizer_tpu.ops.raster import render_raster_frame
    from software_rasterizer_tpu.ops.whitted import whitted_render
    from software_rasterizer_tpu.scenes import build_cornell_scene

    scene = build_cornell_scene()
    scene.set_ndc_matrix(96, 96)
    geom = jax.tree_util.tree_map(jnp.asarray, scene.raster_geometry())
    img, z = render_raster_frame(geom, scene.raster_frame(), 96, 96)
    scene = build_cornell_scene()
    scene.set_ndc_matrix(64, 64)
    rt = prepare_rt_scene(scene.rt_geometry(), scene.rt_frame())
    wh = whitted_render(rt, 64, 64, scene.fovy, jax.random.PRNGKey(0),
                        spp=1, max_depth=4)
    scene = build_cornell_scene()
    scene.set_ndc_matrix(48, 48)
    rt = prepare_rt_scene(scene.rt_geometry(), scene.rt_frame())
    pt = path_render(rt, 48, 48, scene.fovy, jax.random.PRNGKey(0), spp=8)
    return chip_smoke, tuple(np.asarray(a) for a in (img, z, wh, pt))


@pytest.mark.parametrize("corrupt", [None, "raster", "whitted", "path"])
def test_check_goldens_rules(golden_renders, corrupt):
    chip_smoke, (img, z, wh, pt) = golden_renders
    if corrupt == "raster":
        img = img + 0.01
    elif corrupt == "whitted":
        wh = wh * 1.5
    elif corrupt == "path":
        pt = pt + 0.05
    rows = chip_smoke.check_goldens(img, z, wh, pt,
                                    np.load(chip_smoke.GOLDENS))
    failed = {name.split("_")[0] for name, _, _, ok in rows if not ok}
    assert failed == (set() if corrupt is None else {corrupt})
