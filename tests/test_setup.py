"""Process set-up: where the persistent compile cache lives."""

import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PROBE = ("import software_rasterizer_tpu, jax; "
         "print(jax.config.jax_compilation_cache_dir)")


def _cache_dir(env_value):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_value is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_value
    r = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300,
                       check=True)
    return r.stdout.strip().splitlines()[-1]


def test_compile_cache_defaults_inside_checkout():
    assert _cache_dir(None) == str(ROOT / ".jax_cache")
    assert ".jax_cache/" in (ROOT / ".gitignore").read_text().split()


def test_compile_cache_follows_env(tmp_path):
    want = str(tmp_path / "cache")
    assert _cache_dir(want) == want
