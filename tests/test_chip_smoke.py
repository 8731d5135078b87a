"""``chip_smoke.py``'s phases at tiny sizes on the CPU, against the same
float64 references it uses on the card, and its refusal to run anywhere
but on an NVIDIA GPU."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest

import chip_smoke
from benchmarks import device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize(
    "phase,kwargs",
    [
        (chip_smoke.phase_flagship,
         dict(channels=4, seconds=0.2, block=147 * 8)),
        (chip_smoke.phase_live, dict(channels=2, seconds=0.75, block=147 * 8)),
        (chip_smoke.phase_config4,
         dict(channels=2, seconds=0.2, block=1024, ir_taps=4096)),
        (chip_smoke.phase_ops, dict(channels=2, frames=4096)),
        (chip_smoke.phase_numerics, dict(channels=4, chunk=147 * 16, steps=2)),
        (chip_smoke.phase_mesh_chain,
         dict(n_devices=4, channels=8, blocks=2, steps=2)),
        (chip_smoke.phase_mesh_pipe,
         dict(n_devices=4, channels=8, n_local=147 * 2, chunks=7,
              ir_seconds=0.02)),
    ],
    ids=lambda v: getattr(v, "__name__", ""),
)
def test_phase_small(phase, kwargs):
    """Each phase raises PhaseError when a comparison misses its bound."""
    assert phase(**kwargs)


def test_check_fails_below_bound():
    ref = np.ones((1, 8))
    with pytest.raises(chip_smoke.PhaseError):
        chip_smoke.check({}, "x", ref, ref + 1e-3, 100.0)
    with pytest.raises(chip_smoke.PhaseError):
        chip_smoke.check({}, "x", ref, ref[:, :4], 100.0)


def test_unpinned_products_found():
    import jax.numpy as jnp
    from jax import lax

    a = jnp.ones((4, 4))
    free = jax.jit(lambda a: a @ a).lower(a).as_text()
    pinned = jax.jit(
        lambda a: jnp.dot(a, a, precision=lax.Precision.HIGHEST)
    ).lower(a).as_text()
    assert len(chip_smoke.unpinned_products(free)) == 1
    assert chip_smoke.unpinned_products(pinned) == []


def test_main_refuses_without_gpu():
    """No GPU: exit non-zero and print no result line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PATH="/usr/bin:/bin")
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_require_gpu_refuses_cpu():
    with pytest.raises(SystemExit):
        device.require_gpu()


def test_compile_cache_dir_follows_env(monkeypatch, tmp_path):
    assert device.compile_cache_dir({}) == os.path.join(REPO, ".jax_cache")
    env = {device.CACHE_ENV: str(tmp_path)}
    assert device.compile_cache_dir(env) == str(tmp_path)

    old = jax.config.jax_compilation_cache_dir
    try:
        jax.config.update("jax_compilation_cache_dir", None)
        assert device.enable_compile_cache(env) == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir is None  # JAX reads env
        assert device.enable_compile_cache({}) == os.path.join(
            REPO, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == os.path.join(
            REPO, ".jax_cache")
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_dir_is_ignored_by_git():
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
