"""What every measuring entry point (``chip_smoke.py``, ``bench.py``, the
scripts in ``benchmarks/``) does before it measures: keep JAX's persistent
compile cache at a fixed place, refuse to run anywhere but on an NVIDIA GPU,
and name the card it ran on beside its numbers.

Importing this module does not import JAX; :func:`require_gpu` does.
"""

from __future__ import annotations

import os
import shutil
import subprocess

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"


def compile_cache_dir(environ=os.environ) -> str:
    """``$JAX_COMPILATION_CACHE_DIR`` when set, else ``<checkout>/.jax_cache``.

    The directory is part of the cache key, so the fallback is a fixed path
    inside the checkout, never one built from a temp name, a pid or a time.
    """
    return environ.get(CACHE_ENV) or os.path.join(REPO, ".jax_cache")


def enable_compile_cache(environ=os.environ) -> str:
    """Point JAX's persistent compile cache at :func:`compile_cache_dir`.

    JAX reads ``$JAX_COMPILATION_CACHE_DIR`` itself, so this sets the
    option only when the variable is unset."""
    import jax

    path = compile_cache_dir(environ)
    if not environ.get(CACHE_ENV):
        jax.config.update("jax_compilation_cache_dir", path)
    return path


def card_name_and_power() -> str:
    """``name, power.limit`` of every visible card, as nvidia-smi gives it."""
    if shutil.which("nvidia-smi") is None:
        raise RuntimeError("nvidia-smi not found: no NVIDIA driver here")
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    if not out:
        raise RuntimeError("nvidia-smi lists no GPU")
    return out


def require_gpu(count: int | None = None):
    """Return ``jax.devices()`` after checking they are GPUs (``count`` of
    them when given). There is no CPU fallback: a number taken on the CPU
    must never pass for a GPU measurement."""
    import jax

    devices = jax.devices()
    platform = devices[0].platform
    if platform != "gpu":
        raise SystemExit(
            f"needs an NVIDIA GPU; JAX found platform {platform!r}"
        )
    if count is not None and len(devices) != count:
        raise SystemExit(f"needs {count} GPUs; JAX found {len(devices)}")
    return devices


def device_record(devices) -> dict:
    d = devices[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(devices)}


def print_header(devices) -> None:
    """Print the device lines that precede every result."""
    import jax

    rec = device_record(devices)
    print(f"device: platform={rec['platform']} kind={rec['kind']} "
          f"count={rec['count']} jax={jax.__version__}", flush=True)
    print(card_name_and_power(), flush=True)  # nvidia-smi's own line
