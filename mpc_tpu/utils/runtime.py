"""Process set-up shared by the entry points (CLI, ``bench.py``,
``chip_smoke.py``): the persistent compile cache and the card's identity."""
from __future__ import annotations

import os
import shutil
import subprocess

import jax

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    ``$JAX_COMPILATION_CACHE_DIR`` wins when set (JAX reads it itself);
    otherwise the cache lives at the fixed ``<checkout>/.jax_cache`` (the
    path is part of the cache key, so it must not move between runs).
    """
    d = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not d:
        d = os.path.join(CHECKOUT, ".jax_cache")
        jax.config.update("jax_compilation_cache_dir", d)
    return d


def require_gpu() -> jax.Device:
    """The first device, which must be a GPU (measurements never fall
    back to the CPU)."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"no GPU: JAX's default device is {dev.platform} "
                         f"({dev.device_kind}); this entry point measures "
                         "the GPU only")
    return dev


def gpu_name_and_power_limit() -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    for the first card (a card below its maximum power limit runs slower
    under load, so every timing is reported beside this line)."""
    exe = shutil.which("nvidia-smi") or "/usr/bin/nvidia-smi"
    out = subprocess.run(
        [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]
