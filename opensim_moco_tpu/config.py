"""Global configuration for the framework.

The framework is dtype-parametric: solver-grade accuracy (IPOPT-class
tolerances, cf. reference Moco/Moco/MocoInverse.cpp:38-39 using 1e-3) needs
float64, which JAX provides natively on the CPU and the GPU. Hot batched
production solves can run float32 with iterative refinement.

Nothing here mutates global JAX state on import; call :func:`use_x64`,
:func:`use_compilation_cache` or :func:`require_gpu` explicitly (tests call
``use_x64`` through conftest.py).
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def use_x64(enable: bool = True) -> None:
    """Enable 64-bit mode globally."""
    jax.config.update("jax_enable_x64", enable)


def default_dtype():
    """The working dtype: float64 when x64 is enabled, else float32."""
    return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32


def is_x64() -> bool:
    return bool(jax.config.jax_enable_x64)


def use_compilation_cache() -> str:
    """Keep JAX's persistent compilation cache at a fixed path; return it.

    ``JAX_COMPILATION_CACHE_DIR``, when set, names the cache and JAX reads
    it itself. Otherwise the cache is ``<repo>/.jax_cache``: the directory
    is part of the cache key, so it must not move between runs.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(REPO_ROOT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def check_gpu(devices) -> None:
    """Raise SystemExit unless ``devices`` are GPUs."""
    platform = devices[0].platform if devices else None
    if platform != "gpu":
        raise SystemExit(f"no GPU found: JAX platform is {platform!r}")


def require_gpu():
    """Restrict JAX to its CUDA backend and return the GPU devices.

    Call before any other JAX work. A host without a usable card exits
    with an error instead of falling back to the CPU.
    """
    jax.config.update("jax_platforms", "cuda")
    try:
        devices = jax.devices()
    # RuntimeError: the CUDA plugin finds no card; AssertionError: no CUDA
    # plugin is installed, so JAX has no backend at all
    except (RuntimeError, AssertionError) as e:
        raise SystemExit(f"no GPU found: {e!r}") from e
    check_gpu(devices)
    return devices
