"""The one place that decides which JAX platform the program runs on,
and where its persistent compile cache lives.

The platform is JAX's own choice (``JAX_PLATFORMS`` or its default
order) unless the CLI names one; a named platform that is missing is an
error, never a silent fall back to the CPU.
"""

from __future__ import annotations

import os

#: ``<checkout>/.jax_cache``: a fixed path, because the cache key
#: includes it (a directory that moves between runs never hits)
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))),
    ".jax_cache",
)


def on_accelerator() -> bool:
    """True when JAX's default device is not the host CPU."""
    import jax

    return jax.devices()[0].platform != "cpu"


def select_platform(name: str) -> None:
    """Pin JAX to `name` ('cpu' or 'gpu', meaning CUDA: JAX's own "gpu"
    also demands a ROCm backend); raises SystemExit with the reason
    when JAX finds no device of that kind."""
    import jax

    jax.config.update("jax_platforms",
                      "cuda,cpu" if name == "gpu" else name)
    try:
        platform = jax.devices()[0].platform
    except RuntimeError as e:
        raise SystemExit(f"error: --platform {name}: no {name} device: {e}")
    if platform != name:
        raise SystemExit(f"error: --platform {name}: no {name} device; "
                         f"JAX found only {platform}")


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compile cache and return its directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is left to JAX (nothing is
    set in code); otherwise the cache goes to ``<checkout>/.jax_cache``.
    Call before the first compilation."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR
