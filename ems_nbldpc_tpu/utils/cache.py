"""Fixed on-disk cache locations inside the checkout.

Both caches live at paths that never depend on a temp name, a pid or the
clock, so a later run of the same checkout finds what an earlier one wrote:

* JAX's persistent compilation cache.  If ``JAX_COMPILATION_CACHE_DIR`` is
  set, JAX reads it itself and nothing here overrides it; otherwise the
  entry points (``cli.main``, ``bench.py``, ``chip_smoke.py``) call
  :func:`enable_compile_cache` before their first compile.
* The encoder's Gaussian-elimination / bit-generator cache
  (``NBLDPC_CACHE_DIR`` overrides it).
"""
from __future__ import annotations

import os

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
COMPILE_CACHE_DIR = os.path.join(REPO_ROOT, ".jax_cache")
ENCODER_CACHE_DIR = os.environ.get(
    "NBLDPC_CACHE_DIR", os.path.join(REPO_ROOT, "data", "encoder_cache")
)


def enable_compile_cache() -> str | None:
    """Point JAX's compilation cache at ``COMPILE_CACHE_DIR`` unless the
    environment already chose one.  Returns the path set, or None."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    import jax

    jax.config.update("jax_compilation_cache_dir", COMPILE_CACHE_DIR)
    return COMPILE_CACHE_DIR
