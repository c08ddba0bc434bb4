"""Where JAX keeps compiled programs between processes.

If JAX_COMPILATION_CACHE_DIR is set, JAX reads it at import and nothing
here changes it. Otherwise the cache goes to `.jax_cache/` at the root of
the checkout: a fixed path, so a later process (or a later run on a
machine that keeps the checkout) finds what an earlier one compiled.
"""

from __future__ import annotations

import os
from pathlib import Path

ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def setup_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory and
    return that directory."""
    if os.environ.get(ENV):
        return os.environ[ENV]
    import jax

    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)
