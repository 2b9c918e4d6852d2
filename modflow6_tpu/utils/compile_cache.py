"""Where the persistent XLA compilation cache lives.

Entry points (``bench.py``, ``chip_smoke.py``, ``python -m modflow6_tpu``)
call :func:`enable_compile_cache` once, before their first compile.  It is
never called at package import, so library users and test workers keep
JAX's own default (no persistent cache).
"""

from __future__ import annotations

import os
from pathlib import Path

# the repository checkout that holds this package
CHECKOUT = Path(__file__).resolve().parents[2]
ENV_VAR = "JAX_COMPILATION_CACHE_DIR"


def enable_compile_cache(environ=None) -> str:
    """Turn on the persistent compilation cache and return its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX has already read it and
    nothing is changed.  Otherwise the cache goes to the fixed path
    ``<checkout>/.jax_cache``: the path is part of the cache key, so it must
    not depend on a temporary directory, process id or time.
    """
    environ = os.environ if environ is None else environ
    path = environ.get(ENV_VAR)
    if path:
        return path
    import jax

    path = str(CHECKOUT / ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
