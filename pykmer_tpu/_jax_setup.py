"""Single-point JAX process configuration.

The engine does exact integer arithmetic — canonical k-mer codes need 2K bits
(K=17 exceeds int32), per-sample merge totals exceed int32 at K>=16 — so
64-bit dtypes must be available before ANY program traces. ``jax_enable_x64``
is process-global, and flipping it after other code has traced programs
invalidates jit caches and makes import order semantically significant; this
module is therefore the ONLY place the flag is written. Every jax-using
subpackage calls :func:`ensure_x64` at import (idempotent, one-shot), and
code that merely depends on the flag being set calls :func:`assert_x64`.

Also points JAX's persistent compilation cache at one fixed directory, so a
program compiles once per (shape, K) and not once per process. Where
``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this module
sets no directory; otherwise the cache lives at ``<checkout>/.jax_cache``.
"""

from __future__ import annotations

import os
from typing import Mapping, Optional

_configured = False

DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def compile_cache_dir(environ: Mapping[str, str]) -> Optional[str]:
    """The cache directory this module sets, or ``None`` when the
    environment already names one."""
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return DEFAULT_CACHE_DIR


def ensure_x64() -> None:
    """Enable 64-bit dtypes + the persistent compile cache (idempotent)."""
    global _configured
    if _configured:
        return
    import jax

    jax.config.update("jax_enable_x64", True)

    cache_dir = compile_cache_dir(os.environ)
    if cache_dir is not None:
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    _configured = True


def assert_x64() -> None:
    """Fail fast where 64-bit programs are about to trace with x64 off."""
    import jax

    if not jax.config.jax_enable_x64:
        raise RuntimeError(
            "pykmer_tpu requires jax_enable_x64: import a pykmer_tpu compute "
            "module (which sets it once) before tracing, and do not disable "
            "it mid-process"
        )
