"""Package configuration knobs.

Matmul precision: on an NVIDIA GPU, XLA may run float32 matrix products on
the tensor cores in TF32, which keeps ~10 mantissa bits (about three
decimal digits). Kalman-type covariance algebra is catastrophically
sensitive to that — e.g. the innovation covariance ``S = R + H P Hᵀ`` with
small ``R`` can come out *negative* under reduced-precision cancellation,
NaN-ing the Cholesky (the reference's own BOT benchmark runs at
R = 2.5e-5). Every filter entry point in this package therefore traces its
math under ``jax.default_matmul_precision(matmul_precision())``.

Default is "highest" (true float32 products, no TF32). Override with the
``BFT_MATMUL_PRECISION`` env var (e.g. "tensorfloat32" to accept TF32
speed/risk, for large-dx throughput experiments).
"""
from __future__ import annotations

import functools
import os
from pathlib import Path

import jax

_ENV_VAR = "BFT_MATMUL_PRECISION"
_CACHE_ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
# Fixed, repo-relative: the cache key includes the path, so a directory
# that moves between runs never hits. Listed in .gitignore.
DEFAULT_CACHE_DIR = Path(__file__).resolve().parent.parent / ".jax_cache"


def matmul_precision() -> str:
    """The package-wide matmul precision name (a valid
    ``jax.default_matmul_precision`` argument)."""
    return os.environ.get(_ENV_VAR, "highest")


def with_matmul_precision(fn):
    """Decorator: trace ``fn`` under the configured matmul precision."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with jax.default_matmul_precision(matmul_precision()):
            return fn(*args, **kwargs)

    return wrapper


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache for an entry-point script.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
    sets nothing. Otherwise the cache goes to ``<repo>/.jax_cache``. Called
    by scripts (``chip_smoke.py``, ``bench.py``, ``experiments/``), never on
    package import. Returns the directory in use.
    """
    env = os.environ.get(_CACHE_ENV_VAR)
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_CACHE_DIR))
    return str(DEFAULT_CACHE_DIR)


__all__ = ["matmul_precision", "with_matmul_precision",
           "enable_compile_cache"]
