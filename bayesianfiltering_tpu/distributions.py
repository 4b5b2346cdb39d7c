"""Native multivariate-normal primitives (Cholesky-based).

The reference leans on ``tensorflow_probability.substrates.jax`` for every
MVN sample / log-prob (e.g. ref: gaussfiltax/inference.py:7,24,367 and
gaussfiltax/models.py:4). TFP is a heavy dependency and its generic
distribution machinery adds dispatch overhead inside `scan` bodies; all we
need is a Cholesky factorization feeding triangular solves (fuses with
neighbours under XLA). We therefore implement the MVN
ops natively and expose a minimal distribution shim with the TFP call
surface used by the model layer (`.sample(seed=...)`, `.log_prob(x)`).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import jax
import jax.numpy as jnp
import jax.random as jr

from bayesianfiltering_tpu.types import PRNGKey
from bayesianfiltering_tpu.utils.linalg import fast_cholesky, tri_inv_lower

_LOG_2PI = math.log(2.0 * math.pi)


def mvn_logpdf(x: jax.Array, mean: jax.Array, cov: jax.Array) -> jax.Array:
    """Log-density of ``N(x | mean, cov)`` via Cholesky.

    Equivalent of the TFP call at ref: gaussfiltax/inference.py:24 and of the
    NumPy ``gaussian_logpdf`` (ref: gaussfiltax/utils.py:75-79), but computed
    with a single Cholesky + triangular solve so XLA can fuse it into the
    surrounding filter step. Supports leading batch dimensions on all args.
    """
    x = jnp.atleast_1d(x)
    mean = jnp.atleast_1d(mean)
    cov = jnp.atleast_2d(cov)
    dim = x.shape[-1]
    chol = fast_cholesky(cov)
    diff = x - mean
    if cov.ndim == 2 and diff.ndim > 1:
        # Shared covariance, batched residuals (the particle-filter hot
        # path): invert the small triangular factor ONCE and whiten via a
        # single batched matmul instead of a large-batch tiny
        # TriangularSolve.
        linv = jax.scipy.linalg.solve_triangular(
            chol, jnp.eye(dim, dtype=chol.dtype), lower=True
        )
        # precision pin: whitening feeds log-weights, so keep full f32 (no
        # TF32; the cost is negligible at these shapes).
        z = jnp.einsum("ij,...j->...i", linv, diff,
                       precision=jax.lax.Precision.HIGHEST)
    else:
        z = jnp.einsum("...ij,...j->...i", tri_inv_lower(chol), diff,
                       precision=jax.lax.Precision.HIGHEST)
    quad = jnp.sum(jnp.square(z), axis=-1)
    logdet = 2.0 * jnp.sum(jnp.log(jnp.diagonal(chol, axis1=-2, axis2=-1)), axis=-1)
    return -0.5 * (dim * _LOG_2PI + logdet + quad)


def mvn_sample(
    key: PRNGKey,
    mean: jax.Array,
    cov: jax.Array,
    shape: Sequence[int] = (),
) -> jax.Array:
    """Draw ``shape``-many samples from ``N(mean, cov)`` via Cholesky.

    ``mean``/``cov`` may carry matching leading batch dimensions; ``shape``
    prepends extra sample dimensions (like ``jr.multivariate_normal``).
    """
    mean = jnp.atleast_1d(mean)
    cov = jnp.atleast_2d(cov)
    dim = mean.shape[-1]
    chol = fast_cholesky(cov)
    batch_shape = jnp.broadcast_shapes(mean.shape[:-1], cov.shape[:-2])
    eps = jr.normal(key, tuple(shape) + batch_shape + (dim,), dtype=mean.dtype)
    return mean + jnp.einsum("...ij,...j->...i", chol, eps)


def mvn_sample_chol(key: PRNGKey, mean: jax.Array, chol: jax.Array,
                    shape: Sequence[int] = ()) -> jax.Array:
    """Sample given a precomputed Cholesky factor (hot-loop variant)."""
    dim = mean.shape[-1]
    batch_shape = jnp.broadcast_shapes(mean.shape[:-1], chol.shape[:-2])
    eps = jr.normal(key, tuple(shape) + batch_shape + (dim,), dtype=mean.dtype)
    return mean + jnp.einsum("...ij,...j->...i", chol, eps)


class MVN:
    """Minimal multivariate-normal distribution object.

    Drop-in for the subset of
    ``tfp.distributions.MultivariateNormalFullCovariance`` the reference
    uses: construction from ``(loc, covariance_matrix)``, ``.sample`` with a
    ``seed`` (and optional leading sample shape), and ``.log_prob``.
    """

    def __init__(
        self,
        loc: jax.Array = None,
        covariance_matrix: jax.Array = None,
    ):
        if loc is None or covariance_matrix is None:
            raise ValueError("MVN requires loc and covariance_matrix")
        self.loc = jnp.atleast_1d(loc)
        self.covariance_matrix = jnp.atleast_2d(covariance_matrix)

    # TFP-style API -----------------------------------------------------
    def sample(
        self,
        sample_shape: Union[int, Sequence[int], Tuple[()]] = (),
        seed: Optional[PRNGKey] = None,
    ) -> jax.Array:
        if seed is None:
            raise ValueError("MVN.sample requires an explicit PRNG key (seed=...)")
        if isinstance(sample_shape, int):
            sample_shape = (sample_shape,)
        return mvn_sample(seed, self.loc, self.covariance_matrix, tuple(sample_shape))

    def log_prob(self, x: jax.Array) -> jax.Array:
        return mvn_logpdf(x, self.loc, self.covariance_matrix)

    def mean(self) -> jax.Array:
        return self.loc

    def covariance(self) -> jax.Array:
        return self.covariance_matrix


# Alias matching the TFP import name used throughout the reference.
MultivariateNormalFullCovariance = MVN

__all__ = [
    "mvn_logpdf",
    "mvn_sample",
    "mvn_sample_chol",
    "MVN",
    "MultivariateNormalFullCovariance",
]
