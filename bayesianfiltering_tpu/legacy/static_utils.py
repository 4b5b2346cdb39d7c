"""Static (one-shot) augmented-joint-approximation utilities.

API parity with ref: gaussfiltax/static_utils.py: ``MixtureModel``,
``AugmentedJointApproximation`` (one-shot ALA posterior from a single
observation), and the ``plot_cov_ellipse`` helper.

Rebuild: the per-particle loop (ref :44-59) is a single batched
pass — sample all particles with one Cholesky draw, compute per-particle
linearized updates with vmapped einsums.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import jax
import jax.numpy as jnp
from jax import jacfwd, vmap

from bayesianfiltering_tpu.distributions import mvn_logpdf, mvn_sample
from bayesianfiltering_tpu.types import PRNGKey
from bayesianfiltering_tpu.utils.linalg import psd_solve, symmetrize


class MixtureModel(NamedTuple):
    """(ref: gaussfiltax/static_utils.py:17-20)"""

    means: jax.Array
    covs: jax.Array
    weights: jax.Array


class AugmentedJointApproximation:
    """One-shot ALA posterior (ref: gaussfiltax/static_utils.py:22-63).

    Given y0 = f(x) + noise with x ~ N(mu, cov): sample particles from the
    deflated N(mu, cov − Δ); each particle carries a local linearization
    J_n = f'(x_n) and yields the component

        mean_n = x_n + Δ J_nᵀ (cov_tol + J_n Δ J_nᵀ)⁻¹ (y0 − f(x_n))
        cov_n  = cov − Δ J_nᵀ (…)⁻¹ J_n Δ
        w_n   ∝ N(y0; f(x_n), cov_tol + J_n Δ J_nᵀ)
    """

    def __init__(self, num_comp: int, f: Callable, dim_in: int, dim_out: int,
                 mu, cov, cov_tol, Delta):
        self.num_comp = num_comp
        self.f = f
        self.jacobian = jacfwd(f)
        self.dim_in = dim_in
        self.dim_out = dim_out
        self.mu = jnp.asarray(mu)
        self.cov = jnp.asarray(cov)
        self.cov_tol = jnp.asarray(cov_tol)
        self.Delta = jnp.asarray(Delta)

    def _sample_particles(self, key: PRNGKey):
        self.particles = mvn_sample(key, self.mu, self.cov - self.Delta,
                                    (self.num_comp,))
        return self.particles

    def return_posterior(self, y0, key: PRNGKey) -> Tuple[MixtureModel, jax.Array]:
        """Returns (posterior mixture, per-particle gradients (N, dx, dy))."""
        particles = self._sample_particles(key)
        y0 = jnp.atleast_1d(y0)

        def one(x_n):
            J = jnp.reshape(self.jacobian(x_n), (self.dim_out, self.dim_in))
            mu_y = jnp.atleast_1d(self.f(x_n))
            Sy = symmetrize(self.cov_tol + J @ self.Delta @ J.T)
            gain = psd_solve(Sy, J @ self.Delta).T  # Δ Jᵀ Sy⁻¹
            mean = x_n + gain @ (y0 - mu_y)
            cov = symmetrize(self.cov - gain @ J @ self.Delta)
            ll = mvn_logpdf(y0, mu_y, Sy)
            return mean, cov, ll, J.T

        means, covs, lls, grads = vmap(one)(particles)
        lls = lls - jnp.max(lls)
        weights = jnp.exp(lls)
        weights = weights / jnp.sum(weights)
        return MixtureModel(means, covs, weights), grads


def plot_cov_ellipse(cov, pos, nstd: int = 2, ax=None, **kwargs):
    """Matplotlib n-sigma covariance ellipse
    (ref: gaussfiltax/static_utils.py:65-101). Import-gated on matplotlib."""
    import numpy as np

    try:
        import matplotlib.pyplot as plt
        from matplotlib.patches import Ellipse
    except ImportError as e:  # pragma: no cover
        raise ImportError("plot_cov_ellipse requires matplotlib") from e

    def eigsorted(cov):
        vals, vecs = np.linalg.eigh(cov)
        order = vals.argsort()[::-1]
        return vals[order], vecs[:, order]

    if ax is None:
        ax = plt.gca()
    vals, vecs = eigsorted(np.asarray(cov))
    theta = np.degrees(np.arctan2(*vecs[:, 0][::-1]))
    width, height = 2 * nstd * np.sqrt(vals)
    ellip = Ellipse(xy=pos, width=width, height=height, angle=theta, **kwargs)
    ax.add_artist(ellip)
    return ellip


__all__ = ["MixtureModel", "AugmentedJointApproximation", "plot_cov_ellipse"]
