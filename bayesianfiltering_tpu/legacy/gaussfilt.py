"""Legacy (v0) object-oriented Gaussian filters.

API parity with ref: gaussfiltax/gaussfilt.py — the NumPy/Python-loop
generation of the library: an additive-noise ``SSM`` holder, the
``GaussFilt`` template (generic moment-approximation predict/update
recursion), and its concrete filters ``UKF``, ``MCF`` (Monte-Carlo moment
filter), ``EKF`` (with optional second-order Hessian terms), ``MCLAF``
(Monte-Carlo linearization-augmented filter), plus the composite
``GaussSumFilt(gauss_filt, num_models)`` bank.

Rebuild notes:
* the per-timestep Python ``for`` loop (ref: gaussfiltax/gaussfilt.py:106)
  becomes one ``lax.scan``; component banks are ``vmap``-ed;
* moment approximations return clean shapes ``((dy,), (dy,dy), (dx,dy))``
  instead of the reference's ``[1, d]`` reshape convention;
* randomness is explicit: stochastic filters take a ``key`` in their
  constructor (default ``PRNGKey(0)``) and fold the timestep in;
* ``EKF(order=2)`` actually applies the second-order correction — the
  reference computes the Hessian terms but ships them commented out
  (ref: gaussfiltax/gaussfilt.py:241-247);
* return layout is time-major: ``run`` returns ``(ll (T,), means (T,dx),
  covs (T,dx,dx))`` without the reference's trailing-initial-condition slot.
"""
from __future__ import annotations

from typing import Callable

import jax.numpy as jnp
import jax.random as jr
from jax import jacfwd, jacrev, lax, vmap

from bayesianfiltering_tpu.distributions import mvn_logpdf, mvn_sample
from bayesianfiltering_tpu.ops.slr import mc_moments, mcla_moments
from bayesianfiltering_tpu.types import PRNGKey
from bayesianfiltering_tpu.utils.linalg import psd_solve, symmetrize
from bayesianfiltering_tpu.utils.sdp import sdp_opt_legacy
from bayesianfiltering_tpu.utils.sigma_points import split_to_sigma_points


class SSM:
    """Additive-noise SSM holder (ref: gaussfiltax/gaussfilt.py:10-52).

    x' = f(x) + N(c, Q),  y = g(x') + N(d, R).
    """

    def __init__(self, dx, dy, c, Q, d, R, f: Callable = None, g: Callable = None):
        self.dx = dx
        self.dy = dy
        self.f = f
        self.g = g
        self.Q = jnp.asarray(Q)
        self.R = jnp.asarray(R)
        self.c = jnp.asarray(c)
        self.d = jnp.asarray(d)

    def propagate(self, old_x, key: PRNGKey):
        k1, k2 = jr.split(key)
        new_x = self.f(old_x) + mvn_sample(k1, self.c, self.Q)
        new_y = self.g(new_x) + mvn_sample(k2, self.d, self.R)
        return new_x, new_y

    def simulate(self, T: int, x0, key: PRNGKey = None):
        """Roll out T steps (scan; the reference loops in Python)."""
        if key is None:
            key = jr.PRNGKey(0)

        def step(x, k):
            new_x, new_y = self.propagate(x, k)
            return new_x, (new_x, new_y)

        _, (xs, ys) = lax.scan(step, jnp.asarray(x0), jr.split(key, T))
        return xs, ys


class GaussFilt:
    """Generic Gaussian-filter recursion (ref: gaussfiltax/gaussfilt.py:55-143).

    Subclasses implement ``moment_approx(m, P, kw, key)`` returning the
    transform moments ``(mean_out, var_out, cov_out)``; ``run`` is the
    shared predict/update scan.
    """

    def __init__(self, ssm: SSM, key: PRNGKey = None):
        self.f = ssm.f
        self.g = ssm.g
        self.Q = ssm.Q
        self.R = ssm.R
        self.dx = ssm.dx
        self.dy = ssm.dy
        self.key = jr.PRNGKey(0) if key is None else key

    def moment_approx(self, m, P, kw: str, key: PRNGKey = None):
        raise NotImplementedError

    def which_step(self, kw: str):
        """(func, additive_cov, dim_in, dim_out) for 'pred'/'upd'
        (ref: gaussfiltax/gaussfilt.py:132-143)."""
        if kw == "pred":
            return self.f, self.Q, self.dx, self.dx
        if kw == "upd":
            return self.g, self.R, self.dx, self.dy
        raise ValueError(f"unknown step {kw!r}")

    def _step(self, m, P, y, key: PRNGKey):
        k1, k2 = jr.split(key)
        m_pred, P_pred, _ = self.moment_approx(m, P, "pred", k1)
        mu_y, Sy, Cxy = self.moment_approx(m_pred, P_pred, "upd", k2)
        gain = psd_solve(Sy, Cxy.T).T  # Cxy Sy^{-1}, via Cholesky
        m_filt = m_pred + gain @ (jnp.atleast_1d(y) - mu_y)
        P_filt = symmetrize(P_pred - gain @ Sy @ gain.T)
        ll = mvn_logpdf(jnp.atleast_1d(y), mu_y, Sy)
        return m_filt, P_filt, ll, m_pred, P_pred

    def run(self, ys, m0, P0, verbose: bool = False):
        """Filter a sequence. Returns ``(ll (T,), means (T,dx), covs)``."""
        ys = jnp.asarray(ys)
        T = ys.shape[0]

        def step(carry, args):
            m, P = carry
            y, k = args
            m_f, P_f, ll, _, _ = self._step(m, P, y, k)
            return (m_f, P_f), (ll, m_f, P_f)

        keys = vmap(lambda t: jr.fold_in(self.key, t))(jnp.arange(T))
        _, (ll, means, covs) = lax.scan(
            step, (jnp.asarray(m0), jnp.asarray(P0)), (ys, keys)
        )
        return ll, means, covs


class UKF(GaussFilt):
    """Unscented moment filter (ref: gaussfiltax/gaussfilt.py:146-176):
    2n+1 Cholesky sigma points, legacy weight scheme."""

    def __init__(self, ssm: SSM, alpha: float = 1e-3, beta: float = 2.0,
                 kappa: float = 0.0, key: PRNGKey = None):
        super().__init__(ssm, key)
        self.alpha = alpha
        self.beta = beta
        self.kappa = kappa
        self.lamda = alpha**2 * (self.dx + kappa) - self.dx

    def __str__(self):
        return "UKF"

    def moment_approx(self, m, P, kw, key=None):
        func, cov, dim_in, dim_out = self.which_step(kw)
        n, lam = self.dx, self.lamda
        pts = split_to_sigma_points(m, P, lam)  # (2n+1, dx), center first
        new_pts = vmap(lambda x: jnp.atleast_1d(func(x)))(pts)
        w0m = lam / (n + lam)
        wim = 1.0 / (2.0 * (n + lam))
        w0c = w0m + 1.0 - self.alpha**2 + self.beta
        mean_out = w0m * new_pts[0] + wim * jnp.sum(new_pts[1:], axis=0)
        d0 = new_pts[0] - mean_out
        di = new_pts[1:] - mean_out
        var_out = cov + w0c * jnp.outer(d0, d0) + wim * jnp.einsum(
            "ij,ik->jk", di, di
        )
        s0 = pts[0] - m
        si = pts[1:] - m
        cov_out = w0c * jnp.outer(s0, d0) + wim * jnp.einsum("ij,ik->jk", si, di)
        return mean_out, symmetrize(var_out), cov_out


class MCF(GaussFilt):
    """Monte-Carlo moment filter (ref: gaussfiltax/gaussfilt.py:179-198)."""

    def __init__(self, ssm: SSM, num_particles: int, key: PRNGKey = None):
        super().__init__(ssm, key)
        self.num_particles = num_particles

    def __str__(self):
        return "MCF"

    def moment_approx(self, m, P, kw, key=None):
        func, cov, _, _ = self.which_step(kw)
        key = self.key if key is None else key
        return mc_moments(key, m, P, lambda x: jnp.atleast_1d(func(x)), cov,
                          self.num_particles)


class EKF(GaussFilt):
    """Extended moment filter with optional second-order terms
    (ref: gaussfiltax/gaussfilt.py:201-252).

    ``order=2`` applies the Hessian corrections
    ``mean += ½ tr(H_k P)``, ``var += ½ tr(H_i P H_j P)`` — which the
    reference computes but leaves commented out (ref :241-247).
    """

    def __init__(self, ssm: SSM, order: int = 2, key: PRNGKey = None):
        super().__init__(ssm, key)
        self.order = order
        self.f_jacobian = jacfwd(self.f)
        self.g_jacobian = jacfwd(self.g)
        self.f_hessian = jacfwd(jacrev(self.f))
        self.g_hessian = jacfwd(jacrev(self.g))

    def __str__(self):
        return "EKF"

    def moment_approx(self, m, P, kw, key=None):
        func, cov, dim_in, dim_out = self.which_step(kw)
        jacobian = self.f_jacobian if kw == "pred" else self.g_jacobian
        hessian = self.f_hessian if kw == "pred" else self.g_hessian

        J = jnp.reshape(jacobian(m), (dim_out, dim_in))
        mean_out = jnp.atleast_1d(func(m))
        var_out = cov + J @ P @ J.T
        cov_out = P @ J.T
        if self.order == 2:
            H = jnp.reshape(hessian(m), (dim_out, dim_in, dim_in))
            HP = H @ P  # (dy, dx, dx)
            mean_out = mean_out + 0.5 * jnp.trace(HP, axis1=-2, axis2=-1)
            var_out = var_out + 0.5 * jnp.einsum("ikl,jlk->ij", HP, HP)
        return mean_out, symmetrize(var_out), cov_out


class MCLAF(GaussFilt):
    """Monte-Carlo linearization-augmented filter
    (ref: gaussfiltax/gaussfilt.py:255-308): sample from the deflated
    N(m, P − Δ) with Δ from the legacy SDP solver, add per-particle
    linearization corrections."""

    def __init__(self, ssm: SSM, num_particles: int, key: PRNGKey = None,
                 lip: float = 1.0, sdp_steps: int = 10, sdp_eta: float = 0.01):
        super().__init__(ssm, key)
        self.num_particles = num_particles
        self.lip = lip
        self.sdp_steps = sdp_steps
        self.sdp_eta = sdp_eta
        self.f_jacobian = jacfwd(self.f)
        self.g_jacobian = jacfwd(self.g)
        self.f_hessian = jacfwd(jacrev(self.f))
        self.g_hessian = jacfwd(jacrev(self.g))

    def __str__(self):
        return "MCLAF"

    def moment_approx(self, m, P, kw, key=None):
        func, cov, dim_in, dim_out = self.which_step(kw)
        jacobian = self.f_jacobian if kw == "pred" else self.g_jacobian
        hessian = self.f_hessian if kw == "pred" else self.g_hessian
        key = self.key if key is None else key

        H = jnp.reshape(hessian(m), (dim_out, dim_in, dim_in))
        avg_hessian = jnp.sum(H, axis=0)
        delta = sdp_opt_legacy(self.dx, self.num_particles, self.lip, P, P,
                               avg_hessian, self.sdp_steps, self.sdp_eta)
        return mcla_moments(
            key, m, P, lambda x: jnp.atleast_1d(func(x)),
            lambda x: jnp.reshape(jacobian(x), (dim_out, dim_in)),
            cov, delta, self.num_particles,
        )


class GaussSumFilt:
    """Composite Gaussian-sum bank over any :class:`GaussFilt`
    (ref: gaussfiltax/gaussfilt.py:311-361).

    The component loop is a ``vmap`` over the underlying filter's step.
    Returns time-major ``(means (T,M,dx), covs (T,M,dx,dx), weights (T,M),
    point_est (T,dx))``; the point estimate is the weighted mixture mean.
    """

    def __init__(self, gauss_filt: GaussFilt, num_models: int):
        self.M = num_models
        self.num_models = num_models
        self.gf = gauss_filt
        self.dx = gauss_filt.dx
        self.dy = gauss_filt.dy

    def __str__(self):
        return "gf.GSF"

    def run(self, ys, m0, P0, verbose: bool = False, key: PRNGKey = None):
        ys = jnp.asarray(ys)
        T = ys.shape[0]
        if key is None:
            key = jr.PRNGKey(0)
        k_init, k_run = jr.split(key)

        # Init: means scattered around m0 with unit covariance
        # (ref: gaussfiltax/gaussfilt.py:336-339).
        means0 = jnp.asarray(m0) + jr.normal(k_init, (self.M, self.dx))
        covs0 = jnp.broadcast_to(jnp.asarray(P0), (self.M, self.dx, self.dx))
        w0 = jnp.full((self.M,), 1.0 / self.M)

        def component_step(m, P, y, k):
            return self.gf._step(m, P, y, k)

        def step(carry, args):
            means, covs, w = carry
            y, k = args
            keys = jr.split(k, self.M)
            m_f, P_f, lls, _, _ = vmap(component_step, (0, 0, None, 0))(
                means, covs, y, keys
            )
            lls = lls - jnp.max(lls)
            w = w * jnp.exp(lls)
            w = w / jnp.sum(w)
            point = w @ m_f
            return (m_f, P_f, w), (m_f, P_f, w, point)

        keys = vmap(lambda t: jr.fold_in(k_run, t))(jnp.arange(T))
        _, (means, covs, weights, point_est) = lax.scan(
            step, (means0, covs0, w0), (ys, keys)
        )
        return means, covs, weights, point_est


__all__ = ["SSM", "GaussFilt", "UKF", "MCF", "EKF", "MCLAF", "GaussSumFilt"]
