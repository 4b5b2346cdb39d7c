"""Legacy (v0) standalone Gaussian-sum and augmented Gaussian-sum filters.

API parity with ref: gaussfiltax/gausssumfilt.py: the EKF-bank
``GaussSumFilt(ssm, M)`` and the original ``AugGaussSumFilt(ssm, M, N, L)``
with the string-mode splitting-covariance configuration
``set_aug_selection_params`` (modes ``prop`` / ``opt_lip`` /
``opt_max_grad`` / ``input`` / ``test``, ref :105-134).

Rebuild: the triple M→N→L Python loop (ref :162-259) becomes
batched split/predict/update array ops inside one ``lax.scan``; weights use
the log-domain EKF innovation likelihood instead of scipy pdf calls; the 3-D
multinomial reduction (ref :264) is a flat resample over M·N·L weights.
Outputs are time-major ``(T, M, ...)``.
"""
from __future__ import annotations

import jax.numpy as jnp
import jax.random as jr
from jax import jacfwd, jacrev, lax, vmap

from bayesianfiltering_tpu.containers import GaussianSum, split_gaussian_sum
from bayesianfiltering_tpu.distributions import mvn_logpdf
from bayesianfiltering_tpu.legacy.gaussfilt import SSM
from bayesianfiltering_tpu.types import PRNGKey
from bayesianfiltering_tpu.utils.linalg import psd_solve, symmetrize
from bayesianfiltering_tpu.utils.resampling import multinomial_resample
from bayesianfiltering_tpu.utils.sdp import sdp_opt_legacy, sdp_opt_test


class GaussSumFilt:
    """Standalone EKF-bank Gaussian-sum filter
    (ref: gaussfiltax/gausssumfilt.py:11-78), vmapped + scanned."""

    def __init__(self, ssm: SSM, M: int):
        self.f, self.g = ssm.f, ssm.g
        self.Q, self.R = ssm.Q, ssm.R
        self.dx, self.dy = ssm.dx, ssm.dy
        self.M = M
        self.f_jacobian = jacfwd(self.f)
        self.g_jacobian = jacfwd(self.g)

    def __str__(self):
        return "GSF"

    def _component_step(self, m, P, y):
        # predict (note the reference's covariance uses P + F P Fᵀ,
        # ref :59 — the additive noise cov Q is *not* added there; we use
        # the correct F P Fᵀ + Q)
        F = jnp.reshape(self.f_jacobian(m), (self.dx, self.dx))
        m_pred = jnp.atleast_1d(self.f(m))
        P_pred = symmetrize(F @ P @ F.T + self.Q)
        # update
        H = jnp.reshape(self.g_jacobian(m_pred), (self.dy, self.dx))
        mu_y = jnp.atleast_1d(self.g(m_pred))
        Sy = symmetrize(self.R + H @ P_pred @ H.T)
        Cxy = P_pred @ H.T
        gain = psd_solve(Sy, Cxy.T).T
        m_filt = m_pred + gain @ (jnp.atleast_1d(y) - mu_y)
        P_filt = symmetrize(P_pred - gain @ Sy @ gain.T)
        ll = mvn_logpdf(jnp.atleast_1d(y), mu_y, Sy)
        return m_filt, P_filt, ll

    def run(self, ys, m0, P0, verbose: bool = False, key: PRNGKey = None):
        ys = jnp.asarray(ys)
        T = ys.shape[0]
        if key is None:
            key = jr.PRNGKey(0)

        means0 = jnp.asarray(m0) + jr.normal(key, (self.M, self.dx))
        covs0 = jnp.broadcast_to(jnp.asarray(P0), (self.M, self.dx, self.dx))
        w0 = jnp.full((self.M,), 1.0 / self.M)

        def step(carry, y):
            means, covs, w = carry
            m_f, P_f, lls = vmap(self._component_step, (0, 0, None))(
                means, covs, y
            )
            lls = lls - jnp.max(lls)
            w = w * jnp.exp(lls)
            w = w / jnp.sum(w)
            point = w @ m_f
            return (m_f, P_f, w), (m_f, P_f, w, point)

        _, (means, covs, weights, point_est) = lax.scan(
            step, (means0, covs0, w0), ys
        )
        return means, covs, weights, point_est


class AugGaussSumFilt:
    """The original augmented Gaussian-sum filter
    (ref: gaussfiltax/gausssumfilt.py:81-272).

    Per step: choose Δ per the configured selection mode, split each of M
    components into N particles from N(m, P−Δ), EKF-predict each; choose Λ,
    split each of the M·N into L, EKF-update each; weight by innovation
    likelihood; multinomially reduce M·N·L → M.
    """

    def __init__(self, ssm: SSM, M: int, N: int, L: int, key: PRNGKey = None):
        self.f, self.g = ssm.f, ssm.g
        self.Q, self.R = ssm.Q, ssm.R
        self.dx, self.dy = ssm.dx, ssm.dy
        self.M, self.N, self.L = M, N, L
        self.f_jacobian = jacfwd(self.f)
        self.f_hessian = jacfwd(jacrev(self.f))
        self.g_jacobian = jacfwd(self.g)
        self.g_hessian = jacfwd(jacrev(self.g))
        self.key = jr.PRNGKey(0) if key is None else key
        self.set = False

    def __str__(self):
        return "AGSF"

    def set_aug_selection_params(self, *args, **selection_mode):
        """Configure the Δ/Λ selection (ref: gaussfiltax/gausssumfilt.py:105-134).

        Keyword order gives (predict-mode, update-mode); ``args`` carries the
        matching scalar (proportionality constant, Lipschitz constant,
        gradient factor, or an explicit matrix for 'input').
        """
        modes = list(selection_mode.values())
        self.pred_mode, self.upd_mode = modes[0], modes[1]
        self.pred_arg = args[0] if len(args) > 0 else 0.1
        self.upd_arg = args[1] if len(args) > 1 else 0.1
        self.set = True

    def _select(self, mode, arg, m, P, hessian_fn, jacobian_fn, num, dim_out,
                max_grad, key):
        """One splitting covariance per the legacy mode table."""
        if mode == "prop":
            return arg * P
        H = jnp.reshape(hessian_fn(m), (dim_out, self.dx, self.dx))
        avg_hessian = jnp.sum(H, axis=0)
        if mode == "opt_lip":
            return sdp_opt_legacy(self.dx, num, arg, P, P, avg_hessian, 10, 0.01)
        if mode == "opt_max_grad":
            return sdp_opt_legacy(self.dx, num, arg * max_grad, P, P,
                                  avg_hessian, 10, 0.01)
        if mode == "input":
            mat = jnp.broadcast_to(jnp.asarray(arg), P.shape)
            # clip to the feasible cone: Δ ⪯ P
            from bayesianfiltering_tpu.utils.linalg import project_to_psd
            return P - project_to_psd(P - mat)
        if mode == "test":
            sample = jr.multivariate_normal(key, m, P, shape=(3,))
            hess_array = vmap(
                lambda x: jnp.reshape(hessian_fn(x), (dim_out, self.dx, self.dx))
            )(sample)
            return sdp_opt_test(self.dx, dim_out, 3, 0.1, P, P, hess_array,
                                10, 0.1)
        raise ValueError(f"unknown selection mode {mode!r}")

    def run(self, ys, m0, P0, verbose: bool = False):
        if not self.set:
            # default: proportional with 0.1, like the common experiment cfg
            self.set_aug_selection_params(0.1, 0.1, mode1="prop", mode2="prop")
        ys = jnp.asarray(ys)
        T = ys.shape[0]
        M, N, L = self.M, self.N, self.L

        def predict_one(m, delta):
            F = jnp.reshape(self.f_jacobian(m), (self.dx, self.dx))
            m_pred = jnp.atleast_1d(self.f(m))
            P_pred = symmetrize(F @ delta @ F.T + self.Q)
            grad = jnp.max(jnp.abs(F))
            return m_pred, P_pred, grad

        def update_one(m, lam, y):
            H = jnp.reshape(self.g_jacobian(m), (self.dy, self.dx))
            mu_y = jnp.atleast_1d(self.g(m))
            Sy = symmetrize(self.R + H @ lam @ H.T)
            Cxy = lam @ H.T
            gain = psd_solve(Sy, Cxy.T).T
            m_f = m + gain @ (jnp.atleast_1d(y) - mu_y)
            P_f = symmetrize(lam - gain @ Sy @ gain.T)
            ll = mvn_logpdf(jnp.atleast_1d(y), mu_y, Sy)
            grad = jnp.max(jnp.abs(H))
            return m_f, P_f, ll, grad

        def step(carry, args):
            means, covs, w, max_grad_p, max_grad_u = carry
            y, k = args
            k1, k2, k3, k4, k5 = jr.split(k, 5)

            deltas = vmap(
                lambda m, P, kk: self._select(
                    self.pred_mode, self.pred_arg, m, P, self.f_hessian,
                    self.f_jacobian, N, self.dx, max_grad_p, kk)
            )(means, covs, jr.split(k1, M))
            branched = split_gaussian_sum(k2, GaussianSum(means, covs, w),
                                          deltas, N)
            deltas_tiled = branched.covariances  # (M*N, dx, dx) = tiled Δ
            pm, pP, grads_p = vmap(predict_one)(branched.means, deltas_tiled)

            lambdas = vmap(
                lambda m, P, kk: self._select(
                    self.upd_mode, self.upd_arg, m, P, self.g_hessian,
                    self.g_jacobian, L, self.dy, max_grad_u, kk)
            )(pm, pP, jr.split(k3, M * N))
            branched2 = split_gaussian_sum(
                k4, GaussianSum(pm, pP, branched.weights), lambdas, L
            )
            um, uP, lls, grads_u = vmap(update_one, (0, 0, None))(
                branched2.means, branched2.covariances, y
            )
            lls = lls - jnp.max(lls)
            new_w = branched2.weights * jnp.exp(lls)
            new_w = new_w / jnp.sum(new_w)

            idx = multinomial_resample(k5, new_w, M)
            means = jnp.take(um, idx, axis=0)
            covs = jnp.take(uP, idx, axis=0)
            w = jnp.full((M,), 1.0 / M)
            point = jnp.mean(means, axis=0)
            return (
                (means, covs, w, jnp.max(grads_p), jnp.max(grads_u)),
                (means, covs, point, deltas, lambdas),
            )

        means0 = jnp.broadcast_to(jnp.asarray(m0), (M, self.dx))
        covs0 = jnp.broadcast_to(jnp.asarray(P0), (M, self.dx, self.dx))
        w0 = jnp.full((M,), 1.0 / M)
        keys = vmap(lambda t: jr.fold_in(self.key, t))(jnp.arange(T))
        _, (means, covs, point_est, Deltas, Lambdas) = lax.scan(
            step, (means0, covs0, w0, 1.0, 1.0), (ys, keys)
        )
        return means, covs, point_est, Deltas, Lambdas


__all__ = ["GaussSumFilt", "AugGaussSumFilt"]
