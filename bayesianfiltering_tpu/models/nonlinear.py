"""Concrete nonlinear state-space models.

Parity with ref: gaussfiltax/models.py:86-289:

* :class:`NonlinearGaussianSSM` — additive-noise nonlinear model.
* :class:`NonlinearSSM` — general non-additive-noise model (the one every
  reference experiment uses), with the override of ``sample`` that threads
  explicitly-sampled noise through f/h (ref: gaussfiltax/models.py:240-289).

Upgrades over the reference: ``marginal_log_prob`` and ``filter`` are
implemented (EKF-based), which makes the inherited ``fit_sgd`` actually
runnable (the reference's is a NameError, SURVEY.md §2.1).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import jax.random as jr
from jax import lax, vmap
from jax.tree_util import tree_map

from bayesianfiltering_tpu.distributions import MVN, mvn_sample
from bayesianfiltering_tpu.models.params import ParamsNLSSM
from bayesianfiltering_tpu.models.ssm import SSM
from bayesianfiltering_tpu.types import PRNGKey


class SuffStatsNLSSM(NamedTuple):
    """Expected sufficient statistics of the extended (linearized) E-step.

    ``sum_qq``/``sum_rr`` are second moments of the process/measurement
    noise about its bias, already mapped INTO noise space through the
    pseudo-inverses of the noise Jacobians F_q/H_r (identity for additive
    models), so the M-step for Q/R is a plain scaled sum.
    """

    Ex0: jax.Array         # smoothed E[x_0]
    Ex0x0: jax.Array       # smoothed E[x_0 x_0ᵀ]
    sum_qq: jax.Array      # Σ_{t=0}^{T-2} E[(q−q0)(q−q0)ᵀ]  (nq, nq)
    sum_rr: jax.Array      # Σ_{t=0}^{T-1} E[(r−r0)(r−r0)ᵀ]  (nr, nr)
    num_timesteps: jax.Array


class NonlinearGaussianSSM(SSM):
    """Additive-noise nonlinear Gaussian SSM (ref: gaussfiltax/models.py:86-157).

    x_t = f(x_{t-1}, u_t) + q_t,  y_t = h(x_t, u_t) + r_t.
    """

    def __init__(self, state_dim: int, emission_dim: int, input_dim: int = 0,
                 em_moments: str = "ekf", em_uparams=None):
        self.state_dim = state_dim
        self.emission_dim = emission_dim
        self.input_dim = input_dim
        # EM E-step quadrature: "ekf" (first-order ERTS linearization) or
        # "ukf" (URTS smoother + joint sigma-point residual moments —
        # required on severely nonlinear models like the UNGM, where the
        # EKF smoother is uninformative and extended EM diverges).
        self.em_moments = em_moments
        self.em_uparams = em_uparams

    @property
    def emission_shape(self):
        return (self.emission_dim,)

    @property
    def inputs_shape(self):
        return (self.input_dim,) if self.input_dim > 0 else None

    def initial_distribution(self, params: ParamsNLSSM, inputs=None):
        return MVN(params.initial_mean, params.initial_covariance)

    def transition_distribution(self, params: ParamsNLSSM, state, inputs=None):
        f = params.dynamics_function
        mean = f(state) if inputs is None else f(state, inputs)
        return MVN(mean, params.dynamics_noise_covariance)

    def emission_distribution(self, params: ParamsNLSSM, state, inputs=None):
        h = params.emission_function
        mean = h(state) if inputs is None else h(state, inputs)
        return MVN(mean, params.emission_noise_covariance)

    # -- inference (upgrade: implemented, reference leaves these as stubs) --
    def _as_nonadditive(self, params: ParamsNLSSM) -> ParamsNLSSM:
        """Wrap additive-noise f(x[,u]) / h(x[,u]) into the non-additive
        (x, noise, u) calling convention used by the filters."""
        f, h = params.dynamics_function, params.emission_function
        has_inputs = self.input_dim > 0

        def fna(x, q, u):
            return (f(x, u) if has_inputs else f(x)) + q

        def hna(x, r, u):
            return (h(x, u) if has_inputs else h(x)) + r

        return params._replace(dynamics_function=fna, emission_function=hna)

    def _filter_params(self, params: ParamsNLSSM) -> ParamsNLSSM:
        """Params in the non-additive (x, noise, u) convention the filter
        layer speaks (identity on :class:`NonlinearSSM`)."""
        return self._as_nonadditive(params)

    def filter(self, params: ParamsNLSSM, emissions, inputs=None):
        from bayesianfiltering_tpu import inference

        return inference.extended_kalman_filter(
            self._filter_params(params), emissions, inputs=inputs
        )

    def smoother(self, params: ParamsNLSSM, emissions, inputs=None):
        from bayesianfiltering_tpu import inference

        return inference.extended_rts_smoother(
            self._filter_params(params), emissions, inputs=inputs
        )

    def marginal_log_prob(self, params: ParamsNLSSM, emissions, inputs=None):
        return self.filter(params, emissions, inputs).marginal_loglik

    # -- extended EM --------------------------------------------------------
    # The reference ships the generic fit_em driver with an abstract e_step
    # (ref: gaussfiltax/ssm.py:302-399) and no working implementation for
    # any nonlinear model; this closes that capability slot. The E-step
    # linearizes about the ERTS-smoothed means (extended EM, Särkkä 2013
    # ch. 12) or, with ``em_moments="ukf"``, takes sigma-point moments of
    # the residuals under the URTS-smoothed pairwise joints; the M-step is
    # the closed-form update for the noise covariances and initial moments.
    # Parameters INSIDE the dynamics/emission callables are not reachable
    # by EM (they live in closures) — fit those with ``fit_sgd``.
    #
    # LIMITATION (documented, tested): on models with genuinely multimodal
    # smoothing posteriors (the UNGM's ±x symmetry), ANY Gaussian
    # approximate E-step absorbs mode-assignment error into the residual
    # second moments, so the Q/R estimates inflate instead of converging —
    # approximate EM's monotone-ascent guarantee needs an exact E-step.
    # Use fit_sgd on such models; the e_step statistics remain finite and
    # the UT marginal likelihood remains usable (tests/test_models.py::
    # TestNonlinearEM::test_unscented_e_step_finite_on_scalar_growth).
    def e_step(self, params: ParamsNLSSM, emissions, inputs=None):
        from bayesianfiltering_tpu import inference
        from bayesianfiltering_tpu.inference import (
            _jacobians,
            _process_input,
        )
        from bayesianfiltering_tpu.utils.linalg import psd_solve

        fp = self._filter_params(params)
        use_ut = self.em_moments == "ukf"
        if use_ut:
            from bayesianfiltering_tpu.ops import ParamsUKF

            uparams = self.em_uparams or ParamsUKF(alpha=1.0,
                                                   sqrt_method="cholesky")
            post = inference.unscented_rts_smoother(fp, uparams, emissions,
                                                    inputs=inputs)
        else:
            post = inference.extended_rts_smoother(fp, emissions,
                                                   inputs=inputs)
        T = emissions.shape[0]
        u = _process_input(inputs, T)
        f, h, F_x, H_x, F_q, H_r = _jacobians(fp)
        q0, r0 = fp.dynamics_noise_bias, fp.emission_noise_bias
        ms, Ps = post.smoothed_means, post.smoothed_covariances
        dx = ms.shape[-1]
        u_next = u[1:T]

        # Smoothing gains matching the smoother's own forward quadrature,
        # then smoothed cross-cov C_{t+1} = Cov(x_{t+1}, x_t) = P^s_{t+1} G_tᵀ.
        if use_ut:
            def one_gain(m_f, P_f, P_p, Q_, uu):
                D = inference._ut_dynamics_cross_cov(
                    f, m_f, P_f, Q_, q0, uu, uparams, additive=False)
                return psd_solve(P_p, D.T).T
            Q_c = fp.dynamics_noise_covariance
            G = vmap(lambda m_f, P_f, P_p, uu: one_gain(m_f, P_f, P_p, Q_c,
                                                        uu))(
                post.filtered_means[:-1], post.filtered_covariances[:-1],
                post.predicted_covariances[:-1], u_next,
            )
        else:
            Fx_f = vmap(lambda m, uu: F_x(m, q0, uu))(
                post.filtered_means[:-1], u_next
            )
            G = vmap(lambda Pf, Fx, Pp: psd_solve(Pp, Fx @ Pf).T)(
                post.filtered_covariances[:-1], Fx_f,
                post.predicted_covariances[:-1],
            )
        C = jnp.einsum("tij,tkj->tik", Ps[1:], G)

        if use_ut:
            # Joint-sigma-point residual moments: draw sigma points of the
            # smoothed pairwise joint (x_t, x_{t+1}) and push them through
            # g = x_{t+1} − f(x_t); E[ggᵀ] = Cov_UT + μμᵀ.
            from bayesianfiltering_tpu.utils.sigma_points import sigma_points
            from bayesianfiltering_tpu.ops.ukf import _ut_moments

            n_j = 2 * dx
            lam_j = uparams.alpha ** 2 * (n_j + uparams.kappa) - n_j

            def dyn_moment(m0, P0, m1, P1, Ct, uu):
                jm = jnp.concatenate([m0, m1])
                top = jnp.concatenate([P0, Ct.T], axis=-1)
                bot = jnp.concatenate([Ct, P1], axis=-1)
                jP = jnp.concatenate([top, bot], axis=-2)
                jP = jP + 1e-6 * jnp.max(jnp.abs(jnp.diagonal(jP))) * jnp.eye(
                    n_j, dtype=jP.dtype)
                pts = sigma_points(jm, jP, lam_j, "cholesky")
                g_pts = vmap(lambda p: p[dx:] - f(p[:dx], q0, uu))(pts)
                g0 = m1 - f(m0, q0, uu)
                mu, cov, _ = _ut_moments(g0, g_pts, lam_j, n_j,
                                         uparams.alpha, uparams.beta)
                return cov + jnp.outer(mu, mu)

            Sigma_q = vmap(dyn_moment)(ms[:-1], Ps[:-1], ms[1:], Ps[1:], C,
                                       u_next)

            lam_e = uparams.alpha ** 2 * (dx + uparams.kappa) - dx

            def obs_moment(m0, P0, y, uu):
                pts = sigma_points(m0, P0, lam_e, "cholesky")
                g_pts = vmap(
                    lambda p: jnp.atleast_1d(y) - jnp.atleast_1d(
                        h(p, r0, uu)))(pts)
                g0 = jnp.atleast_1d(y) - jnp.atleast_1d(h(m0, r0, uu))
                mu, cov, _ = _ut_moments(g0, g_pts, lam_e, dx,
                                         uparams.alpha, uparams.beta)
                return cov + jnp.outer(mu, mu)

            y2 = jnp.reshape(emissions, (T, -1))
            Sigma_r = vmap(obs_moment)(ms, Ps, y2, u[:T])
        else:
            # Dynamics residual t -> t+1, linearized at the smoothed means:
            # x_{t+1} − f(x_t) ≈ δ_t − F_x (x_t − m^s_t) + F_q (q − q0) with
            # δ_t = m^s_{t+1} − f(m^s_t, q0, u_{t+1}), so
            # E[F_q (q−q0)(q−q0)ᵀ F_qᵀ] ≈ δδᵀ + P^s_{t+1} − C F_xᵀ − F_x Cᵀ
            #                                + F_x P^s_t F_xᵀ.
            Fx_s = vmap(lambda m, uu: F_x(m, q0, uu))(ms[:-1], u_next)
            delta = ms[1:] - vmap(lambda m, uu: f(m, q0, uu))(ms[:-1],
                                                              u_next)
            Sigma_q = (
                jnp.einsum("ti,tj->tij", delta, delta)
                + Ps[1:]
                - jnp.einsum("tij,tkj->tik", C, Fx_s)
                - jnp.einsum("tij,tkj->tik", Fx_s, C)
                + jnp.einsum("tik,tkl,tjl->tij", Fx_s, Ps[:-1], Fx_s)
            )
            # Emission residual at each t, linearized at the smoothed mean.
            yhat = vmap(lambda m, uu: jnp.atleast_1d(h(m, r0, uu)))(ms,
                                                                    u[:T])
            resid = jnp.reshape(emissions, yhat.shape) - yhat
            Hx_s = vmap(
                lambda m, uu: jnp.reshape(H_x(m, r0, uu), (-1, dx))
            )(ms, u[:T])
            Sigma_r = (
                jnp.einsum("ti,tj->tij", resid, resid)
                + jnp.einsum("tik,tkl,tjl->tij", Hx_s, Ps, Hx_s)
            )

        # Map into noise space through the noise Jacobian's pseudo-inverse
        # (identity when noise is additive; exact when F_q is invertible).
        Gq = vmap(lambda m, uu: F_q(m, q0, uu))(ms[:-1], u_next)
        Gq_pinv = vmap(jnp.linalg.pinv)(Gq)
        sum_qq = jnp.einsum("tai,tij,tbj->ab", Gq_pinv, Sigma_q, Gq_pinv)

        dy = jnp.reshape(emissions, (T, -1)).shape[-1]
        Hr_s = vmap(
            lambda m, uu: jnp.reshape(H_r(m, r0, uu), (dy, -1))
        )(ms, u[:T])
        Hr_pinv = vmap(jnp.linalg.pinv)(Hr_s)
        sum_rr = jnp.einsum("tai,tij,tbj->ab", Hr_pinv, Sigma_r, Hr_pinv)

        stats = SuffStatsNLSSM(
            Ex0=ms[0],
            Ex0x0=Ps[0] + jnp.outer(ms[0], ms[0]),
            sum_qq=sum_qq,
            sum_rr=sum_rr,
            num_timesteps=jnp.asarray(T, dtype=jnp.float32),
        )
        return stats, post.marginal_loglik

    def m_step(self, params: ParamsNLSSM, props, batch_stats: SuffStatsNLSSM,
               m_step_state):
        from bayesianfiltering_tpu.utils.linalg import symmetrize

        s = tree_map(lambda x: jnp.sum(x, axis=0), batch_stats)
        n_seq = batch_stats.num_timesteps.shape[0]
        T_total = s.num_timesteps

        Q_new = symmetrize(s.sum_qq / (T_total - n_seq))
        R_new = symmetrize(s.sum_rr / T_total)
        m0_new = s.Ex0 / n_seq
        P0_new = symmetrize(s.Ex0x0 / n_seq - jnp.outer(m0_new, m0_new))

        def pick(name, new, old):
            prop = getattr(props, name, None) if props is not None else None
            trainable = getattr(prop, "trainable", True)
            return new if trainable else old

        new_params = params._replace(
            initial_mean=pick("initial_mean", m0_new, params.initial_mean),
            initial_covariance=pick("initial_covariance", P0_new,
                                    params.initial_covariance),
            dynamics_noise_covariance=pick(
                "dynamics_noise_covariance", Q_new,
                params.dynamics_noise_covariance),
            emission_noise_covariance=pick(
                "emission_noise_covariance", R_new,
                params.emission_noise_covariance),
        )
        return new_params, m_step_state


class NonlinearSSM(NonlinearGaussianSSM):
    """General non-additive-noise nonlinear SSM
    (ref: gaussfiltax/models.py:160-289).

    x_t = f(x_{t-1}, q_t, u_t),  y_t = h(x_t, r_t, u_t).
    """

    def __init__(
        self,
        state_dim: int,
        state_noise_dim: int,
        emission_dim: int,
        emission_noise_dim: int,
        input_dim: int = 0,
        em_moments: str = "ekf",
        em_uparams=None,
    ):
        super().__init__(state_dim, emission_dim, input_dim,
                         em_moments=em_moments, em_uparams=em_uparams)
        self.state_noise_dim = state_noise_dim
        self.emission_noise_dim = emission_noise_dim

    def transition_distribution(self, params: ParamsNLSSM, state, inputs=None):
        """Gaussian approximation of p(x' | x): mean is the zero-noise
        propagation f(x, q0, u), covariance the noise-linearized
        F_q Q F_qᵀ — exact when the noise enters additively.

        (The reference's version calls ``f(state)`` and TypeErrors on its own
        non-additive convention, ref: gaussfiltax/models.py:214-225; this is
        the working generalization.)
        """
        from jax import jacfwd

        f = params.dynamics_function
        q0 = params.dynamics_noise_bias
        mean = f(state, q0, inputs)
        Fq = jacfwd(f, argnums=1)(state, q0, inputs)
        cov = Fq @ params.dynamics_noise_covariance @ Fq.T
        return MVN(mean, cov)

    def emission_distribution(self, params: ParamsNLSSM, state, inputs=None):
        """Gaussian approximation of p(y | x) via noise linearization
        (exact for additive noise); see :meth:`transition_distribution`."""
        from jax import jacfwd

        h = params.emission_function
        r0 = params.emission_noise_bias
        mean = h(state, r0, inputs)
        Hr = jacfwd(h, argnums=1)(state, r0, inputs)
        cov = Hr @ params.emission_noise_covariance @ Hr.T
        return MVN(jnp.atleast_1d(mean), jnp.atleast_2d(cov))

    def sample(
        self,
        params: ParamsNLSSM,
        key: PRNGKey,
        num_timesteps: int,
        inputs=None,
    ) -> Tuple[jnp.ndarray, jnp.ndarray]:
        """Sample with explicit noise threading; capability match for
        ref: gaussfiltax/models.py:240-289 (q ~ N(q0, Q), r ~ N(r0, R),
        x = f(x, q, u), y = h(x, r, u)).

        Shape: ALL process/measurement noise is drawn up front as two
        batched MVN samples (one Cholesky + one (T, n) matmul each) and the
        scan itself is deterministic — per-step in-scan
        sampling would re-factorize Q/R every iteration. One scan covers
        every timestep; t=0 substitutes the initial-distribution draw.
        """
        f = params.dynamics_function
        h = params.emission_function
        key_init, key_dyn, key_obs = jr.split(key, 3)
        x_first = self.initial_distribution(
            params, tree_map(lambda a: a[0], inputs)
        ).sample(seed=key_init)
        dyn_noise = mvn_sample(
            key_dyn, params.dynamics_noise_bias,
            params.dynamics_noise_covariance, (num_timesteps,),
        )
        obs_noise = mvn_sample(
            key_obs, params.emission_noise_bias,
            params.emission_noise_covariance, (num_timesteps,),
        )

        def _roll(x_prev, step):
            t, q_t, r_t = step
            u_t = tree_map(lambda a: a[t], inputs)
            x_t = jnp.where(t > 0, f(x_prev, q_t, u_t), x_first)
            y_t = h(x_t, r_t, u_t)
            return x_t, (x_t, y_t)

        _, (states, emissions) = lax.scan(
            _roll, x_first, (jnp.arange(num_timesteps), dyn_noise, obs_noise)
        )
        return states, emissions

    def _filter_params(self, params: ParamsNLSSM) -> ParamsNLSSM:
        # Already in the non-additive convention the filter layer speaks.
        return params


__all__ = ["NonlinearGaussianSSM", "NonlinearSSM", "SuffStatsNLSSM"]
