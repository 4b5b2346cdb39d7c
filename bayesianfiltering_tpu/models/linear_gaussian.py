"""Linear-Gaussian SSM model class with WORKING EM.

The reference inherits ``fit_em`` from its dynamax fork but implements
``e_step``/``m_step`` nowhere, so EM is uncallable end-to-end (SURVEY.md
§2.1 #5). This class makes the EM capability real for the linear-Gaussian
family: the E-step runs the RTS smoother (exact sufficient statistics incl.
smoothed cross-covariances), the M-step is the closed-form MLE update.

Layout: the E-step is the smoother scan + a handful of time-axis einsum
contractions; the M-step is a few small solves. ``fit_em`` (inherited
from :class:`SSM`) vmaps the E-step over batches of sequences, so EM over
1k sequences is data-parallel for free (shard the batch axis).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import vmap

from bayesianfiltering_tpu.config import with_matmul_precision
from bayesianfiltering_tpu.distributions import MVN
from bayesianfiltering_tpu.models.parameters import ParameterProperties
from bayesianfiltering_tpu.models.ssm import SSM
from bayesianfiltering_tpu.ops.linear import (
    ParamsLGSSM,
    kalman_filter,
    kalman_smoother,
)
from bayesianfiltering_tpu.utils.linalg import psd_solve, symmetrize

# Above this length the smoother pass (and hence every EM iteration) runs
# through the temporally-parallel chunked scan; below it the sequential
# scan's lower constant wins. The 4096 crossover is not measured on the GPU.
_PARALLEL_SMOOTHER_MIN_T = 4096


def _smoother_dispatch(params: ParamsLGSSM, emissions):
    if emissions.shape[0] >= _PARALLEL_SMOOTHER_MIN_T:
        from bayesianfiltering_tpu.ops.associative import (
            parallel_kalman_smoother,
        )

        return parallel_kalman_smoother(params, emissions)
    return kalman_smoother(params, emissions)


class SuffStatsLGSSM(NamedTuple):
    """Expected sufficient statistics from one sequence's smoother pass."""

    Ex0: jax.Array         # E[x_0]
    Ex0x0: jax.Array       # E[x_0 x_0ᵀ]
    sum_prev: jax.Array    # Σ_{t=0}^{T-2} E[x_t x_tᵀ]
    sum_next: jax.Array    # Σ_{t=1}^{T-1} E[x_t x_tᵀ]
    sum_cross: jax.Array   # Σ_{t=0}^{T-2} E[x_{t+1} x_tᵀ]
    sum_all: jax.Array     # Σ_t E[x_t x_tᵀ]
    sum_yx: jax.Array      # Σ_t y_t E[x_t]ᵀ
    sum_yy: jax.Array      # Σ_t y_t y_tᵀ
    num_timesteps: jax.Array


class PropsLGSSM(NamedTuple):
    """Trainability flags matching :class:`ParamsLGSSM` (bias fields frozen
    by default; this EM fits F, Q, H, R, m0, P0)."""

    initial_mean: ParameterProperties = ParameterProperties()
    initial_covariance: ParameterProperties = ParameterProperties()
    dynamics_matrix: ParameterProperties = ParameterProperties()
    dynamics_covariance: ParameterProperties = ParameterProperties()
    emission_matrix: ParameterProperties = ParameterProperties()
    emission_covariance: ParameterProperties = ParameterProperties()


class LinearGaussianSSM(SSM):
    """x_t = F x_{t-1} + q,  y_t = H x_t + r — with exact inference and EM."""

    def __init__(self, state_dim: int, emission_dim: int):
        self.state_dim = state_dim
        self.emission_dim = emission_dim

    @property
    def emission_shape(self):
        return (self.emission_dim,)

    # -- distributions ----------------------------------------------------
    def initial_distribution(self, params: ParamsLGSSM, inputs=None):
        return MVN(params.initial_mean, params.initial_covariance)

    def transition_distribution(self, params: ParamsLGSSM, state, inputs=None):
        mean = params.dynamics_matrix @ state
        if params.dynamics_bias is not None:
            mean = mean + params.dynamics_bias
        return MVN(mean, params.dynamics_covariance)

    def emission_distribution(self, params: ParamsLGSSM, state, inputs=None):
        mean = params.emission_matrix @ state
        if params.emission_bias is not None:
            mean = mean + params.emission_bias
        return MVN(mean, params.emission_covariance)

    # -- exact inference ----------------------------------------------------
    def filter(self, params: ParamsLGSSM, emissions, inputs=None):
        return kalman_filter(params, emissions)

    def smoother(self, params: ParamsLGSSM, emissions, inputs=None):
        return _smoother_dispatch(params, emissions)

    def marginal_log_prob(self, params: ParamsLGSSM, emissions, inputs=None):
        return kalman_filter(params, emissions).marginal_loglik

    # -- EM -----------------------------------------------------------------
    @with_matmul_precision
    def e_step(self, params: ParamsLGSSM, emissions, inputs=None):
        """RTS smoother pass → expected sufficient statistics + loglik."""
        post = _smoother_dispatch(params, emissions)
        ms = post.smoothed_means          # (T, dx)
        Ps = post.smoothed_covariances    # (T, dx, dx)
        F = params.dynamics_matrix

        # smoothing gains G_t = P_t^f Fᵀ (P^pred_{t->t+1})⁻¹, t = 0..T-2
        G = vmap(lambda Pf, Pp: psd_solve(Pp, F @ Pf).T)(
            post.filtered_covariances[:-1], post.predicted_covariances[:-1]
        )
        # E[x_{t+1} x_tᵀ] = P^s_{t+1} G_tᵀ + m^s_{t+1} m^sᵀ_t
        cross = jnp.einsum("tij,tkj->tik", Ps[1:], G) + jnp.einsum(
            "ti,tj->tij", ms[1:], ms[:-1]
        )
        Exx = Ps + jnp.einsum("ti,tj->tij", ms, ms)   # E[x_t x_tᵀ]

        stats = SuffStatsLGSSM(
            Ex0=ms[0],
            Ex0x0=Exx[0],
            sum_prev=jnp.sum(Exx[:-1], axis=0),
            sum_next=jnp.sum(Exx[1:], axis=0),
            sum_cross=jnp.sum(cross, axis=0),
            sum_all=jnp.sum(Exx, axis=0),
            sum_yx=jnp.einsum("ti,tj->ij", emissions, ms),
            sum_yy=jnp.einsum("ti,tj->ij", emissions, emissions),
            num_timesteps=jnp.asarray(emissions.shape[0], dtype=jnp.float32),
        )
        return stats, post.marginal_loglik

    def initialize_m_step_state(self, params, props):
        return None

    @with_matmul_precision
    def m_step(self, params: ParamsLGSSM, props: Optional[PropsLGSSM],
               batch_stats: SuffStatsLGSSM, m_step_state):
        """Closed-form MLE from (batch-summed) sufficient statistics."""
        # sum over the batch axis added by fit_em's vmap
        s = jax.tree_util.tree_map(lambda x: jnp.sum(x, axis=0), batch_stats)
        n_seq = batch_stats.num_timesteps.shape[0]
        T_total = s.num_timesteps

        F_new = psd_solve(symmetrize(s.sum_prev), s.sum_cross.T).T
        Q_new = symmetrize(
            (s.sum_next - F_new @ s.sum_cross.T - s.sum_cross @ F_new.T
             + F_new @ s.sum_prev @ F_new.T) / (T_total - n_seq)
        )
        H_new = psd_solve(symmetrize(s.sum_all), s.sum_yx.T).T
        R_new = symmetrize(
            (s.sum_yy - H_new @ s.sum_yx.T - s.sum_yx @ H_new.T
             + H_new @ s.sum_all @ H_new.T) / T_total
        )
        m0_new = s.Ex0 / n_seq
        P0_new = symmetrize(s.Ex0x0 / n_seq - jnp.outer(m0_new, m0_new))

        def pick(trainable, new, old):
            return new if trainable else old

        if props is None:
            props = PropsLGSSM()
        new_params = params._replace(
            initial_mean=pick(props.initial_mean.trainable, m0_new,
                              params.initial_mean),
            initial_covariance=pick(props.initial_covariance.trainable,
                                    P0_new, params.initial_covariance),
            dynamics_matrix=pick(props.dynamics_matrix.trainable, F_new,
                                 params.dynamics_matrix),
            dynamics_covariance=pick(props.dynamics_covariance.trainable,
                                     Q_new, params.dynamics_covariance),
            emission_matrix=pick(props.emission_matrix.trainable, H_new,
                                 params.emission_matrix),
            emission_covariance=pick(props.emission_covariance.trainable,
                                     R_new, params.emission_covariance),
        )
        return new_params, m_step_state


__all__ = ["LinearGaussianSSM", "PropsLGSSM", "SuffStatsLGSSM"]
