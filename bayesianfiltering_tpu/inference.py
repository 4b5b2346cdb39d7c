"""Filter entry points — the public inference API.

Entry-point parity with the reference's ``gaussfiltax/inference.py``:

=====================================   =====================================
this module                             reference
=====================================   =====================================
gaussian_sum_filter                     inference.py:303-377
unscented_gaussian_sum_filter           inference.py:379-456
augmented_gaussian_sum_filter           inference.py:458-619
speedy_augmented_gaussian_sum_filter    inference.py:621-812
unscented_agsf                          inference.py:814-964
speedy_unscented_agsf                   inference.py:966-1155
augmented_gaussian_sum_filter_optimal   inference.py:1157-1300
bootstrap_particle_filter               inference.py:1302-1381
extended_kalman_filter (new)            (the M=1 fast path; BASELINE config 2)
unscented_kalman_filter (new)           (the M=1 fast path)
=====================================   =====================================

Design notes (SURVEY.md §7):

* Every filter is a single `lax.scan` over time of batched (vmapped) step
  primitives from :mod:`bayesianfiltering_tpu.ops`; mixtures are
  struct-of-arrays (:mod:`bayesianfiltering_tpu.containers`), so trace size
  is independent of component counts. The reference's pytree-branching AGSF
  and its "speedy" rewrite collapse to ONE implementation here — the names
  are kept as aliases.
* Component splitting is a batched Cholesky + matmul
  (:func:`containers.split_gaussian_sum`), reduction is resampling on sorted
  cumulative weights.
* PRNG discipline: the reference reuses the *same* key every scan step and
  reseeds resampling with ``jr.PRNGKey(0)`` inside the step
  (ref: gaussfiltax/inference.py:521,566,766,914,1112), i.e. identical
  randomness at every timestep. Default behavior here folds the step index
  into the filter key (independent randomness per step); pass
  ``compat_fixed_keys=True`` to reproduce the reference pattern.
* The splitting covariances Δ/Λ ("autocov", ref: inference.py:226-301) are
  selected by a strategy enum ``autocov ∈ {"prop", "eye", "sdp", "trace"}``
  instead of commented-out code blocks; "prop" (Δ = α·P) is the reference's
  active branch.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import functools

import jax
import jax.numpy as jnp
import jax.random as jr
from jax import jacfwd, jacrev, lax, vmap

from bayesianfiltering_tpu import containers
from bayesianfiltering_tpu import utils
from bayesianfiltering_tpu.config import with_matmul_precision
from bayesianfiltering_tpu.containers import GaussianSum, split_gaussian_sum
from bayesianfiltering_tpu.distributions import mvn_sample
from bayesianfiltering_tpu.models.params import ParamsBPF, ParamsNLSSM
from bayesianfiltering_tpu.ops import bank_update as _bank
from bayesianfiltering_tpu.ops import ekf as _ekf
from bayesianfiltering_tpu.ops import ukf as _ukf
from bayesianfiltering_tpu.ops.ukf import ParamsUKF
from bayesianfiltering_tpu.types import PRNGKey
from bayesianfiltering_tpu.utils.resampling import (
    effective_sample_size,
    get_resampler,
)

# ---------------------------------------------------------------------------
# Helpers (ref: gaussfiltax/inference.py:21-27)
# ---------------------------------------------------------------------------

def _get_params(x, dim, t):
    """Per-step slice of an optionally time-varying parameter stack."""
    return x[t] if x.ndim == dim + 1 else x


def _process_input(inputs, num_timesteps):
    return jnp.zeros((num_timesteps, 1)) if inputs is None else inputs


def swap_axes_on_values(outputs: Dict, axis1: int = 0, axis2: int = 1) -> Dict:
    return {k: jnp.swapaxes(v, axis1, axis2) for k, v in outputs.items()}


def _step_key(base_key: PRNGKey, t, compat_fixed: bool) -> PRNGKey:
    """Per-step key: fold in t by default; reference reuses base_key."""
    return base_key if compat_fixed else jr.fold_in(base_key, t)


def _predict_input(inputs, t, num_timesteps: int):
    """Input for the within-scan t → t+1 transition.

    The generative model is ``x_{t+1} = f(x_t, q, u_{t+1})`` (models/
    nonlinear.py and ref: gaussfiltax/models.py:264), but the reference's
    update-then-predict filters predict with ``u_t``
    (ref: gaussfiltax/inference.py:353): at every input switch the filter
    propagates the wrong dynamics for one step. On the BOT maneuver model
    (R = 2.5e-5) that single wrong-dynamics step drops every component's
    log-likelihood by ~1e6 and is the root cause of the reference's GSF
    divergences (its AGSF is immune — its split→predict→update order makes
    the in-step predict (t−1)→t with ``u_t``, which is aligned). Conscious
    fix, see PARITY.md; the final step clamps to the last input (its
    prediction conditions no further emission).
    """
    return inputs[jnp.minimum(t + 1, num_timesteps - 1)]


def _jacobians(params: ParamsNLSSM):
    """Model functions + Jacobians: analytic when the params provide them
    (ParamsNLSSM.*_jacobian_* — an extension; the vmapped jacfwd evaluation
    can dominate the mixture filters' scan step), jacfwd otherwise.
    """
    f, h = params.dynamics_function, params.emission_function
    return (
        f,
        h,
        getattr(params, "dynamics_jacobian_x", None) or jacfwd(f, argnums=0),
        getattr(params, "emission_jacobian_x", None) or jacfwd(h, argnums=0),
        getattr(params, "dynamics_jacobian_q", None) or jacfwd(f, argnums=1),
        getattr(params, "emission_jacobian_r", None) or jacfwd(h, argnums=1),
    )


def _slice_noise(params: ParamsNLSSM, t):
    Q = _get_params(params.dynamics_noise_covariance, 2, t)
    q0 = _get_params(params.dynamics_noise_bias, 1, t)
    R = _get_params(params.emission_noise_covariance, 2, t)
    r0 = _get_params(params.emission_noise_bias, 1, t)
    return Q, q0, R, r0


# ---------------------------------------------------------------------------
# Posterior containers
# ---------------------------------------------------------------------------

class PosteriorGaussianSumFiltered(NamedTuple):
    """Marginals of the Gaussian-sum filtering posterior
    (ref: gaussfiltax/inference.py:29-39, plus a marginal likelihood)."""

    weights: Optional[jax.Array] = None
    means: Optional[jax.Array] = None
    covariances: Optional[jax.Array] = None
    predicted_means: Optional[jax.Array] = None
    predicted_covariances: Optional[jax.Array] = None
    marginal_loglik: Optional[jax.Array] = None


class PosteriorGaussianFiltered(NamedTuple):
    """Single-Gaussian (EKF/UKF) filtering posterior."""

    marginal_loglik: jax.Array
    filtered_means: jax.Array
    filtered_covariances: jax.Array
    predicted_means: jax.Array
    predicted_covariances: jax.Array


class PosteriorGaussianSmoothed(NamedTuple):
    """EKF filtering posterior + RTS-smoothed marginals."""

    marginal_loglik: jax.Array
    filtered_means: jax.Array
    filtered_covariances: jax.Array
    predicted_means: jax.Array
    predicted_covariances: jax.Array
    smoothed_means: jax.Array
    smoothed_covariances: jax.Array


# ---------------------------------------------------------------------------
# EKF / UKF (single-Gaussian fast paths)
# ---------------------------------------------------------------------------

@with_matmul_precision
def extended_kalman_filter(
    params: ParamsNLSSM,
    emissions: jax.Array,
    num_iter: int = 1,
    inputs: Optional[jax.Array] = None,
    jitter: float = 0.0,
    compat_scalar: bool = False,
    update_chunk: Optional[int] = None,
) -> PosteriorGaussianFiltered:
    """First-order EKF for non-additive-noise nonlinear SSMs.

    The M=1 specialization of :func:`gaussian_sum_filter` without mixture
    bookkeeping: update-then-predict per step, marginal log-likelihood
    accumulated from the innovation density. Differentiable in ``params``
    (used by ``NonlinearSSM.fit_sgd``).

    ``compat_scalar=True`` runs the reference-exact update (scalar-jitter LU
    gain, difference-form downdate — ref: gaussfiltax/utils.py:256-259) for
    golden-parity testing; it ignores ``num_iter``/``jitter``.

    ``update_chunk`` enables the sequential chunked measurement update for
    large emission dimensions (exact for block-diagonal effective noise;
    see :func:`bayesianfiltering_tpu.ops.ekf.ekf_condition_on_chunked`).
    Recommended ``update_chunk=128`` for dy > 128 with diagonal R (the
    BASELINE dx=512 Lorenz-96 config).
    """
    num_timesteps = len(emissions)
    f, h, F_x, H_x, F_q, H_r = _jacobians(params)
    inputs = _process_input(inputs, num_timesteps)
    residual_fn = getattr(params, "emission_residual", None)

    def step(carry, t):
        m_pred, P_pred, ll = carry
        Q, q0, R, r0 = _slice_noise(params, t)
        u, y = inputs[t], emissions[t]
        if compat_scalar:
            # reference-exact mode: plain subtraction, quirks included
            upd = _ekf.ekf_condition_on_ref(
                m_pred, P_pred, h, H_x, H_r, R, r0, u, y
            )
        elif update_chunk is not None:
            upd = _ekf.ekf_condition_on_chunked(
                m_pred, P_pred, h, H_x, H_r, R, r0, u, y, update_chunk,
                num_iter, jitter, residual_fn,
            )
        else:
            upd = _ekf.ekf_condition_on_iterated(
                m_pred, P_pred, h, H_x, H_r, R, r0, u, y, num_iter, jitter,
                residual_fn,
            )
        # compat mode keeps the reference's misaligned u_t predict
        # (see _predict_input) so golden parity pins its exact semantics.
        u_next = u if compat_scalar else _predict_input(inputs, t,
                                                        num_timesteps)
        m_next, P_next, _ = _ekf.ekf_predict(
            upd.mean, upd.cov, f, F_x, F_q, Q, q0, u_next)
        carry = (m_next, P_next, ll + upd.log_likelihood)
        return carry, (upd.mean, upd.cov, m_next, P_next)

    init = (params.initial_mean, params.initial_covariance, jnp.zeros(()))
    (_, _, ll), (fm, fP, pm, pP) = lax.scan(step, init, jnp.arange(num_timesteps))
    return PosteriorGaussianFiltered(ll, fm, fP, pm, pP)


@with_matmul_precision
def extended_rts_smoother(
    params: ParamsNLSSM,
    emissions: jax.Array,
    num_iter: int = 1,
    inputs: Optional[jax.Array] = None,
    jitter: float = 0.0,
) -> PosteriorGaussianSmoothed:
    """Extended Rauch–Tung–Striebel smoother (ERTS).

    Forward pass = :func:`extended_kalman_filter`; backward pass is the RTS
    recursion with the dynamics relinearized at each filtered mean:
    ``G_t = P_f F_x(m_f)ᵀ P_p⁻¹``, ``m_s = m_f + G (m_s' − m_p)``,
    ``P_s = P_f + G (P_s' − P_p) Gᵀ``. The non-additive noise convention is
    inherited from the filter (the predicted covariance already carries
    ``F_q Q F_qᵀ``). NEW surface vs the reference, which ships no smoother
    for its nonlinear models (its only backward pass is the dead dynamax
    import, ref: gaussfiltax/distributions.py); the linear specialization is
    exact (matches ops/linear.py::kalman_smoother, tested).
    """
    post = extended_kalman_filter(params, emissions, num_iter, inputs, jitter)
    num_timesteps = len(emissions)
    _, _, F_x, _, _, _ = _jacobians(params)
    inputs_arr = _process_input(inputs, num_timesteps)
    fm, fP = post.filtered_means, post.filtered_covariances
    pm, pP = post.predicted_means, post.predicted_covariances

    def step(carry, xs):
        sm_next, sP_next = carry
        m_f, P_f, m_p, P_p, t = xs
        _, q0, _, _ = _slice_noise(params, t)
        # same u_{t+1} linearization as the filter's t -> t+1 predict
        Fx = F_x(m_f, q0, inputs_arr[t + 1])
        G = utils.psd_solve(P_p, Fx @ P_f).T
        sm = m_f + G @ (sm_next - m_p)
        sP = utils.symmetrize(P_f + G @ (sP_next - P_p) @ G.T)
        return (sm, sP), (sm, sP)

    last = (fm[-1], fP[-1])
    xs = (fm[:-1], fP[:-1], pm[:-1], pP[:-1], jnp.arange(num_timesteps - 1))
    _, (sm, sP) = lax.scan(step, last, xs, reverse=True)
    sm = jnp.concatenate([sm, fm[-1:]], axis=0)
    sP = jnp.concatenate([sP, fP[-1:]], axis=0)
    return PosteriorGaussianSmoothed(
        post.marginal_loglik, fm, fP, pm, pP, sm, sP
    )


def _ut_dynamics_cross_cov(f, m, P, Q, q0, u, uparams, additive: bool):
    """D = Cov(x_t, x_{t+1} | y_{1:t}) = Σ wᶜ (χ − m)(f(χ) − m⁺)ᵀ via the
    same quadrature as the UKF predict (non-additive: augmented; additive:
    state-only). Shared by the URTS smoother and the unscented EM E-step
    (models/nonlinear.py)."""
    from bayesianfiltering_tpu.utils.sigma_points import (
        sigma_points,
        sigma_points_blockdiag,
    )

    dx = m.shape[-1]
    if additive:
        lamda = uparams.alpha ** 2 * (dx + uparams.kappa) - dx
        pts = sigma_points(m, P, lamda, uparams.sqrt_method)
        zero_q = jnp.zeros_like(q0)
        new_pts = vmap(lambda x: f(x, zero_q, u))(pts)
        center_new = f(m, zero_q, u)
        n_aug = dx
        pts_x = pts
    else:
        nq = q0.shape[-1]
        n_aug = dx + nq
        lamda = uparams.alpha ** 2 * (n_aug + uparams.kappa) - n_aug
        pts = sigma_points_blockdiag(m, P, q0, Q, lamda, uparams.sqrt_method)
        new_pts = vmap(lambda xA: f(xA[:dx], xA[dx:], u))(pts)
        center_new = f(m, q0, u)
        pts_x = pts[:, :dx]
    mu_new, _, centered_new = _ukf._ut_moments(
        center_new, new_pts, lamda, n_aug, uparams.alpha, uparams.beta
    )
    D = jnp.einsum("ij,ik->jk", pts_x - m, centered_new) / (
        2.0 * (lamda + n_aug)
    )
    return D


@with_matmul_precision
def unscented_rts_smoother(
    params: ParamsNLSSM,
    uparams: ParamsUKF,
    emissions: jax.Array,
    inputs: Optional[jax.Array] = None,
    additive: bool = False,
) -> PosteriorGaussianSmoothed:
    """Unscented Rauch–Tung–Striebel smoother (URTS).

    Forward pass = :func:`unscented_kalman_filter`; backward pass uses the
    statistically-linearized gain ``G_t = D_t P_p⁻¹`` where ``D_t`` is the
    unscented cross-covariance ``Cov(x_t, x_{t+1} | y_{1:t})`` recomputed
    from sigma points at the filtered moments (Särkkä 2008). NEW surface vs
    the reference (no smoother for nonlinear models); the linear
    specialization is exact.
    """
    post = unscented_kalman_filter(params, uparams, emissions, inputs,
                                   additive)
    num_timesteps = len(emissions)
    f = params.dynamics_function
    inputs_arr = _process_input(inputs, num_timesteps)
    fm, fP = post.filtered_means, post.filtered_covariances
    pm, pP = post.predicted_means, post.predicted_covariances
    dx = params.initial_mean.shape[-1]

    def cross_cov(m, P, Q, q0, u):
        return _ut_dynamics_cross_cov(f, m, P, Q, q0, u, uparams, additive)

    def step(carry, xs):
        sm_next, sP_next = carry
        m_f, P_f, m_p, P_p, t = xs
        Q, q0, _, _ = _slice_noise(params, t)
        # same u_{t+1} quadrature as the filter's t -> t+1 predict
        D = cross_cov(m_f, P_f, Q, q0, inputs_arr[t + 1])
        G = utils.psd_solve(P_p, D.T).T
        sm = m_f + G @ (sm_next - m_p)
        sP = utils.symmetrize(P_f + G @ (sP_next - P_p) @ G.T)
        return (sm, sP), (sm, sP)

    last = (fm[-1], fP[-1])
    xs = (fm[:-1], fP[:-1], pm[:-1], pP[:-1], jnp.arange(num_timesteps - 1))
    _, (sm, sP) = lax.scan(step, last, xs, reverse=True)
    sm = jnp.concatenate([sm, fm[-1:]], axis=0)
    sP = jnp.concatenate([sP, fP[-1:]], axis=0)
    return PosteriorGaussianSmoothed(
        post.marginal_loglik, fm, fP, pm, pP, sm, sP
    )


@with_matmul_precision
def unscented_kalman_filter(
    params: ParamsNLSSM,
    uparams: ParamsUKF,
    emissions: jax.Array,
    inputs: Optional[jax.Array] = None,
    additive: bool = False,
    num_iter: int = 1,
) -> PosteriorGaussianFiltered:
    """UKF for nonlinear SSMs; ``additive=True`` selects the additive-noise
    quadrature (fewer sigma points), otherwise state-noise augmentation.

    ``num_iter>1`` runs the iterated posterior-linearization update (IPLF,
    non-additive path only)."""
    num_timesteps = len(emissions)
    f, h = params.dynamics_function, params.emission_function
    inputs = _process_input(inputs, num_timesteps)
    residual_fn = getattr(params, "emission_residual", None)
    if additive:
        if num_iter > 1:
            raise ValueError(
                "num_iter > 1 (IPLF) is only implemented for the "
                "non-additive quadrature; pass additive=False"
            )
        predict = _ukf.ukf_predict_additive
        condition = functools.partial(_ukf.ukf_condition_on_additive,
                                      residual_fn=residual_fn)
    else:
        predict = _ukf.ukf_predict_nonadditive

        def condition(m, P, h, R, u, y, uparams, r0):
            return _ukf.ukf_condition_on_nonadditive_iterated(
                m, P, h, R, u, y, uparams, r0, num_iter, residual_fn)

    def step(carry, t):
        m_pred, P_pred, ll = carry
        Q, q0, R, r0 = _slice_noise(params, t)
        u, y = inputs[t], emissions[t]
        ll_t, m_filt, P_filt = condition(m_pred, P_pred, h, R, u, y, uparams, r0)
        u_next = _predict_input(inputs, t, num_timesteps)
        m_next, P_next = predict(m_filt, P_filt, f, u_next, Q, uparams, q0)
        return (m_next, P_next, ll + ll_t), (m_filt, P_filt, m_next, P_next)

    init = (params.initial_mean, params.initial_covariance, jnp.zeros(()))
    (_, _, ll), (fm, fP, pm, pP) = lax.scan(step, init, jnp.arange(num_timesteps))
    return PosteriorGaussianFiltered(ll, fm, fP, pm, pP)


# ---------------------------------------------------------------------------
# Gaussian-sum filters (banks of EKFs / UKFs)
# ---------------------------------------------------------------------------

def _init_mixture(params: ParamsNLSSM, num_components: int, key: PRNGKey):
    """Initial mixture: M means sampled from the initial distribution,
    shared initial covariance, uniform weights
    (ref: gaussfiltax/inference.py:367-369)."""
    means = mvn_sample(key, params.initial_mean, params.initial_covariance,
                       (num_components,))
    covs = jnp.broadcast_to(
        params.initial_covariance,
        (num_components,) + params.initial_covariance.shape,
    )
    weights = jnp.full((num_components,), 1.0 / num_components,
                       dtype=means.dtype)
    return weights, means, covs


def _reweight(lls, weights):
    """Log-space multiplicative weight update; also returns the incremental
    marginal likelihood log Σ_m w_m exp(ll_m).

    Shifting by max(log w + ll) — not max(ll) as the reference does
    (ref: gaussfiltax/inference.py:347-350) — guarantees the dominant term
    exponentiates to exactly 1, so the normalizer can never underflow to
    0/0 when every component's likelihood is astronomically small (one bad
    step at R=2.5e-5 gives lls ≈ −8e6 across the whole bank; the
    reference's form NaNs there if the best-fitting component's weight had
    already underflowed)."""
    logw = jnp.log(weights) + lls
    shift = jnp.max(logw)
    unnorm = jnp.exp(logw - shift)
    total = jnp.sum(unnorm)
    step_loglik = jnp.log(total) + shift
    return unnorm / total, step_loglik


@with_matmul_precision
def gaussian_sum_filter(
    params: ParamsNLSSM,
    emissions: jax.Array,
    num_components: int = 1,
    num_iter: int = 1,
    inputs: Optional[jax.Array] = None,
    key: PRNGKey = None,
    jitter: float = 0.0,
) -> PosteriorGaussianSumFiltered:
    """Gaussian-sum filter: a bank of M (iterated) EKFs
    (ref: gaussfiltax/inference.py:303-377).

    ``key`` seeds the initial component means (the reference hard-codes
    ``jr.PRNGKey(0)``, which remains the default).
    """
    num_timesteps = len(emissions)
    f, h, F_x, H_x, F_q, H_r = _jacobians(params)
    inputs = _process_input(inputs, num_timesteps)
    if key is None:
        key = jr.PRNGKey(0)

    # Bank primitives (ops/bank_update.py): one kernel per half-step over
    # the component bank where bank_impl claims the shapes, the vmapped
    # EKF algebra otherwise.
    v_update = functools.partial(
        _bank.bank_ekf_condition_on_iterated,
        residual_fn=getattr(params, "emission_residual", None))
    v_predict = _bank.bank_ekf_predict

    def step(carry, t):
        weights, pred_means, pred_covs, ll = carry
        Q, q0, R, r0 = _slice_noise(params, t)
        u, y = inputs[t], emissions[t]

        upd = v_update(pred_means, pred_covs, h, H_x, H_r, R, r0, u, y,
                       num_iter, jitter)
        weights, step_ll = _reweight(upd.log_likelihood, weights)
        u_next = _predict_input(inputs, t, num_timesteps)
        pred_means, pred_covs, _ = v_predict(upd.mean, upd.cov, f, F_x, F_q,
                                             Q, q0, u_next)

        carry = (weights, pred_means, pred_covs, ll + step_ll)
        outputs = {
            "means": upd.mean,
            "covariances": upd.cov,
            "predicted_means": pred_means,
            "predicted_covariances": pred_covs,
            "weights": weights,
        }
        return carry, outputs

    w0, m0, P0 = _init_mixture(params, num_components, key)
    (_, _, _, marginal_ll), outputs = lax.scan(
        step, (w0, m0, P0, jnp.zeros(())), jnp.arange(num_timesteps)
    )
    outputs = swap_axes_on_values(outputs)
    return PosteriorGaussianSumFiltered(marginal_loglik=marginal_ll, **outputs)


@with_matmul_precision
def unscented_gaussian_sum_filter(
    params: ParamsNLSSM,
    uparams: ParamsUKF,
    emissions: jax.Array,
    num_components: int = 1,
    num_iter: int = 1,
    inputs: Optional[jax.Array] = None,
    key: PRNGKey = None,
) -> PosteriorGaussianSumFiltered:
    """Gaussian-sum filter with UKF moments
    (ref: gaussfiltax/inference.py:379-456)."""
    num_timesteps = len(emissions)
    f, h = params.dynamics_function, params.emission_function
    inputs = _process_input(inputs, num_timesteps)
    if key is None:
        key = jr.PRNGKey(0)

    v_update = vmap(
        functools.partial(
            _ukf.ukf_condition_on_nonadditive_iterated,
            residual_fn=getattr(params, "emission_residual", None)),
        in_axes=(0, 0, None, None, None, None, None, None, None),
    )
    v_predict = vmap(
        _ukf.ukf_predict_nonadditive, in_axes=(0, 0, None, None, None, None, None)
    )

    def step(carry, t):
        weights, pred_means, pred_covs, ll = carry
        Q, q0, R, r0 = _slice_noise(params, t)
        u, y = inputs[t], emissions[t]

        lls, f_means, f_covs = v_update(pred_means, pred_covs, h, R, u, y, uparams,
                                        r0, num_iter)
        weights, step_ll = _reweight(lls, weights)
        u_next = _predict_input(inputs, t, num_timesteps)
        pred_means, pred_covs = v_predict(f_means, f_covs, f, u_next, Q,
                                          uparams, q0)

        carry = (weights, pred_means, pred_covs, ll + step_ll)
        outputs = {
            "means": f_means,
            "covariances": f_covs,
            "predicted_means": pred_means,
            "predicted_covariances": pred_covs,
            "weights": weights,
        }
        return carry, outputs

    w0, m0, P0 = _init_mixture(params, num_components, key)
    (_, _, _, marginal_ll), outputs = lax.scan(
        step, (w0, m0, P0, jnp.zeros(())), jnp.arange(num_timesteps)
    )
    outputs = swap_axes_on_values(outputs)
    return PosteriorGaussianSumFiltered(marginal_loglik=marginal_ll, **outputs)


# ---------------------------------------------------------------------------
# Augmented Gaussian-sum filters (AGSF family)
# ---------------------------------------------------------------------------

def _select_split_cov(
    strategy: str,
    alpha,
    means,
    covs,
    jacobian: Callable,
    hessian: Callable,
    num_splits: int,
    bias,
    u,
):
    """Splitting-covariance selection ("autocov",
    ref: gaussfiltax/inference.py:226-301). Batched over components.

    Strategies: "prop" Δ=α·P (the reference's active branch, ref :255,295);
    "eye" Δ=α·I; "sdp" the fixed-point SDP solver (ref commented branch 1a);
    "trace" the Hessian-trace-scaled proportional rule (ref branch 4).
    """
    if strategy == "prop":
        return alpha * covs
    if strategy == "eye":
        dx = covs.shape[-1]
        return jnp.broadcast_to(alpha * jnp.eye(dx, dtype=covs.dtype), covs.shape)
    if strategy == "sdp":
        def one(m, P):
            H = hessian(m, bias, u)
            J = jacobian(m, bias, u)
            return utils.sdp_opt(P.shape[-1], num_splits, P, J, H, alpha)
        return vmap(one)(means, covs)
    if strategy == "trace":
        def one(m, P):
            H = jnp.reshape(hessian(m, bias, u), (-1,) + P.shape)
            # Curvature scale Σ_i |tr(H_i P)|. The reference's commented
            # branch 4 (ref: gaussfiltax/inference.py:253) sums the signed
            # traces — which can be ≤ 0 for sign-indefinite Hessians (e.g.
            # the BOT bearing emission), making Δ = scale·P indefinite and
            # NaN-ing the filter. Magnitudes + a [0,1] clamp keep 0 ⪯ Δ ⪯ P.
            denom = jnp.sum(jnp.abs(jnp.trace(H @ P, axis1=-2, axis2=-1)))
            scale = jnp.clip(
                alpha * jnp.trace(P) / (denom + 1e-30), 0.0, 1.0
            )
            return scale * P
        return vmap(one)(means, covs)
    raise ValueError(f"unknown autocov strategy {strategy!r}")


def _agsf_engine(
    params: ParamsNLSSM,
    emissions: jax.Array,
    num_components: Sequence[int],
    rng_key: PRNGKey,
    opt_args: Tuple[float, float],
    inputs: Optional[jax.Array],
    moments: str,
    uparams: Optional[ParamsUKF],
    reduction: str,
    autocov: str,
    num_iter: int,
    compat_fixed_keys: bool,
    jitter: float,
):
    """Shared AGSF scan: split → predict → split → update → reduce.

    One struct-of-arrays implementation covers the reference's pytree AGSF,
    its "speedy" rewrite, and both UKF variants
    (ref: gaussfiltax/inference.py:458-1155).
    """
    M, N, L = int(num_components[0]), int(num_components[1]), int(num_components[2])
    num_timesteps = len(emissions)
    f, h, F_x, H_x, F_q, H_r = _jacobians(params)
    F_xx, H_xx = jacrev(F_x), jacrev(H_x)
    inputs = _process_input(inputs, num_timesteps)
    alpha0, alpha1 = opt_args

    # Key discipline: the caller's rng_key controls BOTH the mixture init and
    # the per-step split/reduce randomness. The reference instead hard-codes
    # jr.PRNGKey(0) for the init draw (ref: gaussfiltax/inference.py:509,367)
    # and reuses fixed keys inside the scan — reproduced by compat_fixed_keys.
    if compat_fixed_keys:
        init_key, scan_key = jr.PRNGKey(0), rng_key
    else:
        init_key, scan_key = jr.split(rng_key)

    use_ekf = moments == "ekf"
    if use_ekf:
        # Bank primitives (ops/bank_update.py), as in gaussian_sum_filter.
        v_predict = _bank.bank_ekf_predict
        v_update = functools.partial(
            _bank.bank_ekf_condition_on_iterated,
            residual_fn=getattr(params, "emission_residual", None))
    else:
        v_predict = vmap(
            _ukf.ukf_predict_nonadditive,
            in_axes=(0, 0, None, None, None, None, None),
        )
        v_update = vmap(
            functools.partial(
                _ukf.ukf_condition_on_nonadditive_iterated,
                residual_fn=getattr(params, "emission_residual", None)),
            in_axes=(0, 0, None, None, None, None, None, None, None),
        )

    def step(carry, t):
        means, covs, weights = carry
        Q, q0, R, r0 = _slice_noise(params, t)
        u, y = inputs[t], emissions[t]
        key_t = _step_key(scan_key, t, compat_fixed_keys)
        key_split1, key_split2, key_reduce = jr.split(key_t, 3)
        if compat_fixed_keys:
            # Reference resamples with a fresh PRNGKey(0) inside every step
            # (ref: gaussfiltax/inference.py:566,766).
            key_reduce = jr.PRNGKey(0)

        # -- autocov 1 + branch 1: M -> M*N --------------------------------
        deltas = _select_split_cov(
            autocov, alpha0, means, covs, F_x, F_xx, N, q0, u
        )
        mixture = GaussianSum(means, covs, weights)
        to_predict = split_gaussian_sum(key_split1, mixture, deltas, N)

        # -- predict --------------------------------------------------------
        if use_ekf:
            pred_means, pred_covs, grads_dyn = v_predict(
                to_predict.means, to_predict.covariances, f, F_x, F_q, Q, q0, u
            )
        else:
            pred_means, pred_covs = v_predict(
                to_predict.means, to_predict.covariances, f, u, Q, uparams, q0
            )
            grads_dyn = None
        pred_weights = to_predict.weights

        # -- autocov 2 + branch 2: M*N -> M*N*L ------------------------------
        lambdas = _select_split_cov(
            autocov, alpha1, pred_means, pred_covs, H_x, H_xx, L, r0, u
        )
        predicted = GaussianSum(pred_means, pred_covs, pred_weights)
        to_update = split_gaussian_sum(key_split2, predicted, lambdas, L)

        # -- update -----------------------------------------------------------
        if use_ekf:
            upd = v_update(
                to_update.means, to_update.covariances, h, H_x, H_r, R, r0, u, y,
                num_iter, jitter,
            )
            lls, upd_means, upd_covs = upd.log_likelihood, upd.mean, upd.cov
            grads_obs, gain = upd.jacobian, upd.gain
        else:
            lls, upd_means, upd_covs = v_update(
                to_update.means, to_update.covariances, h, R, u, y, uparams, r0,
                num_iter,
            )
            grads_obs = gain = None
        new_weights, step_ll = _reweight(lls, to_update.weights)
        pre_weights = new_weights

        # -- reduce M*N*L -> M -------------------------------------------------
        updated = GaussianSum(upd_means, upd_covs, new_weights)
        reduced = containers.reduce_gaussian_sum(updated, M, key_reduce, reduction)

        carry = (reduced.means, reduced.covariances, reduced.weights)
        outputs = {
            "weights": reduced.weights,
            "means": reduced.means,
            "covariances": reduced.covariances,
        }
        aux = {
            "Deltas": deltas,
            "Lambdas": lambdas,
            "updated_means": upd_means,
            "pre_weights": pre_weights,
            "step_loglik": step_ll,
        }
        if use_ekf:
            aux.update(grads_dyn=grads_dyn, grads_obs=grads_obs, gain=gain)
        return carry, (outputs, aux)

    w0, m0, P0 = _init_mixture(params, M, init_key)
    carry = (m0, P0, w0)
    _, (outputs, aux) = lax.scan(step, carry, jnp.arange(num_timesteps))
    outputs = swap_axes_on_values(outputs)
    marginal_ll = jnp.sum(aux.pop("step_loglik"))
    posterior = PosteriorGaussianSumFiltered(
        outputs["weights"],
        outputs["means"],
        outputs["covariances"],
        marginal_loglik=marginal_ll,
    )
    return posterior, aux


@with_matmul_precision
def augmented_gaussian_sum_filter(
    params: ParamsNLSSM,
    emissions: jax.Array,
    num_components: Sequence[int],
    rng_key: PRNGKey = None,
    num_iter: int = 1,
    opt_args: Tuple[float, float] = (0.1, 0.1),
    inputs: Optional[jax.Array] = None,
    autocov: str = "prop",
    reduction: str = "multinomial",
    compat_fixed_keys: bool = False,
    jitter: float = 0.0,
):
    """Augmented Gaussian-sum filter (AGSF) with EKF moments.

    Per step: select splitting covariances Δ (autocov), branch each of the M
    components into N, EKF-predict, select Λ, branch into L, EKF-update,
    reweight, and resample back to M components
    (ref: gaussfiltax/inference.py:458-619). The reference's separate
    pytree-based and "speedy" implementations are numerically the same
    algorithm; this package has only the struct-of-arrays implementation.

    Returns ``(posterior, aux_outputs)`` where ``aux_outputs`` carries the
    per-step Deltas/Lambdas/gradients/gain/pre-resampling weights
    (ref: gaussfiltax/inference.py:592-601; the reference's "timing" entry is
    dropped — it recorded trace-time constants, see SURVEY.md §5.1).

    ``reduction`` ∈ {"multinomial", "systematic", "stratified", "topk",
    "optimal"}. "multinomial" is the reference's nominal behavior, but iid
    resampling at small M occasionally discards the only on-track component
    (catastrophic RMSE outliers on the BOT benchmark); prefer "topk" or
    "systematic" at M ≲ 8.
    """
    if rng_key is None:
        rng_key = jr.PRNGKey(0)
    return _agsf_engine(
        params, emissions, num_components, rng_key, opt_args, inputs,
        moments="ekf", uparams=None, reduction=reduction, autocov=autocov,
        num_iter=num_iter, compat_fixed_keys=compat_fixed_keys, jitter=jitter,
    )


# The reference's vectorized rewrite (ref: gaussfiltax/inference.py:621-812)
# is this package's only implementation; keep the name as an alias.
speedy_augmented_gaussian_sum_filter = augmented_gaussian_sum_filter


@with_matmul_precision
def unscented_agsf(
    params: ParamsNLSSM,
    uparams: ParamsUKF,
    emissions: jax.Array,
    num_components: Sequence[int],
    rng_key: PRNGKey = None,
    num_iter: int = 1,
    opt_args: Tuple[float, float] = (0.1, 0.1),
    inputs: Optional[jax.Array] = None,
    autocov: str = "prop",
    reduction: str = "multinomial",
    compat_fixed_keys: bool = False,
    jitter: float = 0.0,
):
    """AGSF with unscented moments (ref: gaussfiltax/inference.py:814-964).

    ``reduction``/``jitter`` mirror :func:`augmented_gaussian_sum_filter`
    (the reference's UAGSF hard-codes iid multinomial reduction)."""
    if rng_key is None:
        rng_key = jr.PRNGKey(0)
    return _agsf_engine(
        params, emissions, num_components, rng_key, opt_args, inputs,
        moments="ukf", uparams=uparams, reduction=reduction,
        autocov=autocov, num_iter=num_iter,
        compat_fixed_keys=compat_fixed_keys, jitter=jitter,
    )


speedy_unscented_agsf = unscented_agsf


@with_matmul_precision
def augmented_gaussian_sum_filter_optimal(
    params: ParamsNLSSM,
    emissions: jax.Array,
    num_components: Sequence[int],
    rng_key: PRNGKey = None,
    num_iter: int = 1,
    opt_args: Tuple[float, float] = (0.1, 0.1),
    inputs: Optional[jax.Array] = None,
    autocov: str = "prop",
    compat_fixed_keys: bool = False,
    jitter: float = 0.0,
):
    """AGSF whose reduction uses Fearnhead–Clifford optimal resampling:
    heavy components survive deterministically, light ones are resampled
    (ref: gaussfiltax/inference.py:1157-1300)."""
    if rng_key is None:
        rng_key = jr.PRNGKey(0)
    return _agsf_engine(
        params, emissions, num_components, rng_key, opt_args, inputs,
        moments="ekf", uparams=None, reduction="optimal", autocov=autocov,
        num_iter=num_iter, compat_fixed_keys=compat_fixed_keys, jitter=jitter,
    )


# ---------------------------------------------------------------------------
# Bootstrap particle filter
# ---------------------------------------------------------------------------

@with_matmul_precision
def bootstrap_particle_filter(
    params: ParamsBPF,
    emissions: jax.Array,
    num_particles: int,
    key: PRNGKey = None,
    inputs: Optional[jax.Array] = None,
    ess_threshold: float = 0.5,
    resampler: str = "systematic",
    store: str = "all",
) -> Dict[str, jax.Array]:
    """Bootstrap PF with ESS-adaptive resampling
    (ref: gaussfiltax/inference.py:1302-1381).

    Changes vs the reference: particle propagation samples the dynamics
    noise as ONE batched Cholesky draw instead of a vmap of per-particle
    MVN constructions; weights are tracked in log space; the default
    resampler is systematic (single uniform + parallel cumsum;
    ``resampler="multinomial"`` recovers the reference behavior). Every
    step whose ESS falls below the threshold resamples, exactly.

    ``store="all"`` returns time-major ``{"weights": (T, P), "particles":
    (T, P, dx)}`` like the reference; ``store="summary"`` returns
    ``{"means": (T, dx), "ess": (T,)}`` — at 1M particles the full history
    does not fit in HBM.
    """
    if key is None:
        key = jr.PRNGKey(0)
    num_timesteps = len(emissions)
    f = params.dynamics_function
    inputs = _process_input(inputs, num_timesteps)
    resample_fn = get_resampler(resampler)
    log_prob_fn = params.emission_distribution_log_prob
    v_log_prob = vmap(log_prob_fn, in_axes=(0, None, None))
    v_dyn = vmap(f, in_axes=(0, 0, None))

    def step(carry, t):
        log_weights, particles, key = carry
        Q, q0, R, r0 = _slice_noise(params, t)
        u, y = inputs[t], emissions[t]
        key, key_prop, key_res = jr.split(key, 3)

        # Propagate: one batched noise draw + vmapped dynamics.
        q = mvn_sample(key_prop, q0, Q, (num_particles,))
        new_particles = v_dyn(particles, q, u)

        # Weight in log space.
        lls = v_log_prob(new_particles, y, u)
        log_weights = log_weights + lls
        log_norm = jax.scipy.special.logsumexp(log_weights)
        log_weights = log_weights - log_norm
        weights = jnp.exp(log_weights)

        # ESS-adaptive resampling (ref: gaussfiltax/inference.py:1355-1357).
        ess = effective_sample_size(weights)

        def do_resample(args):
            lw, p = args
            w = jnp.exp(lw)
            uniform = jnp.full((num_particles,), -jnp.log(num_particles),
                               lw.dtype)
            idx = resample_fn(key_res, w, num_particles)
            resampled = jnp.take(p, idx, axis=0)
            return uniform, resampled

        def no_resample(args):
            # Pass log weights through UNCHANGED: a log(exp(lw)) round-trip
            # would turn any weight that underflows to 0 in f32
            # (lw < ~-88, routine at 1M particles) into a permanent -inf.
            return args

        log_weights, new_particles = lax.cond(
            ess < ess_threshold * num_particles,
            do_resample,
            no_resample,
            (log_weights, new_particles),
        )
        weights = jnp.exp(log_weights)

        carry = (log_weights, new_particles, key)
        if store == "all":
            outputs = {"weights": weights, "particles": new_particles}
        else:
            outputs = {
                "means": weights @ new_particles,
                "ess": ess,
            }
        return carry, outputs

    key, key_init = jr.split(key)
    particles = mvn_sample(
        key_init, params.initial_mean, params.initial_covariance, (num_particles,)
    )
    log_weights = jnp.full((num_particles,), -jnp.log(num_particles))
    carry = (log_weights, particles, key)

    _, outputs = lax.scan(step, carry, jnp.arange(num_timesteps))
    if store == "all":
        outputs = swap_axes_on_values(outputs)
    return outputs


# Log-depth iterated smoothers (IEKS/IPLS) live in ops/parallel_iterated.py
# (they import helpers from this module at call time); re-exported here so
# the smoother family is discoverable from one namespace.
from bayesianfiltering_tpu.ops.parallel_iterated import (  # noqa: E402
    parallel_iterated_extended_smoother,
    parallel_iterated_sigma_point_smoother,
)

__all__ = [
    "ParamsUKF",
    "PosteriorGaussianSumFiltered",
    "PosteriorGaussianFiltered",
    "PosteriorGaussianSmoothed",
    "extended_kalman_filter",
    "extended_rts_smoother",
    "unscented_rts_smoother",
    "parallel_iterated_extended_smoother",
    "parallel_iterated_sigma_point_smoother",
    "unscented_kalman_filter",
    "gaussian_sum_filter",
    "unscented_gaussian_sum_filter",
    "augmented_gaussian_sum_filter",
    "speedy_augmented_gaussian_sum_filter",
    "unscented_agsf",
    "speedy_unscented_agsf",
    "augmented_gaussian_sum_filter_optimal",
    "bootstrap_particle_filter",
]
