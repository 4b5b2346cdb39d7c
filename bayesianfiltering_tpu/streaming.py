"""Streaming / chunked filtering with checkpointable carries.

The reference's filters are single-shot scans holding all outputs in memory
(SURVEY.md §5.4: no checkpoint/resume anywhere). Here every filter family
exposes an explicit ``(init, step)`` pair over a tiny carry pytree, so long
runs can be processed in chunks, the carry checkpointed between chunks (the
carry is a few KB), and output storage bounded by the chunk length.

    stepper = make_gsf_stepper(params, num_components=8)
    state = stepper.init(jr.PRNGKey(0))
    for chunk_emissions, chunk_inputs in stream:
        state, outputs = stepper.run_chunk(state, chunk_emissions, chunk_inputs)
        save_state(path, state)

The chunk runner is one ``lax.scan`` (jit it once; all chunks reuse the
compilation if equally sized).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
from jax import lax, vmap

from bayesianfiltering_tpu.config import with_matmul_precision
from bayesianfiltering_tpu.distributions import mvn_sample
from bayesianfiltering_tpu.inference import (
    _init_mixture,
    _jacobians,
    _reweight,
    _slice_noise,
)
from bayesianfiltering_tpu.models.params import ParamsBPF, ParamsNLSSM
from bayesianfiltering_tpu.ops import ekf as _ekf
from bayesianfiltering_tpu.types import PRNGKey
from bayesianfiltering_tpu.utils.resampling import (
    effective_sample_size,
    get_resampler,
)


class FilterStepper(NamedTuple):
    """A filter exposed as (init, step, run_chunk)."""

    init: Callable        # (key) -> state
    step: Callable        # (state, y, u, t) -> (state, outputs)
    run_chunk: Callable   # (state, emissions, inputs, t0=0) -> (state, outputs)


def _chunk_runner(step):
    def run_chunk(state, emissions, inputs=None, t0: int = 0):
        T = emissions.shape[0]
        if inputs is None:
            inputs = jnp.zeros((T, 1))

        def body(state, args):
            y, u, t = args
            return step(state, y, u, t)

        ts = t0 + jnp.arange(T)
        return lax.scan(body, state, (emissions, inputs, ts))

    return run_chunk


class EKFState(NamedTuple):
    mean: jax.Array
    cov: jax.Array
    marginal_loglik: jax.Array


def make_ekf_stepper(params: ParamsNLSSM, num_iter: int = 1,
                     jitter: float = 0.0) -> FilterStepper:
    """Streaming EKF: carry is the FILTERED (mean, cov, loglik).

    Predict-then-update order: a streaming step only sees the current
    input, and the generative model propagates with u_t INTO step t
    (``x_t = f(x_{t-1}, q, u_t)``, see inference._predict_input) — so the
    step first predicts the carried t−1 posterior with u_t (skipped at
    t=0, where the carry is the initial prior), then conditions on y_t.
    Matches :func:`~bayesianfiltering_tpu.inference.extended_kalman_filter`
    exactly (tests/test_streaming.py).
    """
    f, h, F_x, H_x, F_q, H_r = _jacobians(params)
    residual_fn = getattr(params, "emission_residual", None)

    def init(key: PRNGKey = None) -> EKFState:
        return EKFState(params.initial_mean, params.initial_covariance,
                        jnp.zeros(()))

    @with_matmul_precision
    def step(state: EKFState, y, u, t):
        # the filter slices Q at the step that RUNS the t-1 -> t predict
        Q, q0, _, _ = _slice_noise(params, jnp.maximum(t - 1, 0))
        _, _, R, r0 = _slice_noise(params, t)

        def do_predict(args):
            m, P = args
            m2, P2, _ = _ekf.ekf_predict(m, P, f, F_x, F_q, Q, q0, u)
            return m2, P2

        m_pred, P_pred = lax.cond(t > 0, do_predict, lambda a: a,
                                  (state.mean, state.cov))
        upd = _ekf.ekf_condition_on_iterated(
            m_pred, P_pred, h, H_x, H_r, R, r0, u, y, num_iter, jitter,
            residual_fn,
        )
        new_state = EKFState(upd.mean, upd.cov,
                             state.marginal_loglik + upd.log_likelihood)
        return new_state, {"mean": upd.mean, "cov": upd.cov}

    return FilterStepper(init, step, _chunk_runner(step))


class GSFState(NamedTuple):
    weights: jax.Array
    means: jax.Array
    covs: jax.Array
    marginal_loglik: jax.Array


def make_gsf_stepper(params: ParamsNLSSM, num_components: int,
                     num_iter: int = 1, jitter: float = 0.0) -> FilterStepper:
    """Streaming Gaussian-sum filter: carry is the full mixture."""
    f, h, F_x, H_x, F_q, H_r = _jacobians(params)
    v_update = vmap(
        _ekf.ekf_condition_on_iterated,
        in_axes=(0, 0) + (None,) * 10,
    )
    v_predict = vmap(_ekf.ekf_predict,
                     in_axes=(0, 0, None, None, None, None, None, None))

    def init(key: PRNGKey = None) -> GSFState:
        if key is None:
            key = jr.PRNGKey(0)
        w, m, P = _init_mixture(params, num_components, key)
        return GSFState(w, m, P, jnp.zeros(()))

    @with_matmul_precision
    def step(state: GSFState, y, u, t):
        # predict-then-update: see make_ekf_stepper docstring
        Q, q0, _, _ = _slice_noise(params, jnp.maximum(t - 1, 0))
        _, _, R, r0 = _slice_noise(params, t)

        def do_predict(args):
            m, P = args
            m2, P2, _ = v_predict(m, P, f, F_x, F_q, Q, q0, u)
            return m2, P2

        m_pred, P_pred = lax.cond(t > 0, do_predict, lambda a: a,
                                  (state.means, state.covs))
        upd = v_update(m_pred, P_pred, h, H_x, H_r, R, r0, u, y,
                       num_iter, jitter,
                       getattr(params, "emission_residual", None))
        weights, step_ll = _reweight(upd.log_likelihood, state.weights)
        new_state = GSFState(weights, upd.mean, upd.cov,
                             state.marginal_loglik + step_ll)
        outputs = {"weights": weights, "means": upd.mean, "covs": upd.cov}
        return new_state, outputs

    return FilterStepper(init, step, _chunk_runner(step))


class BPFState(NamedTuple):
    log_weights: jax.Array
    particles: jax.Array
    key: PRNGKey


def make_bpf_stepper(params: ParamsBPF, num_particles: int,
                     ess_threshold: float = 0.5,
                     resampler: str = "systematic") -> FilterStepper:
    """Streaming bootstrap PF: carry is the particle bank."""
    f = params.dynamics_function
    resample_fn = get_resampler(resampler)
    v_log_prob = vmap(params.emission_distribution_log_prob,
                      in_axes=(0, None, None))
    v_dyn = vmap(f, in_axes=(0, 0, None))

    def init(key: PRNGKey = None) -> BPFState:
        if key is None:
            key = jr.PRNGKey(0)
        key, k_init = jr.split(key)
        particles = mvn_sample(k_init, params.initial_mean,
                               params.initial_covariance, (num_particles,))
        log_w = jnp.full((num_particles,), -jnp.log(num_particles))
        return BPFState(log_w, particles, key)

    @with_matmul_precision
    def step(state: BPFState, y, u, t):
        Q, q0, R, r0 = _slice_noise(params, t)
        key, k_prop, k_res = jr.split(state.key, 3)
        q = mvn_sample(k_prop, q0, Q, (num_particles,))
        particles = v_dyn(state.particles, q, u)
        log_w = state.log_weights + v_log_prob(particles, y, u)
        log_w = log_w - jax.scipy.special.logsumexp(log_w)
        w = jnp.exp(log_w)
        ess = effective_sample_size(w)

        def do_resample(args):
            lw, p = args
            idx = resample_fn(k_res, jnp.exp(lw), num_particles)
            return (
                jnp.full((num_particles,), -jnp.log(num_particles), lw.dtype),
                jnp.take(p, idx, axis=0),
            )

        # No-resample branch passes log weights through unchanged: an
        # exp/log round-trip turns f32-underflowed weights into -inf.
        log_w, particles = lax.cond(
            ess < ess_threshold * num_particles, do_resample,
            lambda args: args, (log_w, particles),
        )
        new_state = BPFState(log_w, particles, key)
        return new_state, {"mean": w @ particles, "ess": ess}

    return FilterStepper(init, step, _chunk_runner(step))


# ---------------------------------------------------------------------------
# Carry checkpointing
# ---------------------------------------------------------------------------

def _npz_path(path) -> str:
    path = str(path)
    return path if path.endswith(".npz") else path + ".npz"


def save_state(path: str, state) -> None:
    """Checkpoint a filter carry pytree to ``path`` (an ``.npz`` archive;
    the suffix is added if missing)."""
    leaves = jax.tree_util.tree_leaves(state)
    np.savez(_npz_path(path),
             **{f"leaf_{i}": np.asarray(x) for i, x in enumerate(leaves)})


def restore_state(path: str, like):
    """Restore a carry checkpointed by :func:`save_state`; ``like`` is a
    template pytree with matching structure/shapes/dtypes."""
    treedef = jax.tree_util.tree_structure(like)
    with np.load(_npz_path(path)) as data:
        leaves = [jnp.asarray(data[f"leaf_{i}"])
                  for i in range(treedef.num_leaves)]
    return jax.tree_util.tree_unflatten(treedef, leaves)


__all__ = [
    "FilterStepper",
    "EKFState", "make_ekf_stepper",
    "GSFState", "make_gsf_stepper",
    "BPFState", "make_bpf_stepper",
    "save_state", "restore_state",
]
