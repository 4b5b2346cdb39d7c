"""Mixture-parallel (component-sharded) Gaussian-sum filter.

Completes the parallelism matrix next to data-parallel
(:mod:`~bayesianfiltering_tpu.parallel.batch`) and particle-parallel
(:mod:`~bayesianfiltering_tpu.parallel.particle`): the component bank of a
Gaussian-sum filter (ref: gaussfiltax/inference.py:303-377, single-device)
is sharded over a mesh axis with ``shard_map``. The per-component EKF
updates and predicts are embarrassingly parallel; the ONLY cross-device
traffic per step is the weight normalization —

    shift = pmax(max local ll·w)          (one scalar)
    total = psum(Σ local unnormalized w)  (one scalar)

a few bytes over the interconnect per step, so scaling is limited only by
the per-device bank size. Useful when M is large enough that one card's
memory or FLOPs bound
the bank (e.g. M ≥ 10⁵ components at high state dimension).

The math is identical to :func:`bayesianfiltering_tpu.inference.
gaussian_sum_filter`: same bank primitives (ops/bank_update.py), same
max-stabilized reweighting, same mixture init (drawn globally, then
sharded).
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import jax.random as jr
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from jax import shard_map as _shard_map

from bayesianfiltering_tpu.config import with_matmul_precision
from bayesianfiltering_tpu.models.params import ParamsNLSSM
from bayesianfiltering_tpu.ops import bank_update as _bank
from bayesianfiltering_tpu.types import PRNGKey

# jit cache: re-creating + jitting the shard_mapped closure per call would
# recompile every invocation. Keyed on everything non-array that shapes the trace;
# bounded like parallel/batch.py's lru_cache so shape sweeps can't grow the
# executable set without limit.
_JIT_CACHE_MAX = 128
_JIT_CACHE: "dict" = {}


def _cache_put(key, value):
    if len(_JIT_CACHE) >= _JIT_CACHE_MAX:
        _JIT_CACHE.pop(next(iter(_JIT_CACHE)))
    _JIT_CACHE[key] = value


def sharded_gaussian_sum_filter(
    params: ParamsNLSSM,
    emissions: jax.Array,
    num_components: int,
    mesh: Mesh,
    key: PRNGKey = None,
    num_iter: int = 1,
    inputs: Optional[jax.Array] = None,
    axis_name: str = "mixture",
    jitter: float = 0.0,
):
    """Gaussian-sum filter with the component bank sharded over ``mesh``.

    Returns the same :class:`~bayesianfiltering_tpu.inference.
    PosteriorGaussianSumFiltered` contents as ``gaussian_sum_filter``
    (component-major ``(M, T, ...)`` arrays plus the marginal loglik);
    outputs are gathered to the caller like any shard_map result.
    """
    import bayesianfiltering_tpu.inference as gf

    if key is None:
        key = jr.PRNGKey(0)
    num_timesteps = len(emissions)
    n_dev = mesh.shape[axis_name]
    M = int(num_components)
    if M % n_dev != 0:
        raise ValueError(
            f"num_components={M} not divisible by mesh axis "
            f"{axis_name}={n_dev}"
        )
    f, h, F_x, H_x, F_q, H_r = gf._jacobians(params)
    inputs = gf._process_input(inputs, num_timesteps)
    w0, m0, P0 = gf._init_mixture(params, M, key)

    @with_matmul_precision
    def local_filter(emissions, inputs, weights, means, covs, noise):
        # noise arrays ride as traced args (NOT closure constants) so the
        # jit cache below cannot serve stale parameter values.
        Qa, q0a, Ra, r0a = noise

        def step(carry, t):
            weights, pred_means, pred_covs, ll = carry
            Q = gf._get_params(Qa, 2, t)
            q0 = gf._get_params(q0a, 1, t)
            R = gf._get_params(Ra, 2, t)
            r0 = gf._get_params(r0a, 1, t)
            u, y = inputs[t], emissions[t]

            upd = _bank.bank_ekf_condition_on_iterated(
                pred_means, pred_covs, h, H_x, H_r, R, r0, u, y, num_iter,
                jitter,
                residual_fn=getattr(params, "emission_residual", None),
            )
            # Log-space reweighting with global collectives: exactly
            # inference._reweight, two scalars across devices.
            logw = jnp.log(weights) + upd.log_likelihood
            shift = lax.pmax(jnp.max(logw), axis_name)
            unnorm = jnp.exp(logw - shift)
            total = lax.psum(jnp.sum(unnorm), axis_name)
            weights = unnorm / total
            step_ll = jnp.log(total) + shift

            # t -> t+1 transition rides u_{t+1} (inference._predict_input)
            u_next = inputs[jnp.minimum(t + 1, num_timesteps - 1)]
            pred_means, pred_covs, _ = _bank.bank_ekf_predict(
                upd.mean, upd.cov, f, F_x, F_q, Q, q0, u_next
            )
            carry = (weights, pred_means, pred_covs, ll + step_ll)
            outputs = {
                "means": upd.mean,
                "covariances": upd.cov,
                "predicted_means": pred_means,
                "predicted_covariances": pred_covs,
                "weights": weights,
            }
            return carry, outputs

        init = (weights, means, covs, jnp.zeros(()))
        (_, _, _, marginal_ll), outputs = lax.scan(
            step, init, jnp.arange(num_timesteps)
        )
        outputs = gf.swap_axes_on_values(outputs)
        return outputs, marginal_ll

    spec_bank = P(axis_name)
    cache_key = (
        params.dynamics_function, params.emission_function,
        getattr(params, "dynamics_jacobian_x", None),
        getattr(params, "dynamics_jacobian_q", None),
        getattr(params, "emission_jacobian_x", None),
        getattr(params, "emission_jacobian_r", None),
        mesh, axis_name, M, int(num_iter), float(jitter),
        num_timesteps, emissions.shape, inputs.shape,
    )
    jitted = _JIT_CACHE.get(cache_key)
    if jitted is None:
        shmapped = _shard_map(
            local_filter,
            mesh=mesh,
            in_specs=(P(), P(), spec_bank, spec_bank, spec_bank, P()),
            out_specs=(
                {
                    "means": spec_bank,
                    "covariances": spec_bank,
                    "predicted_means": spec_bank,
                    "predicted_covariances": spec_bank,
                    "weights": spec_bank,
                },
                P(),
            ),
            check_vma=False,
        )
        jitted = jax.jit(shmapped)
        _cache_put(cache_key, jitted)
    noise = (params.dynamics_noise_covariance, params.dynamics_noise_bias,
             params.emission_noise_covariance, params.emission_noise_bias)
    outputs, marginal_ll = jitted(emissions, inputs, w0, m0, P0, noise)
    return gf.PosteriorGaussianSumFiltered(
        marginal_loglik=marginal_ll, **outputs
    )


def sharded_agsf(
    params: ParamsNLSSM,
    emissions: jax.Array,
    num_components,
    mesh: Mesh,
    key: PRNGKey = None,
    num_iter: int = 1,
    opt_args=(0.1, 0.1),
    inputs: Optional[jax.Array] = None,
    axis_name: str = "mixture",
    moments: str = "ekf",
    uparams=None,
    reduction: str = "systematic",
    autocov: str = "prop",
    jitter: float = 0.0,
):
    """Augmented Gaussian-sum filter with the mixture sharded over ``mesh``.

    The flagship M·N·L split→predict→split→update→reduce pipeline of
    :func:`bayesianfiltering_tpu.inference.augmented_gaussian_sum_filter`
    (ref: gaussfiltax/inference.py:621-812 being the pipeline sharded),
    with each device carrying M/n_dev components and branching them to
    M·N·L/n_dev locally. Cross-device traffic per step:

    * weight normalization — two scalars (``pmax`` + ``psum``) across devices;
    * the M→M reduction — one ``all_gather`` of the updated bank
      (M·N·L·(dx²+dx+1) floats; a few KB at AGSF bank sizes), after which
      every device runs the identical deterministic reduction and keeps
      its M/n_dev slice.

    Bit-equal to the single-device engine for the same ``key``: the split
    noise is drawn from the global per-step key and sliced by device index,
    and the gathered reduction re-runs the exact same resampler. Aux
    outputs (Deltas/Lambdas/grads) are not returned by the sharded variant.

    ``reduction="local"`` swaps the gathered reduction for a shard-local
    mass-preserving systematic reduction (the parallel/particle.py
    pattern): each device resamples its own M·N·L/n → M/n slice against
    locally renormalized weights and carries its local mixture mass
    forward, so the per-step collective cost drops to the two reweight
    scalars — no bank gather at all. This is the mode that makes the
    "M ≥ 10⁵ components" scaling story real: at that size the gathered
    bank (M·N·L·(dx²+dx+1) floats per step) is the wire bottleneck.
    Statistically equivalent to the global reduction (same
    weight-proportional expected counts; tests/test_parallel.py pins the
    estimator-level agreement) but not bit-equal: component support never
    crosses shards, and shard masses rebalance only through the global
    reweight.
    """
    import bayesianfiltering_tpu.inference as gf
    from bayesianfiltering_tpu import containers
    from bayesianfiltering_tpu.ops import ukf as _ukf
    from bayesianfiltering_tpu.utils.linalg import cholesky_guarded
    from jax import jacrev, vmap

    if key is None:
        key = jr.PRNGKey(0)
    M, N, L = (int(num_components[0]), int(num_components[1]),
               int(num_components[2]))
    num_timesteps = len(emissions)
    n_dev = mesh.shape[axis_name]
    if M % n_dev != 0:
        raise ValueError(
            f"num_components[0]={M} not divisible by mesh axis "
            f"{axis_name}={n_dev}"
        )
    Ml = M // n_dev
    f, h, F_x, H_x, F_q, H_r = gf._jacobians(params)
    F_xx, H_xx = jacrev(F_x), jacrev(H_x)
    inputs = gf._process_input(inputs, num_timesteps)
    alpha0, alpha1 = opt_args
    init_key, scan_key = jr.split(key)
    w0, m0, P0 = gf._init_mixture(params, M, init_key)
    dx = m0.shape[-1]
    use_ekf = moments == "ekf"
    residual_fn = getattr(params, "emission_residual", None)

    def _local_split(key_split, n_total, means, covs, split_covs, weights,
                     n_splits, dev):
        # Global split noise, sliced to this device's components so the
        # sharded draw equals the single-device containers.split_gaussian_sum.
        n_local = means.shape[0]
        eps = jr.normal(key_split, (n_total, n_splits, dx),
                        dtype=means.dtype)
        eps = lax.dynamic_slice_in_dim(eps, dev * n_local, n_local)
        chol = cholesky_guarded(covs - split_covs)
        child_means = means[:, None, :] + jnp.einsum("mij,mnj->mni", chol, eps)
        child_means = jnp.reshape(child_means, (n_local * n_splits, dx))
        child_covs = jnp.reshape(
            jnp.broadcast_to(split_covs[:, None],
                             (n_local, n_splits, dx, dx)),
            (n_local * n_splits, dx, dx),
        )
        child_weights = jnp.reshape(
            jnp.broadcast_to((weights / n_splits)[:, None],
                             (n_local, n_splits)),
            (n_local * n_splits,),
        )
        return child_means, child_covs, child_weights

    @with_matmul_precision
    def local_filter(emissions, inputs, weights, means, covs, noise):
        Qa, q0a, Ra, r0a = noise
        dev = lax.axis_index(axis_name)

        def step(carry, t):
            mloc, Ploc, wloc = carry
            Q = gf._get_params(Qa, 2, t)
            q0 = gf._get_params(q0a, 1, t)
            R = gf._get_params(Ra, 2, t)
            r0 = gf._get_params(r0a, 1, t)
            u, y = inputs[t], emissions[t]
            key_t = jr.fold_in(scan_key, t)
            key_split1, key_split2, key_reduce = jr.split(key_t, 3)

            # -- autocov 1 + local branch: M/n -> M*N/n ----------------
            deltas = gf._select_split_cov(
                autocov, alpha0, mloc, Ploc, F_x, F_xx, N, q0, u
            )
            sm, sP, sw = _local_split(key_split1, M, mloc, Ploc, deltas,
                                      wloc, N, dev)

            # -- predict (local bank) ----------------------------------
            if use_ekf:
                pm, pP, _ = _bank.bank_ekf_predict(sm, sP, f, F_x, F_q, Q,
                                                   q0, u)
            else:
                pm, pP = vmap(
                    _ukf.ukf_predict_nonadditive,
                    in_axes=(0, 0, None, None, None, None, None),
                )(sm, sP, f, u, Q, uparams, q0)

            # -- autocov 2 + local branch: M*N/n -> M*N*L/n ------------
            lambdas = gf._select_split_cov(
                autocov, alpha1, pm, pP, H_x, H_xx, L, r0, u
            )
            um, uP, uw = _local_split(key_split2, M * N, pm, pP, lambdas,
                                      sw, L, dev)

            # -- update (local bank) -----------------------------------
            if use_ekf:
                upd = _bank.bank_ekf_condition_on_iterated(
                    um, uP, h, H_x, H_r, R, r0, u, y, num_iter, jitter,
                    residual_fn=residual_fn,
                )
                lls, fm, fP = upd.log_likelihood, upd.mean, upd.cov
            else:
                lls, fm, fP = vmap(
                    _ukf.ukf_condition_on_nonadditive_iterated,
                    in_axes=(0, 0) + (None,) * 8,
                )(um, uP, h, R, u, y, uparams, r0, num_iter, residual_fn)

            # -- global log-space reweight (two scalars across devices) ------
            logw = jnp.log(uw) + lls
            shift = lax.pmax(jnp.max(logw), axis_name)
            unnorm = jnp.exp(logw - shift)
            total = lax.psum(jnp.sum(unnorm), axis_name)
            new_w = unnorm / total
            step_ll = jnp.log(total) + shift

            if reduction == "local":
                # -- shard-local mass-preserving reduction: no gather ---
                # Each device resamples its own slice against locally
                # renormalized weights; kept components share the local
                # mass equally, so global mass (=1) is preserved exactly.
                from bayesianfiltering_tpu.utils.resampling import (
                    systematic_resample,
                )

                local_mass = jnp.sum(new_w)
                n_local = new_w.shape[0]
                lw = jnp.where(local_mass > 0, new_w / local_mass,
                               1.0 / n_local)
                idx = systematic_resample(
                    jr.fold_in(key_reduce, dev), lw, Ml)
                mloc = jnp.take(fm, idx, axis=0)
                Ploc = jnp.take(fP, idx, axis=0)
                wloc = jnp.full((Ml,), 1.0 / Ml, new_w.dtype) * local_mass
            else:
                # -- reduce M*N*L -> M: gather, identical global reduction
                g_m = jnp.reshape(lax.all_gather(fm, axis_name), (-1, dx))
                g_P = jnp.reshape(lax.all_gather(fP, axis_name),
                                  (-1, dx, dx))
                g_w = jnp.reshape(lax.all_gather(new_w, axis_name), (-1,))
                reduced = containers.reduce_gaussian_sum(
                    containers.GaussianSum(g_m, g_P, g_w), M, key_reduce,
                    reduction,
                )
                mloc = lax.dynamic_slice_in_dim(reduced.means, dev * Ml, Ml)
                Ploc = lax.dynamic_slice_in_dim(reduced.covariances,
                                                dev * Ml, Ml)
                wloc = lax.dynamic_slice_in_dim(reduced.weights, dev * Ml,
                                                Ml)

            outputs = {"weights": wloc, "means": mloc, "covariances": Ploc}
            return (mloc, Ploc, wloc), (outputs, step_ll)

        init = (means, covs, weights)
        _, (outputs, step_lls) = lax.scan(step, init,
                                          jnp.arange(num_timesteps))
        outputs = gf.swap_axes_on_values(outputs)
        return outputs, jnp.sum(step_lls)

    spec_bank = P(axis_name)
    cache_key = (
        "agsf", params.dynamics_function, params.emission_function,
        getattr(params, "dynamics_jacobian_x", None),
        getattr(params, "dynamics_jacobian_q", None),
        getattr(params, "emission_jacobian_x", None),
        getattr(params, "emission_jacobian_r", None),
        residual_fn, mesh, axis_name, M, N, L, int(num_iter), float(jitter),
        moments, uparams, reduction, autocov, float(alpha0), float(alpha1),
        num_timesteps, emissions.shape, inputs.shape,
    )
    jitted = _JIT_CACHE.get(cache_key)
    if jitted is None:
        shmapped = _shard_map(
            local_filter,
            mesh=mesh,
            in_specs=(P(), P(), spec_bank, spec_bank, spec_bank, P()),
            out_specs=(
                {"means": spec_bank, "covariances": spec_bank,
                 "weights": spec_bank},
                P(),
            ),
            check_vma=False,
        )
        jitted = jax.jit(shmapped)
        _cache_put(cache_key, jitted)
    noise = (params.dynamics_noise_covariance, params.dynamics_noise_bias,
             params.emission_noise_covariance, params.emission_noise_bias)
    outputs, marginal_ll = jitted(emissions, inputs, w0, m0, P0, noise)
    return gf.PosteriorGaussianSumFiltered(
        marginal_loglik=marginal_ll, **outputs
    )


__all__ = ["sharded_gaussian_sum_filter", "sharded_agsf"]
