"""Particle-sharded bootstrap particle filter (multi-device).

The reference's BPF is single-device (SURVEY.md §2.4). Here the particle
bank is sharded over a mesh axis with ``shard_map``; the only cross-device
traffic is:

* ``psum`` / ``pmax`` scalars for global weight normalization and ESS
  (a few bytes per step across devices), and
* resampling, in one of two modes:
    - ``"local"`` (default): ESS-adaptive resampling *within* each shard,
      preserving each shard's weight mass exactly (per-shard systematic
      resampling; zero particle traffic). Global normalization is preserved;
      shard masses rebalance only through the weights.
    - ``"gather"``: exact global systematic resampling every step via
      ``all_gather`` of the bank (bandwidth-heavy; exactness reference).

Propagation and weighting are embarrassingly parallel — identical math to
:func:`bayesianfiltering_tpu.inference.bootstrap_particle_filter`.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import jax.random as jr
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from jax import shard_map as _shard_map

from bayesianfiltering_tpu.distributions import mvn_sample
from bayesianfiltering_tpu.models.params import ParamsBPF
from bayesianfiltering_tpu.types import PRNGKey
from bayesianfiltering_tpu.utils.resampling import systematic_resample


def sharded_bootstrap_particle_filter(
    params: ParamsBPF,
    emissions: jax.Array,
    num_particles: int,
    mesh: Mesh,
    key: PRNGKey = None,
    inputs: Optional[jax.Array] = None,
    ess_threshold: float = 0.5,
    axis_name: str = "particle",
    resampling_mode: str = "local",
) -> Dict[str, jax.Array]:
    """Run a bootstrap PF with the particle bank sharded over ``mesh``.

    Returns time-major summaries ``{"means": (T, dx), "ess": (T,)}``
    (the full (T, P) history of a sharded bank is deliberately not
    materialized).
    """
    if key is None:
        key = jr.PRNGKey(0)
    num_timesteps = len(emissions)
    n_dev = mesh.shape[axis_name]
    if num_particles % n_dev != 0:
        raise ValueError(
            f"num_particles={num_particles} not divisible by mesh axis "
            f"{axis_name}={n_dev}"
        )
    local_n = num_particles // n_dev
    f = params.dynamics_function
    if inputs is None:
        inputs = jnp.zeros((num_timesteps, 1))

    v_log_prob = jax.vmap(params.emission_distribution_log_prob,
                          in_axes=(0, None, None))
    v_dyn = jax.vmap(f, in_axes=(0, 0, None))
    log_p_total = math.log(num_particles)

    def local_filter(emissions, inputs, key):
        shard = lax.axis_index(axis_name)
        shard_key = jr.fold_in(key, shard)

        def step(carry, t):
            log_w, particles, k = carry
            u, y = inputs[t], emissions[t]
            k, k_prop, k_res = jr.split(k, 3)

            q = mvn_sample(k_prop, params.dynamics_noise_bias,
                           params.dynamics_noise_covariance, (local_n,))
            particles = v_dyn(particles, q, u)

            log_w = log_w + v_log_prob(particles, y, u)
            # Global normalization: shifted psum-logsumexp.
            gmax = lax.pmax(jnp.max(log_w), axis_name)
            total = lax.psum(jnp.sum(jnp.exp(log_w - gmax)), axis_name)
            log_w = log_w - (jnp.log(total) + gmax)
            w = jnp.exp(log_w)

            ess = 1.0 / lax.psum(jnp.sum(jnp.square(w)), axis_name)
            mean = lax.psum(w @ particles, axis_name)

            if resampling_mode == "gather":
                all_w = lax.all_gather(w, axis_name, tiled=True)
                all_p = lax.all_gather(particles, axis_name, tiled=True)
                # Same key on every shard -> identical global index set; each
                # shard keeps its slice of the comb.
                idx = systematic_resample(jr.fold_in(key, t), all_w,
                                          num_particles)
                local_idx = lax.dynamic_slice_in_dim(
                    idx, shard * local_n, local_n
                )
                particles = jnp.take(all_p, local_idx, axis=0)
                log_w = jnp.full((local_n,), -log_p_total, log_w.dtype)
            else:
                def do_resample(args):
                    lw, p = args
                    # Shard-local systematic resampling preserving the
                    # shard's total mass.
                    local_logmass = jax.scipy.special.logsumexp(lw)
                    local_w = jnp.exp(lw - local_logmass)
                    local_w = jnp.where(jnp.isfinite(local_w), local_w,
                                        1.0 / local_n)
                    idx = systematic_resample(k_res, local_w, local_n)
                    new_lw = jnp.full(
                        (local_n,), local_logmass - jnp.log(float(local_n)),
                        lw.dtype,
                    )
                    return new_lw, jnp.take(p, idx, axis=0)

                log_w, particles = lax.cond(
                    ess < ess_threshold * num_particles,
                    do_resample,
                    lambda args: args,
                    (log_w, particles),
                )

            return (log_w, particles, k), {"means": mean, "ess": ess}

        k_init, k_scan = jr.split(shard_key)
        particles = mvn_sample(
            k_init, params.initial_mean, params.initial_covariance, (local_n,)
        )
        log_w = jnp.full((local_n,), -log_p_total)
        _, outputs = lax.scan(step, (log_w, particles, k_scan),
                              jnp.arange(num_timesteps))
        return outputs

    shmapped = _shard_map(
        local_filter,
        mesh=mesh,
        in_specs=(P(), P(), P()),
        out_specs={"means": P(), "ess": P()},
        check_vma=False,
    )
    return jax.jit(shmapped)(emissions, inputs, key)


__all__ = ["sharded_bootstrap_particle_filter"]
