"""Legacy (v0) bootstrap particle filter.

API parity with ref: gaussfiltax/particlefilt.py:11-57: ``BootstrapPF(ssm, N)``
with ``run(ys, m0, P0)`` over an additive-noise legacy :class:`SSM`.

Rebuild: the per-particle Python loops and multinomial-counts
expansion (ref :37-50) become one batched propagate/weight pass per scan
step with systematic resampling (``resampler="multinomial"`` recovers the
reference's scheme, expressed as index draws rather than count expansion).
Resampling happens every step, as in the reference (no ESS gate).
"""
from __future__ import annotations

import jax.numpy as jnp
import jax.random as jr
from jax import lax, vmap

from bayesianfiltering_tpu.distributions import mvn_logpdf, mvn_sample
from bayesianfiltering_tpu.legacy.gaussfilt import SSM
from bayesianfiltering_tpu.types import PRNGKey
from bayesianfiltering_tpu.utils.resampling import get_resampler


class BootstrapPF:
    def __init__(self, ssm: SSM, N: int, key: PRNGKey = None,
                 resampler: str = "systematic"):
        self.f, self.g = ssm.f, ssm.g
        self.Q, self.R = ssm.Q, ssm.R
        self.dx, self.dy = ssm.dx, ssm.dy
        self.N = N
        self.key = jr.PRNGKey(0) if key is None else key
        self.resample_fn = get_resampler(resampler)

    def __str__(self):
        return "BPF"

    def run(self, ys, m0, P0, verbose: bool = False):
        """Returns the (T, N, dx) post-resampling particle history."""
        ys = jnp.asarray(ys)
        T = ys.shape[0]
        k_init, k_run = jr.split(self.key)
        particles0 = mvn_sample(k_init, jnp.asarray(m0), jnp.asarray(P0),
                                (self.N,))

        def step(particles, args):
            y, k = args
            k_prop, k_res = jr.split(k)
            q = mvn_sample(k_prop, jnp.zeros(self.dx), self.Q, (self.N,))
            new_particles = vmap(lambda p: jnp.atleast_1d(self.f(p)))(particles) + q
            lls = vmap(
                lambda p: mvn_logpdf(jnp.atleast_1d(y),
                                     jnp.atleast_1d(self.g(p)), self.R)
            )(new_particles)
            lls = lls - jnp.max(lls)
            w = jnp.exp(lls)
            w = w / jnp.sum(w)
            idx = self.resample_fn(k_res, w, self.N)
            resampled = jnp.take(new_particles, idx, axis=0)
            return resampled, resampled

        keys = vmap(lambda t: jr.fold_in(k_run, t))(jnp.arange(T))
        _, history = lax.scan(step, particles0, (ys, keys))
        return history


__all__ = ["BootstrapPF"]
