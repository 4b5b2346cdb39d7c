"""Abstract state-space-model base class.

Capability parity with the dynamax-forked ``gaussfiltax/ssm.py``: abstract
distribution accessors, generic ``sample``/``log_prob`` via ``lax.scan``
(ref: gaussfiltax/ssm.py:169-241), inference stubs, and the EM/SGD fitting
drivers (ref: :346-469) — with the reference's latent NameErrors fixed: this
package actually ships ``ensure_array_has_batch_dim`` and ``run_sgd``
(see :mod:`bayesianfiltering_tpu.models._fit`), so ``fit_em``/``fit_sgd``
are runnable.
"""
from __future__ import annotations

from abc import ABC, abstractmethod
from functools import partial
from typing import Any, Optional, Tuple

import jax.numpy as jnp
import jax.random as jr
import optax
from jax import jit, lax, vmap
from jax import tree_util as jtu
from jax.tree_util import tree_map
from typing import Protocol

from bayesianfiltering_tpu.models._fit import (
    ensure_array_has_batch_dim,
    run_sgd,
)
from bayesianfiltering_tpu.models.parameters import (
    ParameterSet,
    PropertySet,
    from_unconstrained,
    to_unconstrained,
)
from bayesianfiltering_tpu.types import PRNGKey, Scalar


class Posterior(Protocol):
    """NamedTuple of posterior arrays."""


class SuffStatsSSM(Protocol):
    """NamedTuple of sufficient statistics."""


class SSM(ABC):
    r"""Base class for state-space models (ref: gaussfiltax/ssm.py:28-80).

    Subclasses implement ``initial_distribution`` / ``transition_distribution``
    / ``emission_distribution`` (returning objects with ``.sample(seed=)`` and
    ``.log_prob``) plus the shape properties, and inherit sampling, joint
    log-probability, and the EM/SGD fitting drivers.
    """

    # -- abstract distribution accessors ---------------------------------
    @abstractmethod
    def initial_distribution(self, params: ParameterSet, inputs=None):
        raise NotImplementedError

    @abstractmethod
    def transition_distribution(self, params: ParameterSet, state, inputs=None):
        raise NotImplementedError

    @abstractmethod
    def emission_distribution(self, params: ParameterSet, state, inputs=None):
        raise NotImplementedError

    def log_prior(self, params: ParameterSet) -> Scalar:
        return 0.0

    @property
    @abstractmethod
    def emission_shape(self) -> Tuple[int, ...]:
        raise NotImplementedError

    @property
    def inputs_shape(self) -> Optional[Tuple[int, ...]]:
        return None

    # -- sampling and log probability ------------------------------------
    def sample(
        self,
        params: ParameterSet,
        key: PRNGKey,
        num_timesteps: int,
        inputs=None,
    ):
        """Sample (states, emissions); capability match for the generic
        ancestral sampler at ref: gaussfiltax/ssm.py:169-211.

        Shape: ONE ``lax.scan`` over every timestep (no
        concatenate of a separately-handled t=0 slice — uniform per-step
        program, uniform output layout), with per-step randomness derived
        by ``jr.fold_in`` on the step index so the stream is independent
        of ``num_timesteps`` prefixes.
        """
        key_init, key_seq = jr.split(key)
        u_first = tree_map(lambda a: a[0], inputs)
        x_first = self.initial_distribution(params, u_first).sample(seed=key_init)

        def _draw_t(x_prev, t):
            u_t = tree_map(lambda a: a[t], inputs)
            k_state, k_obs = jr.split(jr.fold_in(key_seq, t))
            x_prop = self.transition_distribution(params, x_prev, u_t).sample(
                seed=k_state
            )
            # Timestep 0 takes the pre-drawn initial-distribution sample;
            # every later step takes the transition draw.
            x_t = tree_map(
                lambda first, prop: jnp.where(t > 0, prop, first),
                x_first, x_prop,
            )
            y_t = self.emission_distribution(params, x_t, u_t).sample(seed=k_obs)
            return x_t, (x_t, y_t)

        _, (states, emissions) = lax.scan(
            _draw_t, x_first, jnp.arange(num_timesteps)
        )
        return states, emissions

    def log_prob(self, params: ParameterSet, states, emissions, inputs=None) -> Scalar:
        """Joint log p(x_{1:T}, y_{1:T}); capability match for
        ref: gaussfiltax/ssm.py:213-241.

        Single scan over step indices emitting per-step log-densities
        (summed once at the end — keeps the scan carry minimal); the t=0
        initial-density term is selected with ``lax.cond`` in-scan.
        """
        num_timesteps = jtu.tree_leaves(states)[0].shape[0]

        def _lp_t(x_prev, t):
            u_t = tree_map(lambda a: a[t], inputs)
            x_t = tree_map(lambda a: a[t], states)
            y_t = tree_map(lambda a: a[t], emissions)
            lp_state = lax.cond(
                t > 0,
                lambda: self.transition_distribution(
                    params, x_prev, u_t).log_prob(x_t),
                lambda: self.initial_distribution(params, u_t).log_prob(x_t),
            )
            lp_obs = self.emission_distribution(params, x_t, u_t).log_prob(y_t)
            return x_t, lp_state + lp_obs

        x_first = tree_map(lambda a: a[0], states)
        _, step_lps = lax.scan(_lp_t, x_first, jnp.arange(num_timesteps))
        return jnp.sum(step_lps)

    # -- inference hooks (overridden by concrete models) ------------------
    def marginal_log_prob(self, params: ParameterSet, emissions, inputs=None) -> Scalar:
        raise NotImplementedError

    def filter(self, params: ParameterSet, emissions, inputs=None) -> Posterior:
        raise NotImplementedError

    def smoother(self, params: ParameterSet, emissions, inputs=None) -> Posterior:
        raise NotImplementedError

    # -- learning ----------------------------------------------------------
    def e_step(self, params: ParameterSet, emissions, inputs=None):
        raise NotImplementedError

    def m_step(self, params: ParameterSet, props: PropertySet, batch_stats, m_step_state):
        raise NotImplementedError

    def initialize_m_step_state(self, params: ParameterSet, props: PropertySet) -> Any:
        return None

    def fit_em(
        self,
        params: ParameterSet,
        props: PropertySet,
        emissions,
        inputs=None,
        num_iters: int = 50,
        verbose: bool = True,
    ):
        """EM driver (ref: gaussfiltax/ssm.py:346-399, NameError fixed)."""
        batch_emissions = ensure_array_has_batch_dim(emissions, self.emission_shape)
        batch_inputs = ensure_array_has_batch_dim(inputs, self.inputs_shape)

        # Function-valued leaves (ParamsNLSSM carries f/h/Jacobian
        # callables) cannot cross a jit boundary as abstract arrays; wrap
        # them in jtu.Partial so they ride the pytree as (static) callables.
        params = tree_map(
            lambda x: jtu.Partial(x)
            if callable(x) and not isinstance(x, jtu.Partial) else x,
            params,
        )

        @jit
        def em_step(params, m_step_state):
            batch_stats, lls = vmap(partial(self.e_step, params))(
                batch_emissions, batch_inputs
            )
            lp = self.log_prior(params) + lls.sum()
            params, m_step_state = self.m_step(params, props, batch_stats, m_step_state)
            return params, m_step_state, lp

        log_probs = []
        m_step_state = self.initialize_m_step_state(params, props)
        for it in range(num_iters):
            params, m_step_state, marginal_loglik = em_step(params, m_step_state)
            log_probs.append(marginal_loglik)
            if verbose and (it % max(1, num_iters // 10) == 0):
                print(f"fit_em iter {it}: lp={float(marginal_loglik):.4f}")
        return params, jnp.array(log_probs)

    def fit_sgd(
        self,
        params: ParameterSet,
        props: PropertySet,
        emissions,
        inputs=None,
        optimizer: optax.GradientTransformation = optax.adam(1e-3),
        batch_size: int = 1,
        num_epochs: int = 50,
        shuffle: bool = False,
        key: PRNGKey = None,
    ):
        """SGD on the negative marginal log-probability
        (ref: gaussfiltax/ssm.py:401-469, NameError fixed — ``run_sgd`` is
        implemented in this package)."""
        if key is None:
            key = jr.PRNGKey(0)
        batch_emissions = ensure_array_has_batch_dim(emissions, self.emission_shape)
        batch_inputs = ensure_array_has_batch_dim(inputs, self.inputs_shape)

        unc_params = to_unconstrained(params, props)

        def _loss_fn(unc_params, minibatch):
            params = from_unconstrained(unc_params, props)
            minibatch_emissions, minibatch_inputs = minibatch
            scale = len(batch_emissions) / len(minibatch_emissions)
            minibatch_lls = vmap(partial(self.marginal_log_prob, params))(
                minibatch_emissions, minibatch_inputs
            )
            lp = self.log_prior(params) + minibatch_lls.sum() * scale
            return -lp / batch_emissions.size

        dataset = (batch_emissions, batch_inputs)
        unc_params, losses = run_sgd(
            _loss_fn,
            unc_params,
            dataset,
            optimizer=optimizer,
            batch_size=batch_size,
            num_epochs=num_epochs,
            shuffle=shuffle,
            key=key,
        )
        return from_unconstrained(unc_params, props), losses


__all__ = ["SSM", "Posterior", "SuffStatsSSM"]
