"""Parameter containers for nonlinear state-space models.

Field-for-field parity with the reference NamedTuples
(ref: gaussfiltax/models.py:26-84): a :class:`ParamsNLSSM` fully specifies a
non-additive-noise nonlinear SSM

    x_t = f(x_{t-1}, q_t, u_t),   q_t ~ N(q0, Q)
    y_t = h(x_t,     r_t, u_t),   r_t ~ N(r0, R)
    x_1 ~ N(m, S)

and :class:`ParamsBPF` extends it with an arbitrary emission log-density for
particle filtering. Noise covariances may optionally carry a leading time
axis (time-varying Q/R), resolved per-step by the filters.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Union

import jax

from bayesianfiltering_tpu.distributions import mvn_sample
from bayesianfiltering_tpu.types import PRNGKey

# Function-signature aliases (ref: gaussfiltax/models.py:20-23).
FnStateToState = Callable
FnStateAndInputToState = Callable
FnStateToEmission = Callable
FnStateAndInputToEmission = Callable


class ParamsNLSSM(NamedTuple):
    """Nonlinear SSM parameters (ref: gaussfiltax/models.py:26-51).

    The four optional ``*_jacobian_*`` fields are an extension over the
    reference: when provided, the filters use them instead of deriving
    Jacobians with ``jax.jacfwd`` — supply them for models whose autodiff
    graph is expensive or non-smooth at branch points, or to pin exact
    linearization semantics.
    Each callable has the same ``(state, noise, input) -> matrix`` signature
    as ``jacfwd(fn, argnums)`` would produce.
    """

    initial_mean: jax.Array
    initial_covariance: jax.Array
    dynamics_function: Union[FnStateToState, FnStateAndInputToState]
    dynamics_noise_bias: jax.Array
    dynamics_noise_covariance: jax.Array
    emission_function: Union[FnStateToEmission, FnStateAndInputToEmission]
    emission_noise_bias: jax.Array
    emission_noise_covariance: jax.Array
    dynamics_jacobian_x: Optional[Callable] = None
    dynamics_jacobian_q: Optional[Callable] = None
    emission_jacobian_x: Optional[Callable] = None
    emission_jacobian_r: Optional[Callable] = None
    # Optional innovation residual ``(y, yhat) -> y ⊖ yhat`` for emissions
    # with non-Euclidean components (bearings: wrap to (−π, π], see
    # utils/angles.py). None means plain subtraction — the reference's
    # (only) behavior, whose unwrapped ±2π bearing innovations are how its
    # GSF/UAGSF runs NaN on the BOT benchmark (BASELINE.md).
    emission_residual: Optional[Callable] = None


class ParamsBPF(NamedTuple):
    """Bootstrap-PF parameters (ref: gaussfiltax/models.py:55-84)."""

    initial_mean: jax.Array
    initial_covariance: jax.Array
    dynamics_function: Union[FnStateToState, FnStateAndInputToState]
    dynamics_noise_bias: jax.Array
    dynamics_noise_covariance: jax.Array
    emission_function: Union[FnStateToEmission, FnStateAndInputToEmission]
    emission_noise_bias: jax.Array
    emission_noise_covariance: jax.Array
    emission_distribution_log_prob: Callable

    def sample_dynamics_distribution(self, key: PRNGKey, x: jax.Array, u):
        """Propagate one particle: q ~ N(q0, Q), then f(x, q, u)
        (ref: gaussfiltax/models.py:82-84)."""
        q = mvn_sample(key, self.dynamics_noise_bias,
                       self.dynamics_noise_covariance)
        return self.dynamics_function(x, q, u)


__all__ = [
    "ParamsNLSSM",
    "ParamsBPF",
    "FnStateToState",
    "FnStateAndInputToState",
    "FnStateToEmission",
    "FnStateAndInputToEmission",
]
