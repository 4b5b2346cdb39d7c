"""Parameter constraint system (trainability + bijectors).

Capability parity with the dynamax-forked ``gaussfiltax/parameters.py``:
:class:`ParameterProperties` registered as a pytree with metadata in
aux_data (ref: gaussfiltax/parameters.py:24-47), constrained/unconstrained
conversion with stop-gradient freezing (ref: :50-93), and the HMC log-det
Jacobian (ref: :96-122) — built on this package's native bijectors instead
of TFP.
"""
from __future__ import annotations

from typing import Optional

import jax.numpy as jnp
from jax import lax
from jax.tree_util import register_pytree_node_class, tree_map, tree_reduce
from typing import Protocol

from bayesianfiltering_tpu.models.bijectors import Bijector
from bayesianfiltering_tpu.types import Scalar


class ParameterSet(Protocol):
    """A NamedTuple with parameter arrays in the leaf nodes."""


class PropertySet(Protocol):
    """A matching NamedTuple with :class:`ParameterProperties` leaves."""


@register_pytree_node_class
class ParameterProperties:
    """Pytree leaf carrying parameter metadata.

    Properties live in aux_data so that changing them retriggers compilation
    of functions that depend on them (ref: gaussfiltax/parameters.py:24-47).
    """

    def __init__(self, trainable: bool = True,
                 constrainer: Optional[Bijector] = None) -> None:
        self.trainable = trainable
        self.constrainer = constrainer

    def tree_flatten(self):
        return (), (self.trainable, self.constrainer)

    @classmethod
    def tree_unflatten(cls, aux_data, children):
        return cls(*aux_data)

    def __repr__(self):
        return (f"ParameterProperties(trainable={self.trainable}, "
                f"constrainer={self.constrainer})")


def _is_props_leaf(node) -> bool:
    return isinstance(node, ParameterProperties)


def to_unconstrained(params: ParameterSet, props: PropertySet) -> ParameterSet:
    """Constrained -> unconstrained (ref: gaussfiltax/parameters.py:50-67)."""
    to_unc = lambda value, prop: (
        prop.constrainer.inverse(value) if prop.constrainer is not None else value
    )
    return tree_map(to_unc, params, props, is_leaf=_is_props_leaf)


def from_unconstrained(unc_params: ParameterSet, props: PropertySet) -> ParameterSet:
    """Unconstrained -> constrained, stop-gradient on frozen leaves
    (ref: gaussfiltax/parameters.py:70-93)."""

    def from_unc(unc_value, prop):
        if callable(unc_value):
            # Function-valued leaves (model f/h callables inside
            # ParamsNLSSM) pass through untouched — they are static.
            return unc_value
        value = prop.constrainer(unc_value) if prop.constrainer is not None else unc_value
        return lax.stop_gradient(value) if not prop.trainable else value

    return tree_map(from_unc, unc_params, props, is_leaf=_is_props_leaf)


def log_det_jac_constrain(params: ParameterSet, props: PropertySet) -> Scalar:
    """Σ log|df(x)/dx| over trainable constrained leaves
    (ref: gaussfiltax/parameters.py:96-122)."""
    unc_params = to_unconstrained(params, props)

    def _logdet(unc_value, prop):
        if prop.constrainer is None or not prop.trainable:
            return 0.0
        return jnp.sum(prop.constrainer.forward_log_det_jacobian(unc_value))

    logdets = tree_map(_logdet, unc_params, props, is_leaf=_is_props_leaf)
    return tree_reduce(jnp.add, logdets, 0.0)


__all__ = [
    "ParameterSet",
    "PropertySet",
    "ParameterProperties",
    "to_unconstrained",
    "from_unconstrained",
    "log_det_jac_constrain",
]
