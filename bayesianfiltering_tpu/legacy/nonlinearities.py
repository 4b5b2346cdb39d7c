"""Legacy nonlinearity zoo (compat shim).

The reference's ``gaussfiltax/nonlinearities.py`` is a snippet library that
references undefined globals and cannot be imported; the working,
parameterized versions live in :mod:`bayesianfiltering_tpu.models.zoo`.
This module re-exports them under the legacy naming (f1.., f96, g96, g96lp)
for code written against the reference layout.
"""
from __future__ import annotations

from bayesianfiltering_tpu.models.zoo import (
    linear_nonlinear_product,
    linear_nonlinear_sum,
    lorenz96,
    power_nonlinearity,
    quadratic_form,
    sinc_nonlinearity,
)


def make_f1(p: float):
    """(1 + ||x||²)^(p/2) triple (ref: gaussfiltax/nonlinearities.py:4-7)."""
    return power_nonlinearity(p)


# f2..H5 are built LAZILY (PEP 562): quadratic_form() et al. create jnp
# arrays, and a module-level jnp op would initialize the JAX backend (and
# open the device) at package import. First attribute access builds and
# caches the closures.
_BUILDERS = {
    "f2": lambda: (sinc_nonlinearity(),),
    "f3": lambda: linear_nonlinear_product(),
    "f4": lambda: linear_nonlinear_sum(),
    "f5": lambda: quadratic_form(),
}
_GROUPS = {
    "f2": ("f2",),
    "f3": ("f3", "J3", "H3"), "J3": ("f3", "J3", "H3"), "H3": ("f3", "J3", "H3"),
    "f4": ("f4", "J4", "H4"), "J4": ("f4", "J4", "H4"), "H4": ("f4", "J4", "H4"),
    "f5": ("f5", "J5", "H5"), "J5": ("f5", "J5", "H5"), "H5": ("f5", "J5", "H5"),
}


def __getattr__(name):
    group = _GROUPS.get(name)
    if group is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    values = _BUILDERS[group[0]]()
    for attr, value in zip(group, values):
        globals()[attr] = value
    return globals()[name]


def make_lorenz96(state_dim: int, emission_dim: int, r: float = 1.0, **kw):
    """Working f96/g96/g96lp triple (ref: gaussfiltax/nonlinearities.py:38-51).

    Returns (f96, g96, g96lp) closures with the (x, noise, u) convention.
    """
    _, params, bpf = lorenz96(state_dim, emission_dim, r=r, **kw)
    f96 = params.dynamics_function
    g96 = params.emission_function
    g96lp = bpf.emission_distribution_log_prob
    return f96, g96, g96lp


__all__ = [
    "make_f1", "f2", "f3", "J3", "H3", "f4", "J4", "H4", "f5", "J5", "H5",
    "make_lorenz96",
]
