"""Gaussian-mixture containers and component splitting ("branching").

Design departure from the reference: the reference stores mixtures as Python
*lists* of per-component NamedTuples and round-trips them through
``jtu.tree_map`` inside every scan step (ref: gaussfiltax/containers.py:43-61,
90-111), which unrolls into the jaxpr per component — the reason its
"speedy" filter variants exist (ref: docs/tests/test_compile_times.py:91-103
measures exactly this bloat). Here a :class:`GaussianSum` is
struct-of-arrays from day one: ``means (M, dx)``, ``covariances (M, dx, dx)``,
``weights (M,)``. All mixture transforms are batched array ops with static
shapes, so trace size is O(1) in the number of components.

Splitting a component into N children samples means from ``N(m, P − Δ)`` and
assigns covariance Δ and weight w/N to each child (the AGSF "augmentation";
ref: gaussfiltax/containers.py:63-111). Non-PSD ``P − Δ`` is handled by
zeroing NaN Cholesky columns, which collapses affected samples onto the
parent mean — the same recovery as the reference's NaN guard
(ref: gaussfiltax/containers.py:83).

The list-based helpers (`GaussianComponent`, ``_gaussian_sum_to_components``,
``_branches_from_tree1/2`` and the module constants ``num_prt1``/``num_prt2``)
are kept as thin compatibility shims for code written against the reference
API; they are NOT used by any filter in this package.
"""
from __future__ import annotations

from typing import List, NamedTuple, Sequence

import jax
import jax.numpy as jnp
import jax.random as jr

from bayesianfiltering_tpu.types import PRNGKey, Scalar
from bayesianfiltering_tpu.utils.linalg import cholesky_guarded

# Compatibility shims for the reference's manually-synced split sizes
# (ref: gaussfiltax/containers.py:13-14). The filters in this package take
# split counts as explicit arguments; these constants exist only so code
# written against the reference keeps importing.
num_prt1 = 2
num_prt2 = 2


class GaussianComponent(NamedTuple):
    """Single mixture component (ref: gaussfiltax/containers.py:17-23)."""

    mean: jax.Array
    covariance: jax.Array
    weight: Scalar


class GaussianSum(NamedTuple):
    """Struct-of-arrays Gaussian mixture.

    Fields (ref: gaussfiltax/containers.py:32-41, re-laid-out as arrays):
        means: (M, dx)
        covariances: (M, dx, dx)
        weights: (M,)
    """

    means: jax.Array
    covariances: jax.Array
    weights: jax.Array

    @property
    def num_components(self) -> int:
        return self.means.shape[0]

    @property
    def state_dim(self) -> int:
        return self.means.shape[-1]

    def _check_normalization(self) -> jax.Array:
        return jnp.allclose(jnp.sum(self.weights), 1.0)

    def _sum_weights(self) -> jax.Array:
        return jnp.sum(self.weights)

    def normalize(self) -> "GaussianSum":
        return self._replace(weights=self.weights / jnp.sum(self.weights))

    def collapse(self):
        """Moment-match the mixture to a single Gaussian (mean, cov)."""
        from bayesianfiltering_tpu.utils.metrics import collapse as _collapse

        return _collapse(self.means, self.covariances, self.weights)


def gaussian_sum(means, covariances, weights) -> GaussianSum:
    """Build a GaussianSum from arrays or sequences, stacking as needed."""
    if not isinstance(means, jax.Array):
        means = jnp.stack(list(means))
    if not isinstance(covariances, jax.Array):
        covariances = jnp.stack(list(covariances))
    weights = jnp.asarray(weights)
    return GaussianSum(means, covariances, weights)


def split_gaussian_sum(
    key: PRNGKey,
    mixture: GaussianSum,
    split_covs: jax.Array,
    num_splits: int,
) -> GaussianSum:
    """Branch every component of ``mixture`` into ``num_splits`` children.

    Children of component m have means sampled from ``N(mean_m, P_m − Δ_m)``,
    covariance ``Δ_m`` and weight ``w_m / num_splits``. Batched equivalent of
    ``_branches_from_tree1/2`` (ref: gaussfiltax/containers.py:90-111) and of
    the inline "z-sample" pattern of the speedy filters
    (ref: gaussfiltax/inference.py:685-695): one batched Cholesky + one
    batched matmul, no per-component tracing.

    Returns a GaussianSum with ``M * num_splits`` components, children of the
    same parent contiguous.
    """
    M, dx = mixture.means.shape
    sampling_cov = mixture.covariances - split_covs
    chol = cholesky_guarded(sampling_cov)  # (M, dx, dx); zeros where non-PSD
    eps = jr.normal(key, (M, num_splits, dx), dtype=mixture.means.dtype)
    child_means = mixture.means[:, None, :] + jnp.einsum("mij,mnj->mni", chol, eps)
    child_means = jnp.reshape(child_means, (M * num_splits, dx))
    child_covs = jnp.reshape(
        jnp.broadcast_to(split_covs[:, None], (M, num_splits, dx, dx)),
        (M * num_splits, dx, dx),
    )
    child_weights = jnp.reshape(
        jnp.broadcast_to(
            (mixture.weights / num_splits)[:, None], (M, num_splits)
        ),
        (M * num_splits,),
    )
    return GaussianSum(child_means, child_covs, child_weights)


def reduce_gaussian_sum(
    mixture: GaussianSum,
    num_keep: int,
    key: PRNGKey = None,
    method: str = "multinomial",
):
    """Reduce a mixture back to ``num_keep`` components.

    Methods:
        * "multinomial" — weight-proportional resampling, uniform output
          weights (ref: gaussfiltax/inference.py:564-571). NOTE the
          reference actually reseeds ``jr.choice`` with a fixed
          ``PRNGKey(0)`` every step (ref :766), which de facto turns its
          reduction into a fixed-quantile comb — a low-variance selection
          closer to "systematic" below than to true iid multinomial.
        * "systematic" / "stratified" — low-variance weight-proportional
          reduction (one shared / per-stratum uniform over a comb of
          quantiles); the principled version of the reference's fixed-comb
          behavior, and the default recommendation at small M where iid
          multinomial occasionally kills the only on-track component.
        * "topk" — deterministic highest-weight reduction, uniform output
          weights (the commented alternative at ref: gaussfiltax/inference.py:573-579).
        * "optimal" — Fearnhead–Clifford: keep heavy components, resample the
          light ones, non-uniform output weights
          (ref: gaussfiltax/inference.py:1254-1259).
    """
    from bayesianfiltering_tpu.utils import resampling as rs

    if method in ("multinomial", "systematic", "stratified"):
        idx = getattr(rs, f"{method}_resample")(key, mixture.weights, num_keep)
        weights = jnp.full((num_keep,), 1.0 / num_keep, mixture.weights.dtype)
    elif method == "topk":
        _, idx = jax.lax.top_k(mixture.weights, num_keep)
        weights = jnp.full((num_keep,), 1.0 / num_keep, mixture.weights.dtype)
    elif method == "optimal":
        idx, weights = rs.optimal_resampling(mixture.weights, num_keep, key)
    else:
        raise ValueError(f"unknown reduction method {method!r}")
    return GaussianSum(
        jnp.take(mixture.means, idx, axis=0),
        jnp.take(mixture.covariances, idx, axis=0),
        weights,
    )


# ---------------------------------------------------------------------------
# Reference-compatibility shims (list-of-components API). Not used by the
# filters in this package; provided so reference-style user code imports.
# ---------------------------------------------------------------------------

def _gaussian_sum_to_components(mixture) -> List[GaussianComponent]:
    """List view of a mixture (ref: gaussfiltax/containers.py:43-44)."""
    means, covs, weights = mixture.means, mixture.covariances, mixture.weights
    return [
        GaussianComponent(means[i], covs[i], weights[i]) for i in range(len(means))
    ]


def _components_to_gaussian_sum(
    components: Sequence[GaussianComponent],
) -> GaussianSum:
    """Stack a component list into struct-of-arrays form
    (ref: gaussfiltax/containers.py:46-61 returns lists; we return arrays)."""
    return gaussian_sum(
        [c.mean for c in components],
        [c.covariance for c in components],
        [c.weight for c in components],
    )


def _branches_from_node(
    node_component: GaussianComponent,
    splitting_cov: jax.Array,
    num_particles: int,
    key: PRNGKey,
) -> List[GaussianComponent]:
    """Split one component into ``num_particles`` children (compat shim).

    Unlike the reference (ref: gaussfiltax/containers.py:80,130), the runtime
    ``num_particles`` argument is honored — there is no module-constant
    override to keep in sync.
    """
    parent = GaussianSum(
        node_component.mean[None],
        node_component.covariance[None],
        jnp.asarray([node_component.weight]),
    )
    child = split_gaussian_sum(key, parent, splitting_cov[None], int(num_particles))
    return _gaussian_sum_to_components(child)


def _branches_from_tree(
    components: Sequence[GaussianComponent],
    split_covs_array,
    num_branch_array,
    key: PRNGKey = None,
):
    """Split every component (compat shim for ``_branches_from_tree1/2``,
    ref: gaussfiltax/containers.py:90-161). Returns a list of child lists."""
    if key is None:
        key = jr.PRNGKey(0)
    keys = jr.split(key, len(components))
    return [
        _branches_from_node(c, jnp.asarray(d), int(n), k)
        for c, d, n, k in zip(components, split_covs_array, num_branch_array, keys)
    ]


# The reference exposes two identical copies differing only in which module
# constant overrides the split count; with the override gone, one
# implementation serves both names.
_branches_from_node1 = _branches_from_node
_branches_from_node2 = _branches_from_node
_branches_from_tree1 = _branches_from_tree
_branches_from_tree2 = _branches_from_tree

__all__ = [
    "GaussianComponent",
    "GaussianSum",
    "gaussian_sum",
    "split_gaussian_sum",
    "reduce_gaussian_sum",
    "num_prt1",
    "num_prt2",
    "_gaussian_sum_to_components",
    "_components_to_gaussian_sum",
    "_branches_from_node1",
    "_branches_from_node2",
    "_branches_from_tree1",
    "_branches_from_tree2",
]
