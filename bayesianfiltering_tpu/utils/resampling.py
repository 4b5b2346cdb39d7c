"""Resampling kernels for particle and Gaussian-sum filters.

Design notes: every resampler here reduces to (sorted) cumulative sums,
``searchsorted``, scatters and batched gathers — no data-dependent shapes,
no host round-trips — so they compile to a handful of fused XLA ops inside
a ``lax.scan`` step.

Coverage of the reference surface:
* multinomial full-reset ``_resample`` — ref: gaussfiltax/utils.py:207-214
* Fearnhead–Clifford ``optimal_resampling`` — ref: gaussfiltax/utils.py:216-244
* 3-D index ``resample`` / top-k ``retain`` (legacy AGSF) —
  ref: gaussfiltax/utils.py:189-205
* NEW (not in reference): systematic and stratified resamplers — the
  standard low-variance choices; a single uniform draw plus a parallel
  cumsum.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import jax.random as jr

from bayesianfiltering_tpu.types import PRNGKey


def effective_sample_size(weights: jax.Array) -> jax.Array:
    """ESS = 1 / sum(w^2) for normalized weights."""
    return 1.0 / jnp.sum(jnp.square(weights), axis=-1)


def _inverse_cdf(weights: jax.Array, positions: jax.Array) -> jax.Array:
    """Map uniform positions in [0,1) to categorical indices via the CDF.

    ``method="sort"`` (one sort-merge of the positions against the CDF)
    rather than the default per-query binary search; which lowering is
    faster on the GPU is not measured.
    """
    # XLA's parallel f32 cumsum can dip by an ulp (re-association), and
    # searchsorted on a non-sorted array is undefined — enforce monotonicity.
    cdf = jax.lax.cummax(jnp.cumsum(weights, axis=-1), axis=weights.ndim - 1)
    cdf = cdf / cdf[..., -1:]  # guard against accumulated rounding
    return jnp.clip(
        jnp.searchsorted(cdf, positions, side="right", method="sort"),
        0,
        weights.shape[-1] - 1,
    )


def _scatter_counts_to_parents(counts: jax.Array, num_samples: int) -> jax.Array:
    """Expand cumulative child counts into a parent index per output slot.

    ``counts[i]`` = number of output slots assigned to particles 0..i;
    output slot j gets parent ``min(#{i : counts[i] ≤ j}, n − 1)``: the
    first particle whose cumulative count exceeds j, and n−1 for a final
    slot that f32 rounding left unassigned (``counts[-1] < n``), so every
    index stays in range. One scatter-add of run starts plus one cumsum —
    O(N), no sort, no searchsorted.
    """
    starts = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), counts[:-1].astype(jnp.int32)]
    )
    marker = jnp.zeros((num_samples,), jnp.int32).at[starts].add(
        1, mode="drop"
    )
    return jnp.cumsum(marker) - 1


def multinomial_resample(key: PRNGKey, weights: jax.Array, num_samples: int) -> jax.Array:
    """IID categorical draws (the reference's ``jr.choice`` pattern)."""
    u = jr.uniform(key, (num_samples,), dtype=weights.dtype)
    return _inverse_cdf(weights, u)


def systematic_counts(key: PRNGKey, weights: jax.Array, num_samples: int) -> jax.Array:
    """Cumulative child counts of systematic resampling (the closed-form
    comb inversion): ``counts_i = ceil(n·cdf_i − u0)``, monotone."""
    n = num_samples
    u0 = jr.uniform(key, (), dtype=weights.dtype)
    cdf = jnp.cumsum(weights)
    cdf = cdf / cdf[-1]
    # XLA's parallel f32 cumsum can dip by an ulp (re-association); keep the
    # cumulative counts monotone so the parents expansion sees a true CDF.
    return jax.lax.cummax(jnp.clip(jnp.ceil(n * cdf - u0), 0, n))


def systematic_resample(key: PRNGKey, weights: jax.Array, num_samples: int) -> jax.Array:
    """Systematic (low-variance) resampling: one uniform, a strided comb.

    Not present in the reference; this is the default for the bootstrap PF.
    With comb positions ``(u0 + j)/n`` the CDF inversion has the closed
    form ``counts_i = ceil(n·cdf_i − u0)``, so the whole resampler is one
    cumsum + a counts→parents inversion — O(N) with no searchsorted.
    """
    return _scatter_counts_to_parents(
        systematic_counts(key, weights, num_samples), num_samples)


def stratified_counts(key: PRNGKey, weights: jax.Array, num_samples: int) -> jax.Array:
    """Cumulative child counts of stratified resampling: one uniform per
    stratum, closed-form ``c_i = ⌊n·cdf_i⌋ + [u_{⌊n·cdf_i⌋} < frac]``."""
    n = num_samples
    u = jr.uniform(key, (n,), dtype=weights.dtype)
    cdf = jnp.cumsum(weights)
    cdf = cdf / cdf[-1]
    t = n * cdf
    jstar = jnp.floor(t).astype(jnp.int32)
    frac = t - jstar
    in_range = jstar < n
    u_at = u[jnp.clip(jstar, 0, n - 1)]
    counts = jnp.clip(jstar + jnp.where(in_range & (u_at < frac), 1, 0), 0, n)
    return jax.lax.cummax(counts)  # guard against non-monotone f32 cumsum


def stratified_resample(key: PRNGKey, weights: jax.Array, num_samples: int) -> jax.Array:
    """Stratified resampling: one uniform per stratum ``[j/n, (j+1)/n)``;
    O(N) like :func:`systematic_resample`."""
    return _scatter_counts_to_parents(
        stratified_counts(key, weights, num_samples), num_samples)


_RESAMPLERS = {
    "multinomial": multinomial_resample,
    "systematic": systematic_resample,
    "stratified": stratified_resample,
}


def get_resampler(name: str):
    try:
        return _RESAMPLERS[name]
    except KeyError:
        raise ValueError(
            f"unknown resampler {name!r}; expected one of {sorted(_RESAMPLERS)}"
        ) from None


def _resample(weights: jax.Array, particles: jax.Array, key: PRNGKey):
    """Full multinomial reset used by the bootstrap PF on ESS trigger.

    Drop-in for ref: gaussfiltax/utils.py:207-214: returns uniform weights,
    gathered particles, and the follow-on key.
    """
    key_draw, next_key = jr.split(key)
    num_particles = weights.shape[0]
    idx = multinomial_resample(key_draw, weights, num_particles)
    resampled = jnp.take(particles, idx, axis=0)
    uniform = jnp.full((num_particles,), 1.0 / num_particles, dtype=weights.dtype)
    return uniform, resampled, next_key


@partial(jax.jit, static_argnums=(1,))
def optimal_resampling(weights: jax.Array, N: int, key: PRNGKey):
    """Fearnhead–Clifford (2003) optimal resampling: M → N support points.

    Finds the threshold ``p`` such that the ``L`` largest weights with
    ``w > p`` are kept deterministically and the remaining mass is
    multinomially resampled into ``N − L`` slots, minimizing resampling
    variance. Same contract as ref: gaussfiltax/utils.py:216-244: returns
    ``(indices[N], weights[N])`` with the kept particles last.

    Implementation: with weights sorted ascending and ``S(r)`` the sum of the
    ``r`` smallest, the candidate threshold for keeping the top ``k`` is
    ``p_k = S(M−k)/(N−k)``; the valid ``k`` satisfies
    ``w_(M−k) < p_k < w_(M−k+1)``.
    """
    M = weights.shape[0]
    if N == 1:
        # Degenerate target: nothing can be kept deterministically — one
        # multinomial draw. (The general path below would build zero-length
        # threshold arrays and gather from them, which is undefined under
        # jit even inside an unselected jnp.where branch.)
        idx = multinomial_resample(key, weights / jnp.sum(weights), 1)
        return idx, jnp.ones((1,), weights.dtype)
    order = jnp.argsort(weights)
    sw = weights[order]
    csum = jnp.cumsum(sw)

    ks = jnp.arange(1, N)
    p_k = csum[M - ks - 1] / (N - ks).astype(weights.dtype)
    valid = jnp.logical_and(sw[M - ks - 1] < p_k, p_k < sw[M - ks])
    L = jnp.sum(jnp.where(valid, ks, 0))
    p = jnp.where(L == 0, 1.0 / N, p_k[jnp.maximum(L - 1, 0)])

    below = sw < p
    res_w = jnp.where(below, sw, 0.0)
    res_w = res_w / jnp.sum(res_w)
    draw = _inverse_cdf(res_w, jr.uniform(key, (M,), dtype=weights.dtype))
    unsorted_draw = order[draw]

    final_idx = jnp.where(below, unsorted_draw, order)
    final_w = jnp.where(below, p, sw)
    idx_out = final_idx[M - N:]
    w_out = final_w[M - N:]
    return idx_out, w_out / jnp.sum(w_out)


def resample(weights: jax.Array, num_samples: int, key: PRNGKey) -> jax.Array:
    """Multinomial resampling over a 3-D weight tensor → (num, 3) indices.

    JAX-native replacement for the NumPy version at
    ref: gaussfiltax/utils.py:189-196 (used by the legacy AGSF's M×N×L
    reduction). Flattens, draws, and unravels — no Python index tables.
    """
    flat = weights.reshape(-1)
    flat_idx = multinomial_resample(key, flat / jnp.sum(flat), num_samples)
    return jnp.stack(jnp.unravel_index(flat_idx, weights.shape), axis=-1)


def retain(weights: jax.Array, num_retained: int) -> jax.Array:
    """Top-k deterministic reduction → (num, 3) indices
    (ref: gaussfiltax/utils.py:198-205)."""
    flat = weights.reshape(-1)
    _, flat_idx = jax.lax.top_k(flat, num_retained)
    flat_idx = flat_idx[::-1]  # reference returns ascending-weight order
    return jnp.stack(jnp.unravel_index(flat_idx, weights.shape), axis=-1)


def split_by_sampling(key: PRNGKey, mean, cov, new_cov, num_comp: int):
    """Sample ``num_comp`` means from N(mean, cov − new_cov)
    (ref: gaussfiltax/utils.py:42-49), jax-native."""
    from bayesianfiltering_tpu.distributions import mvn_sample

    return mvn_sample(key, jnp.atleast_1d(mean), jnp.atleast_2d(cov - new_cov),
                      (num_comp,))


__all__ = [
    "effective_sample_size",
    "multinomial_resample",
    "systematic_resample",
    "systematic_counts",
    "stratified_resample",
    "stratified_counts",
    "get_resampler",
    "_resample",
    "optimal_resampling",
    "resample",
    "retain",
    "split_by_sampling",
]
