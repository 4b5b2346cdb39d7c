"""Splitting-covariance selection via projected fixed-point / SDP solvers.

The AGSF chooses a splitting covariance Δ ⪯ P that trades linearization
error (wants small Δ) against Monte-Carlo error (wants Δ close to P). The
reference ships several generations of the solver; all are reproduced here,
jax-native and jit/vmap-friendly:

* ``sdp_opt`` / ``sdp_opt2`` — modern fixed-point iterations with double PSD
  projection Δ ← P − proj(P − Δ) (ref: gaussfiltax/utils.py:109-177).
  NOTE a conscious deviation: the reference builds its second-order operator
  with ``vec_h[i] * vec_h[i].T`` where ``vec_h[i]`` is a flat *vector*, so
  ``.T`` is a no-op and the expression broadcasts an elementwise square
  across rows instead of forming the rank-1 matrix; it also loops
  ``range(state_dim)`` over an (emission_dim, n, n) Hessian. We implement
  the evidently intended operator ``Σ_i vec(H_i) vec(H_i)^T`` over the
  output dimension.
* ``gradient_descent`` / ``sdp_opt_legacy`` / ``sdp_opt_test`` — the legacy
  projected-gradient generation (ref: build/lib/codebase/utils.py:95-125),
  still required by the legacy AGSF selection modes ``opt_lip`` /
  ``opt_max_grad`` / ``test`` (ref: gaussfiltax/gausssumfilt.py:179,190,237).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from bayesianfiltering_tpu.utils.linalg import project_to_psd_fast


def _vec(x: jax.Array, n: int) -> jax.Array:
    return jnp.reshape(x, (n * n,))


def _mat(x: jax.Array, n: int) -> jax.Array:
    return jnp.reshape(x, (n, n))


def _second_order_operator(hessian: jax.Array, n: int) -> jax.Array:
    """lhs = (1/4) Σ_i vec(H_i) vec(H_i)^T + I over the output dimension."""
    hessian = jnp.reshape(jnp.atleast_3d(hessian), (-1, n, n))
    vecs = jnp.reshape(hessian, (hessian.shape[0], n * n))
    low_rank = jnp.einsum("ia,ib->ab", vecs, vecs)
    return 0.25 * low_rank + jnp.eye(n * n, dtype=hessian.dtype)


def _double_projection(delta: jax.Array, p: jax.Array) -> jax.Array:
    """Project onto {Δ : 0 ⪯ Δ ⪯ P} (alternating, as in the reference).

    Uses :func:`~bayesianfiltering_tpu.utils.linalg.project_to_psd_fast`
    (this function runs inside ``lax.while_loop`` inside the filter scan,
    autocov="sdp"). Note the
    fixed-point solver itself is still O(n⁴) memory in the state dimension
    (the (n², n²) second-order operator) — autocov="sdp" is for small-to-
    moderate dx, which is the regime the AGSF splits in.
    """
    delta = project_to_psd_fast(delta)
    delta = p - project_to_psd_fast(p - delta)
    return project_to_psd_fast(delta)


def _fixed_point(lhs, aid, p, n, tol, max_iters=100):
    def step(val):
        vec_delta, _, it = val
        rhs = aid + vec_delta
        new_vec = jnp.linalg.solve(lhs, rhs)
        delta = _double_projection(_mat(new_vec, n), p)
        new_vec = _vec(delta, n)
        diff = jnp.linalg.norm(new_vec - vec_delta) / n**2
        return new_vec, diff, it + 1

    def cond(val):
        _, diff, it = val
        return jnp.logical_and(diff > tol, it < max_iters)

    init = (jnp.zeros((n * n,), dtype=p.dtype), jnp.asarray(1.0, p.dtype), 0)
    out = lax.while_loop(cond, step, init)
    return _mat(out[0], n)


def sdp_opt(state_dim: int, N, P, jacobian, hessian, beta, tol: float = 0.1):
    """Fixed-point splitting-covariance solver (ref: gaussfiltax/utils.py:109-144).

    Solves the stationarity condition of
    ``min_Δ (β/N)·tr((P−Δ)J^TJ) + (1/4)·Σ_i tr(Δ H_i)^2`` over 0 ⪯ Δ ⪯ P
    by iterating the linear update with alternating PSD projections.
    Unlike the reference, the loop is capped at 100 iterations so a
    non-contracting instance cannot hang the program.
    """
    n = state_dim
    lhs = _second_order_operator(hessian, n)
    aid = beta * _vec(jacobian.T @ jacobian, n) / N
    return _fixed_point(lhs, aid, P, n, tol)


def sdp_opt2(state_dim: int, N, P, jacobian, hessian, alpha, eta=None, tol: float = 0.1):
    """Vanilla variant (ref: gaussfiltax/utils.py:146-177). ``eta`` accepted
    and ignored to match the 8-arg call at ref: gaussfiltax/inference.py:249."""
    n = state_dim
    lhs = _second_order_operator(hessian, n)
    aid = alpha * _vec(jacobian.T @ jacobian, n) / N
    return _fixed_point(lhs, aid, P, n, tol)


def gradient_descent(dim: int, N, L, X0, P, H, Nsteps: int, eta):
    """Unprojected gradient steps on the splitting objective
    (ref: build/lib/codebase/utils.py:95-99)."""
    X = X0
    eye = jnp.eye(dim, dtype=jnp.result_type(X0))
    for _ in range(Nsteps):
        X = X - eta * (-(2.0 * L**2 / N) * eye + 0.5 * jnp.trace(H @ X) * H)
    return X


def sdp_opt_legacy(dim: int, N, L, X0, P, H, Nsteps: int, eta):
    """Projected-gradient legacy solver (ref: build/lib/codebase/utils.py:102-109).

    This is the 8-argument signature still used by the legacy filters
    (ref: gaussfiltax/gaussfilt.py:287, gausssumfilt.py:179).
    """
    X = X0
    for i in range(Nsteps):
        X = gradient_descent(dim, N, L, X, P, H, 1, eta**i)
        X = _double_projection(X, P)
    return jnp.reshape(X, (dim, dim))


def sdp_opt_test(dim_in: int, dim_out: int, num_prt, lip, X0, cutoff_cov,
                 hess_array, Nsteps: int, eta):
    """Vmapped-Hessian projected-gradient solver
    (ref: build/lib/codebase/utils.py:111-125), used by the legacy AGSF
    'test' selection mode (ref: gaussfiltax/gausssumfilt.py:190,237)."""
    X = X0
    hess_array = jnp.asarray(hess_array)
    if hess_array.ndim == 3:  # (num_prt, n, n) scalar-output case
        hess_array = hess_array[:, None]
    sum_hess = jnp.sum(hess_array, axis=0)  # (dim_out, n, n)
    eye = jnp.eye(dim_in, dtype=jnp.result_type(X0))
    for _ in range(Nsteps):
        coeffs = jnp.sum(
            jnp.trace(jnp.matmul(X, hess_array), axis1=-2, axis2=-1), axis=0
        )  # (dim_out,)
        term_two = jnp.einsum("j,jab->ab", coeffs, sum_hess)
        X = X - eta * (
            -(2.0 * lip**2 / num_prt) * eye + 0.5 / num_prt**2 * term_two
        )
    return _double_projection(X, cutoff_cov)


__all__ = [
    "sdp_opt",
    "sdp_opt2",
    "gradient_descent",
    "sdp_opt_legacy",
    "sdp_opt_test",
]
