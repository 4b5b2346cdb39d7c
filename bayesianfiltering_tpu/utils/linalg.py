"""Dense linear-algebra primitives shared by all filters.

Equivalents of the reference numerics:

* ``psd_solve`` — ref: gaussfiltax/utils.py:256-259. The reference does an LU
  solve after adding the scalar ``1e-6`` to *every entry* of ``A`` (not the
  diagonal). We solve via Cholesky (half the FLOPs, PSD-respecting) with an
  optional diagonal jitter; the reference's scalar-add behavior is available
  as ``compat_scalar=True`` for golden-parity experiments.
* ``project_to_psd`` — ref: gaussfiltax/utils.py:89-95 (eigh + clamp).
* ``sqrtm_psd`` — ref: gaussfiltax/utils.py:247-254 uses
  ``scipy.linalg.sqrtm`` (Schur-based, returns complex). For symmetric PSD
  input the symmetric square root is the same matrix, is differentiable,
  and batches under ``vmap``.
* ``cholesky_guarded`` — Cholesky whose failed factors (non-PSD input) are
  replaced by zeros, mirroring the NaN-guard semantics of
  ref: gaussfiltax/containers.py:83 at the sampling site.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

_HI = jax.lax.Precision.HIGHEST
# The PSD square root / projection table. Measured on an H100 80GB HBM3 at
# a 700 W power limit (experiments/chol_crossover.py, µs per step of a
# chained scan): batched B=512, eigh 34 / 57 µs vs Newton–Schulz 71 / 157
# at n = 4 / 8; Newton–Schulz 219 vs 251 at n=32 and 539 vs 1140 at n=64;
# unbatched 371 vs 685 at n=64 and 231 vs 1422 at n=128. Above 128 eigh
# (not measured on the card). CPU takes the same table.
_NS_MIN, _NS_MAX = 9, 128


def sqrt_impl(n: int) -> str:
    """``"newton_schulz"`` for 9 ≤ n ≤ 128, ``"eigh"`` otherwise."""
    return "newton_schulz" if _NS_MIN <= n <= _NS_MAX else "eigh"


def symmetrize(a: jax.Array) -> jax.Array:
    """Return the symmetric part ``(A + A^T)/2`` (batched)."""
    return 0.5 * (a + jnp.swapaxes(a, -1, -2))


def psd_solve(
    a: jax.Array,
    b: jax.Array,
    jitter: float = 0.0,
    compat_scalar: bool = False,
) -> jax.Array:
    """Solve ``A x = b`` for symmetric PSD ``A`` via Cholesky.

    Args:
        a: (..., n, n) PSD matrix.
        b: (..., n) or (..., n, k) right-hand side.
        jitter: optional multiple of the identity added to ``A`` before
            factorization (numerical safety for near-singular innovation
            covariances).
        compat_scalar: reproduce the reference quirk of adding ``1e-6`` to
            every entry of ``A`` (ref: gaussfiltax/utils.py:258) before an LU
            solve — only for parity experiments.
    """
    if compat_scalar:
        return jnp.linalg.solve(a + 1e-6, b)
    n = a.shape[-1]
    if jitter:
        a = a + jitter * jnp.eye(n, dtype=a.dtype)
    chol, linv = chol_and_inv_lower(a)
    vector_rhs = b.ndim == a.ndim - 1
    if vector_rhs:
        b = b[..., None]
    x = jnp.swapaxes(linv, -1, -2) @ (linv @ b)
    return x[..., 0] if vector_rhs else x


def project_to_psd(delta: jax.Array) -> jax.Array:
    """Project a symmetric matrix onto the PSD cone (eigenvalue clamp).

    Same math as ref: gaussfiltax/utils.py:89-95; we keep the input dtype
    instead of force-casting to float32 and use a broadcasted eigenvector
    scale instead of materializing ``diag(evals)``.
    """
    evals, evecs = jnp.linalg.eigh(symmetrize(delta))
    clamped = jnp.maximum(evals, 0.0)
    projected = (evecs * clamped[..., None, :]) @ jnp.swapaxes(evecs, -1, -2)
    return symmetrize(projected)


def project_to_psd_ns(delta: jax.Array, num_iters: int = 16) -> jax.Array:
    """PSD-cone projection via the polar form — matmuls only.

    ``proj(A) = (A + (A²)^{1/2}) / 2`` equals the eigenvalue clamp of
    :func:`project_to_psd` for symmetric ``A``, but is batched matmuls
    only, through the Newton–Schulz square root. Eigenvalues within ~1e-6
    of the spectral radius of zero converge partially — clamp error at the
    jitter scale.
    """
    a = symmetrize(delta)
    a2 = jnp.matmul(a, a, precision=_HI)
    # floor=1e-5: prevents the NS divergence on rounding-indefinite A²
    # (see sqrtm_psd_ns) — for a projection the resulting ~3e-3·‖A‖ PSD
    # inflation in null directions is conservative and harmless.
    root = sqrtm_psd_ns(a2, num_iters, floor=1e-5)
    return symmetrize(0.5 * (a + root))


def project_to_psd_fast(delta: jax.Array) -> jax.Array:
    """PSD projection by :func:`sqrt_impl`: the Newton–Schulz polar form
    (matmul-only) or the eigh clamp."""
    if sqrt_impl(delta.shape[-1]) == "newton_schulz":
        return project_to_psd_ns(delta)
    return project_to_psd(delta)


def sqrtm_psd_eigh(p: jax.Array) -> jax.Array:
    """Symmetric PSD matrix square root via eigendecomposition.

    Exact stand-in for ``jnp.real(scipy.linalg.sqrtm(P))``
    (ref: gaussfiltax/utils.py:250) on PSD input.
    """
    evals, evecs = jnp.linalg.eigh(symmetrize(p))
    root = jnp.sqrt(jnp.maximum(evals, 0.0))
    return symmetrize((evecs * root[..., None, :]) @ jnp.swapaxes(evecs, -1, -2))


def sqrtm_psd_ns(p: jax.Array, num_iters: int = 14,
                 floor: float = 0.0) -> jax.Array:
    """Symmetric PSD square root via Newton–Schulz iteration — matmuls only.

    Trace-normalized coupled iteration
    ``Y ← Y(3I − ZY)/2, Z ← (3I − ZY)Z/2`` (quadratic convergence for
    spectral radius < 1). All work is batched matmuls. Eigendirections with eigenvalue ratio ≲1e-6 of the
    trace converge partially — an absolute covariance error at the jitter
    scale, irrelevant for sigma-point spreads.
    """
    n = p.shape[-1]
    eye = jnp.eye(n, dtype=p.dtype)
    p = symmetrize(p)
    s = jnp.trace(p, axis1=-2, axis2=-1)[..., None, None] + 1e-30
    # ``floor`` > 0 shifts the trace-normalized spectrum up: matmul rounding
    # can push a zero eigenvalue of a mathematically-PSD input (e.g. A² in
    # project_to_psd_ns) slightly NEGATIVE, and the coupled iteration then
    # amplifies it (zy ~ −2.25^k) and overflows to ±inf within ~20 steps —
    # observed in-jit in the legacy MCLAF SDP on a (2,2) rounding-residue
    # matrix (round 3). The default stays 0 so the sigma-point sqrtm path
    # keeps golden parity with the reference (tests/test_golden_parity.py);
    # the projection path passes 1e-5, which dominates that rounding (~1e-7)
    # at a ~3e-3·tr(P) spread cost only in null directions.
    a = p / s + floor * eye
    y, z = a, jnp.broadcast_to(eye, p.shape)
    for _ in range(num_iters):
        t = 0.5 * (3.0 * eye - jnp.matmul(z, y, precision=_HI))
        y = jnp.matmul(y, t, precision=_HI)
        z = jnp.matmul(t, z, precision=_HI)
    return symmetrize(y * jnp.sqrt(s))


def sqrtm_psd(p: jax.Array) -> jax.Array:
    """PSD matrix square root by :func:`sqrt_impl`: Newton–Schulz
    (matmul-only) or eigh."""
    if sqrt_impl(p.shape[-1]) == "newton_schulz":
        return sqrtm_psd_ns(p)
    return sqrtm_psd_eigh(p)


def cholesky_guarded(p: jax.Array) -> jax.Array:
    """Cholesky factor with failed factors (non-PSD input) replaced by zeros.

    Sampling with a zero factor collapses the perturbation to the mean,
    which is exactly the recovery behavior of the reference NaN guard
    ``jnp.where(jnp.isnan(new_means), node.mean, new_means)``
    (ref: gaussfiltax/containers.py:83,133), expressed one level earlier so a
    single guarded factor serves any number of samples.
    """
    chol = fast_cholesky(p)
    # All-or-nothing per matrix, on ANY non-finite entry: the unrolled
    # lattice leaves the columns before the failure point finite, and a
    # PARTIAL factor of an indefinite matrix can carry huge or infinite
    # entries — zero the entire factor so sampling collapses onto the mean.
    bad = jnp.any(~jnp.isfinite(chol), axis=(-2, -1), keepdims=True)
    return jnp.where(bad, 0.0, chol)


# ---------------------------------------------------------------------------
# Cholesky and triangular inverse: the one factorization table.
#
# Measured on an H100 80GB HBM3 at a 400 W power limit
# (experiments/chol_crossover.py, chol + L⁻¹ per step of a chained scan,
# B=512 batched): the unrolled Cholesky–Crout lattice below takes 11 µs at
# n=4 and 27 µs at n=8 against 78 and 76 µs for the native factorization
# (cuSOLVER); native wins from n=16 on (53 vs 76 µs; 82 vs 162 µs at n=32;
# 222 vs 431 µs at n=64) and compiles in ~1 s where the unrolled graph
# takes 44 s at n=16. The column-vectorized and blocked-recursion forms
# lost to one of the two at every n. CPU takes the same table (LAPACK).
# ---------------------------------------------------------------------------

# Largest n factorized by the unrolled lattice; native above.
_UNROLLED_MAX = 8


def factor_impl(n: int) -> str:
    """``"unrolled"`` (elementwise Cholesky–Crout lattice, fused by XLA)
    for n ≤ 8, ``"native"`` (cuSOLVER on GPU, LAPACK on CPU) above."""
    return "unrolled" if n <= _UNROLLED_MAX else "native"


def _chol_unrolled(S: jax.Array) -> jax.Array:
    """Cholesky–Crout fully unrolled over the (tiny, static) n×n lattice;
    every statement is one batched elementwise op."""
    n = S.shape[-1]
    e = {}
    for j in range(n):
        d = S[..., j, j]
        for k in range(j):
            d = d - e[(j, k)] * e[(j, k)]
        d = jnp.sqrt(d)
        e[(j, j)] = d
        inv = 1.0 / d
        for i in range(j + 1, n):
            s = S[..., i, j]
            for k in range(j):
                s = s - e[(i, k)] * e[(j, k)]
            e[(i, j)] = s * inv
    zero = jnp.zeros_like(e[(0, 0)])
    rows = [
        jnp.stack([e.get((i, j), zero) for j in range(n)], axis=-1)
        for i in range(n)
    ]
    return jnp.stack(rows, axis=-2)


def _tri_inv_unrolled(L: jax.Array) -> jax.Array:
    """Unrolled forward-substitution inverse of a tiny lower-triangular L."""
    n = L.shape[-1]
    e = {}
    for j in range(n):
        for i in range(j, n):
            if i == j:
                e[(i, j)] = 1.0 / L[..., i, i]
            else:
                s = None
                for k in range(j, i):
                    t = L[..., i, k] * e[(k, j)]
                    s = t if s is None else s + t
                e[(i, j)] = -s / L[..., i, i]
    zero = jnp.zeros_like(e[(0, 0)])
    rows = [
        jnp.stack([e.get((i, j), zero) for j in range(n)], axis=-1)
        for i in range(n)
    ]
    return jnp.stack(rows, axis=-2)


def _tri_inv_native(L: jax.Array) -> jax.Array:
    eye = jnp.broadcast_to(jnp.eye(L.shape[-1], dtype=L.dtype), L.shape)
    return jax.scipy.linalg.solve_triangular(L, eye, lower=True)


def fast_cholesky(S: jax.Array) -> jax.Array:
    """Lower Cholesky factor of (batched) PSD ``S``, by :func:`factor_impl`."""
    if factor_impl(S.shape[-1]) == "unrolled":
        return _chol_unrolled(S)
    return jnp.linalg.cholesky(S)


def tri_inv_lower(L: jax.Array) -> jax.Array:
    """Inverse of a (batched) lower-triangular matrix, by
    :func:`factor_impl`."""
    if factor_impl(L.shape[-1]) == "unrolled":
        return _tri_inv_unrolled(L)
    return _tri_inv_native(L)


def chol_and_inv_lower(S: jax.Array):
    """``(L, L⁻¹)`` for (batched) PSD ``S``: the factor and its inverse,
    which serve the gain, the log-determinant and the whitened innovation
    of one update together."""
    L = fast_cholesky(S)
    return L, tri_inv_lower(L)


def sandwich(f: jax.Array, p: jax.Array) -> jax.Array:
    """Congruence transform ``F P F^T`` (batched). The EKF covariance kernel."""
    return jnp.einsum("...ik,...kl,...jl->...ij", f, p, f)


def matrix_projection(a: jax.Array, b: jax.Array) -> jax.Array:
    """Frobenius projection of ``A`` on span(B) (ref: gaussfiltax/utils.py:86-87)."""
    return (jnp.trace(a.T @ b) / jnp.trace(b.T @ b)) * b


__all__ = [
    "symmetrize",
    "psd_solve",
    "project_to_psd",
    "project_to_psd_ns",
    "project_to_psd_fast",
    "sqrtm_psd",
    "cholesky_guarded",
    "fast_cholesky",
    "tri_inv_lower",
    "chol_and_inv_lower",
    "factor_impl",
    "sqrt_impl",
    "sandwich",
    "matrix_projection",
]
