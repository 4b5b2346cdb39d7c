"""Temporally-parallel Kalman filtering via ``lax.associative_scan``.

Long-sequence scaling story for the linear-Gaussian case: the sequential
scan in :mod:`bayesianfiltering_tpu.ops.linear` is O(T) depth; here the
filtering recursion is phrased as an associative operator over per-timestep
five-tuples ``(A, b, C, J, η)`` and combined in O(log T) depth
(Särkkä & García-Fernández, *Temporal Parallelization of Bayesian Smoothers*,
IEEE TAC 2021 — listed in PAPERS.md), turning a latency-bound recursion
into batched matmuls across the time axis. The flat ``lax.associative_scan``
builds an O(log T)-layer graph whose compile grows with T; the default
:func:`chunked_associative_scan` schedule (O(T) work, constant-size graph —
sequential-within-chunk BATCHED combines + recursion over chunk aggregates)
keeps the graph constant. All paths match the sequential filter (float64
oracle parity in tests).

No counterpart exists in the reference (its only time handling is
``lax.scan``, e.g. ref: gaussfiltax/inference.py:371); this is the answer
to SURVEY.md §5.7.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax, vmap

from bayesianfiltering_tpu.config import with_matmul_precision
from bayesianfiltering_tpu.ops.linear import ParamsLGSSM, PosteriorKalman, _biases
from bayesianfiltering_tpu.utils.linalg import (
    chol_and_inv_lower,
    cholesky_guarded,
    psd_solve,
    symmetrize,
)


def _first_element(params: ParamsLGSSM, y0):
    """Element for t=0: condition the prior on y_0 (no propagation first,
    matching the update-then-predict convention of the sequential filter)."""
    H, R = params.emission_matrix, params.emission_covariance
    _, d = _biases(params)
    m0, P0 = params.initial_mean, params.initial_covariance
    dx = m0.shape[-1]

    S = symmetrize(H @ P0 @ H.T + R)
    K = psd_solve(S, H @ P0).T
    A = jnp.zeros((dx, dx))
    b = m0 + K @ (y0 - H @ m0 - d)
    C = symmetrize(P0 - K @ S @ K.T)
    J = jnp.zeros((dx, dx))
    eta = jnp.zeros((dx,))
    return A, b, C, J, eta


def _generic_element(params: ParamsLGSSM, y):
    """Element for t >= 1 (predict through F,Q then update with y).

    Reference form, one step at a time — kept as the oracle for
    :func:`_elements_time_invariant`, which is what the filter runs."""
    F, Q = params.dynamics_matrix, params.dynamics_covariance
    H, R = params.emission_matrix, params.emission_covariance
    c, d = _biases(params)

    S = symmetrize(H @ Q @ H.T + R)
    K = psd_solve(S, H @ Q).T
    resid = y - d - H @ c
    A = (jnp.eye(F.shape[0]) - K @ H) @ F
    b = c + K @ resid
    C = symmetrize((jnp.eye(F.shape[0]) - K @ H) @ Q)
    HF = H @ F
    J = symmetrize(HF.T @ psd_solve(S, HF))
    eta = HF.T @ psd_solve(S, resid)
    return A, b, C, J, eta


def _elements_time_invariant(params: ParamsLGSSM, emissions):
    """All T filtering elements, with the constant algebra hoisted.

    For a time-invariant model the t>=1 element matrices (A, C, J) do not
    depend on y_t at all, and (b, eta) are AFFINE in y_t. A vmap of
    :func:`_generic_element` re-runs the (dy,dy) psd_solve and all the
    small constant matmuls T times; here the solves run once and the
    per-step work collapses to two (T,dy)x(dy,dx) matmuls plus
    broadcasts of the constant matrices, which shrinks the graph and the
    FLOP count at zero cost."""
    F, Q = params.dynamics_matrix, params.dynamics_covariance
    H, R = params.emission_matrix, params.emission_covariance
    c, d = _biases(params)
    T = emissions.shape[0]
    dx = F.shape[0]

    S = symmetrize(H @ Q @ H.T + R)
    K = psd_solve(S, H @ Q).T
    I = jnp.eye(dx, dtype=F.dtype)
    IKH = I - K @ H
    A1 = IKH @ F
    C1 = symmetrize(IKH @ Q)
    HF = H @ F
    SinvHF = psd_solve(S, HF)
    J1 = symmetrize(HF.T @ SinvHF)

    resid = emissions[1:] - d - H @ c            # (T-1, dy)
    b1 = c + resid @ K.T
    eta1 = resid @ SinvHF

    A0, b0, C0, J0, eta0 = _first_element(params, emissions[0])
    bc = lambda M: jnp.broadcast_to(M, (T - 1, dx, dx))
    return (
        jnp.concatenate([A0[None], bc(A1)], axis=0),
        jnp.concatenate([b0[None], b1], axis=0),
        jnp.concatenate([C0[None], bc(C1)], axis=0),
        jnp.concatenate([J0[None], bc(J1)], axis=0),
        jnp.concatenate([eta0[None], eta1], axis=0),
    )


def _minv_woodbury(C1, J2):
    """Batched ``inv(I + C1 J2)`` for PSD ``C1``, ``J2`` without a general
    linear solve.

    Factor the COVARIANCE side: with ``U = chol(C1)`` (guarded — C1 is a
    filtering covariance, PD up to roundoff; an all-zero C1 degrades to
    the exact answer I), Woodbury gives
    ``inv(I + U Uᵀ J2) = I − U inv(I + Uᵀ J2 U) Uᵀ J2`` where the inner
    matrix is symmetric PD (⪰ I). Everything is batched matmuls + two
    Cholesky factorizations instead of a general LU solve.
    Factoring C1 rather than J2 matters twice over: J2 = (HF)ᵀ S⁻¹ (HF)
    is rank-deficient whenever dy < dx (so it needs the 14-iteration
    Newton–Schulz PSD root — ~42 matmuls per combine; the round-3 original),
    while C1 takes a single blocked Cholesky.
    """
    dx = C1.shape[-1]
    I = jnp.eye(dx, dtype=C1.dtype)
    # C1 is SINGULAR whenever the process noise is rank-deficient
    # (non-additive dq < dx, e.g. the BOT family: C = (I−KH)·F_qQF_qᵀ has
    # rank dq) — a bare guarded Cholesky would zero the whole factor and
    # silently turn the combine into Minv = I (caught round 3: the TV
    # smoother returned a wrong trajectory ONLY on rank-deficient-Q
    # models). A trace-relative jitter (1e-7, below the f32 matmul noise
    # floor) keeps the factor finite and the inverse exact to rounding.
    tr = jnp.trace(C1, axis1=-2, axis2=-1)
    eps = (1e-7 * tr / dx + 1e-30)[..., None, None]
    U = cholesky_guarded(C1 + eps * I)
    J2U = J2 @ U
    inner = I + symmetrize(jnp.swapaxes(U, -1, -2) @ J2U)
    _, linv = chol_and_inv_lower(inner)
    inner_inv = jnp.swapaxes(linv, -1, -2) @ linv
    return I - U @ inner_inv @ jnp.swapaxes(J2U, -1, -2)


def _filter_identity(dx, dtype):
    """Two-sided identity of the filtering combine: (A=I, b=0, C=0, J=0,
    η=0). Verified algebraically (combine(e, id) = combine(id, e) = e —
    every C1/J2 product vanishes) and numerically exact to f32 rounding
    through the Woodbury path (the trace-relative jitter degrades to
    1e-30·I). Enables chunk padding and scan-carry initialization in
    :func:`chunked_associative_scan`."""
    I = jnp.eye(dx, dtype=dtype)
    z = jnp.zeros((dx, dx), dtype=dtype)
    return I, jnp.zeros((dx,), dtype=dtype), z, z, jnp.zeros((dx,), dtype=dtype)


def _smoother_identity(dx, dtype):
    """Two-sided identity of the smoothing combine: (E=I, g=0, L=0)."""
    I = jnp.eye(dx, dtype=dtype)
    return I, jnp.zeros((dx,), dtype=dtype), jnp.zeros((dx, dx), dtype=dtype)


def chunked_associative_scan(combine, elems, identity, chunk: int = 128,
                             reverse: bool = False):
    """Recursive two-level (Blelloch-style) inclusive scan.

    ``lax.associative_scan`` does O(T log T) combine work in a graph with
    O(log T) inlined combine layers — at T=1M that is a multi-minute XLA
    compile and ~20 full passes over HBM. This version does O(T) work in a
    CONSTANT-size graph:

    1. pad T to G·chunk with identity elements and reshape to (G, chunk);
    2. within-chunk inclusive prefixes via ONE ``lax.scan`` of ``chunk``
       steps whose body is a combine BATCHED over all G chunks — the
       batched-small-matrix regime every kernel in this repo is built
       around (one pass over HBM);
    3. recurse on the G chunk aggregates until they fit in one chunk,
       then a plain sequential ``lax.scan`` prefix;
    4. one batched combine broadcasting each chunk's exclusive prefix
       into its in-chunk prefixes (second pass over HBM).

    Depth is O(chunk·log_chunk T) instead of O(log T); step 2's combines
    are batched over all G chunks, so each scan step is one wide kernel.

    ``combine`` must accept broadcastable leading batch axes and be
    associative; ``identity`` is a tuple of single-element arrays that is
    a TWO-SIDED identity of ``combine``. ``reverse=True`` matches
    ``lax.associative_scan(combine, elems, reverse=True)`` exactly:
    flip → forward scan with the SAME operator → flip (so, as there, a
    time-ordered suffix product wants the caller to pass the
    operand-swapped operator).
    """
    if reverse:
        flipped = tuple(jnp.flip(x, axis=0) for x in elems)
        out = chunked_associative_scan(combine, flipped, identity, chunk)
        return tuple(jnp.flip(x, axis=0) for x in out)

    T = elems[0].shape[0]

    def _seq_prefix(xs):
        init = tuple(jnp.broadcast_to(i, x.shape[1:])
                     for i, x in zip(identity, xs))

        def step(carry, x):
            new = combine(carry, x)
            return new, new

        _, out = lax.scan(step, init, xs)
        return out

    if T <= chunk:
        return _seq_prefix(elems)

    G = -(-T // chunk)
    pad = G * chunk - T
    if pad:
        elems = tuple(
            jnp.concatenate(
                [x, jnp.broadcast_to(i, (pad,) + x.shape[1:])], axis=0)
            for i, x in zip(identity, elems))
    # (T, ...) -> (chunk, G, ...): chunk g covers [g*chunk, (g+1)*chunk).
    blocked = tuple(
        jnp.moveaxis(x.reshape((G, chunk) + x.shape[1:]), 1, 0)
        for x in elems)

    # Step 2: in-chunk prefixes, combine batched over all G chunks.
    init = tuple(jnp.broadcast_to(i, (G,) + i.shape) for i in identity)

    def step(carry, x):
        new = combine(carry, x)
        return new, new

    _, prefix = lax.scan(step, init, blocked)        # (chunk, G, ...)

    # Step 3: exclusive prefix of the G chunk aggregates, recursively.
    aggregates = tuple(p[-1] for p in prefix)        # (G, ...)
    agg_prefix = chunked_associative_scan(combine, aggregates, identity,
                                          chunk)
    shifted = tuple(
        jnp.concatenate([jnp.broadcast_to(i, (1,) + i.shape), a[:-1]],
                        axis=0)
        for i, a in zip(identity, agg_prefix))       # (G, ...)

    # Step 4: broadcast each chunk's exclusive prefix into its elements.
    out = combine(tuple(s[None] for s in shifted), prefix)  # (chunk, G, ...)
    out = tuple(
        jnp.moveaxis(x, 0, 1).reshape((G * chunk,) + x.shape[2:])[:T]
        for x in out)
    return out


def _run_filter_scan(elems, solver: str, chunk):
    """Dispatch the filtering prefix scan: chunked two-level (default for
    long sequences) or the flat ``lax.associative_scan``(``chunk=None``)."""
    fn = functools.partial(_combine, solver=solver)
    if chunk is None:
        return lax.associative_scan(fn, elems)
    dx = elems[0].shape[-1]
    ident = _filter_identity(dx, elems[0].dtype)
    return chunked_associative_scan(fn, elems, ident, chunk=chunk)


def _resolve_chunk(chunk, T):
    """``chunk="auto"``: flat associative scan for short sequences (its
    O(log T) graph is small there), two-level at 128 beyond. The 4096
    crossover is not measured on the GPU."""
    if chunk == "auto":
        return None if T <= 4096 else 128
    return chunk


def _combine(elem_left, elem_right, solver: str = "woodbury"):
    """Associative combination of filtering elements (Särkkä & G-F, Lemma 8)."""
    A1, b1, C1, J1, eta1 = elem_left
    A2, b2, C2, J2, eta2 = elem_right
    dx = A1.shape[-1]
    I = jnp.eye(dx, dtype=A1.dtype)

    # (I + C1 J2)^{-1}, applied right (M) and left (N = Mᵀ).
    if solver == "woodbury":
        Minv = _minv_woodbury(C1, J2)
        A2M = A2 @ Minv
        Ninv = jnp.swapaxes(Minv, -1, -2)       # inv(I + J2 C1) = inv(M)ᵀ
        nsolve = lambda x: Ninv @ x
    else:
        M = I + C1 @ J2
        A2M = jnp.swapaxes(jnp.linalg.solve(jnp.swapaxes(M, -1, -2),
                                            jnp.swapaxes(A2, -1, -2)), -1, -2)
        N = I + J2 @ C1
        nsolve = lambda x: jnp.linalg.solve(N, x)
    A = A2M @ A1
    b = A2M @ (b1 + jnp.einsum("...ij,...j->...i", C1, eta2))[..., None]
    b = b[..., 0] + b2
    C = symmetrize(A2M @ C1 @ jnp.swapaxes(A2, -1, -2) + C2)

    tmp = nsolve((eta2 - jnp.einsum("...ij,...j->...i", J2, b1))[..., None])[..., 0]
    eta = jnp.einsum("...ji,...j->...i", A1, tmp) + eta1
    JA = nsolve(J2 @ A1)
    J = symmetrize(jnp.swapaxes(A1, -1, -2) @ JA + J1)
    return A, b, C, J, eta


@with_matmul_precision
def parallel_kalman_filter(params: ParamsLGSSM, emissions: jax.Array,
                           solver: str = "woodbury",
                           chunk="auto") -> PosteriorKalman:
    """Temporally-parallel Kalman filter; matches :func:`kalman_filter`
    outputs (filtered means/covariances; predicted moments derived by one
    extra propagation; marginal loglik from the innovation form).

    ``solver``: "woodbury" (default) runs each combine's inverses as
    batched matmuls + Cholesky (see :func:`_minv_woodbury`); "native" uses
    ``jnp.linalg.solve`` (reference semantics for accuracy comparisons).

    ``chunk``: "auto" (default) picks the scan schedule by sequence
    length; an int runs the two-level :func:`chunked_associative_scan`
    with that chunk size; ``None`` forces the flat
    ``lax.associative_scan``.
    """
    F, Q = params.dynamics_matrix, params.dynamics_covariance
    c, _ = _biases(params)

    elems = _elements_time_invariant(params, emissions)

    _, b_all, C_all, _, _ = _run_filter_scan(
        elems, solver, _resolve_chunk(chunk, len(emissions)))
    filtered_means = b_all
    filtered_covs = C_all

    predicted_means = jnp.einsum("ij,tj->ti", F, filtered_means) + c
    predicted_covs = symmetrize(
        jnp.einsum("ik,tkl,jl->tij", F, filtered_covs, F) + Q
    )

    # predicted_*[t] is the prediction of t+1 given 0..t, so the loglik's
    # per-step prior at t is predicted_*[t-1] — reuse it instead of
    # re-running the (T,dx,dx) propagation einsums.
    ll = _marginal_loglik(params, emissions,
                          predicted_means[:-1], predicted_covs[:-1])
    return PosteriorKalman(ll, filtered_means, filtered_covs,
                           predicted_means, predicted_covs)


def _run_smoother_scan(elems, chunk):
    """Reverse suffix scan of smoothing elements over the chunked / flat
    schedule. In both, the REVERSE scan's left operand is the LATER-time
    partial product, so the time-ordered combine's roles are swapped."""
    dx = elems[0].shape[-1]
    combine = _smoother_combine
    if chunk is None:
        return lax.associative_scan(
            lambda a, b: combine(b, a), elems, reverse=True)
    ident = _smoother_identity(dx, elems[0].dtype)
    return chunked_associative_scan(
        lambda a, b: combine(b, a), elems, ident, chunk=chunk,
        reverse=True)


def _smoother_elements(fm, fP, pm, pP, F):
    """Per-step RTS elements ``(G, g, L)`` for t < T-1, batched over the
    time axis: the smoothing gain ``G_t = P^f_t F_tᵀ (P^p_t)⁻¹``,
    ``g_t = m^f_t − G_t m^p_t`` and ``L_t = P^f_t − G_t P^p_t G_tᵀ``.
    ``F`` is (T, dx, dx) (broadcast a shared transition before calling)."""
    G = vmap(lambda Pf, Pp, Ft: psd_solve(Pp, Ft @ Pf).T)(fP, pP, F)
    g = fm - jnp.einsum("tij,tj->ti", G, pm)
    L = symmetrize(fP - jnp.einsum("tij,tjk,tlk->til", G, pP, G))
    return G, g, L


def _smoother_combine(elem_earlier, elem_later):
    """Associative combination of RTS smoothing elements
    (Särkkä & G-F, Lemma 10): pure matmuls — no solves, so every combine
    stage is batched across the time axis.

    ``x_t | x_s ~ N(E x_s + g, L)`` composed over earlier ∘ later."""
    E1, g1, L1 = elem_earlier
    E2, g2, L2 = elem_later
    E = E1 @ E2
    g = jnp.einsum("...ij,...j->...i", E1, g2) + g1
    L = symmetrize(E1 @ L2 @ jnp.swapaxes(E1, -1, -2) + L1)
    return E, g, L


@with_matmul_precision
def parallel_kalman_smoother(params: ParamsLGSSM, emissions: jax.Array,
                             solver: str = "woodbury",
                             chunk="auto") -> PosteriorKalman:
    """Temporally-parallel RTS smoother (Särkkä & García-Fernández 2021,
    §IV).

    Forward pass = :func:`parallel_kalman_filter`; backward
    pass phrases the RTS recursion as affine elements
    ``x_t | x_{t+1} ~ N(E_t x_{t+1} + g_t, L_t)`` with ``E_t`` the classic
    smoothing gain, combined by a REVERSE scan over the same chunked /
    flat schedule (the smoothing combine is solve-free). Matches
    :func:`bayesianfiltering_tpu.ops.linear.kalman_smoother` exactly
    (tested to 1e-4 at T=200).
    """
    post = parallel_kalman_filter(params, emissions, solver, chunk)
    F = params.dynamics_matrix
    c, _ = _biases(params)
    fm, fP = post.filtered_means, post.filtered_covariances
    pm, pP = post.predicted_means, post.predicted_covariances

    # Elements for t < T-1: G_t = P^f_t Fᵀ (P^p_{t+1|t})⁻¹,
    # g_t = m^f_t − G_t m^p_{t+1|t}, L_t = P^f_t − G_t P^p G_tᵀ.
    G, g, L = _smoother_elements(
        fm[:-1], fP[:-1], pm[:-1], pP[:-1],
        jnp.broadcast_to(F, (len(fm) - 1,) + F.shape))
    # Last element: the smoothed marginal at T-1 IS the filtered one.
    E_last = jnp.zeros_like(fP[:1])
    elems = (
        jnp.concatenate([G, E_last], axis=0),
        jnp.concatenate([g, fm[-1:]], axis=0),
        jnp.concatenate([L, fP[-1:]], axis=0),
    )
    _, sm, sP = _run_smoother_scan(elems,
                                   _resolve_chunk(chunk, len(emissions)))
    return post._replace(smoothed_means=sm, smoothed_covariances=sP)


# ---------------------------------------------------------------------------
# Time-varying (per-step affine) variants — the substrate for the parallel
# ITERATED nonlinear smoothers (ops/parallel_iterated.py): each iteration
# linearizes the nonlinear model into a per-timestep affine LGSSM
# x_t = F_t x_{t-1} + c_t + q_t, y_t = H_t x_t + d_t + r_t and runs these.
# ---------------------------------------------------------------------------


def _first_element_tv(m0, P0, H0, d0, R0, y0):
    """t=0 element: condition the prior on y_0 (same convention as
    :func:`_first_element`, per-step emission model)."""
    dx = m0.shape[-1]
    S = symmetrize(H0 @ P0 @ H0.T + R0)
    K = psd_solve(S, H0 @ P0).T
    A = jnp.zeros((dx, dx))
    b = m0 + K @ (y0 - H0 @ m0 - d0)
    C = symmetrize(P0 - K @ S @ K.T)
    return A, b, C, jnp.zeros((dx, dx)), jnp.zeros((dx,))


def _generic_element_tv(F, c, Q, H, d, R, y):
    """t>=1 element: predict through (F, c, Q) then update with (H, d, R)."""
    dx = F.shape[-1]
    S = symmetrize(H @ Q @ H.T + R)
    K = psd_solve(S, H @ Q).T
    resid = y - d - H @ c
    A = (jnp.eye(dx) - K @ H) @ F
    b = c + K @ resid
    C = symmetrize((jnp.eye(dx) - K @ H) @ Q)
    HF = H @ F
    J = symmetrize(HF.T @ psd_solve(S, HF))
    eta = HF.T @ psd_solve(S, resid)
    return A, b, C, J, eta


@with_matmul_precision
def parallel_kalman_filter_tv(m0, P0, Fs, cs, Qs, Hs, ds, Rs, emissions,
                              solver: str = "woodbury",
                              chunk="auto") -> PosteriorKalman:
    """Log-depth Kalman filter for a TIME-VARYING affine LGSSM.

    Stacks are length T along axis 0. Index ``t`` of ``Fs``/``cs``/``Qs``
    is the transition INTO step t (``Fs[0]`` is unused — step 0 conditions
    the prior directly); ``Hs``/``ds``/``Rs[t]`` is the emission model at
    t. ``predicted_*[t]`` is the one-step prediction of t+1 given 0..t
    (the final step reuses ``Fs[T-1]``, matching the time-invariant
    variant's convention).
    """
    first = _first_element_tv(m0, P0, Hs[0], ds[0], Rs[0], emissions[0])
    rest = vmap(_generic_element_tv)(Fs[1:], cs[1:], Qs[1:], Hs[1:], ds[1:],
                                     Rs[1:], emissions[1:])
    elems = tuple(
        jnp.concatenate([f[None], r], axis=0) for f, r in zip(first, rest)
    )
    _, b_all, C_all, _, _ = _run_filter_scan(
        elems, solver, _resolve_chunk(chunk, len(emissions)))
    fm, fP = b_all, C_all

    Fn = jnp.concatenate([Fs[1:], Fs[-1:]], axis=0)      # F_{t+1}, clamped
    cn = jnp.concatenate([cs[1:], cs[-1:]], axis=0)
    Qn = jnp.concatenate([Qs[1:], Qs[-1:]], axis=0)
    pm = jnp.einsum("tij,tj->ti", Fn, fm) + cn
    pP = symmetrize(jnp.einsum("tik,tkl,tjl->tij", Fn, fP, Fn) + Qn)

    ll = _marginal_loglik_tv(m0, P0, Fs, cs, Qs, Hs, ds, Rs, emissions,
                             fm, fP)
    return PosteriorKalman(ll, fm, fP, pm, pP)


@with_matmul_precision
def parallel_kalman_smoother_tv(m0, P0, Fs, cs, Qs, Hs, ds, Rs, emissions,
                                solver: str = "woodbury",
                                chunk="auto") -> PosteriorKalman:
    """Temporally-parallel RTS smoother for a time-varying affine LGSSM
    (same stack conventions as :func:`parallel_kalman_filter_tv`)."""
    post = parallel_kalman_filter_tv(m0, P0, Fs, cs, Qs, Hs, ds, Rs,
                                     emissions, solver, chunk)
    fm, fP = post.filtered_means, post.filtered_covariances
    pm, pP = post.predicted_means, post.predicted_covariances

    # G_t = P^f_t F_{t+1}ᵀ (P^p_{t+1|t})⁻¹ — per-step transition F_{t+1}.
    G, g, L = _smoother_elements(fm[:-1], fP[:-1], pm[:-1], pP[:-1], Fs[1:])
    elems = (
        jnp.concatenate([G, jnp.zeros_like(fP[:1])], axis=0),
        jnp.concatenate([g, fm[-1:]], axis=0),
        jnp.concatenate([L, fP[-1:]], axis=0),
    )
    _, sm, sP = _run_smoother_scan(elems,
                                   _resolve_chunk(chunk, len(emissions)))
    return post._replace(smoothed_means=sm, smoothed_covariances=sP)


def _marginal_loglik_tv(m0, P0, Fs, cs, Qs, Hs, ds, Rs, emissions,
                        filtered_means, filtered_covs):
    from bayesianfiltering_tpu.distributions import mvn_logpdf

    pm_prev = jnp.concatenate(
        [m0[None],
         jnp.einsum("tij,tj->ti", Fs[1:], filtered_means[:-1]) + cs[1:]],
        axis=0)
    pP_prev = jnp.concatenate(
        [P0[None],
         symmetrize(jnp.einsum("tik,tkl,tjl->tij", Fs[1:],
                               filtered_covs[:-1], Fs[1:]) + Qs[1:])],
        axis=0)
    yhat = jnp.einsum("tij,tj->ti", Hs, pm_prev) + ds
    S = symmetrize(jnp.einsum("tik,tkl,tjl->tij", Hs, pP_prev, Hs) + Rs)
    return jnp.sum(mvn_logpdf(emissions, yhat, S))


def _marginal_loglik(params, emissions, predicted_means, predicted_covs):
    """Innovation-form marginal log-likelihood.

    ``predicted_means[t]``/``predicted_covs[t]`` is the one-step-ahead
    prediction of step t+1 (length T-1 suffices — the caller passes
    ``predicted_*[:-1]``); the t=0 term uses the prior."""
    H, R = params.emission_matrix, params.emission_covariance
    _, d = _biases(params)
    from bayesianfiltering_tpu.distributions import mvn_logpdf

    pm_prev = jnp.concatenate(
        [params.initial_mean[None], predicted_means], axis=0)
    pP_prev = jnp.concatenate(
        [params.initial_covariance[None], predicted_covs], axis=0)
    yhat = jnp.einsum("ij,tj->ti", H, pm_prev) + d
    S = symmetrize(jnp.einsum("ik,tkl,jl->tij", H, pP_prev, H) + R)
    return jnp.sum(mvn_logpdf(emissions, yhat, S))


__all__ = [
    "chunked_associative_scan",
    "parallel_kalman_filter",
    "parallel_kalman_smoother",
    "parallel_kalman_filter_tv",
    "parallel_kalman_smoother_tv",
]
