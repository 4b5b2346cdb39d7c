"""Mixture-bank EKF update and predict covariance, one Triton kernel each.

The GSF/AGSF scan step conditions a bank of M small Gaussians on one
emission (ref: gaussfiltax/inference.py:72-105, vmapped over components)
and propagates their covariances. The plain XLA form of that step is a
chain of small batched contractions plus a Cholesky and a triangular
inverse on ``(M, d, d)`` arrays: several kernel launches and round trips
through device memory per scan step, at a fixed M, T times in sequence.

Here each half is ONE Pallas kernel on the Triton route. A program owns a
power-of-two block of components (one component per thread). It reads each
component's matrices straight from the natural ``(M, d, e)`` layout, with
the tail block masked, so there is no transpose and no padding; it keeps the
whole ``d×d`` lattice in registers (every scalar of every matrix is a
block-wide vector, fully unrolled at trace time — d is tiny and static);
and it writes the results. Nothing is carried from one program to another.

    update:   S = Rt + H P Hᵀ  (+ relative diagonal floor)
              L = chol(S), L⁻¹ by forward substitution
              K = (S⁻¹ H P)ᵀ
              Σ = (I − K H) P (I − K H)ᵀ + K Rt Kᵀ      (Joseph form)
              μ = m + K innov,  ll = log N(innov | 0, S)
    predict:  Σ⁺ = F_x P F_xᵀ + F_q Q F_qᵀ

Numerics match :func:`bayesianfiltering_tpu.ops.ekf.chol_update_precomputed`
(same relative floor, Joseph form, shared-factor log-likelihood) in plain
float32 FMA arithmetic — no tensor cores, so no TF32. The kernels are
forward-only: a ``jax.custom_vjp`` differentiates through the XLA
reference. Model-specific pieces (Jacobians, ŷ = h(m)) stay outside in XLA.

Which implementation runs is decided in one place, :func:`bank_impl`, from
the backend and the shapes.
"""
from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from bayesianfiltering_tpu.ops.ekf import (
    _REL_JITTER,
    EKFUpdate,
    _degenerate_update,
    _residual,
    _static_num_iter,
    chol_update_precomputed,
)
from bayesianfiltering_tpu.utils.linalg import symmetrize

_LOG_2PI = math.log(2.0 * math.pi)
# Components per program: one per thread at four warps.
_BLOCK = 128
_NUM_WARPS = 4
# Largest state / emission / noise width the kernels take. The unrolled
# lattice lives in registers and Triton compiles it as one straight-line
# block: at dx = dy = 8 (~4k FMAs per component) the compile did not finish
# in 18 minutes on an H100, while dx = dy = 1 compiles in 0.2 s.
MAX_DIM = 4


def _target_platform() -> str:
    """The platform being traced for: ``jax.default_device`` when a caller
    set one (e.g. a CPU reference run next to a GPU), else the default
    backend."""
    dev = jax.config.jax_default_device
    if dev is None:
        return jax.default_backend()
    return dev if isinstance(dev, str) else dev.platform


def bank_impl(*dims, dtype, jitter=0.0) -> str:
    """The implementation the bank primitives run: ``"triton"`` on a GPU for
    float32 banks whose widths are all ≤ :data:`MAX_DIM` (with a static
    jitter, which the kernel bakes in), ``"xla"`` otherwise.

    A shape the kernel claims is never sent elsewhere on the card, and a
    kernel that fails to lower raises."""
    if (_target_platform() in ("gpu", "cuda")
            and jnp.dtype(dtype) == jnp.float32
            and all(d <= MAX_DIM for d in dims)
            and isinstance(jitter, (int, float))):
        return "triton"
    return "xla"


# ---------------------------------------------------------------------------
# Kernel plumbing: masked block loads/stores of one scalar entry per component
# ---------------------------------------------------------------------------

def _block(num):
    start = pl.program_id(0) * _BLOCK
    rows = pl.ds(start, _BLOCK)
    mask = start + jnp.arange(_BLOCK) < num
    return rows, mask


def _load_mat(ref, rows, mask, r, c, diag_other=0.0):
    """``{(i, j): ref[rows, i, j]}`` — dead tail lanes read ``diag_other`` on
    the diagonal (an identity keeps their factorization finite) and 0 off
    it."""
    return {
        (i, j): plgpu.load(ref.at[rows, i, j], mask=mask,
                           other=diag_other if i == j else 0.0)
        for i in range(r) for j in range(c)
    }


def _load_vec(ref, rows, mask, r):
    return {i: plgpu.load(ref.at[rows, i], mask=mask, other=0.0)
            for i in range(r)}


def _dot(terms):
    acc = None
    for a, b in terms:
        acc = a * b if acc is None else acc + a * b
    return acc


def _store_sym(ref, rows, mask, lattice, n):
    for i in range(n):
        for j in range(n):
            v = lattice[(min(i, j), max(i, j))]
            plgpu.store(ref.at[rows, i, j], v, mask=mask)


# ---------------------------------------------------------------------------
# Update kernel
# ---------------------------------------------------------------------------

def _update_kernel(m_ref, p_ref, hx_ref, rt_ref, inn_ref,
                   ll_ref, mean_ref, cov_ref, k_ref, *, dx, dy, jitter, num):
    rows, mask = _block(num)
    P = _load_mat(p_ref, rows, mask, dx, dx)
    H = _load_mat(hx_ref, rows, mask, dy, dx)
    Rt = _load_mat(rt_ref, rows, mask, dy, dy, diag_other=1.0)
    inn = _load_vec(inn_ref, rows, mask, dy)

    hp = {(i, k): _dot((H[(i, j)], P[(j, k)]) for j in range(dx))
          for i in range(dy) for k in range(dx)}                  # H P
    S = {}
    for i in range(dy):
        for j in range(i, dy):
            S[(i, j)] = 0.5 * (Rt[(i, j)] + Rt[(j, i)]) + _dot(
                (hp[(i, k)], H[(j, k)]) for k in range(dx))
            S[(j, i)] = S[(i, j)]
    maxd = jnp.abs(S[(0, 0)])
    for i in range(1, dy):
        maxd = jnp.maximum(maxd, jnp.abs(S[(i, i)]))
    floor = jitter + _REL_JITTER * maxd
    for i in range(dy):
        S[(i, i)] = S[(i, i)] + floor

    # Cholesky–Crout, with the log-determinant on the way
    L, logdet = {}, None
    for j in range(dy):
        d = S[(j, j)]
        for k in range(j):
            d = d - L[(j, k)] * L[(j, k)]
        d = jnp.sqrt(d)
        L[(j, j)] = d
        logdet = jnp.log(d) if logdet is None else logdet + jnp.log(d)
        inv_d = 1.0 / d
        for i in range(j + 1, dy):
            s = S[(i, j)]
            for k in range(j):
                s = s - L[(i, k)] * L[(j, k)]
            L[(i, j)] = s * inv_d
    # L⁻¹ by forward substitution
    Li = {}
    for j in range(dy):
        Li[(j, j)] = 1.0 / L[(j, j)]
        for i in range(j + 1, dy):
            Li[(i, j)] = -_dot((L[(i, k)], Li[(k, j)])
                               for k in range(j, i)) / L[(i, i)]
    # Z = L⁻¹ H P;  K = (L⁻ᵀ Z)ᵀ = (S⁻¹ H P)ᵀ,  (dx, dy)
    Z = {(i, k): _dot((Li[(i, j)], hp[(j, k)]) for j in range(i + 1))
         for i in range(dy) for k in range(dx)}
    K = {(k, i): _dot((Li[(j, i)], Z[(j, k)]) for j in range(i, dy))
         for i in range(dy) for k in range(dx)}
    for k in range(dx):
        for i in range(dy):
            plgpu.store(k_ref.at[rows, k, i], K[(k, i)], mask=mask)

    # Joseph form: A = I − K H;  Σ = A P Aᵀ + (K Rt) Kᵀ
    A = {}
    for i in range(dx):
        for j in range(dx):
            kh = _dot((K[(i, l)], H[(l, j)]) for l in range(dy))
            A[(i, j)] = 1.0 - kh if i == j else -kh
    AP = {(i, j): _dot((A[(i, k)], P[(k, j)]) for k in range(dx))
          for i in range(dx) for j in range(dx)}
    KR = {(i, b): _dot((K[(i, a)], Rt[(a, b)]) for a in range(dy))
          for i in range(dx) for b in range(dy)}
    cov = {(i, j): _dot([(AP[(i, k)], A[(j, k)]) for k in range(dx)]
                        + [(KR[(i, b)], K[(j, b)]) for b in range(dy)])
           for i in range(dx) for j in range(i, dx)}
    _store_sym(cov_ref, rows, mask, cov, dx)

    m = _load_vec(m_ref, rows, mask, dx)
    for i in range(dx):
        mu = m[i] + _dot((K[(i, l)], inn[l]) for l in range(dy))
        plgpu.store(mean_ref.at[rows, i], mu, mask=mask)
    zsq = None
    for i in range(dy):
        z = _dot((Li[(i, j)], inn[j]) for j in range(i + 1))
        zsq = z * z if zsq is None else zsq + z * z
    plgpu.store(ll_ref.at[rows], -0.5 * (dy * _LOG_2PI + 2.0 * logdet + zsq),
                mask=mask)


def _update_pallas(m, P, Hx, Rt, innov, jitter: float, interpret=False):
    M, dx = m.shape
    dy = innov.shape[-1]
    dt = m.dtype
    return tuple(pl.pallas_call(
        functools.partial(_update_kernel, dx=dx, dy=dy, jitter=float(jitter),
                          num=M),
        out_shape=[
            jax.ShapeDtypeStruct((M,), dt),
            jax.ShapeDtypeStruct((M, dx), dt),
            jax.ShapeDtypeStruct((M, dx, dx), dt),
            jax.ShapeDtypeStruct((M, dx, dy), dt),
        ],
        grid=(pl.cdiv(M, _BLOCK),),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=_NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="bank_ekf_update",
    )(m, P, Hx, Rt, innov))


def _update_xla(m, P, Hx, Rt, innov, jitter):
    # The one shared update implementation (ops/ekf.py): the kernel is
    # validated against it and the VJP re-runs it.
    return jax.vmap(chol_update_precomputed, in_axes=(0, 0, 0, 0, 0, None))(
        m, P, Hx, Rt, innov, jitter)


@functools.partial(jax.custom_vjp, nondiff_argnums=(5, 6))
def _bank_chol_update(m, P, Hx, Rt, innov, jitter, impl):
    if impl == "xla":
        return _update_xla(m, P, Hx, Rt, innov, jitter)
    return _update_pallas(m, P, Hx, Rt, innov, jitter,
                          interpret=impl == "interpret")


def _update_fwd(m, P, Hx, Rt, innov, jitter, impl):
    return (_bank_chol_update(m, P, Hx, Rt, innov, jitter, impl),
            (m, P, Hx, Rt, innov))


def _update_bwd(jitter, impl, res, cts):
    _, vjp = jax.vjp(lambda *a: _update_xla(*a, jitter), *res)
    return vjp(cts)


_bank_chol_update.defvjp(_update_fwd, _update_bwd)


def bank_chol_update(m, P, Hx, Rt, innov, jitter=0.0):
    """EKF measurement update over a bank of M Gaussians.

    Args:
      m:     (M, dx) prior means.
      P:     (M, dx, dx) prior covariances.
      Hx:    (M, dy, dx) emission Jacobians at the linearization points.
      Rt:    (M, dy, dy) effective emission noise H_r R H_rᵀ.
      innov: (M, dy) innovations ``y − ŷ`` (ŷ already includes any IEKF
             relinearization correction).
      jitter: absolute diagonal jitter added on top of the relative floor.

    Returns ``(ll, mean, cov, gain)`` with shapes
    ``(M,), (M, dx), (M, dx, dx), (M, dx, dy)`` — the semantics of vmapping
    :func:`bayesianfiltering_tpu.ops.ekf.chol_update_precomputed`.
    """
    impl = bank_impl(m.shape[-1], innov.shape[-1], dtype=m.dtype,
                     jitter=jitter)
    if impl == "xla":
        # natively differentiable, and takes a traced jitter
        return _update_xla(m, P, Hx, Rt, innov, jitter)
    return _bank_chol_update(m, P, Hx, Rt, innov, float(jitter), impl)


# ---------------------------------------------------------------------------
# Predict covariance kernel: Σ⁺ = F_x P F_xᵀ + F_q Q F_qᵀ
# ---------------------------------------------------------------------------

def _predict_kernel(fx_ref, p_ref, fq_ref, q_ref, cov_ref, *, dx, dq, num):
    rows, mask = _block(num)
    Fx = _load_mat(fx_ref, rows, mask, dx, dx)
    P = _load_mat(p_ref, rows, mask, dx, dx)
    Fq = _load_mat(fq_ref, rows, mask, dx, dq)
    Q = {(i, j): plgpu.load(q_ref.at[i, j])
         for i in range(dq) for j in range(dq)}
    FP = {(i, j): _dot((Fx[(i, k)], P[(k, j)]) for k in range(dx))
          for i in range(dx) for j in range(dx)}
    FQ = {(i, j): _dot((Fq[(i, k)], Q[(k, j)]) for k in range(dq))
          for i in range(dx) for j in range(dq)}
    cov = {(i, j): _dot([(FP[(i, k)], Fx[(j, k)]) for k in range(dx)]
                        + [(FQ[(i, k)], Fq[(j, k)]) for k in range(dq)])
           for i in range(dx) for j in range(i, dx)}
    _store_sym(cov_ref, rows, mask, cov, dx)


def _predict_pallas(Fx, P, Fq, Q, interpret=False):
    M, dx = Fx.shape[0], Fx.shape[-1]
    dq = Fq.shape[-1]
    return pl.pallas_call(
        functools.partial(_predict_kernel, dx=dx, dq=dq, num=M),
        out_shape=jax.ShapeDtypeStruct((M, dx, dx), P.dtype),
        grid=(pl.cdiv(M, _BLOCK),),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=_NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="bank_ekf_predict_cov",
    )(Fx, P, Fq, Q)


def _predict_xla(Fx, P, Fq, Q):
    return symmetrize(jnp.einsum("mik,mkl,mjl->mij", Fx, P, Fx)
                      + jnp.einsum("mik,kl,mjl->mij", Fq, Q, Fq))


@functools.partial(jax.custom_vjp, nondiff_argnums=(4,))
def _bank_predict_cov(Fx, P, Fq, Q, impl):
    if impl == "xla":
        return _predict_xla(Fx, P, Fq, Q)
    return _predict_pallas(Fx, P, Fq, Q, interpret=impl == "interpret")


def _predict_fwd(Fx, P, Fq, Q, impl):
    return _bank_predict_cov(Fx, P, Fq, Q, impl), (Fx, P, Fq, Q)


def _predict_bwd(impl, res, ct):
    _, vjp = jax.vjp(_predict_xla, *res)
    return vjp(ct)


_bank_predict_cov.defvjp(_predict_fwd, _predict_bwd)


def bank_predict_cov(Fx, P, Fq, Q):
    """Σ⁺[m] = F_x[m] P[m] F_x[m]ᵀ + F_q[m] Q F_q[m]ᵀ for a bank of M
    components; ``Q`` is the shared (dq, dq) dynamics noise covariance."""
    impl = bank_impl(Fx.shape[-1], Fq.shape[-1], dtype=P.dtype)
    if impl == "xla":
        return _predict_xla(Fx, P, Fq, Q)
    return _bank_predict_cov(Fx, P, Fq, Q, impl)


# ---------------------------------------------------------------------------
# Bank-level EKF primitives, signature-parallel to vmapping ops/ekf.py
# ---------------------------------------------------------------------------

def bank_ekf_predict(ms, Ps, f, F_x, F_q, Q, q0, u):
    """Bank EKF predict: ``vmap(ekf_predict)`` with the covariance
    propagation in one kernel. Returns ``(mu_pred, Sigma_pred, Fx)``.

    The Jacobians are evaluated as separate vmapped passes on purpose: a
    combined linearization (jax.linearize over concat(x, q)) defeats XLA's
    loop-invariant hoisting of constant Jacobians (e.g. linear dynamics).
    """
    Fx = jax.vmap(lambda m: F_x(m, q0, u))(ms)
    Fq = jax.vmap(lambda m: F_q(m, q0, u))(ms)
    mu = jax.vmap(lambda m: f(m, q0, u))(ms)
    return mu, bank_predict_cov(Fx, Ps, Fq, Q), Fx


def bank_ekf_condition_on_iterated(
    ms, Ps, h, H_x, H_r, R, r0, u, y, num_iter=1, jitter=0.0,
    residual_fn=None,
):
    """Bank (iterated) EKF measurement update: ``vmap(ekf_condition_on_
    iterated)`` with the linear algebra in one kernel per iteration.
    Returns an :class:`~bayesianfiltering_tpu.ops.ekf.EKFUpdate` of banked
    arrays."""
    y = jnp.atleast_1d(y)
    num_iter = _static_num_iter(num_iter)
    if num_iter <= 0:
        return jax.vmap(lambda m1, P1: _degenerate_update(m1, P1, y))(ms, Ps)
    vH = jax.vmap(lambda lp: H_x(lp, r0, u))
    vHr = jax.vmap(lambda lp: H_r(lp, r0, u))
    vh = jax.vmap(lambda lp: jnp.atleast_1d(h(lp, r0, u)))
    lin = ms
    out = None
    for it in range(num_iter):
        Hx = jnp.reshape(vH(lin), (ms.shape[0], -1, ms.shape[-1]))
        Hr = jnp.reshape(vHr(lin), (ms.shape[0], Hx.shape[1], -1))
        yh = vh(lin)
        # IEKF innovation correction (ops/ekf.py:ekf_condition_on_iterated);
        # zero at the first iteration where lin == ms.
        yhat = yh if it == 0 else yh + jnp.einsum("mij,mj->mi", Hx, ms - lin)
        Rt = jnp.einsum("mij,jk,mlk->mil", Hr, R, Hr)
        innov = _residual(y[None, :], yhat, residual_fn)
        ll, mean, cov, K = bank_chol_update(ms, Ps, Hx, Rt, innov, jitter)
        lin = mean
        out = EKFUpdate(ll, mean, cov, Hx, K)
    return out


__all__ = [
    "MAX_DIM",
    "bank_impl",
    "bank_chol_update",
    "bank_predict_cov",
    "bank_ekf_predict",
    "bank_ekf_condition_on_iterated",
]
