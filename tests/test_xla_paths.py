"""The plain XLA paths every backend runs: the associative filtering and
smoothing combines, the single-stream EKF/UKF steps, the counts→parents
expansion of the O(N) resamplers, and gradients through each wrapper.

Oracles are independent: the sequential Kalman filter / RTS smoother, and
float64 NumPy/SciPy implementations of the step formulas written here.
"""
import math

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import scipy.linalg

from bayesianfiltering_tpu.models import zoo
from bayesianfiltering_tpu.ops import associative as A
from bayesianfiltering_tpu.ops import ekf as _ekf
from bayesianfiltering_tpu.ops import ukf as _ukf
from bayesianfiltering_tpu.ops.linear import kalman_filter, kalman_smoother
from bayesianfiltering_tpu.utils import resampling as rs

_LOG_2PI = math.log(2.0 * math.pi)


# ---------------------------------------------------------------------------
# Associative combine and smoother
# ---------------------------------------------------------------------------

def _lgssm(dx, T=300, seed=0):
    dy = max(1, dx // 2)
    lg = zoo.linear_gaussian_lgssm(dx, dy)
    model, params, _ = zoo.linear_gaussian(dx, dy)
    _, emissions = model.sample(params, jr.PRNGKey(seed), T)
    return lg, emissions


def _elements(key, m, dx, dy=2):
    ks = jr.split(key, 5)
    Am = jr.normal(ks[0], (m, dx, dx)) * 0.5
    b = jr.normal(ks[1], (m, dx))
    cr = jr.normal(ks[2], (m, dx, dx)) * 0.3
    C = cr @ jnp.swapaxes(cr, -1, -2) + 0.01 * jnp.eye(dx)
    jr_ = jr.normal(ks[3], (m, dx, dy)) * 0.4
    J = jr_ @ jnp.swapaxes(jr_, -1, -2)       # rank dy < dx
    eta = jr.normal(ks[4], (m, dx))
    return Am, b, C, J, eta


class TestAssociativeCombine:
    @pytest.mark.parametrize("dx", [2, 4, 8])
    def test_filter_matches_sequential_kf(self, dx):
        lg, emissions = _lgssm(dx, seed=dx)
        seq = kalman_filter(lg, emissions)
        par = A.parallel_kalman_filter(lg, emissions, chunk=64)
        np.testing.assert_allclose(par.filtered_means, seq.filtered_means,
                                   rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(par.filtered_covariances,
                                   seq.filtered_covariances,
                                   rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(par.marginal_loglik, seq.marginal_loglik,
                                   rtol=1e-4)

    @pytest.mark.parametrize("dx", [2, 4, 8])
    def test_smoother_matches_sequential_rts(self, dx):
        lg, emissions = _lgssm(dx, seed=10 + dx)
        seq = kalman_smoother(lg, emissions)
        par = A.parallel_kalman_smoother(lg, emissions, chunk=64)
        np.testing.assert_allclose(par.smoothed_means, seq.smoothed_means,
                                   rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(par.smoothed_covariances,
                                   seq.smoothed_covariances,
                                   rtol=1e-3, atol=1e-4)

    def test_indefinite_c_lane_is_guarded(self):
        """A combined C can be rank-deficient AND slightly indefinite from
        f32 rounding (eigenvalue ≈ −1e-8, below the trace-relative jitter).
        cholesky_guarded zeroes that lane's factor (M⁻¹ → I) instead of
        NaN-ing the scan; the other lanes are untouched."""
        dx, m = 4, 16
        left = _elements(jr.PRNGKey(3), m, dx)
        right = _elements(jr.PRNGKey(4), m, dx)
        q, _ = jnp.linalg.qr(jr.normal(jr.PRNGKey(5), (dx, dx)))
        C_bad = (q * jnp.array([1e-2, 1e-2, -1e-8, 0.0])) @ q.T
        bad_left = (left[0], left[1], left[2].at[0].set(C_bad), left[3],
                    left[4])
        out = A._combine(bad_left, right)
        ref = A._combine(left, right)
        for name, o, r in zip("A b C J eta".split(), out, ref):
            assert np.isfinite(np.asarray(o)).all(), name
            np.testing.assert_allclose(o[1:], r[1:], rtol=1e-5, atol=1e-6,
                                       err_msg=name)

    def test_filter_combine_broadcasts_batch_dims(self):
        """The chunked scan's step 4: left (1, G, ...) against right
        (C, G, ...) equals the per-element combine."""
        G, Cn, dx = 6, 4, 3
        left = tuple(x[None] for x in _elements(jr.PRNGKey(3), G, dx))
        right = tuple(x.reshape((Cn, G) + x.shape[1:])
                      for x in _elements(jr.PRNGKey(4), Cn * G, dx))
        out = A._combine(left, right)
        for c in range(Cn):
            ref = A._combine(tuple(x[0] for x in left),
                             tuple(x[c] for x in right))
            for o, r in zip(out, ref):
                np.testing.assert_allclose(o[c], r, rtol=2e-5, atol=2e-5)

    def test_smoother_combine_broadcasts_batch_dims(self):
        G, Cn, dx = 5, 4, 3

        def mk(key, lead):
            m = int(np.prod(lead))
            E = jr.normal(jr.fold_in(key, 0), (m, dx, dx)) * 0.5
            g = jr.normal(jr.fold_in(key, 1), (m, dx))
            a = jr.normal(jr.fold_in(key, 2), (m, dx, dx))
            Lc = a @ jnp.swapaxes(a, -1, -2) + jnp.eye(dx)
            return tuple(x.reshape(lead + x.shape[1:]) for x in (E, g, Lc))

        e1 = mk(jr.PRNGKey(1), (1, G))
        e2 = mk(jr.PRNGKey(2), (Cn, G))
        out = A._smoother_combine(e1, e2)
        for c in range(Cn):
            ref = A._smoother_combine(tuple(x[0] for x in e1),
                                      tuple(x[c] for x in e2))
            for o, r in zip(out, ref):
                np.testing.assert_allclose(o[c], r, rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# Single-stream EKF / UKF steps against float64 oracles
# ---------------------------------------------------------------------------

def _psd(key, n, scale=1.0):
    a = jr.normal(key, (n, n))
    return a @ a.T / n + scale * jnp.eye(n)


def _np_update(m, P, H, Rt, innov):
    """Kalman update in float64: returns (ll, mean, cov, gain)."""
    m, P, H, Rt, innov = (np.asarray(x, np.float64)
                          for x in (m, P, H, Rt, innov))
    S = H @ P @ H.T + Rt
    K = np.linalg.solve(S, H @ P).T
    cov = P - K @ S @ K.T
    Lc = np.linalg.cholesky(S)
    z = scipy.linalg.solve_triangular(Lc, innov, lower=True)
    ll = -0.5 * (len(innov) * _LOG_2PI + 2 * np.log(np.diag(Lc)).sum()
                 + z @ z)
    return ll, m + K @ innov, cov, K


class TestSingleStreamEKF:
    def test_update_matches_float64(self):
        dx, dy = 16, 8
        k = jr.split(jr.PRNGKey(21), 5)
        m = jr.normal(k[0], (dx,))
        P = _psd(k[1], dx, 0.5)
        Hx = jr.normal(k[2], (dy, dx))
        Rt = _psd(k[3], dy, 0.05) * 0.1
        innov = jr.normal(k[4], (dy,))
        out = _ekf.chol_update_precomputed(m, P, Hx, Rt, innov)
        for o, r in zip(out, _np_update(m, P, Hx, Rt, innov)):
            np.testing.assert_allclose(o, r, rtol=2e-3, atol=2e-3)

    def test_predict_matches_float64(self):
        dx, dq = 16, 8
        k = jr.split(jr.PRNGKey(22), 4)
        Fx = jr.normal(k[0], (dx, dx)) / 4
        Fq = jr.normal(k[1], (dx, dq))
        P, Q = _psd(k[2], dx), _psd(k[3], dq)
        f = lambda x, q, u: Fx @ x + Fq @ q
        m = jnp.ones(dx)
        mu, Sig, _ = _ekf.ekf_predict(m, P, f, jax.jacfwd(f, 0),
                                      jax.jacfwd(f, 1), Q, jnp.zeros(dq), 0.)
        F64 = [np.asarray(x, np.float64) for x in (Fx, Fq, P, Q)]
        ref = F64[0] @ F64[2] @ F64[0].T + F64[1] @ F64[3] @ F64[1].T
        np.testing.assert_allclose(mu, F64[0] @ np.ones(dx), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(Sig, ref, rtol=1e-4, atol=1e-4)

    @pytest.mark.parametrize("chunk", [3, 4, 8])
    def test_chunked_equals_joint_for_diagonal_noise(self, chunk):
        """Sequential processing is exact when H_r R H_rᵀ is block-diagonal
        w.r.t. the chunks (here: diagonal)."""
        dx, dy = 6, 8
        k = jr.split(jr.PRNGKey(23), 3)
        m = jr.normal(k[0], (dx,))
        P = _psd(k[1], dx, 0.5)
        R = jnp.diag(jnp.linspace(0.1, 0.5, dy))
        W = jr.normal(k[2], (dy, dx))
        h = lambda x, r, u: jnp.tanh(W @ x) + r
        H_x, H_r = jax.jacfwd(h, 0), jax.jacfwd(h, 1)
        y = jnp.linspace(-0.5, 0.5, dy)
        joint = _ekf.ekf_condition_on_iterated(m, P, h, H_x, H_r, R,
                                               jnp.zeros(dy), 0., y)
        chunked = _ekf.ekf_condition_on_chunked(m, P, h, H_x, H_r, R,
                                                jnp.zeros(dy), 0., y, chunk)
        for name in ("log_likelihood", "mean", "cov"):
            np.testing.assert_allclose(getattr(chunked, name),
                                       getattr(joint, name),
                                       rtol=1e-4, atol=1e-5, err_msg=name)


def _np_sigma(m, P, lam, method):
    n = len(m)
    if method == "cholesky":
        Fm = np.linalg.cholesky(P)
    else:
        Fm = np.real(scipy.linalg.sqrtm(P))
    off = math.sqrt(n + lam) * Fm.T
    return np.concatenate([m + off, m - off])


def _np_moments(center, pts, lam, n, alpha, beta):
    w_side = 1.0 / (2 * (n + lam))
    w0m = lam / (n + lam)
    mu = w_side * pts.sum(0) + w0m * center
    cen = pts - mu
    d0 = center - mu
    cov = w_side * cen.T @ cen + (w0m + 1 - alpha**2 + beta) * np.outer(d0, d0)
    return mu, cov, cen, w_side


class TestSingleStreamUKF:
    """ops/ukf.py against a float64 NumPy unscented transform."""

    @staticmethod
    def _setup(dx=8, dy=5):
        k = jr.PRNGKey(7)
        P = np.asarray(_psd(k, dx), np.float64)
        m = np.asarray(jr.normal(jr.fold_in(k, 1), (dx,)), np.float64)
        R = np.asarray(_psd(jr.fold_in(k, 2), dy, 0.5), np.float64)
        Q = 0.3 * np.eye(dx)
        y = np.asarray(jr.normal(jr.fold_in(k, 3), (dy,)), np.float64)
        H = np.asarray(jr.normal(jr.fold_in(k, 4), (dy, dx)), np.float64)
        f = lambda x, q, u, xp=jnp: xp.tanh(x) + 0.9 * x + q
        h = lambda x, r, u, xp=jnp: xp.asarray(H) @ xp.sin(x) + r
        return m, P, Q, R, y, f, h

    @pytest.mark.parametrize("method", ["cholesky", "sqrtm"])
    @pytest.mark.parametrize("additive", [True, False])
    def test_predict_matches_float64(self, method, additive):
        m, P, Q, R, y, f, h = self._setup()
        up = _ukf.ParamsUKF(alpha=1.0, beta=2.0, kappa=0.0,
                            sqrt_method=method)
        dx = len(m)
        fn = _ukf.ukf_predict_additive if additive else \
            _ukf.ukf_predict_nonadditive
        mu, cov = fn(jnp.asarray(m, jnp.float32), jnp.asarray(P, jnp.float32),
                     f, None, jnp.asarray(Q, jnp.float32), up,
                     jnp.zeros(dx))
        if additive:
            lam = dx * (1.0 - 1.0)           # alpha²(n+κ) − n with α=1, κ=0
            pts = _np_sigma(m, P, lam, method)
            fp = np.stack([f(p, 0.0, None, np) for p in pts])
            rmu, rcov, _, _ = _np_moments(f(m, 0.0, None, np), fp, lam, dx,
                                          1.0, 2.0)
            rcov = rcov + Q
        else:
            na = 2 * dx
            lam = 0.0
            mA = np.concatenate([m, np.zeros(dx)])
            PA = scipy.linalg.block_diag(P, Q)
            pts = _np_sigma(mA, PA, lam, method)
            fp = np.stack([f(p[:dx], p[dx:], None, np) for p in pts])
            rmu, rcov, _, _ = _np_moments(f(m, np.zeros(dx), None, np), fp,
                                          lam, na, 1.0, 2.0)
        np.testing.assert_allclose(mu, rmu, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(cov, rcov, rtol=1e-3, atol=1e-3)

    @pytest.mark.parametrize("method", ["cholesky", "sqrtm"])
    @pytest.mark.parametrize("additive", [True, False])
    def test_update_matches_float64(self, method, additive):
        m, P, Q, R, y, f, h = self._setup()
        up = _ukf.ParamsUKF(alpha=1.0, beta=2.0, kappa=0.0,
                            sqrt_method=method)
        dx, dy = len(m), len(y)
        fn = _ukf.ukf_condition_on_additive if additive else \
            _ukf.ukf_condition_on_nonadditive
        f32 = lambda x: jnp.asarray(x, jnp.float32)
        ll, mean, cov = fn(f32(m), f32(P), h, f32(R), None, f32(y), up,
                           jnp.zeros(dy))
        if additive:
            lam, n = 0.0, dx
            pts = _np_sigma(m, P, lam, method)
            hp = np.stack([h(p, 0.0, None, np) for p in pts])
            mu_y, S, cen, w = _np_moments(h(m, 0.0, None, np), hp, lam, n,
                                          1.0, 2.0)
            S = S + R
            C = w * cen.T @ (pts - m)
        else:
            lam, n = 0.0, dx + dy
            mA = np.concatenate([m, np.zeros(dy)])
            pts = _np_sigma(mA, scipy.linalg.block_diag(P, R), lam, method)
            hp = np.stack([h(p[:dx], p[dx:], None, np) for p in pts])
            mu_y, S, cen, w = _np_moments(h(m, np.zeros(dy), None, np), hp,
                                          lam, n, 1.0, 2.0)
            C = w * cen.T @ (pts[:, :dx] - m)
        K = np.linalg.solve(S, C).T
        Lc = np.linalg.cholesky(S)
        z = scipy.linalg.solve_triangular(Lc, y - mu_y, lower=True)
        rll = -0.5 * (dy * _LOG_2PI + 2 * np.log(np.diag(Lc)).sum() + z @ z)
        np.testing.assert_allclose(ll, rll, rtol=1e-3, atol=1e-3)
        np.testing.assert_allclose(mean, m + K @ (y - mu_y), rtol=1e-3,
                                   atol=1e-3)
        np.testing.assert_allclose(cov, P - K @ S @ K.T, rtol=1e-3,
                                   atol=1e-3)


# ---------------------------------------------------------------------------
# counts → parents (the O(N) systematic / stratified resamplers)
# ---------------------------------------------------------------------------

def _np_parents(counts, n):
    """min(#{i : counts_i ≤ j}, n − 1) for every output slot j."""
    c = np.asarray(counts, np.int64)
    return np.minimum((c[None, :] <= np.arange(n)[:, None]).sum(1), n - 1)


def _profile(name, n):
    if name == "dirichlet":
        w = jr.dirichlet(jr.PRNGKey(0), jnp.ones(n) * 0.5)
        cdf = jnp.cumsum(w) / jnp.sum(w)
        return jax.lax.cummax(jnp.clip(jnp.ceil(n * cdf - 0.3), 0, n))
    if name == "concentration":          # all mass on the last particle
        return jnp.concatenate([jnp.zeros(n - 1), jnp.full((1,), float(n))])
    if name == "spread_skew":            # particle 0 owns 3/4, rest spread
        i = jnp.arange(n, dtype=jnp.float32)
        c = jnp.ceil(0.75 * n + (i / (n - 1)) * 0.25 * n)
        return jax.lax.cummax(jnp.clip(c, 0, n))
    if name == "unassigned_tail":        # f32 rounding leaves slot n−1 empty
        w = jr.dirichlet(jr.PRNGKey(9), jnp.ones(n))
        cdf = jnp.cumsum(w) / jnp.sum(w)
        c = jax.lax.cummax(jnp.clip(jnp.ceil(n * cdf - 0.5), 0, n))
        return jnp.minimum(c, float(n - 1))
    raise ValueError(name)


class TestCountsToParents:
    @pytest.mark.parametrize("profile,n", [
        ("dirichlet", 4096), ("dirichlet", 5000), ("concentration", 4096),
        ("spread_skew", 8192), ("unassigned_tail", 4096)])
    def test_matches_numpy_count(self, profile, n):
        counts = _profile(profile, n)
        out = jax.jit(rs._scatter_counts_to_parents,
                      static_argnums=1)(counts, n)
        np.testing.assert_array_equal(np.asarray(out),
                                      _np_parents(counts, n))
        assert int(out.min()) >= 0 and int(out.max()) <= n - 1

    def test_systematic_resample_sorted_and_in_range(self):
        w = jr.dirichlet(jr.PRNGKey(2), jnp.ones(512))
        idx = rs.systematic_resample(jr.PRNGKey(3), w, 512)
        assert idx.shape == (512,)
        assert int(idx.min()) >= 0 and int(idx.max()) < 512
        assert bool(jnp.all(jnp.diff(idx) >= 0))


# ---------------------------------------------------------------------------
# Gradients through each wrapper that stays
# ---------------------------------------------------------------------------

class TestGradients:
    def test_chunked_update(self):
        dx, dy = 4, 6
        m, P = jnp.ones(dx), _psd(jr.PRNGKey(1), dx)
        W = jr.normal(jr.PRNGKey(2), (dy, dx))
        h = lambda x, r, u: W @ x + r
        R = 0.2 * jnp.eye(dy)

        def loss(P):
            out = _ekf.ekf_condition_on_chunked(
                m, P, h, jax.jacfwd(h, 0), jax.jacfwd(h, 1), R,
                jnp.zeros(dy), 0., jnp.ones(dy), 2)
            return out.log_likelihood + jnp.sum(out.cov)

        assert bool(jnp.isfinite(jax.grad(loss)(P)).all())

    def test_ukf_update(self):
        dx, dy = 4, 3
        H = jr.normal(jr.PRNGKey(3), (dy, dx))
        h = lambda x, r, u: H @ jnp.sin(x) + r
        up = _ukf.ParamsUKF(alpha=1.0, sqrt_method="cholesky")

        def loss(P):
            ll, mn, cv = _ukf.ukf_condition_on_additive(
                jnp.ones(dx), P, h, 0.5 * jnp.eye(dy), None, jnp.ones(dy),
                up, jnp.zeros(dy))
            return ll + jnp.sum(mn) + jnp.sum(cv)

        assert bool(jnp.isfinite(jax.grad(loss)(_psd(jr.PRNGKey(4),
                                                     dx))).all())

    def test_associative_filter(self):
        lg, emissions = _lgssm(3, T=50)

        def loss(F):
            post = A.parallel_kalman_filter(
                lg._replace(dynamics_matrix=F), emissions, chunk=16)
            return post.marginal_loglik

        g = jax.grad(loss)(lg.dynamics_matrix)
        assert bool(jnp.isfinite(g).all())

    def test_associative_smoother(self):
        lg, emissions = _lgssm(2, T=40)

        def loss(Q):
            post = A.parallel_kalman_smoother(
                lg._replace(dynamics_covariance=Q), emissions, chunk=16)
            return jnp.sum(post.smoothed_means)

        g = jax.grad(loss)(lg.dynamics_covariance)
        assert bool(jnp.isfinite(g).all())
