"""Unit tests for the numerics core (utils/)."""
import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import scipy.linalg

from bayesianfiltering_tpu import utils
from bayesianfiltering_tpu.distributions import mvn_logpdf, mvn_sample


def _random_psd(key, n, scale=1.0):
    a = jr.normal(key, (n, n))
    return scale * (a @ a.T + n * jnp.eye(n))


class TestLinalg:
    def test_psd_solve_matches_dense_solve(self):
        key = jr.PRNGKey(0)
        A = _random_psd(key, 5)
        b = jr.normal(jr.PRNGKey(1), (5, 3))
        x = utils.psd_solve(A, b)
        np.testing.assert_allclose(A @ x, b, rtol=1e-4, atol=1e-4)

    def test_psd_solve_vector_rhs(self):
        A = _random_psd(jr.PRNGKey(2), 4)
        b = jr.normal(jr.PRNGKey(3), (4,))
        x = utils.psd_solve(A, b)
        np.testing.assert_allclose(A @ x, b, rtol=1e-4, atol=1e-4)

    def test_psd_solve_compat_scalar_reproduces_reference_quirk(self):
        A = _random_psd(jr.PRNGKey(4), 3)
        b = jr.normal(jr.PRNGKey(5), (3,))
        x = utils.psd_solve(A, b, compat_scalar=True)
        expected = jnp.linalg.solve(A + 1e-6, b)
        np.testing.assert_allclose(x, expected, rtol=1e-6)

    def test_project_to_psd_clamps_negative_eigenvalues(self):
        A = jnp.diag(jnp.array([2.0, -1.0, 0.5]))
        P = utils.project_to_psd(A)
        np.testing.assert_allclose(P, jnp.diag(jnp.array([2.0, 0.0, 0.5])),
                                   atol=1e-6)
        # idempotent on PSD input
        np.testing.assert_allclose(utils.project_to_psd(P), P, atol=1e-6)

    def test_sqrtm_psd_matches_scipy_sqrtm(self):
        A = np.asarray(_random_psd(jr.PRNGKey(6), 6))
        ours = np.asarray(utils.sqrtm_psd(jnp.asarray(A)))
        theirs = np.real(scipy.linalg.sqrtm(A))
        np.testing.assert_allclose(ours, theirs, rtol=1e-3, atol=1e-3)
        np.testing.assert_allclose(ours @ ours, A, rtol=1e-3, atol=1e-3)

    def test_cholesky_guarded_zeroes_non_psd(self):
        bad = -jnp.eye(3)
        chol = utils.cholesky_guarded(bad)
        assert not jnp.any(jnp.isnan(chol))
        good = _random_psd(jr.PRNGKey(7), 3)
        np.testing.assert_allclose(
            utils.cholesky_guarded(good), jnp.linalg.cholesky(good), atol=1e-6
        )


class TestMetrics:
    def test_rmse_reference_semantics(self):
        x = jnp.ones((10, 4))
        y = jnp.zeros((10, 4))
        # sum over all entries (40) divided by T (10) -> 4; sqrt -> 2
        assert float(utils.rmse(x, y)) == pytest.approx(2.0)

    def test_collapse_moments(self):
        means = jnp.array([[0.0, 0.0], [2.0, 0.0]])
        covs = jnp.stack([jnp.eye(2), jnp.eye(2)])
        w = jnp.array([0.5, 0.5])
        mean, cov = utils.collapse(means, covs, w)
        np.testing.assert_allclose(mean, [1.0, 0.0], atol=1e-6)
        # cov = I + E[(m - mu)(m - mu)^T] = I + diag(1, 0)
        np.testing.assert_allclose(cov, jnp.diag(jnp.array([2.0, 1.0])),
                                   atol=1e-6)

    def test_gaussian_logpdf_matches_mvn(self):
        y = jnp.array([0.3, -0.2])
        m = jnp.array([0.0, 0.1])
        S = _random_psd(jr.PRNGKey(8), 2)
        ours = utils.gaussian_logpdf(y, m, S)
        theirs = mvn_logpdf(y, m, S)
        np.testing.assert_allclose(ours, theirs, rtol=1e-5)

    def test_normal_kl_zero_for_identical(self):
        m = jnp.array([1.0, 2.0])
        S = _random_psd(jr.PRNGKey(9), 2)
        assert float(utils.normal_kl(m, m, S, S)) == pytest.approx(0.0, abs=1e-4)

    def test_dec_to_base(self):
        assert utils.dec_to_base(255, 16) == "FF"
        assert utils.dec_to_base(10, 2) == "1010"


class TestSigmaPoints:
    def test_sigma_points_first_two_moments(self):
        m = jnp.array([1.0, -2.0, 0.5])
        P = _random_psd(jr.PRNGKey(10), 3)
        lamda = 0.5
        pts = utils.sigma_points(m, P, lamda)
        assert pts.shape == (6, 3)
        # mean of the 2n points is m
        np.testing.assert_allclose(pts.mean(axis=0), m, rtol=1e-4, atol=1e-4)
        # empirical covariance: sum (p - m)(p - m)^T / (2 (n + lamda)) = P
        centered = pts - m
        emp = jnp.einsum("ij,ik->jk", centered, centered) / (2 * (3 + lamda))
        np.testing.assert_allclose(emp, P, rtol=1e-3, atol=1e-3)

    def test_split_to_sigma_points_center_first(self):
        m = jnp.array([1.0, 2.0])
        P = jnp.eye(2)
        pts = utils.split_to_sigma_points(m, P, 1.0)
        assert pts.shape == (5, 2)
        np.testing.assert_allclose(pts[0], m, atol=1e-6)

    def test_unscented_weights_sum(self):
        lamda, wm, wc = utils.unscented_weights(4, alpha=1e-3, beta=2.0, kappa=0.0)
        np.testing.assert_allclose(jnp.sum(wm), 1.0, rtol=1e-3)

    @pytest.mark.parametrize("method", ["cholesky", "sqrtm"])
    def test_sigma_points_blockdiag_matches_augmented(self, method):
        """Block-wise augmented points == points of the explicit
        block-diagonal augmented Gaussian (the non-additive UKF path)."""
        from bayesianfiltering_tpu.utils.sigma_points import (
            sigma_points_blockdiag,
        )

        dx, dn = 5, 3
        P = _random_psd(jr.PRNGKey(11), dx)
        C = _random_psd(jr.PRNGKey(12), dn)
        m = jnp.arange(1.0, dx + 1.0)
        bias = jnp.array([0.5, -1.0, 2.0])
        mA = jnp.concatenate([m, bias])
        PA = jnp.zeros((dx + dn, dx + dn)).at[:dx, :dx].set(P)
        PA = PA.at[dx:, dx:].set(C)
        ref = utils.sigma_points(mA, PA, 0.5, method)
        new = sigma_points_blockdiag(m, P, bias, C, 0.5, method)
        np.testing.assert_allclose(new, ref, rtol=1e-5, atol=1e-5)

    def test_sigma_points_blockdiag_batched(self):
        from bayesianfiltering_tpu.utils.sigma_points import (
            sigma_points_blockdiag,
        )

        dx, dn, B = 4, 2, 3
        P = jnp.stack([_random_psd(jr.PRNGKey(i), dx) for i in range(B)])
        C = jnp.stack([_random_psd(jr.PRNGKey(10 + i), dn) for i in range(B)])
        m = jnp.arange(float(B * dx)).reshape(B, dx)
        bias = jnp.ones((B, dn))
        batched = sigma_points_blockdiag(m, P, bias, C, 1.0, "cholesky")
        single = jax.vmap(
            lambda mm, pp, bb, cc: sigma_points_blockdiag(
                mm, pp, bb, cc, 1.0, "cholesky"
            )
        )(m, P, bias, C)
        assert batched.shape == (B, 2 * (dx + dn), dx + dn)
        np.testing.assert_allclose(batched, single, rtol=1e-5, atol=1e-6)


class TestResampling:
    def test_systematic_preserves_heavy_weight(self):
        w = jnp.array([0.01, 0.01, 0.96, 0.01, 0.01])
        idx = utils.systematic_resample(jr.PRNGKey(0), w, 100)
        counts = jnp.bincount(idx, length=5)
        assert counts[2] >= 90

    def test_multinomial_unbiased_counts(self):
        w = jnp.array([0.2, 0.3, 0.5])
        idx = utils.multinomial_resample(jr.PRNGKey(1), w, 30000)
        freq = jnp.bincount(idx, length=3) / 30000
        np.testing.assert_allclose(freq, w, atol=0.02)

    def test_systematic_low_variance(self):
        # systematic counts deviate from expectation by < 1 per particle
        w = jr.dirichlet(jr.PRNGKey(2), jnp.ones(16))
        n = 1600
        idx = utils.systematic_resample(jr.PRNGKey(3), w, n)
        counts = jnp.bincount(idx, length=16)
        np.testing.assert_allclose(counts, w * n, atol=1.0 + 1e-3)

    def test_resample_full_reset(self):
        w = jnp.array([0.0, 0.0, 1.0, 0.0])
        particles = jnp.arange(4.0)[:, None]
        new_w, new_p, _ = utils._resample(w, particles, jr.PRNGKey(4))
        np.testing.assert_allclose(new_w, jnp.full(4, 0.25))
        np.testing.assert_allclose(new_p, jnp.full((4, 1), 2.0))

    def test_optimal_resampling_keeps_heavy_tail(self):
        # Two dominant weights must survive deterministically.
        w = jnp.array([0.005] * 8 + [0.48, 0.48])
        w = w / w.sum()
        idx, new_w = utils.optimal_resampling(w, 4, jr.PRNGKey(5))
        assert idx.shape == (4,)
        np.testing.assert_allclose(jnp.sum(new_w), 1.0, rtol=1e-5)
        assert 8 in list(np.asarray(idx)) and 9 in list(np.asarray(idx))

    def test_optimal_resampling_uniform_input(self):
        w = jnp.full(12, 1.0 / 12)
        idx, new_w = utils.optimal_resampling(w, 6, jr.PRNGKey(6))
        assert idx.shape == (6,)
        np.testing.assert_allclose(jnp.sum(new_w), 1.0, rtol=1e-5)

    def test_optimal_resampling_single_target(self):
        """N=1 previously gathered from a zero-length threshold array;
        must return one valid index with weight 1."""
        w = jnp.array([0.1, 0.2, 0.65, 0.05])
        idx, new_w = utils.optimal_resampling(w, 1, jr.PRNGKey(7))
        assert idx.shape == (1,)
        assert 0 <= int(idx[0]) < 4
        np.testing.assert_allclose(new_w, jnp.ones(1))
        # reachable through the public mixture-reduction path too
        from bayesianfiltering_tpu.containers import (
            GaussianSum, reduce_gaussian_sum,
        )
        gs = GaussianSum(
            jnp.arange(4.0)[:, None],
            jnp.broadcast_to(jnp.eye(1), (4, 1, 1)),
            w,
        )
        red = reduce_gaussian_sum(gs, 1, jr.PRNGKey(8), "optimal")
        assert red.means.shape == (1, 1)
        assert bool(jnp.all(jnp.isfinite(red.means)))

    def test_project_to_psd_ns_matches_eigh(self):
        """Matmul-only PSD projection (in-scan safe) vs the eigh clamp."""
        from bayesianfiltering_tpu.utils.linalg import project_to_psd_ns

        A = jnp.diag(jnp.array([2.0, -1.0, 0.5]))
        np.testing.assert_allclose(
            project_to_psd_ns(A), utils.project_to_psd(A), atol=1e-4
        )
        B = np.asarray(_random_psd(jr.PRNGKey(11), 5)) - 0.5 * np.eye(5)
        B = 0.5 * (B + B.T)
        np.testing.assert_allclose(
            project_to_psd_ns(jnp.asarray(B)),
            utils.project_to_psd(jnp.asarray(B)),
            atol=2e-3,
        )

    def test_3d_resample_and_retain(self):
        w = jnp.zeros((2, 3, 4)).at[1, 2, 3].set(0.9).at[0, 0, 0].set(0.1)
        out = utils.resample(w, 5, jr.PRNGKey(7))
        assert out.shape == (5, 3)
        top = utils.retain(w, 2)
        assert (np.asarray(top) == np.array([[0, 0, 0], [1, 2, 3]])).all()


class TestSDP:
    def test_sdp_opt_respects_bounds(self):
        P = _random_psd(jr.PRNGKey(11), 3)
        J = jr.normal(jr.PRNGKey(12), (3, 3))
        H = jr.normal(jr.PRNGKey(13), (3, 3, 3))
        delta = utils.sdp_opt(3, 4, P, J, H, 0.5)
        evals_delta = jnp.linalg.eigvalsh(utils.symmetrize(delta))
        evals_rem = jnp.linalg.eigvalsh(utils.symmetrize(P - delta))
        assert float(evals_delta.min()) >= -1e-4
        assert float(evals_rem.min()) >= -1e-4

    def test_sdp_opt_legacy_bounds(self):
        P = _random_psd(jr.PRNGKey(14), 2)
        H = jnp.eye(2)
        delta = utils.sdp_opt_legacy(2, 4, 1.0, P, P, H, 10, 0.01)
        evals_delta = jnp.linalg.eigvalsh(utils.symmetrize(delta))
        evals_rem = jnp.linalg.eigvalsh(utils.symmetrize(P - delta))
        assert float(evals_delta.min()) >= -1e-4
        assert float(evals_rem.min()) >= -1e-4


class TestDistributions:
    def test_mvn_logpdf_matches_scipy(self):
        from scipy.stats import multivariate_normal

        m = np.array([0.5, -1.0])
        S = np.asarray(_random_psd(jr.PRNGKey(15), 2))
        x = np.array([0.1, 0.2])
        ours = float(mvn_logpdf(jnp.asarray(x), jnp.asarray(m), jnp.asarray(S)))
        theirs = multivariate_normal.logpdf(x, m, S)
        assert ours == pytest.approx(theirs, rel=1e-4)

    def test_mvn_sample_moments(self):
        m = jnp.array([1.0, -1.0])
        S = jnp.array([[2.0, 0.5], [0.5, 1.0]])
        xs = mvn_sample(jr.PRNGKey(16), m, S, (20000,))
        np.testing.assert_allclose(xs.mean(axis=0), m, atol=0.05)
        emp = jnp.cov(xs.T)
        np.testing.assert_allclose(emp, S, atol=0.1)


class TestCholAndInv:
    """utils/linalg.py — the factorization table and both of its forms."""

    @pytest.mark.parametrize("n", [1, 4, 5, 8, 9, 16, 24, 32])
    def test_matches_native(self, n):
        from bayesianfiltering_tpu.utils.linalg import chol_and_inv_lower

        a = jr.normal(jr.PRNGKey(31), (n, n))
        S = a @ a.T + 0.5 * jnp.eye(n)
        L, Li = chol_and_inv_lower(S)
        np.testing.assert_allclose(L, jnp.linalg.cholesky(S), rtol=2e-4,
                                   atol=2e-4)
        np.testing.assert_allclose(Li @ L, jnp.eye(n), rtol=1e-3, atol=1e-3)

    @pytest.mark.parametrize("n", [3, 12])
    def test_batched(self, n):
        from bayesianfiltering_tpu.utils.linalg import chol_and_inv_lower

        a = jr.normal(jr.PRNGKey(32), (7, n, n))
        S = jnp.einsum("mik,mjk->mij", a, a) + jnp.eye(n)
        L, Li = chol_and_inv_lower(S)
        np.testing.assert_allclose(L, jnp.linalg.cholesky(S), rtol=2e-4,
                                   atol=2e-4)
        eye = jnp.broadcast_to(jnp.eye(n), (7, n, n))
        np.testing.assert_allclose(jnp.einsum("mij,mjk->mik", Li, L), eye,
                                   rtol=1e-3, atol=1e-3)

    @pytest.mark.parametrize("n,expect", [(1, "unrolled"), (8, "unrolled"),
                                          (9, "native"), (512, "native")])
    def test_table(self, n, expect):
        from bayesianfiltering_tpu.utils.linalg import factor_impl

        assert factor_impl(n) == expect

    @pytest.mark.parametrize("n,expect", [(4, "eigh"), (9, "newton_schulz"),
                                          (128, "newton_schulz"),
                                          (129, "eigh")])
    def test_sqrt_table(self, n, expect):
        from bayesianfiltering_tpu.utils.linalg import sqrt_impl

        assert sqrt_impl(n) == expect

    @pytest.mark.parametrize("n", [3, 12])
    def test_guarded_zeroes_failed_factors(self, n):
        """Both forms: an indefinite matrix's factor is zeroed whole (the
        unrolled lattice leaves a finite prefix; native NaNs it all)."""
        from bayesianfiltering_tpu.utils.linalg import cholesky_guarded

        good = jnp.eye(n) * 2.0
        bad = jnp.eye(n).at[n - 1, n - 1].set(-1.0)
        out = cholesky_guarded(jnp.stack([good, bad]))
        np.testing.assert_allclose(out[0], jnp.sqrt(2.0) * jnp.eye(n),
                                   rtol=1e-6)
        np.testing.assert_array_equal(out[1], jnp.zeros((n, n)))
