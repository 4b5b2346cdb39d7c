"""The five BASELINE.json benchmark configs as CI checks (SURVEY.md §7.9).

CPU-runnable versions are asserted here (reduced sizes where the full config
needs a card); the full sizes run on the GPU in chip_smoke.py.
"""
import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest

import bayesianfiltering_tpu.inference as gf
from bayesianfiltering_tpu.models import zoo
from bayesianfiltering_tpu.ops import ParamsUKF, kalman_filter
from bayesianfiltering_tpu.utils import rmse


class TestBaselineConfigs:
    def test_config1_linear_gaussian_kf_dx2_1k_steps(self):
        """Config 1: linear-Gaussian KF, dx=2 tracking, 1k steps."""
        model, params, _ = zoo.linear_gaussian(2, 2)
        lg = zoo.linear_gaussian_lgssm(2, 2)
        states, emissions = model.sample(params, jr.PRNGKey(0), 1000)
        post = kalman_filter(lg, emissions)
        assert post.filtered_means.shape == (1000, 2)
        assert bool(jnp.all(jnp.isfinite(post.filtered_means)))
        # EKF on the same model must agree to float tolerance
        ekf = gf.extended_kalman_filter(params, emissions)
        np.testing.assert_allclose(ekf.filtered_means, post.filtered_means,
                                   rtol=1e-3, atol=1e-3)

    def test_config2_ekf_ukf_scalar_growth(self):
        """Config 2: EKF + UKF on the scalar nonlinear growth model."""
        model, params, _ = zoo.scalar_growth()
        inputs = jnp.arange(100.0)[:, None]
        states, emissions = model.sample(params, jr.PRNGKey(1), 100,
                                         inputs=inputs)
        ekf = gf.extended_kalman_filter(params, emissions, inputs=inputs)
        # NB: the reference's default alpha=1e-3 yields W0c ≈ 1 − 1/alpha²
        # ≈ −1e6 and diverges on this model (as its own UGSF does on BOT,
        # BASELINE.md); alpha=1 is the sane UT configuration.
        ukf = gf.unscented_kalman_filter(params, ParamsUKF(alpha=1.0),
                                         emissions, inputs=inputs)
        assert bool(jnp.all(jnp.isfinite(ekf.filtered_means)))
        assert bool(jnp.all(jnp.isfinite(ukf.filtered_means)))
        # UKF should handle the severe nonlinearity at least as gracefully
        prior_rmse = float(rmse(jnp.zeros_like(states), states))
        assert float(rmse(ukf.filtered_means, states)) < 2.0 * prior_rmse

    def test_config3_gsf_ala_splitting_bimodal(self):
        """Config 3: Gaussian-sum filter with ALA adaptive splitting on the
        bimodal quadratic-measurement SSM, 16 components."""
        model, params, _ = zoo.quadratic_measurement()
        states, emissions = model.sample(params, jr.PRNGKey(2), 80)
        post, aux = gf.augmented_gaussian_sum_filter(
            params, emissions, [16, 2, 2], jr.PRNGKey(3), 1, (0.2, 0.2)
        )
        assert post.means.shape == (16, 80, 1)
        est = jnp.einsum("mt,mtd->td", post.weights, post.means)
        # bimodal sign-symmetric posterior: track |x| well
        abs_err = float(rmse(jnp.abs(est), jnp.abs(states)))
        assert abs_err < 3.0, abs_err

    def test_config4_bpf_100k_systematic_dx8(self):
        """Config 4: bootstrap PF, 100k particles, systematic resampling,
        dx=8 SSM (reduced to 30 steps for CPU CI)."""
        model, params, bpf_params = zoo.lorenz96(8, 4)
        states, emissions = model.sample(params, jr.PRNGKey(4), 30)
        out = gf.bootstrap_particle_filter(
            bpf_params, emissions, 100_000, jr.PRNGKey(5), store="summary",
            resampler="systematic",
        )
        assert out["means"].shape == (30, 8)
        assert bool(jnp.all(jnp.isfinite(out["means"])))
        assert float(rmse(out["means"], states)) < float(
            rmse(jnp.zeros_like(states), states)
        )

    def test_config5_lorenz96_highdim_ukf_batched(self):
        """Config 5: Lorenz-96 high-dim UKF + vmapped batch of sequences
        (dx reduced 512→32 and batch 1k→8 for CPU CI)."""
        dx = 32
        model, params, _ = zoo.lorenz96(dx, dx // 2)
        keys = jr.split(jr.PRNGKey(6), 8)
        states, emissions = jax.vmap(
            lambda k: model.sample(params, k, 20)
        )(keys)
        up = ParamsUKF(alpha=1.0, sqrt_method="cholesky")
        batched = jax.vmap(
            lambda e: gf.unscented_kalman_filter(
                params, up, e, additive=True
            ).filtered_means
        )
        means = batched(emissions)
        assert means.shape == (8, 20, dx)
        assert bool(jnp.all(jnp.isfinite(means)))

    def test_ukf_sqrt_methods_agree_on_small_dims(self):
        """cholesky vs sqrtm sigma points: both exact to second order —
        moments agree on a mildly nonlinear model."""
        model, params, _ = zoo.lorenz63()
        _, emissions = model.sample(params, jr.PRNGKey(7), 20)
        m1 = gf.unscented_kalman_filter(
            params, ParamsUKF(alpha=1.0, sqrt_method="sqrtm"), emissions
        ).filtered_means
        m2 = gf.unscented_kalman_filter(
            params, ParamsUKF(alpha=1.0, sqrt_method="cholesky"), emissions
        ).filtered_means
        np.testing.assert_allclose(m1, m2, rtol=0.2, atol=0.5)
