"""Integration tests for every filter entry point on the reference's
canonical bearing-only-tracking benchmark (ref: docs/tests/test_inference.py)
— but with assertions: shapes, finiteness, weight normalization, PSD
covariances, and accuracy against the ground truth."""
import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest

import bayesianfiltering_tpu.inference as gf
from bayesianfiltering_tpu.models import zoo
from bayesianfiltering_tpu.ops import ParamsUKF
from bayesianfiltering_tpu.utils import rmse

SEQ_LEN = 30


@pytest.fixture(scope="module")
def bot():
    model, params, bpf_params = zoo.bearings_only_tracking()
    inputs = zoo.bot_maneuver_inputs(SEQ_LEN)
    # Seed 2: a realization where the (range-unobservable) bearing-only
    # GSF tracks as well as a 5000-particle BPF (4.79 vs 4.92 RMSE) — the
    # accuracy gates below calibrate against it. Seeds where even the BPF
    # drifts in range (e.g. 0: BPF 20.7) say nothing about filter quality.
    states, emissions = model.sample(params, jr.PRNGKey(2), SEQ_LEN,
                                     inputs=inputs)
    return model, params, bpf_params, inputs, states, emissions


def _check_mixture_posterior(post, M, T, dx, psd=True):
    assert post.weights.shape == (M, T)
    assert post.means.shape == (M, T, dx)
    assert post.covariances.shape == (M, T, dx, dx)
    assert bool(jnp.all(jnp.isfinite(post.means)))
    np.testing.assert_allclose(jnp.sum(post.weights, axis=0),
                               jnp.ones(T), rtol=1e-4)
    if psd:
        evals = jnp.linalg.eigvalsh(post.covariances)
        assert float(evals.min()) > -1e-3


def _point_estimate(post):
    # weighted mixture mean per step: (M,T) x (M,T,dx) -> (T,dx)
    return jnp.einsum("mt,mtd->td", post.weights, post.means)


class TestGaussianSumFilters:
    def test_gaussian_sum_filter(self, bot):
        _, params, _, inputs, states, emissions = bot
        post = gf.gaussian_sum_filter(params, emissions, 5, 1, inputs)
        _check_mixture_posterior(post, 5, SEQ_LEN, 4)
        assert post.predicted_means.shape == (5, SEQ_LEN, 4)
        # Calibrated gate: measured 4.08 on this seed; the no-information
        # estimate (hold the prior mean) scores 18.0 — a 2x accuracy
        # regression fails this, unlike the old `< 50` smoke bound.
        assert float(rmse(_point_estimate(post), states)) < 9.0

    def test_unscented_gaussian_sum_filter(self):
        # UKF moments on the near-deterministic-bearing BOT model sit in a
        # divergent regime (the reference's BOT notebook reports no UGSF
        # RMSE and its UAGSF diverges, BASELINE.md); exercise the UGSF on
        # the well-conditioned stochastic-volatility model instead.
        model, params, _ = zoo.stochastic_volatility()
        T = 30
        inputs = jnp.array([0] * (T // 2) + [1] * (T - T // 2))
        _, emissions = model.sample(params, jr.PRNGKey(0), T, inputs=inputs)
        post = gf.unscented_gaussian_sum_filter(
            params, ParamsUKF(alpha=1.0), emissions, 5, 1, inputs
        )
        _check_mixture_posterior(post, 5, T, 3, psd=False)

    def test_gsf_single_component_equals_ekf(self, bot):
        """An M=1 GSF is exactly one EKF initialized at a sampled mean."""
        _, params, _, inputs, _, emissions = bot
        post = gf.gaussian_sum_filter(params, emissions, 1, 1, inputs)
        m0 = post.means[0, 0]
        # run EKF from the same (sampled) initial mean
        from bayesianfiltering_tpu.distributions import mvn_sample

        init_mean = mvn_sample(jr.PRNGKey(0), params.initial_mean,
                               params.initial_covariance, (1,))[0]
        params1 = params._replace(initial_mean=init_mean)
        ekf = gf.extended_kalman_filter(params1, emissions, inputs=inputs)
        np.testing.assert_allclose(post.means[0], ekf.filtered_means,
                                   rtol=1e-3, atol=1e-4)


class TestAGSF:
    @pytest.mark.parametrize("reduction", ["multinomial", "systematic",
                                           "stratified", "topk", "optimal"])
    def test_agsf_reduction_methods(self, bot, reduction):
        _, params, _, inputs, _, emissions = bot
        post, _ = gf.augmented_gaussian_sum_filter(
            params, emissions[:12], [4, 2, 2], jr.PRNGKey(1), 1, (0.1, 0.1),
            inputs[:12], reduction=reduction,
        )
        _check_mixture_posterior(post, 4, 12, 4, psd=False)

    @pytest.mark.parametrize("fn_name", [
        "augmented_gaussian_sum_filter",
        "speedy_augmented_gaussian_sum_filter",
        "augmented_gaussian_sum_filter_optimal",
    ])
    def test_ekf_agsf_variants(self, bot, fn_name):
        _, params, _, inputs, states, emissions = bot
        fn = getattr(gf, fn_name)
        post, aux = fn(params, emissions, [5, 3, 2], jr.PRNGKey(1), 1,
                       (0.1, 0.1), inputs)
        _check_mixture_posterior(post, 5, SEQ_LEN, 4)
        assert aux["Deltas"].shape == (SEQ_LEN, 5, 4, 4)
        assert aux["Lambdas"].shape == (SEQ_LEN, 15, 4, 4)
        assert aux["pre_weights"].shape == (SEQ_LEN, 30)
        # Calibrated: 5.46 / 5.46 / 3.19 measured per variant on this seed
        # (prior-mean baseline 18.0); catches a 2x accuracy regression.
        assert float(rmse(_point_estimate(post), states)) < 11.0

    @pytest.mark.parametrize("fn_name", ["unscented_agsf",
                                         "speedy_unscented_agsf"])
    def test_ukf_agsf_variants(self, fn_name):
        # UKF moments on the near-deterministic-bearing BOT model sit in a
        # divergent regime (the reference's own UAGSF BOT row reads RMSE
        # 498±260, BASELINE.md — covariances overflow f32); exercise the
        # UKF-AGSF on the well-conditioned stochastic-volatility model.
        model, params, _ = zoo.stochastic_volatility()
        T = 30
        inputs = jnp.array([0] * (T // 2) + [1] * (T - T // 2))
        _, emissions = model.sample(params, jr.PRNGKey(0), T, inputs=inputs)
        fn = getattr(gf, fn_name)
        post, aux = fn(params, ParamsUKF(alpha=1.0), emissions, [4, 2, 2],
                       jr.PRNGKey(1), 1, (0.1, 0.1), inputs)
        _check_mixture_posterior(post, 4, T, 3, psd=False)

    @pytest.mark.parametrize("strategy", ["prop", "eye", "sdp", "trace"])
    def test_agsf_autocov_strategies(self, strategy):
        """All four splitting-covariance strategies must run inside the
        engine on a Hessian-bearing model (sdp/trace exercise the
        Hessian-reshape paths; ref commented branches at
        gaussfiltax/inference.py:226-301)."""
        model, params, _ = zoo.quadratic_measurement()
        states, emissions = model.sample(params, jr.PRNGKey(2), 25)
        post, aux = gf.augmented_gaussian_sum_filter(
            params, emissions, [3, 2, 2], jr.PRNGKey(1), 1, (0.1, 0.1),
            autocov=strategy,
        )
        assert bool(jnp.all(jnp.isfinite(post.means)))
        assert bool(jnp.all(jnp.isfinite(aux["Deltas"])))
        assert bool(jnp.all(jnp.isfinite(aux["Lambdas"])))
        # splitting covariances must stay within the PSD order bound Δ ⪯ P-ish
        # (loose sanity: finite, symmetric, non-explosive)
        d = aux["Deltas"]
        np.testing.assert_allclose(d, jnp.swapaxes(d, -1, -2), atol=1e-5)

    @pytest.mark.parametrize("strategy", ["sdp", "trace"])
    def test_agsf_autocov_strategies_bot(self, bot, strategy):
        """sdp/trace on the 4-D BOT model (vector emission Hessians)."""
        _, params, _, inputs, _, emissions = bot
        post, _ = gf.augmented_gaussian_sum_filter(
            params, emissions[:10], [3, 2, 2], jr.PRNGKey(1), 1, (0.1, 0.1),
            inputs[:10], autocov=strategy,
        )
        assert bool(jnp.all(jnp.isfinite(post.means)))

    def test_agsf_num_iter_honored(self, bot):
        """num_iter must change the AGSF update (IEKF relinearization) —
        it was once silently ignored."""
        _, params, _, inputs, _, emissions = bot
        run = lambda k: gf.augmented_gaussian_sum_filter(
            params, emissions, [3, 2, 2], jr.PRNGKey(1), k, (0.1, 0.1), inputs
        )[0].means
        m1, m3 = run(1), run(3)
        assert bool(jnp.all(jnp.isfinite(m3)))
        assert float(jnp.max(jnp.abs(m1 - m3))) > 1e-6

    def test_ugsf_num_iter_honored(self):
        model, params, _ = zoo.stochastic_volatility()
        T = 20
        inputs = jnp.array([0] * (T // 2) + [1] * (T - T // 2))
        _, emissions = model.sample(params, jr.PRNGKey(0), T, inputs=inputs)
        run = lambda k: gf.unscented_gaussian_sum_filter(
            params, ParamsUKF(alpha=1.0), emissions, 4, k, inputs
        ).means
        m1, m3 = run(1), run(3)
        assert bool(jnp.all(jnp.isfinite(m3)))
        assert float(jnp.max(jnp.abs(m1 - m3))) > 1e-7

    def test_agsf_rng_key_controls_init(self, bot):
        """The caller's rng_key must control the mixture init draw; round 1
        hard-coded PRNGKey(0). compat_fixed_keys=True
        restores the reference's fixed-key init."""
        _, params, _, inputs, _, emissions = bot
        run = lambda key, **kw: gf.augmented_gaussian_sum_filter(
            params, emissions[:5], [3, 2, 2], key, 1, (0.1, 0.1),
            inputs[:5], **kw,
        )[0].means
        assert float(jnp.max(jnp.abs(run(jr.PRNGKey(1)) - run(jr.PRNGKey(2))))) > 1e-6
        np.testing.assert_array_equal(run(jr.PRNGKey(1), compat_fixed_keys=True),
                                      run(jr.PRNGKey(1), compat_fixed_keys=True))

    def test_agsf_is_jittable(self, bot):
        _, params, _, inputs, _, emissions = bot
        jitted = jax.jit(
            lambda e: gf.augmented_gaussian_sum_filter(
                params, e, [3, 2, 2], jr.PRNGKey(1), 1, (0.1, 0.1), inputs
            )[0].means
        )
        out = jitted(emissions)
        assert out.shape == (3, SEQ_LEN, 4)

    def test_agsf_compat_fixed_keys_mode(self, bot):
        _, params, _, inputs, _, emissions = bot
        post, _ = gf.augmented_gaussian_sum_filter(
            params, emissions, [3, 2, 2], jr.PRNGKey(1), 1, (0.1, 0.1),
            inputs, compat_fixed_keys=True,
        )
        assert bool(jnp.all(jnp.isfinite(post.means)))

    def test_agsf_deterministic_given_key(self, bot):
        _, params, _, inputs, _, emissions = bot
        run = lambda: gf.augmented_gaussian_sum_filter(
            params, emissions, [3, 2, 2], jr.PRNGKey(5), 1, (0.1, 0.1), inputs
        )[0].means
        np.testing.assert_array_equal(run(), run())


class TestBPF:
    def test_bootstrap_particle_filter_shapes(self, bot):
        _, _, bpf_params, inputs, states, emissions = bot
        out = gf.bootstrap_particle_filter(bpf_params, emissions, 500,
                                           jr.PRNGKey(2), inputs)
        assert out["particles"].shape == (500, SEQ_LEN, 4)
        assert out["weights"].shape == (500, SEQ_LEN)
        np.testing.assert_allclose(out["weights"].sum(axis=0),
                                   jnp.ones(SEQ_LEN), rtol=1e-3)

    def test_bpf_summary_mode(self, bot):
        _, _, bpf_params, inputs, _, emissions = bot
        out = gf.bootstrap_particle_filter(
            bpf_params, emissions, 500, jr.PRNGKey(2), inputs,
            store="summary",
        )
        assert out["means"].shape == (SEQ_LEN, 4)
        assert out["ess"].shape == (SEQ_LEN,)
        assert bool(jnp.all(out["ess"] >= 1.0 - 1e-3))
        assert bool(jnp.all(out["ess"] <= 500 + 1e-3))

    def test_bpf_multinomial_matches_reference_behavior(self, bot):
        _, _, bpf_params, inputs, _, emissions = bot
        out = gf.bootstrap_particle_filter(
            bpf_params, emissions, 200, jr.PRNGKey(3), inputs,
            resampler="multinomial",
        )
        assert bool(jnp.all(jnp.isfinite(out["particles"])))

    def test_bpf_tracks_linear_model(self):
        """On a near-linear model the BPF mean must track the KF closely."""
        model, params, bpf_params = zoo.linear_gaussian(2, 2, r=0.5)
        states, emissions = model.sample(params, jr.PRNGKey(1), 40)
        out = gf.bootstrap_particle_filter(
            bpf_params, emissions, 4000, jr.PRNGKey(4), store="summary"
        )
        lg = zoo.linear_gaussian_lgssm(2, 2, r=0.5)
        from bayesianfiltering_tpu.ops import kalman_filter

        kf = kalman_filter(lg, emissions)
        err = float(jnp.max(jnp.abs(out["means"] - kf.filtered_means)))
        assert err < 0.35, err


class TestAccuracy:
    def test_agsf_beats_or_matches_gsf_on_quadratic(self):
        """On the ICASSP quadratic-measurement model, the AGSF should track
        the (bimodal) state at least as well as a plain GSF on average."""
        model, params, _ = zoo.quadratic_measurement()
        rmses_gsf, rmses_agsf = [], []
        for seed in range(3):
            states, emissions = model.sample(params, jr.PRNGKey(seed), 60)
            gsf = gf.gaussian_sum_filter(params, emissions, 6, 1)
            agsf, _ = gf.augmented_gaussian_sum_filter(
                params, emissions, [6, 3, 3], jr.PRNGKey(seed + 100), 1,
                (0.2, 0.2),
            )
            rmses_gsf.append(float(rmse(_point_estimate(gsf), states)))
            rmses_agsf.append(float(rmse(_point_estimate(agsf), states)))
        assert np.mean(rmses_agsf) < 2.0 * np.mean(rmses_gsf) + 2.0

    def test_ekf_tracks_scalar_growth(self):
        model, params, _ = zoo.scalar_growth()
        inputs = jnp.arange(50.0)[:, None]
        states, emissions = model.sample(params, jr.PRNGKey(3), 50,
                                         inputs=inputs)
        post = gf.extended_kalman_filter(params, emissions, inputs=inputs)
        assert bool(jnp.all(jnp.isfinite(post.filtered_means)))


class TestIteratedUpdates:
    """IEKF / IPLF relinearization (num_iter semantics)."""

    def _stiff_update_args(self):
        h = lambda x, r, u: 0.05 * x**2 + r
        H_x = jax.jacfwd(h, 0)
        H_r = jax.jacfwd(h, 1)
        m = jnp.array([1.0])
        P = 4.0 * jnp.eye(1)
        R = 0.01 * jnp.eye(1)
        r0 = jnp.zeros(1)
        y = jnp.array([0.05 * 3.0**2])  # true state at 3.0 — far from m
        return h, H_x, H_r, m, P, R, r0, y

    def test_iekf_improves_stiff_update(self):
        from bayesianfiltering_tpu.ops import ekf as _ekf

        h, H_x, H_r, m, P, R, r0, y = self._stiff_update_args()
        residual = lambda upd: abs(float(y[0] - 0.05 * upd.mean[0] ** 2))
        u1 = _ekf.ekf_condition_on_iterated(m, P, h, H_x, H_r, R, r0, 0.0, y, 1)
        u8 = _ekf.ekf_condition_on_iterated(m, P, h, H_x, H_r, R, r0, 0.0, y, 8)
        assert residual(u8) < residual(u1)

    def test_iplf_num_iter_one_matches_plain_ukf(self):
        from bayesianfiltering_tpu.ops import ukf as _ukf

        h, _, _, m, P, R, r0, y = self._stiff_update_args()
        up = ParamsUKF(alpha=1.0)
        plain = _ukf.ukf_condition_on_nonadditive(m, P, h, R, 0.0, y, up, r0)
        it1 = _ukf.ukf_condition_on_nonadditive_iterated(
            m, P, h, R, 0.0, y, up, r0, 1
        )
        for a, b in zip(plain, it1):
            np.testing.assert_array_equal(a, b)

    def test_iplf_improves_stiff_update(self):
        from bayesianfiltering_tpu.ops import ukf as _ukf

        h, _, _, m, P, R, r0, y = self._stiff_update_args()
        up = ParamsUKF(alpha=1.0)
        res = {}
        for k in (1, 8):
            _, mean, cov = _ukf.ukf_condition_on_nonadditive_iterated(
                m, P, h, R, 0.0, y, up, r0, k
            )
            assert bool(jnp.all(jnp.isfinite(mean)))
            assert float(jnp.linalg.eigvalsh(cov).min()) > -1e-5
            res[k] = abs(float(y[0] - 0.05 * mean[0] ** 2))
        assert res[8] < res[1]

    def test_ukf_update_psd_on_tiny_noise(self):
        """Joseph-style grouped downdate keeps the UKF posterior covariance
        PSD with near-singular innovation covariance (the difference form P − K S Kᵀ goes indefinite under f32 cancellation)."""
        from bayesianfiltering_tpu.ops import ukf as _ukf

        h = lambda x, r, u: x[:1] + r  # observe first coordinate
        m = jnp.array([0.3, -0.2])
        P = jnp.array([[2.0, 0.5], [0.5, 1.0]])
        R = 2.5e-5 * jnp.eye(1)  # the BOT bearing-noise scale
        r0 = jnp.zeros(1)
        y = jnp.array([1.0])
        _, _, cov = _ukf.ukf_condition_on_nonadditive(
            m, P, h, R, 0.0, y, ParamsUKF(alpha=1.0), r0
        )
        assert float(jnp.linalg.eigvalsh(cov).min()) > -1e-6


class TestBPFLogWeights:
    def test_underflowed_weights_survive_no_resample(self, bot):
        """f32-underflowed weights (w=0, finite log-weight) must not become
        -inf through the no-resample branch."""
        from bayesianfiltering_tpu.streaming import make_bpf_stepper

        _, _, bpf_params, inputs, _, emissions = bot
        # Harsh likelihood: most particles' log-weights < -88 (f32 exp
        # underflow) after one step.
        harsh = lambda x, y, u: -2000.0 * jnp.sum(jnp.square(x[:2] - 100.0))
        params = bpf_params._replace(emission_distribution_log_prob=harsh)
        stepper = make_bpf_stepper(params, 64, ess_threshold=0.0)  # never resample
        state = stepper.init(jr.PRNGKey(0))
        for t in range(3):
            state, _ = stepper.step(state, emissions[t], inputs[t], t)
        assert bool(jnp.all(jnp.isfinite(state.log_weights))), state.log_weights


class TestTimeVaryingNoise:
    """Time-varying Q/R stacks resolved per step — the reference's
    `_get_params` capability (ref: gaussfiltax/inference.py:21,337-340)."""

    def test_time_varying_emission_noise(self):
        model, params, _ = zoo.linear_gaussian(2, 2, r=0.1)
        T = 30
        _, emissions = model.sample(params, jr.PRNGKey(0), T)
        # R ramps from exact (0.1 I) to huge — late-step updates should be
        # increasingly ignored, inflating late filtered covariances.
        R_stack = jnp.stack(
            [0.1 * (1 + 100.0 * t / T) * jnp.eye(2) for t in range(T)]
        )
        tv_params = params._replace(emission_noise_covariance=R_stack)
        post_tv = gf.extended_kalman_filter(tv_params, emissions)
        post_const = gf.extended_kalman_filter(params, emissions)
        assert bool(jnp.all(jnp.isfinite(post_tv.filtered_means)))
        tr = lambda p: jnp.trace(p.filtered_covariances[-1])
        assert float(tr(post_tv)) > float(tr(post_const))
        # early steps (small R difference) agree closely
        np.testing.assert_allclose(post_tv.filtered_means[0],
                                   post_const.filtered_means[0], atol=1e-3)

    def test_time_varying_q_in_gsf(self):
        model, params, _ = zoo.linear_gaussian(2, 2)
        T = 20
        _, emissions = model.sample(params, jr.PRNGKey(1), T)
        Q_stack = jnp.stack([(0.5 + 0.1 * t) * jnp.eye(2) for t in range(T)])
        tv_params = params._replace(dynamics_noise_covariance=Q_stack)
        post = gf.gaussian_sum_filter(tv_params, emissions, 3)
        assert bool(jnp.all(jnp.isfinite(post.means)))


class TestExtendedRTSSmoother:
    def test_linear_specialization_exact(self):
        from bayesianfiltering_tpu.ops.linear import kalman_smoother

        model, params, _ = zoo.linear_gaussian(3, 3)
        lg = zoo.linear_gaussian_lgssm(3, 3)
        _, emissions = model.sample(params, jr.PRNGKey(0), 25)
        ref = kalman_smoother(lg, emissions)
        out = gf.extended_rts_smoother(params, emissions)
        np.testing.assert_allclose(out.smoothed_means, ref.smoothed_means,
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(out.smoothed_covariances,
                                   ref.smoothed_covariances, rtol=1e-4,
                                   atol=1e-5)

    def test_smoothing_tightens_covariances(self):
        model, params, _ = zoo.scalar_growth()
        T = 60
        u = jnp.arange(float(T))
        states, emissions = model.sample(params, jr.PRNGKey(1), T, inputs=u)
        out = gf.extended_rts_smoother(params, emissions, inputs=u)
        assert bool(jnp.all(jnp.isfinite(out.smoothed_means)))
        # smoothed marginal variances are no larger than filtered ones
        # everywhere except numerical noise, and strictly smaller early on
        fvar = jnp.diagonal(out.filtered_covariances, axis1=-2, axis2=-1)
        svar = jnp.diagonal(out.smoothed_covariances, axis1=-2, axis2=-1)
        assert float(jnp.max(svar - fvar)) < 1e-3
        assert float(jnp.mean(fvar[:-1] - svar[:-1])) > 0.0


class TestUnscentedRTSSmoother:
    def test_linear_specialization_exact(self):
        from bayesianfiltering_tpu.ops.linear import kalman_smoother

        model, params, _ = zoo.linear_gaussian(3, 3)
        lg = zoo.linear_gaussian_lgssm(3, 3)
        _, emissions = model.sample(params, jr.PRNGKey(0), 25)
        ref = kalman_smoother(lg, emissions)
        out = gf.unscented_rts_smoother(params, ParamsUKF(1.0, 0.0, 0.0),
                                        emissions)
        np.testing.assert_allclose(out.smoothed_means, ref.smoothed_means,
                                   rtol=1e-3, atol=1e-3)
        np.testing.assert_allclose(out.smoothed_covariances,
                                   ref.smoothed_covariances, rtol=1e-3,
                                   atol=1e-3)

    def test_nonlinear_finite_and_tightens(self):
        model, params, _ = zoo.scalar_growth()
        T = 40
        u = jnp.arange(float(T))
        _, emissions = model.sample(params, jr.PRNGKey(1), T, inputs=u)
        out = gf.unscented_rts_smoother(params, ParamsUKF(1.0, 0.0, 0.0),
                                        emissions, inputs=u)
        assert bool(jnp.all(jnp.isfinite(out.smoothed_means)))
        fvar = jnp.diagonal(out.filtered_covariances, axis1=-2, axis2=-1)
        svar = jnp.diagonal(out.smoothed_covariances, axis1=-2, axis2=-1)
        assert float(jnp.mean(fvar[:-1] - svar[:-1])) > 0.0


class TestUAGSFReduction:
    def test_reduction_kwarg(self, bot):
        """unscented_agsf accepts reduction/jitter like its EKF sibling."""
        _, params, _, inputs, _, emissions = bot
        post, _ = gf.unscented_agsf(
            params, ParamsUKF(alpha=1.0), emissions[:10], [4, 2, 2],
            jr.PRNGKey(1), 1, (0.5, 0.5), inputs[:10],
            reduction="systematic", jitter=1e-8,
        )
        assert bool(jnp.all(jnp.isfinite(post.means)))
        np.testing.assert_allclose(jnp.sum(post.weights, axis=0),
                                   jnp.ones(10), rtol=1e-4)
