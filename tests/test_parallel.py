"""Multi-device tests on the virtual 8-CPU mesh (SURVEY.md §4 item d)."""
import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest

import bayesianfiltering_tpu.inference as gf
from bayesianfiltering_tpu.models import zoo
from bayesianfiltering_tpu.parallel import (
    batched_filter,
    make_mesh,
    sharded_bootstrap_particle_filter,
)


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) >= 8, "conftest must provide 8 CPU devices"
    return make_mesh((8,), ("batch",))


@pytest.fixture(scope="module")
def particle_mesh():
    return make_mesh((8,), ("particle",))


class TestBatchedFilter:
    def test_batched_ekf_matches_loop(self, mesh8):
        model, params, _ = zoo.linear_gaussian(2, 2)
        B, T = 16, 20
        keys = jr.split(jr.PRNGKey(0), B)
        emissions = jnp.stack(
            [model.sample(params, k, T)[1] for k in keys]
        )
        out = batched_filter(
            gf.extended_kalman_filter, params, emissions, mesh=mesh8
        )
        assert out.filtered_means.shape == (B, T, 2)
        # spot-check one sequence against the single-sequence filter
        single = gf.extended_kalman_filter(params, emissions[3])
        np.testing.assert_allclose(out.filtered_means[3],
                                   single.filtered_means, rtol=1e-4,
                                   atol=1e-5)

    def test_batched_filter_no_mesh(self):
        model, params, _ = zoo.linear_gaussian(2, 2)
        emissions = jnp.stack(
            [model.sample(params, jr.PRNGKey(i), 10)[1] for i in range(4)]
        )
        out = batched_filter(gf.extended_kalman_filter, params, emissions)
        assert out.filtered_means.shape == (4, 10, 2)

    def test_repeated_calls_hit_jit_cache(self):
        """batched_filter must not re-trace per call:
        same configuration + new emission values → one trace."""
        model, params, _ = zoo.linear_gaussian(2, 2)
        traces = []

        def counting_filter(params, emissions, inputs=None):
            traces.append(1)
            return gf.extended_kalman_filter(params, emissions, inputs=inputs)

        for seed in range(3):
            emissions = jnp.stack(
                [model.sample(params, jr.PRNGKey(seed * 4 + i), 10)[1]
                 for i in range(4)]
            )
            out = batched_filter(counting_filter, params, emissions)
        assert out.filtered_means.shape == (4, 10, 2)
        assert len(traces) == 1, f"re-traced {len(traces)} times"

    def test_agsf_config_through_cache(self):
        """List hyper-params (num_components) and PRNG-key args survive the
        static/traced partition."""
        model, params, _ = zoo.linear_gaussian(2, 2)
        emissions = jnp.stack(
            [model.sample(params, jr.PRNGKey(i), 8)[1] for i in range(4)]
        )
        post, _ = batched_filter(
            gf.augmented_gaussian_sum_filter, params, emissions,
            [3, 2, 2], jr.PRNGKey(0), 1, (0.1, 0.1),
        )
        assert post.means.shape == (4, 3, 8, 2)


class TestShardedBPF:
    def test_sharded_bpf_tracks_kalman(self, particle_mesh):
        model, params, bpf_params = zoo.linear_gaussian(2, 2, r=0.5)
        _, emissions = model.sample(params, jr.PRNGKey(1), 30)
        out = sharded_bootstrap_particle_filter(
            bpf_params, emissions, 4096, particle_mesh, key=jr.PRNGKey(2)
        )
        assert out["means"].shape == (30, 2)
        assert out["ess"].shape == (30,)
        from bayesianfiltering_tpu.ops import kalman_filter

        kf = kalman_filter(zoo.linear_gaussian_lgssm(2, 2, r=0.5), emissions)
        err = float(jnp.max(jnp.abs(out["means"] - kf.filtered_means)))
        assert err < 0.4, err

    def test_sharded_bpf_gather_mode(self, particle_mesh):
        model, params, bpf_params = zoo.linear_gaussian(2, 2, r=0.5)
        _, emissions = model.sample(params, jr.PRNGKey(1), 15)
        out = sharded_bootstrap_particle_filter(
            bpf_params, emissions, 1024, particle_mesh, key=jr.PRNGKey(2),
            resampling_mode="gather",
        )
        assert bool(jnp.all(jnp.isfinite(out["means"])))
        assert bool(jnp.all(out["ess"] > 0)), "ESS must stay positive"

    def test_weak_scaling_consistent_across_mesh_sizes(self):
        """Weak scaling: constant per-device particle
        count as the mesh doubles 1→2→4→8; every mesh size must produce a
        consistent posterior (same model, within MC error of the Kalman
        truth), and the local shard shapes must stay fixed."""
        model, params, bpf_params = zoo.linear_gaussian(2, 2, r=0.5)
        _, emissions = model.sample(params, jr.PRNGKey(7), 20)
        from bayesianfiltering_tpu.ops import kalman_filter

        kf = kalman_filter(zoo.linear_gaussian_lgssm(2, 2, r=0.5), emissions)
        per_device = 1024
        for n_dev in (1, 2, 4, 8):
            mesh = make_mesh((n_dev,), ("particle",))
            out = sharded_bootstrap_particle_filter(
                bpf_params, emissions, per_device * n_dev, mesh,
                key=jr.PRNGKey(8),
            )
            assert out["means"].shape == (20, 2)
            err = float(jnp.max(jnp.abs(out["means"] - kf.filtered_means)))
            assert err < 0.5, (n_dev, err)
            ess = out["ess"]
            assert bool(jnp.all(ess > 0)) and bool(
                jnp.all(ess <= per_device * n_dev + 1e-3)
            )

    def test_sharded_matches_single_device_statistics(self, particle_mesh):
        """Sharded and single-device BPF agree statistically (different key
        streams, same posterior): compare means within MC error."""
        model, params, bpf_params = zoo.linear_gaussian(2, 2, r=0.5)
        _, emissions = model.sample(params, jr.PRNGKey(3), 20)
        sharded = sharded_bootstrap_particle_filter(
            bpf_params, emissions, 8192, particle_mesh, key=jr.PRNGKey(4)
        )
        single = gf.bootstrap_particle_filter(
            bpf_params, emissions, 8192, jr.PRNGKey(5), store="summary"
        )
        err = float(jnp.max(jnp.abs(sharded["means"] - single["means"])))
        assert err < 0.3, err


class TestShardedGSF:
    """parallel/mixture.py: component-sharded GSF vs the single-device
    filter — identical posteriors, collectives only for normalization."""

    def test_matches_single_device(self):
        from bayesianfiltering_tpu.parallel import make_mesh
        from bayesianfiltering_tpu.parallel.mixture import (
            sharded_gaussian_sum_filter,
        )

        mesh = make_mesh((8,), ("mixture",))
        model, params, _ = zoo.bearings_only_tracking()
        T, M = 15, 16
        inputs = zoo.bot_maneuver_inputs(T)
        _, emissions = model.sample(params, jr.PRNGKey(0), T, inputs=inputs)
        ref = gf.gaussian_sum_filter(params, emissions, M, 1, inputs)
        out = sharded_gaussian_sum_filter(params, emissions, M, mesh,
                                          inputs=inputs)
        np.testing.assert_allclose(out.weights, ref.weights, rtol=2e-4,
                                   atol=2e-5)
        np.testing.assert_allclose(out.means, ref.means, rtol=2e-4,
                                   atol=2e-4)
        np.testing.assert_allclose(out.covariances, ref.covariances,
                                   rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(out.marginal_loglik, ref.marginal_loglik,
                                   rtol=1e-4)

    def test_indivisible_raises(self):
        from bayesianfiltering_tpu.parallel import make_mesh
        from bayesianfiltering_tpu.parallel.mixture import (
            sharded_gaussian_sum_filter,
        )

        mesh = make_mesh((8,), ("mixture",))
        model, params, _ = zoo.bearings_only_tracking()
        inputs = zoo.bot_maneuver_inputs(5)
        _, emissions = model.sample(params, jr.PRNGKey(0), 5, inputs=inputs)
        with pytest.raises(ValueError, match="divisible"):
            sharded_gaussian_sum_filter(params, emissions, 12, mesh,
                                        inputs=inputs)

    def test_sharded_agsf_matches_single_device(self):
        """The mixture-sharded flagship AGSF must reproduce the
        single-device engine exactly (same keys: sliced global split noise,
        gathered identical reduction)."""
        from bayesianfiltering_tpu.parallel import make_mesh
        from bayesianfiltering_tpu.parallel.mixture import sharded_agsf

        mesh = make_mesh((8,), ("mixture",))
        model, params, _ = zoo.bearings_only_tracking()
        T = 12
        inputs = zoo.bot_maneuver_inputs(T)
        _, emissions = model.sample(params, jr.PRNGKey(0), T, inputs=inputs)
        ref, _ = gf.augmented_gaussian_sum_filter(
            params, emissions, [16, 2, 2], jr.PRNGKey(5), 1, (0.1, 0.1),
            inputs, reduction="systematic",
        )
        out = sharded_agsf(params, emissions, [16, 2, 2], mesh,
                           key=jr.PRNGKey(5), opt_args=(0.1, 0.1),
                           inputs=inputs, reduction="systematic")
        np.testing.assert_allclose(out.weights, ref.weights, rtol=2e-4,
                                   atol=2e-5)
        np.testing.assert_allclose(out.means, ref.means, rtol=2e-4,
                                   atol=2e-4)
        np.testing.assert_allclose(out.covariances, ref.covariances,
                                   rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(out.marginal_loglik, ref.marginal_loglik,
                                   rtol=1e-4)

    def test_sharded_unscented_agsf_runs(self):
        from bayesianfiltering_tpu.ops import ParamsUKF
        from bayesianfiltering_tpu.parallel import make_mesh
        from bayesianfiltering_tpu.parallel.mixture import sharded_agsf

        mesh = make_mesh((4,), ("mixture",))
        model, params, _ = zoo.stochastic_volatility()
        T = 8
        inputs = jnp.array([0] * 4 + [1] * 4)
        _, emissions = model.sample(params, jr.PRNGKey(0), T, inputs=inputs)
        up = ParamsUKF(alpha=1.0)
        ref, _ = gf.unscented_agsf(
            params, up, emissions, [4, 2, 2], jr.PRNGKey(3), 1, (0.1, 0.1),
            inputs, reduction="systematic",
        )
        out = sharded_agsf(params, emissions, [4, 2, 2], mesh,
                           key=jr.PRNGKey(3), opt_args=(0.1, 0.1),
                           inputs=inputs, moments="ukf", uparams=up,
                           reduction="systematic")
        np.testing.assert_allclose(out.means, ref.means, rtol=5e-4,
                                   atol=5e-4)

    def test_sharded_agsf_local_reduction_statistics(self):
        """reduction="local": no bank gather, shard-local mass-preserving
        systematic reduction. Not bit-equal to the global reduction, so pin
        (a) exact weight normalization, (b) estimator-level agreement of
        the mixture point estimate with the gathered mode at a bank size
        where the docstring's scaling story applies (M*N*L >= 1e4)."""
        from bayesianfiltering_tpu.parallel import make_mesh
        from bayesianfiltering_tpu.parallel.mixture import sharded_agsf

        mesh = make_mesh((8,), ("mixture",))
        model, params, _ = zoo.linear_gaussian(1, 1)
        T = 8
        _, emissions = model.sample(params, jr.PRNGKey(1), T)
        num_components = [640, 4, 4]  # M*N*L = 10240
        kw = dict(key=jr.PRNGKey(7), opt_args=(0.2, 0.2))
        ref = sharded_agsf(params, emissions, num_components, mesh,
                           reduction="systematic", **kw)
        out = sharded_agsf(params, emissions, num_components, mesh,
                           reduction="local", **kw)
        # (a) mass preservation: weights normalized exactly each step
        np.testing.assert_allclose(np.sum(out.weights, axis=0),
                                   np.ones(T), rtol=1e-5)
        # (b) point estimates agree at resampling-noise level
        pt_ref = np.einsum("mt,mtd->td", ref.weights, ref.means)
        pt_out = np.einsum("mt,mtd->td", out.weights, out.means)
        spread = np.sqrt(np.einsum(
            "mt,mtdd->td", ref.weights, ref.covariances)).mean()
        assert np.max(np.abs(pt_ref - pt_out)) < 0.5 * max(spread, 0.1), (
            pt_ref, pt_out)
        # Loglik agreement at resampling-noise level: the totals here are
        # near zero (|ll| ~ 0.4 at T=8), so a relative tolerance alone is
        # ill-posed — pin ~0.02 nats/step absolute alongside it.
        np.testing.assert_allclose(out.marginal_loglik, ref.marginal_loglik,
                                   rtol=0.05, atol=0.02 * T)

    def test_sharded_agsf_local_reduction_at_1e5_bank(self):
        """The docstring's M ≥ 1e5 scaling claim, exercised AT that size:
        M·N·L = 102400 components in flight on the 8-mesh with the
        gather-free local reduction — two steps, correctness-only (the
        timed gathered-vs-local A/B at this size lives in
        experiments/sharded_agsf_scale.py).
        Pins mass preservation, finiteness, and the shard-local shapes."""
        from bayesianfiltering_tpu.parallel import make_mesh
        from bayesianfiltering_tpu.parallel.mixture import sharded_agsf

        mesh = make_mesh((8,), ("mixture",))
        model, params, _ = zoo.bearings_only_tracking()
        T = 2
        inputs = zoo.bot_maneuver_inputs(T)
        _, emissions = model.sample(params, jr.PRNGKey(5), T, inputs=inputs)
        M, N, L = 6400, 4, 4  # M·N·L = 102400
        out = sharded_agsf(params, emissions, [M, N, L], mesh,
                           key=jr.PRNGKey(9), opt_args=(0.1, 0.1),
                           inputs=inputs, reduction="local")
        assert out.means.shape == (M, T, 4)
        assert bool(jnp.isfinite(out.means).all())
        assert bool(jnp.isfinite(out.marginal_loglik).all())
        np.testing.assert_allclose(np.sum(out.weights, axis=0),
                                   np.ones(T), rtol=1e-5)

    def test_weak_scaling_device_counts(self):
        """Per-device bank constant as the mesh grows: outputs stay
        consistent with the single-device filter at every device count."""
        from bayesianfiltering_tpu.parallel import make_mesh
        from bayesianfiltering_tpu.parallel.mixture import (
            sharded_gaussian_sum_filter,
        )

        model, params, _ = zoo.bearings_only_tracking()
        T = 10
        inputs = zoo.bot_maneuver_inputs(T)
        _, emissions = model.sample(params, jr.PRNGKey(2), T, inputs=inputs)
        per_device = 2
        for n_dev in (2, 4, 8):
            M = per_device * n_dev
            mesh = make_mesh((n_dev,), ("mixture",))
            ref = gf.gaussian_sum_filter(params, emissions, M, 1, inputs)
            out = sharded_gaussian_sum_filter(params, emissions, M, mesh,
                                              inputs=inputs)
            np.testing.assert_allclose(out.means, ref.means, rtol=2e-4,
                                       atol=2e-4)
            np.testing.assert_allclose(out.marginal_loglik,
                                       ref.marginal_loglik, rtol=1e-4)
