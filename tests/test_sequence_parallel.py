"""Sequence-parallel filtering: the associative-scan Kalman filter with the
TIME axis sharded over the device mesh (SURVEY.md §5.7's long-sequence
scaling story). `lax.associative_scan` is log-depth, so XLA turns the
time-sharded input into a cross-device scan with collectives."""
import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from bayesianfiltering_tpu.models import zoo
from bayesianfiltering_tpu.ops import kalman_filter, parallel_kalman_filter
from bayesianfiltering_tpu.ops.associative import parallel_kalman_smoother
from bayesianfiltering_tpu.ops.linear import kalman_smoother
from bayesianfiltering_tpu.parallel import make_mesh


class TestTimeShardedParallelKF:
    def test_time_sharded_matches_sequential(self):
        assert len(jax.devices()) >= 8
        mesh = make_mesh((8,), ("time",))
        model, params, _ = zoo.linear_gaussian(3, 3)
        lg = zoo.linear_gaussian_lgssm(3, 3)
        T = 256  # divisible by 8
        _, emissions = model.sample(params, jr.PRNGKey(0), T)

        seq = kalman_filter(lg, emissions)

        sharded = jax.device_put(
            emissions, NamedSharding(mesh, P("time", None))
        )
        par = jax.jit(lambda e: parallel_kalman_filter(lg, e))(sharded)
        np.testing.assert_allclose(par.filtered_means, seq.filtered_means,
                                   rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(par.marginal_loglik, seq.marginal_loglik,
                                   rtol=1e-3)

    def test_long_sequence_sharded(self):
        """A 16k-step sequence filtered with the time axis sharded 8 ways."""
        mesh = make_mesh((8,), ("time",))
        lg = zoo.linear_gaussian_lgssm(2, 2)
        model, params, _ = zoo.linear_gaussian(2, 2)
        _, emissions = model.sample(params, jr.PRNGKey(1), 16384)
        sharded = jax.device_put(
            emissions, NamedSharding(mesh, P("time", None))
        )
        post = jax.jit(lambda e: parallel_kalman_filter(lg, e))(sharded)
        assert post.filtered_means.shape == (16384, 2)
        assert bool(jnp.all(jnp.isfinite(post.filtered_means)))


class TestElementConstruction:
    def test_hoisted_elements_match_per_step_oracle(self):
        """_elements_time_invariant (constant algebra hoisted out of the T
        axis) must equal the per-step _first_element/_generic_element
        construction it replaced — that pair stays as the oracle."""
        from bayesianfiltering_tpu.ops import associative as A

        lg = zoo.linear_gaussian_lgssm(3, 2)
        model, params, _ = zoo.linear_gaussian(3, 2)
        _, emissions = model.sample(params, jr.PRNGKey(7), 64)

        hoisted = A._elements_time_invariant(lg, emissions)
        first = A._first_element(lg, emissions[0])
        rest = jax.vmap(lambda y: A._generic_element(lg, y))(emissions[1:])
        ref = tuple(jnp.concatenate([f[None], r], axis=0)
                    for f, r in zip(first, rest))
        for h, r in zip(hoisted, ref):
            assert h.shape == r.shape
            np.testing.assert_allclose(h, r, rtol=1e-5, atol=1e-6)


class TestParallelCombineSolvers:
    def test_woodbury_matches_native(self):
        """The matmul-only Woodbury combine must agree with the native-solve
        combine (same associative elements, different inverse evaluation)."""
        lg = zoo.linear_gaussian_lgssm(3, 2)
        model, params, _ = zoo.linear_gaussian(3, 2)
        _, emissions = model.sample(params, jr.PRNGKey(3), 300)
        w = parallel_kalman_filter(lg, emissions, solver="woodbury")
        n = parallel_kalman_filter(lg, emissions, solver="native")
        np.testing.assert_allclose(w.filtered_means, n.filtered_means,
                                   rtol=2e-3, atol=2e-4)
        np.testing.assert_allclose(w.filtered_covariances,
                                   n.filtered_covariances,
                                   rtol=2e-3, atol=2e-4)


class TestParallelSmoother:
    @pytest.mark.parametrize("dims", [(2, 2), (3, 1)])
    def test_matches_sequential_rts(self, dims):
        dx, dy = dims
        lg = zoo.linear_gaussian_lgssm(dx, dy)
        model, params, _ = zoo.linear_gaussian(dx, dy)
        _, emissions = model.sample(params, jr.PRNGKey(2), 200)
        seq = kalman_smoother(lg, emissions)
        par = parallel_kalman_smoother(lg, emissions)
        np.testing.assert_allclose(par.smoothed_means, seq.smoothed_means,
                                   rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(
            par.smoothed_covariances, seq.smoothed_covariances,
            rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(par.filtered_means, seq.filtered_means,
                                   rtol=1e-3, atol=1e-4)

class TestChunkedScan:
    """The two-level (chunked) scan schedule must match the flat
    ``lax.associative_scan`` and the sequential oracle bit-for-rounding."""

    @pytest.mark.parametrize("T,chunk", [(7, 16), (64, 16), (257, 64),
                                         (1000, 128)])
    def test_chunked_matches_sequential(self, T, chunk):
        lg = zoo.linear_gaussian_lgssm(3, 2)
        model, params, _ = zoo.linear_gaussian(3, 2)
        _, emissions = model.sample(params, jr.PRNGKey(5), T)
        seq = kalman_smoother(lg, emissions)
        par = parallel_kalman_smoother(lg, emissions, chunk=chunk)
        np.testing.assert_allclose(par.filtered_means, seq.filtered_means,
                                   rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(par.smoothed_means, seq.smoothed_means,
                                   rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(
            par.smoothed_covariances, seq.smoothed_covariances,
            rtol=1e-3, atol=1e-4)

    def test_auto_threshold_paths_agree(self):
        """T above the auto threshold (chunked) vs forced flat (None)."""
        lg = zoo.linear_gaussian_lgssm(2, 2)
        model, params, _ = zoo.linear_gaussian(2, 2)
        _, emissions = model.sample(params, jr.PRNGKey(6), 5000)
        auto = parallel_kalman_smoother(lg, emissions)            # chunked
        flat = parallel_kalman_smoother(lg, emissions, chunk=None)
        np.testing.assert_allclose(auto.smoothed_means, flat.smoothed_means,
                                   rtol=1e-3, atol=1e-4)

    def test_chunked_native_solver(self):
        lg = zoo.linear_gaussian_lgssm(3, 2)
        model, params, _ = zoo.linear_gaussian(3, 2)
        _, emissions = model.sample(params, jr.PRNGKey(7), 300)
        w = parallel_kalman_filter(lg, emissions, chunk=32)
        n = parallel_kalman_filter(lg, emissions, solver="native", chunk=32)
        np.testing.assert_allclose(w.filtered_means, n.filtered_means,
                                   rtol=2e-3, atol=2e-4)

    def test_chunked_time_sharded(self):
        """Chunked schedule under a time-sharded input on the 8-CPU mesh."""
        mesh = make_mesh((8,), ("time",))
        lg = zoo.linear_gaussian_lgssm(2, 2)
        model, params, _ = zoo.linear_gaussian(2, 2)
        _, emissions = model.sample(params, jr.PRNGKey(8), 2048)
        sharded = jax.device_put(
            emissions, NamedSharding(mesh, P("time", None))
        )
        post = jax.jit(
            lambda e: parallel_kalman_filter(lg, e, chunk=64))(sharded)
        seq = kalman_filter(lg, emissions)
        np.testing.assert_allclose(post.filtered_means, seq.filtered_means,
                                   rtol=1e-3, atol=1e-4)


class TestParallelSmootherSharded:
    def test_time_sharded_smoother(self):
        mesh = make_mesh((8,), ("time",))
        lg = zoo.linear_gaussian_lgssm(2, 2)
        model, params, _ = zoo.linear_gaussian(2, 2)
        _, emissions = model.sample(params, jr.PRNGKey(4), 2048)
        sharded = jax.device_put(
            emissions, NamedSharding(mesh, P("time", None))
        )
        post = jax.jit(lambda e: parallel_kalman_smoother(lg, e))(sharded)
        assert post.smoothed_means.shape == (2048, 2)
        assert bool(jnp.all(jnp.isfinite(post.smoothed_means)))
