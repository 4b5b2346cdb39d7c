"""The Triton bank kernels (ops/bank_update.py): interpret mode on CPU
against the XLA reference, the gradient rule, and the choice of
implementation. The compiled kernels run only on a GPU (marker ``gpu``)."""
import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest

import bayesianfiltering_tpu.inference as gf
from bayesianfiltering_tpu.models import zoo
from bayesianfiltering_tpu.ops import bank_update as bu
from bayesianfiltering_tpu.ops import ekf as _ekf


def _bank(m, dx, dy, seed=12):
    k = jr.split(jr.PRNGKey(seed), 5)
    ms = jr.normal(k[0], (m, dx))
    a = jr.normal(k[1], (m, dx, dx))
    Ps = jnp.einsum("mik,mjk->mij", a, a) + 0.5 * jnp.eye(dx)
    Hx = jr.normal(k[2], (m, dy, dx))
    b = jr.normal(k[3], (m, dy, dy))
    Rt = jnp.einsum("mik,mjk->mij", b, b) * 0.1 + 0.05 * jnp.eye(dy)
    innov = jr.normal(k[4], (m, dy))
    return ms, Ps, Hx, Rt, innov


def _predict_bank(m, dx, dq, seed=13):
    k = jr.split(jr.PRNGKey(seed), 3)
    Fx = jr.normal(k[0], (m, dx, dx))
    a = jr.normal(k[1], (m, dx, dx))
    P = jnp.einsum("mik,mjk->mij", a, a) + jnp.eye(dx)
    Fq = jr.normal(k[2], (m, dx, dq))
    Q = jnp.diag(jnp.arange(1.0, dq + 1))
    return Fx, P, Fq, Q


@pytest.fixture
def kernel_everywhere(monkeypatch):
    """Route every bank primitive through the kernel in interpret mode."""
    monkeypatch.setattr(bu, "bank_impl", lambda *a, **k: "interpret")


class TestBankUpdateKernel:
    # tails: 130 and 37 are not multiples of the 128-component block
    @pytest.mark.parametrize("m,dx,dy", [(128, 4, 2), (130, 4, 1),
                                         (200, 2, 1), (37, 4, 4), (5, 1, 1),
                                         (300, 3, 2)])
    def test_matches_xla(self, m, dx, dy):
        args = _bank(m, dx, dy)
        ref = bu._update_xla(*args, 0.0)
        out = bu._update_pallas(*args, 0.0, interpret=True)
        for name, r, o in zip(("ll", "mean", "cov", "gain"), ref, out):
            assert o.shape == r.shape, name
            np.testing.assert_allclose(o, r, rtol=5e-4, atol=5e-4,
                                       err_msg=name)

    def test_absolute_jitter(self):
        args = _bank(50, 3, 2)
        ref = bu._update_xla(*args, 0.3)
        out = bu._update_pallas(*args, 0.3, interpret=True)
        for r, o in zip(ref, out):
            np.testing.assert_allclose(o, r, rtol=5e-4, atol=5e-4)

    def test_vmapped_adds_a_grid_axis(self):
        """Under vmap (e.g. a batch of GSFs) the kernel gains a batch grid
        axis; results equal the vmapped reference."""
        args = [jnp.stack([x, 1.1 * x, 0.9 * x]) for x in _bank(130, 4, 1)]
        out = jax.vmap(lambda *a: bu._update_pallas(*a, 0.0,
                                                    interpret=True))(*args)
        ref = jax.vmap(lambda *a: bu._update_xla(*a, 0.0))(*args)
        for r, o in zip(ref, out):
            np.testing.assert_allclose(o, r, rtol=5e-4, atol=5e-4)


class TestBankPredictKernel:
    @pytest.mark.parametrize("m,dx,dq", [(150, 4, 3), (129, 4, 4),
                                         (7, 2, 1)])
    def test_matches_xla(self, m, dx, dq):
        args = _predict_bank(m, dx, dq)
        np.testing.assert_allclose(
            bu._predict_pallas(*args, interpret=True), bu._predict_xla(*args),
            rtol=5e-4, atol=5e-4)


class TestBankWrappers:
    @pytest.mark.parametrize("num_iter", [1, 3])
    def test_iterated_update_matches_vmapped_iekf(self, num_iter,
                                                  kernel_everywhere):
        m, dx, dy = 130, 4, 2
        k = jr.split(jr.PRNGKey(14), 3)
        ms = jr.normal(k[0], (m, dx))
        a = jr.normal(k[1], (m, dx, dx))
        Ps = jnp.einsum("mik,mjk->mij", a, a) + 0.5 * jnp.eye(dx)
        R, r0 = jnp.eye(dy) * 2.5e-5, jnp.zeros(dy)
        y = jr.normal(k[2], (dy,))
        h = lambda x, r, u: jnp.array(
            [jnp.sqrt(x[0] ** 2 + x[2] ** 2), jnp.arctan2(x[2], x[0])]) + r
        H_x, H_r = jax.jacfwd(h, 0), jax.jacfwd(h, 1)
        vu = jax.vmap(_ekf.ekf_condition_on_iterated,
                      in_axes=(0, 0) + (None,) * 9)
        ref = vu(ms, Ps, h, H_x, H_r, R, r0, 0.0, y, num_iter, 0.0)
        out = bu.bank_ekf_condition_on_iterated(ms, Ps, h, H_x, H_r, R, r0,
                                                0.0, y, num_iter, 0.0)
        for r, o in zip(ref, out):
            np.testing.assert_allclose(o, r, rtol=1e-3, atol=1e-3)

    def test_predict_matches_vmapped_ekf(self, kernel_everywhere):
        m, dx = 70, 4
        ms = jr.normal(jr.PRNGKey(1), (m, dx))
        Ps = _predict_bank(m, dx, 2)[1]
        W = jr.normal(jr.PRNGKey(2), (dx, dx)) / 3
        G = jr.normal(jr.PRNGKey(3), (dx, 2))
        f = lambda x, q, u: jnp.tanh(W @ x) + G @ q
        F_x, F_q = jax.jacfwd(f, 0), jax.jacfwd(f, 1)
        Q, q0 = jnp.eye(2), jnp.zeros(2)
        ref = jax.vmap(_ekf.ekf_predict, in_axes=(0, 0) + (None,) * 6)(
            ms, Ps, f, F_x, F_q, Q, q0, 0.0)
        out = bu.bank_ekf_predict(ms, Ps, f, F_x, F_q, Q, q0, 0.0)
        for r, o in zip(ref, out):
            np.testing.assert_allclose(o, r, rtol=5e-4, atol=5e-4)

    def test_gsf_and_agsf_with_kernel_match_xla(self, monkeypatch):
        """The whole filter, bank steps through the interpreted kernel, vs
        the XLA bank (BOT: dx=4, dq=2, dy=1)."""
        model, params, _ = zoo.bearings_only_tracking()
        inputs = zoo.bot_maneuver_inputs(12)
        _, em = model.sample(params, jr.PRNGKey(0), 12, inputs=inputs)

        def run():
            g = gf.gaussian_sum_filter(params, em, 8, 1, inputs)
            a = gf.augmented_gaussian_sum_filter(params, em, [4, 2, 2],
                                                 jr.PRNGKey(1), 1,
                                                 (0.1, 0.1), inputs)[0]
            return g.means, g.marginal_loglik, a.means

        ref = run()
        monkeypatch.setattr(bu, "bank_impl", lambda *a, **k: "interpret")
        out = run()
        for r, o in zip(ref, out):
            np.testing.assert_allclose(o, r, rtol=2e-3, atol=2e-3)


class TestGradientRule:
    """The kernels are forward-only; the custom VJP differentiates the XLA
    reference. Gradients through the kernel path equal the reference's."""

    @pytest.mark.parametrize("argnum", [0, 1, 2, 3, 4])
    def test_update_grad_matches_reference(self, argnum):
        args = list(_bank(40, 3, 2))

        def loss(impl, x):
            a = list(args)
            a[argnum] = x
            if impl == "ref":
                ll, mean, cov, K = bu._update_xla(*a, 0.0)
            else:
                ll, mean, cov, K = bu._bank_chol_update(*a, 0.0, impl)
            return jnp.sum(ll) + jnp.sum(mean) + jnp.sum(cov) + jnp.sum(K)

        g_ref = jax.grad(lambda x: loss("ref", x))(args[argnum])
        g_ker = jax.grad(lambda x: loss("interpret", x))(args[argnum])
        assert bool(jnp.isfinite(g_ker).all())
        np.testing.assert_allclose(g_ker, g_ref, rtol=1e-5, atol=1e-5)

    def test_predict_grad_matches_reference(self):
        Fx, P, Fq, Q = _predict_bank(20, 3, 2)
        g_ref = jax.grad(lambda p: jnp.sum(bu._predict_xla(Fx, p, Fq, Q)))(P)
        g_ker = jax.grad(lambda p: jnp.sum(
            bu._bank_predict_cov(Fx, p, Fq, Q, "interpret")))(P)
        np.testing.assert_allclose(g_ker, g_ref, rtol=1e-5, atol=1e-5)

    def test_traced_jitter_takes_differentiable_xla_path(self):
        args = _bank(10, 2, 1)
        g = jax.grad(lambda j: jnp.sum(bu.bank_chol_update(*args, j)[0]))(0.1)
        assert bool(jnp.isfinite(g))


class TestDispatchTable:
    """bank_impl: the one place the bank implementation is chosen."""

    @pytest.mark.parametrize("backend,dims,dtype,jitter,expect", [
        ("gpu", (4, 1), jnp.float32, 0.0, "triton"),
        ("gpu", (4, 4), jnp.float32, 0.0, "triton"),
        ("gpu", (5, 1), jnp.float32, 0.0, "xla"),
        ("gpu", (4, 8), jnp.float32, 0.0, "xla"),
        ("gpu", (4, 1), jnp.float64, 0.0, "xla"),
        ("gpu", (4, 1), jnp.float32, jnp.float32(0.1), "xla"),
        ("cpu", (4, 1), jnp.float32, 0.0, "xla"),
    ])
    def test_choice(self, monkeypatch, backend, dims, dtype, jitter, expect):
        monkeypatch.setattr(jax, "default_backend", lambda: backend)
        assert bu.bank_impl(*dims, dtype=dtype, jitter=jitter) == expect

    def test_default_device_cpu_overrides_gpu_backend(self, monkeypatch):
        """A CPU computation traced next to a GPU (jax.default_device) takes
        the XLA path: Triton kernels cannot lower for the CPU."""
        monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
        with jax.default_device(jax.devices("cpu")[0]):
            assert bu.bank_impl(4, 1, dtype=jnp.float32) == "xla"

    def test_cpu_wrappers_run_the_reference(self):
        args = _bank(20, 4, 1)
        out = bu.bank_chol_update(*args)
        ref = bu._update_xla(*args, 0.0)
        for r, o in zip(ref, out):
            np.testing.assert_array_equal(o, r)


@pytest.mark.gpu
class TestCompiledKernel:
    """Compiled through Triton: runs only where JAX sees a GPU."""

    def test_update_and_predict_match_xla(self, gpu):
        args = _bank(1000, 4, 1)
        for r, o in zip(bu._update_xla(*args, 0.0),
                        jax.jit(lambda *a: bu._update_pallas(*a, 0.0))(*args)):
            np.testing.assert_allclose(o, r, rtol=1e-4, atol=1e-4)
        pargs = _predict_bank(1000, 4, 2)
        np.testing.assert_allclose(jax.jit(bu._predict_pallas)(*pargs),
                                   bu._predict_xla(*pargs),
                                   rtol=1e-4, atol=1e-4)
