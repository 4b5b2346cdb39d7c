"""Model zoo: the benchmark SSMs scattered across the reference's
experiments and notebooks, reified as constructors.

Each constructor returns ``(model, params, bpf_params)`` — a
:class:`NonlinearSSM`, its :class:`ParamsNLSSM`, and a matching
:class:`ParamsBPF` whose emission log-density assumes Gaussian observation
noise unless stated otherwise. All dynamics/emission functions use the
non-additive calling convention ``f(x, q, u)`` / ``h(x, r, u)``.

Provenance:
* bearing-only tracking (+ maneuvering variant) — ref: docs/tests/test_inference.py:22-56
  and docs/experiments/BOT_Experiment_script.py
* markov-switching stochastic volatility — ref: docs/experiments/adaptive_experiment.py:34-66
* Lorenz-63 — ref: docs/experiments/exp_lorentz63.py:37-42
* Lorenz-96 — ref: gaussfiltax/nonlinearities.py:38-51
* scalar growth (UNGM) — ref: docs/experiments/exp_lorentz63.py:30 (commented
  classic), the standard univariate nonlinear growth model
* quadratic measurement — ref: docs/experiments/exp_quadratic_measurements.py,
  ICASSP-2023 notebook (f=0.8x, g=0.1x²)
* linear-Gaussian — ref: docs/experiments/adaptive_experiment.py:60-65
"""
from __future__ import annotations

from typing import Optional

import jax.numpy as jnp

from bayesianfiltering_tpu.distributions import mvn_logpdf
from bayesianfiltering_tpu.models.nonlinear import NonlinearSSM
from bayesianfiltering_tpu.models.params import ParamsBPF, ParamsNLSSM
from bayesianfiltering_tpu.ops.linear import ParamsLGSSM
from bayesianfiltering_tpu.utils.angles import angular_residual


def _bundle(state_dim, state_noise_dim, emission_dim, emission_noise_dim,
            mu0, Sigma0, f, Q, h, R, log_prob=None, **jacobians):
    model = NonlinearSSM(state_dim, state_noise_dim, emission_dim,
                         emission_noise_dim)
    params = ParamsNLSSM(
        initial_mean=mu0,
        initial_covariance=Sigma0,
        dynamics_function=f,
        dynamics_noise_bias=jnp.zeros(state_noise_dim),
        dynamics_noise_covariance=Q,
        emission_function=h,
        emission_noise_bias=jnp.zeros(emission_noise_dim),
        emission_noise_covariance=R,
        **jacobians,
    )
    if log_prob is None:
        r0 = jnp.zeros(emission_noise_dim)
        log_prob = lambda x, y, u: mvn_logpdf(y, h(x, r0, u), R)
    bpf_params = ParamsBPF(*params[:8], emission_distribution_log_prob=log_prob)
    return model, params, bpf_params


def quadratic_measurement(a: float = 0.8, b: float = 0.1,
                          q: float = 1.0, r: float = 1.0):
    """1-D f=a·x, g=b·x² model of the ICASSP-2023 experiment
    (ref: docs/notebooks/Experiment_ICASSP_2023.ipynb; BASELINE.md row 1)."""
    f = lambda x, qn, u: a * x + qn
    h = lambda x, rn, u: b * x**2 + rn
    return _bundle(1, 1, 1, 1, jnp.zeros(1), jnp.eye(1), f, q * jnp.eye(1),
                   h, r * jnp.eye(1))


def sine_quadratic(a: float = 10.0, q: float = 1.0, r: float = 1.0):
    """1-D f = sin(a·x) + q, g = x·x + r — the "Experiment A" model
    (ref: docs/notebooks/Experiment A.ipynb cell 2, ``f1``/``g1``;
    BASELINE.md rows 17-18). The sin(10x) dynamics fold the state into
    [−1, 1] with ~3 oscillations per unit, and the quadratic emission hides
    the sign — a severely multimodal posterior that motivates the
    splitting filters."""
    f = lambda x, qn, u: jnp.sin(a * x) + qn
    h = lambda x, rn, u: jnp.dot(x, x) + rn
    return _bundle(1, 1, 1, 1, jnp.zeros(1), jnp.eye(1), f, q * jnp.eye(1),
                   h, r * jnp.eye(1))


def scalar_growth(q: float = 10.0, r: float = 1.0):
    """Univariate nonlinear growth model (UNGM): the classic severe EKF
    stress test, x' = x/2 + 25x/(1+x²) + 8cos(1.2u), y = x²/20
    (BASELINE config 2 stand-in for ALA/test-nonlinear.py workloads)."""
    f = lambda x, qn, u: 0.5 * x + 25.0 * x / (1.0 + x**2) + 8.0 * jnp.cos(1.2 * jnp.squeeze(u)) + qn
    h = lambda x, rn, u: x**2 / 20.0 + rn
    return _bundle(1, 1, 1, 1, jnp.zeros(1), 5.0 * jnp.eye(1), f,
                   q * jnp.eye(1), h, r * jnp.eye(1))


def linear_gaussian(state_dim: int = 3, emission_dim: int = 3,
                    a: float = 0.8, h_scale: float = 0.1,
                    q: float = 1.0, r: float = 0.1):
    """Linear-Gaussian SSM (ref: docs/experiments/adaptive_experiment.py:60-65).
    Also returns closed-form testability via :func:`linear_gaussian_lgssm`."""
    A = a * jnp.eye(state_dim)
    H = h_scale * jnp.eye(emission_dim, state_dim)
    f = lambda x, qn, u: A @ x + qn
    h = lambda x, rn, u: H @ x + rn
    return _bundle(state_dim, state_dim, emission_dim, emission_dim,
                   jnp.zeros(state_dim), jnp.eye(state_dim), f,
                   q * jnp.eye(state_dim), h, r * jnp.eye(emission_dim))


def linear_gaussian_lgssm(state_dim: int = 3, emission_dim: int = 3,
                          a: float = 0.8, h_scale: float = 0.1,
                          q: float = 1.0, r: float = 0.1) -> ParamsLGSSM:
    """The same linear model as :func:`linear_gaussian`, in closed-form
    :class:`ParamsLGSSM` layout for the exact Kalman filter."""
    return ParamsLGSSM(
        initial_mean=jnp.zeros(state_dim),
        initial_covariance=jnp.eye(state_dim),
        dynamics_matrix=a * jnp.eye(state_dim),
        dynamics_covariance=q * jnp.eye(state_dim),
        emission_matrix=h_scale * jnp.eye(emission_dim, state_dim),
        emission_covariance=r * jnp.eye(emission_dim),
    )


def bearings_only_tracking(dt: float = 0.5, acc: float = 0.5,
                           maneuvering: bool = True,
                           r: float = 25e-6,
                           wrap_bearing: bool = True):
    """Bearing-only tracking with optional maneuver inputs — the reference's
    canonical benchmark (ref: docs/tests/test_inference.py:22-56).

    State (px, vx, py, vy); constant-velocity / coordinated-turn dynamics
    blended by the discrete input u ∈ {0, 1, 2}; bearing observation
    arctan2(py, px).

    ``wrap_bearing`` (default on) wraps the bearing innovation to (−π, π]
    (utils/angles.py): when the trajectory crosses the ±π branch cut the
    raw innovation jumps by ~2π, which at this model's R = 2.5e-5 catapults
    every EKF in a bank — the root cause of the GSF divergences on this
    benchmark (the reference, which never wraps, NaNs the same way in its
    committed BOT notebook run). Pass False for reference-faithful
    behavior.
    """
    FCV = jnp.array([[1, dt, 0, 0], [0, 1, 0, 0], [0, 0, 1, dt], [0, 0, 0, 1]],
                    dtype=jnp.float32)
    G = jnp.array([[0.5, 0], [1, 0], [0, 0.5], [0, 1]], dtype=jnp.float32)

    def omega(x, a):
        return 0.1 * a / jnp.sqrt(x[1] ** 2 + x[3] ** 2)

    def FCT(x, a):
        w = omega(x, a)
        s, c = jnp.sin(dt * w), jnp.cos(dt * w)
        return jnp.array(
            [[1, s / w, 0, -(1 - c) / w],
             [0, c, 0, -s],
             [0, (1 - c) / w, 1, s / w],
             [0, s, 0, c]]
        )

    if maneuvering:
        def f(x, q, u):
            u = jnp.squeeze(u)
            blend = (
                0.5 * (u - 1) * (u - 2) * FCV
                - u * (u - 2) * FCT(x, acc)
                + 0.5 * u * (u - 1) * FCT(x, -acc)
            )
            return blend @ x + G @ q
    else:
        def f(x, q, u):
            return FCV @ x + G @ q

    def h(x, rn, u):
        return jnp.arctan2(x[2], x[0]) + rn

    mu0 = jnp.ones(4)
    Sigma0 = jnp.diag(jnp.array([0.1, 0.005, 0.1, 0.01]))
    Q = jnp.eye(2)
    R = r * jnp.eye(1)
    extras = {}
    if wrap_bearing:
        extras["emission_residual"] = angular_residual((0,))
    return _bundle(4, 2, 1, 1, mu0, Sigma0, f, Q, h, R, **extras)


def bot_maneuver_inputs(seq_length: int) -> jnp.ndarray:
    """The three-phase maneuver schedule used by the reference tests
    (ref: docs/tests/test_inference.py:53)."""
    third = seq_length // 3
    return jnp.array([1] * third + [0] * third + [2] * (seq_length - 2 * third))


def range_bearing_tracking(dt: float = 0.5, acc: float = 0.5,
                           q: float = 1e-5, r: float = 25e-6,
                           wrap_bearing: bool = True):
    """The T=500 BOT-experiment variant with range+bearing observations
    (ref: docs/notebooks/BOTExperiment.ipynb cell 2; BASELINE.md "BOT
    tracking" rows): Q = 1e-5, mildly unstable CV dynamics (1.05·F_CV),
    emission (arctan2(py,px), √(px²+py²)) — range observed, so long-horizon
    RMSE stays small (reference AGSF: 3.09 ± 0.63)."""
    FCV = 1.05 * jnp.array(
        [[1, dt, 0, 0], [0, 1, 0, 0], [0, 0, 1, dt], [0, 0, 0, 1]],
        dtype=jnp.float32,
    )
    G = jnp.array([[0.5, 0], [1, 0], [0, 0.5], [0, 1]], dtype=jnp.float32)

    def omega(x, a):
        return 0.1 * a / jnp.sqrt(x[1] ** 2 + x[3] ** 2)

    def FCT(x, a):
        w = omega(x, a)
        s, c = jnp.sin(dt * w), jnp.cos(dt * w)
        return jnp.array(
            [[1, s / w, 0, -(1 - c) / w],
             [0, c, 0, -s],
             [0, (1 - c) / w, 1, s / w],
             [0, s, 0, c]]
        )

    def f(x, qn, u):
        u = jnp.squeeze(u)
        blend = (
            0.5 * (u - 1) * (u - 2) * FCV
            - u * (u - 2) * FCT(x, acc)
            + 0.5 * u * (u - 1) * FCT(x, -acc)
        )
        return blend @ x + G @ qn

    def h(x, rn, u):
        return jnp.array(
            [jnp.arctan2(x[2], x[0]), jnp.sqrt(x[0] ** 2 + x[2] ** 2)]
        ) + rn

    def h_jac_x(x, rn, u):
        # closed-form d[atan2(y, x), sqrt(x^2+y^2)]/d(state): exercises the
        # ParamsNLSSM analytic-jacobian extension (perf-neutral here)
        rho2 = x[0] ** 2 + x[2] ** 2
        rho = jnp.sqrt(rho2)
        return jnp.array(
            [[-x[2] / rho2, 0.0, x[0] / rho2, 0.0],
             [x[0] / rho, 0.0, x[2] / rho, 0.0]]
        )

    def h_jac_r(x, rn, u):
        return jnp.eye(2, dtype=x.dtype)

    mu0 = jnp.array([-0.05, 0.001, 0.7, -0.05])
    Sigma0 = jnp.diag(jnp.array([0.1, 0.005, 0.1, 0.01]))
    extras = {}
    if wrap_bearing:
        # bearing is emission component 0 (see zoo.bearings_only_tracking
        # docstring for the ±π branch-cut rationale)
        extras["emission_residual"] = angular_residual((0,))
    return _bundle(4, 2, 2, 2, mu0, Sigma0, f, q * jnp.eye(2), h,
                   r * jnp.eye(2), emission_jacobian_x=h_jac_x,
                   emission_jacobian_r=h_jac_r, **extras)


def bot_experiment_inputs(seq_length: int) -> jnp.ndarray:
    """The 2/5–1/5–2/5 maneuver schedule of the T=500 BOT experiment
    (ref: docs/notebooks/BOTExperiment.ipynb cell 2)."""
    two_fifth = int(2 * seq_length / 5)
    fifth = int(seq_length / 5)
    return jnp.array(
        [1] * two_fifth + [0] * fifth + [2] * (seq_length - two_fifth - fifth)
    )


def tsp_lorenz63(q: float = 20.0, r: float = 0.1, obs_scale: float = 0.001,
                 dt: float = 0.01):
    """The TSP-2023 notebook's benchmark model: Lorenz-63 Euler dynamics with
    the weak quadratic observation ``y = 0.001·xᵀx + r``
    (ref: docs/notebooks/Experiment_TSP_2023.ipynb cell 2: f63 + g1,
    Q = 20·I₃, R = 0.1, μ₀ = 0, Σ₀ = I₃). The huge dynamics noise plus the
    nearly uninformative emission make this the reference's hardest tracking
    table (per-sim RMSEs 20-70, BASELINE.md TSP row)."""

    def f(x, qn, u):
        sigma, rho, beta = 10.0, 28.0, 2.667
        dx = dt * sigma * (x[1] - x[0])
        dy = dt * (x[0] * rho - x[1] - x[0] * x[2])
        dz = dt * (x[0] * x[1] - beta * x[2])
        return jnp.array([x[0] + dx, x[1] + dy, x[2] + dz]) + qn

    def h(x, rn, u):
        return obs_scale * jnp.dot(x, x) + rn

    return _bundle(3, 3, 1, 1, jnp.zeros(3), jnp.eye(3), f, q * jnp.eye(3),
                   h, r * jnp.eye(1))


def stochastic_volatility(state_dim: int = 3, sigma: float = 5.0,
                          beta: float = 0.5, phi: float = 0.8,
                          q: float = 20.0, r: float = 1e-3):
    """Markov-switching stochastic-volatility model
    (ref: docs/experiments/adaptive_experiment.py:34-58): linear regime for
    u=0, multiplicative exp-volatility emission for u=1."""
    Phi = phi * jnp.eye(state_dim)
    H0 = 0.1 * jnp.eye(state_dim)
    R = r * jnp.eye(state_dim)

    f = lambda x, qn, u: Phi @ x + qn

    def h(x, rn, u):
        u = jnp.squeeze(u)
        return u * beta * jnp.exp(x / sigma) * rn + (1 - u) * (H0 @ x + rn)

    def log_prob(x, y, u):
        u = jnp.squeeze(u)
        M = u * beta * jnp.diag(jnp.exp(x / sigma)) + (1 - u) * jnp.eye(state_dim)
        r0 = jnp.zeros(state_dim)
        return mvn_logpdf(y, h(x, r0, u), M @ R @ M.T)

    return _bundle(state_dim, state_dim, state_dim, state_dim,
                   jnp.zeros(state_dim), jnp.eye(state_dim), f,
                   q * jnp.eye(state_dim), h, R, log_prob=log_prob)


def lorenz63(sigma: float = 10.0, rho: float = 28.0, beta: float = 2.667,
             dt: float = 0.01, q: float = 0.1, r: float = 1.0):
    """Lorenz-63 attractor with quadratic-norm observation
    (ref: docs/experiments/exp_lorentz63.py:37-60)."""

    def f(x, qn, u):
        dx = dt * sigma * (x[1] - x[0])
        dy = dt * (x[0] * rho - x[1] - x[0] * x[2])
        dz = dt * (x[0] * x[1] - beta * x[2])
        return jnp.array([x[0] + dx, x[1] + dy, x[2] + dz]) + qn

    def h(x, rn, u):
        return jnp.array([jnp.dot(x, x)]) + rn

    return _bundle(3, 3, 1, 1, jnp.ones(3), jnp.eye(3), f, q * jnp.eye(3),
                   h, r * jnp.eye(1))


def lorenz96(state_dim: int = 40, emission_dim: Optional[int] = None,
             alpha: float = 1.0, beta: float = 1.0, gamma: float = 8.0,
             dt: float = 0.01, q: float = 0.1, r: float = 1.0,
             integrator: str = "euler"):
    """Lorenz-96 dynamics with strided linear observations
    (ref: gaussfiltax/nonlinearities.py:38-51; BASELINE config 5 uses
    state_dim=512).

    The reference builds the advection term with dense circulant-shift
    matrices; here the shifts are ``jnp.roll`` (O(dx) instead of two dx²
    matvecs) — the standard L96 form
    dx_i = (x_{i+1} − x_{i−2}) x_{i−1} − x_i + γ.

    ``integrator``: "euler" is the reference's explicit Euler step — which
    is UNSTABLE for L96 at the default dt=0.01 (a large fraction of noisy
    trajectories leave f32 range within a few hundred steps). "rk4" is a classic Runge–Kutta step over the
    same vector field — four f-evals, no control flow, stable at this dt;
    use it to generate finite long trajectories (e.g. as benchmark data)
    while filtering with whichever discretization the experiment calls for.
    """
    if emission_dim is None:
        emission_dim = state_dim // 2
    H_rows = jnp.arange(emission_dim)
    H_cols = 2 * H_rows
    H = jnp.zeros((emission_dim, state_dim)).at[H_rows, H_cols].set(1.0)
    R = r * jnp.eye(emission_dim)

    def vf(x):
        adv = alpha * (jnp.roll(x, -1) - jnp.roll(x, 2)) * jnp.roll(x, 1)
        return adv - beta * x + gamma

    if integrator == "rk4":
        def f(x, qn, u):
            k1 = vf(x)
            k2 = vf(x + 0.5 * dt * k1)
            k3 = vf(x + 0.5 * dt * k2)
            k4 = vf(x + dt * k3)
            return x + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4) + qn
    elif integrator == "euler":
        def f(x, qn, u):
            return x + dt * vf(x) + qn
    else:
        raise ValueError(f"unknown integrator {integrator!r}")

    def h(x, rn, u):
        return H @ x + rn

    return _bundle(state_dim, state_dim, emission_dim, emission_dim,
                   gamma * jnp.ones(state_dim), jnp.eye(state_dim), f,
                   q * jnp.eye(state_dim), h, R)

# ---------------------------------------------------------------------------
# Nonlinearity test functions (ref: gaussfiltax/nonlinearities.py:1-36),
# jax-native with analytic Jacobian/Hessian triples where the reference
# provides them. The reference module references undefined globals and is not
# importable; these are self-contained closures over (dx, p).
# ---------------------------------------------------------------------------

def power_nonlinearity(p: float):
    """f(x) = (1 + ||x||²)^(p/2) with analytic J, H
    (ref: gaussfiltax/nonlinearities.py:4-7)."""
    f = lambda x: (1 + jnp.dot(x, x)) ** (p / 2)
    J = lambda x: p * (1 + jnp.dot(x, x)) ** (p / 2 - 1) * x
    H = lambda x: (
        2 * p * (p / 2 - 1) * (1 + jnp.dot(x, x)) ** (p / 2 - 2) * jnp.outer(x, x)
        + jnp.eye(x.shape[-1]) * p * (1 + jnp.dot(x, x)) ** (p / 2 - 1)
    )
    return f, J, H


def sinc_nonlinearity():
    """f(x) = sin(||x||²)/||x||² (ref: gaussfiltax/nonlinearities.py:9-18)."""
    f = lambda x: jnp.sin(jnp.dot(x, x)) / jnp.dot(x, x)
    return f


def linear_nonlinear_product():
    """f(x) = x₀ sin(x₁) with J, H (ref: gaussfiltax/nonlinearities.py:20-23)."""
    f = lambda x: x[0] * jnp.sin(x[1])
    J = lambda x: jnp.array([jnp.sin(x[1]), x[0] * jnp.cos(x[1])])
    H = lambda x: jnp.array(
        [[0.0, jnp.cos(x[1])], [jnp.cos(x[1]), -x[0] * jnp.sin(x[1])]]
    )
    return f, J, H


def linear_nonlinear_sum():
    """f(x) = x₀ + sin(x₁) (ref: gaussfiltax/nonlinearities.py:25-28)."""
    f = lambda x: x[0] + jnp.sin(x[1])
    J = lambda x: jnp.array([1.0, jnp.cos(x[1])])
    H = lambda x: jnp.array([[0.0, 0.0], [0.0, -jnp.sin(x[1])]])
    return f, J, H


def quadratic_form(a: float = 1.0, b: float = 1.0):
    """f(x) = xᵀAx/2, A=diag(a,b) (ref: gaussfiltax/nonlinearities.py:30-36)."""
    A = jnp.array([[a, 0.0], [0.0, b]])
    f = lambda x: jnp.dot(x, A @ x) / 2
    J = lambda x: A @ x
    H = lambda x: A
    return f, J, H


__all__ = [
    "quadratic_measurement",
    "scalar_growth",
    "linear_gaussian",
    "linear_gaussian_lgssm",
    "bearings_only_tracking",
    "bot_maneuver_inputs",
    "range_bearing_tracking",
    "bot_experiment_inputs",
    "stochastic_volatility",
    "lorenz63",
    "lorenz96",
    "power_nonlinearity",
    "sinc_nonlinearity",
    "linear_nonlinear_product",
    "linear_nonlinear_sum",
    "quadratic_form",
]
