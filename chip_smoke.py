"""Smoke test of the filters on an NVIDIA GPU, through the entry points a
user calls, at sizes users run.

Each phase runs a filter family through ``bayesianfiltering_tpu.inference``,
``.ops`` or ``.parallel``, compares what comes out with a plain reference,
and prints one line::

    phase=<name> precision=<matmul precision> compile_s=<first call>
        steady_s=<best later call> err=<measured> tol=<limit> ...

Usage::

    python chip_smoke.py                 # phases 1-6 on one card
    python chip_smoke.py --four-cards    # only the sharded paths, 4 cards
    python chip_smoke.py --phases 2,6    # a subset, for development

Before any phase it prints the card's ``nvidia-smi`` name and power limit.
The last line of standard output is the JSON object
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
The script exits non-zero, without that line, when JAX finds no GPU or when
any phase fails: there is no CPU path, and no failure is caught.

Precision is the package default (``config.matmul_precision()``,
"highest": no TF32). CPU references run in float64 unless a phase says
otherwise. One process drives the card(s); the CPU references run in the
same process on JAX's CPU backend.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import time

import numpy as np

import jax
import jax.numpy as jnp
import jax.random as jr

import bayesianfiltering_tpu.inference as gf
from bayesianfiltering_tpu import diagnostics
from bayesianfiltering_tpu.config import enable_compile_cache, matmul_precision
from bayesianfiltering_tpu.models import zoo
from bayesianfiltering_tpu.ops import ParamsUKF, bank_update, kalman_filter
from bayesianfiltering_tpu.ops.associative import (
    parallel_kalman_filter,
    parallel_kalman_smoother,
)
from bayesianfiltering_tpu.ops.linear import kalman_smoother


# Sizes (module constants, so a rehearsal on the CPU can shrink them).
BATCH = 512                   # phase 1: sequences
T_LORENZ = 1000               # phases 1, 3: steps at dx=64
T_DX512 = 200                 # phase 3: steps at dx=512
T_BOT = 500                   # phases 2, 6: the reference's BOT length
BIG_BANK = (25000, 2, 2)      # phases 2, 6: M·N·L = 1e5
T_ASSOC = 1 << 20             # phase 4
N_BPF = 1 << 20               # phase 5 (four cards: 4×)
M_KERNEL = 100_000            # phase 6: components per band-edge compile
BATCH_4X = 2048               # four cards: sequences

# ---------------------------------------------------------------------------
# Harness
# ---------------------------------------------------------------------------

class PhaseFailed(RuntimeError):
    pass


def _block(x):
    return jax.block_until_ready(x)


def _timed(fn, *args, reps=3):
    """(output, compile_s, steady_s): the first call compiles; steady is the
    best of ``reps`` later calls, each ended by block_until_ready."""
    t0 = time.perf_counter()
    out = _block(fn(*args))
    compile_s = time.perf_counter() - t0
    steady = math.inf
    for _ in range(reps):
        t0 = time.perf_counter()
        _block(fn(*args))
        steady = min(steady, time.perf_counter() - t0)
    return out, compile_s, steady


def _rel(a, b):
    """max |a − b| / max |b| (inf when either side is non-finite)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if not (np.isfinite(a).all() and np.isfinite(b).all()):
        return math.inf
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _rmse(est, truth):
    return float(np.sqrt(np.mean((np.asarray(est) - np.asarray(truth)) ** 2)))


def report(phase, compile_s, steady_s, err, tol, **extra):
    fields = " ".join(f"{k}={v}" for k, v in extra.items())
    ok = bool(err <= tol)
    print(f"phase={phase} precision={matmul_precision()} "
          f"compile_s={compile_s:.3f} steady_s={steady_s:.6f} "
          f"err={err:.3e} tol={tol:.1e} {fields} {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        raise PhaseFailed(f"{phase}: err {err:.3e} > tol {tol:.1e}")


def _is_float_array(x):
    return (isinstance(x, (jax.Array, np.ndarray))
            and jnp.issubdtype(x.dtype, jnp.floating))


@contextlib.contextmanager
def _x64():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", old)


def on_cpu(fn, *args, f64=True):
    """Run ``fn(*args)`` jitted on JAX's CPU backend — in float64 (every
    float array leaf of ``args`` cast) unless ``f64=False`` — and return
    NumPy outputs. Callables inside ``args`` (model functions) pass
    through."""
    cpu = jax.devices("cpu")[0]
    ctx = _x64() if f64 else contextlib.nullcontext()
    with ctx:
        dt = jnp.float64 if f64 else jnp.float32

        def prep(x):
            return (jax.device_put(jnp.asarray(np.asarray(x), dt), cpu)
                    if _is_float_array(x) else x)

        flat, tree = jax.tree_util.tree_flatten(
            jax.tree_util.tree_map(prep, args))
        idx = [i for i, a in enumerate(flat) if isinstance(a, jax.Array)]
        arrays = [flat[i] for i in idx]

        def run(*arrs):
            leaves = list(flat)
            for i, a in zip(idx, arrs):
                leaves[i] = a
            return fn(*jax.tree_util.tree_unflatten(tree, leaves))

        with jax.default_device(cpu):
            out = jax.jit(run)(*arrays)
        return jax.tree_util.tree_map(np.asarray, out)


@contextlib.contextmanager
def bank_path(impl):
    """Trace the mixture filters with the bank primitives pinned to one
    implementation ("xla" = the plain version XLA compiles). Applies to
    functions traced inside the block."""
    saved = bank_update.bank_impl
    bank_update.bank_impl = lambda *a, **k: impl
    try:
        yield
    finally:
        bank_update.bank_impl = saved


def _mixture_summary(post):
    """Point estimate Σ_m w_m μ_m (T, dx) of a Gaussian-sum posterior, and
    its spread (T,): the root of the mixture's variance (within and between
    components), averaged over the state dimensions."""
    w = post.weights
    mean = jnp.einsum("mt,mtd->td", w, post.means)
    within = jnp.einsum("mt,mtdd->t", w, post.covariances)
    between = jnp.einsum("mt,mtd->t", w, (post.means - mean) ** 2)
    return mean, jnp.sqrt((within + between) / post.means.shape[-1])


# A mixture filter that resamples its bank makes discrete choices that
# rounding differences between two runs flip after ~20 steps on this
# benchmark (measured on the CPU: kernel vs XLA summation order); after
# that the two are different Monte-Carlo samples of one filter (RMSE
# 500–2300 on BOT at [50, 2, 2]). So two such runs are compared on the
# first PREFIX steps, where the point estimates must agree to within
# GAP_TOL posterior spreads (the estimator-level criterion of
# tests/test_parallel.py), and both RMSEs over the whole run are printed.
PREFIX, GAP_TOL = 8, 0.5


def _gap(out, ref):
    """max over the first PREFIX steps of |Δ point estimate| / spread."""
    (m1, _), (m2, spread) = out, ref
    d = np.abs(np.asarray(m1[:PREFIX], np.float64)
               - np.asarray(m2[:PREFIX], np.float64))
    g = d / np.asarray(spread[:PREFIX], np.float64)[:, None]
    return float(g.max()) if np.isfinite(g).all() else math.inf


# ---------------------------------------------------------------------------
# Shared data
# ---------------------------------------------------------------------------

def lorenz_data(dx, dy, T, B, seed=0):
    """Emissions from the RK4 Lorenz-96 model (the Euler step the filters
    run is unstable at dt=0.01 for noisy trajectories)."""
    dm, dp, _ = zoo.lorenz96(dx, dy, integrator="rk4")
    sample = jax.jit(jax.vmap(lambda k: dm.sample(dp, k, T)[1]))
    em = _block(sample(jr.split(jr.PRNGKey(seed), B)))
    if not bool(jnp.all(jnp.isfinite(em))):
        raise PhaseFailed("non-finite Lorenz-96 emissions")
    return em


class Bot:
    """The reference's bearings-only tracking benchmark at T=500, with the
    compiled AGSF/GSF point estimators memoized per (config, bank path)."""

    def __init__(self):
        model, self.params, _ = zoo.bearings_only_tracking()
        self.inputs = zoo.bot_maneuver_inputs(T_BOT)
        self.states, self.em = model.sample(self.params, jr.PRNGKey(0),
                                            T_BOT, inputs=self.inputs)
        self._fns = {}

    def agsf_call(self, bank, reduction="multinomial"):
        def call(params, em, inputs):
            return _mixture_summary(gf.augmented_gaussian_sum_filter(
                params, em, list(bank), jr.PRNGKey(1), 1, (0.1, 0.1),
                inputs, reduction=reduction)[0])
        return call

    def gsf_call(self, M):
        def call(params, em, inputs):
            return _mixture_summary(gf.gaussian_sum_filter(
                params, em, M, 1, inputs, jr.PRNGKey(2)))
        return call

    def fn(self, kind, size, impl=None, reduction="multinomial"):
        key = (kind, size, impl, reduction)
        if key not in self._fns:
            call = (self.agsf_call(size, reduction) if kind == "agsf"
                    else self.gsf_call(size))
            ctx = bank_path(impl) if impl else contextlib.nullcontext()
            with ctx:
                lowered = jax.jit(
                    lambda e: call(self.params, e, self.inputs)).lower(self.em)
            t0 = time.perf_counter()
            compiled = lowered.compile()
            self._fns[key] = (compiled, time.perf_counter() - t0)
        return self._fns[key]


# ---------------------------------------------------------------------------
# Phases (one card)
# ---------------------------------------------------------------------------

def phase1_batched_ekf(bot):
    """Batched EKF, Lorenz-96 dx=64, dy=32, B=512, T=1000 (bench.py's
    cell)."""
    model, params, _ = zoo.lorenz96(64, 32)
    em = lorenz_data(64, 32, T_LORENZ, BATCH)
    filt = jax.jit(jax.vmap(
        lambda e: gf.extended_kalman_filter(params, e).filtered_means))
    out, c, s = _timed(filt, em)
    ref = on_cpu(lambda p, e: jax.vmap(
        lambda x: gf.extended_kalman_filter(p, x).filtered_means)(e),
        params, em[:4])
    # f32 on the card vs f64 on the CPU over 1000 steps of a chaotic model:
    # the filter forgets rounding (measured 7e-7 f32-vs-f64 on the CPU), so
    # 1e-3 leaves room for the GPU's other summation order.
    report(f"1_batched_ekf_dx64_B{BATCH}_T{T_LORENZ}", c, s,
           _rel(out[:4], ref), 1e-3,
           timestep_equiv_per_s=f"{BATCH * T_LORENZ / s:.1f}")


def phase2_mixture(bot):
    """AGSF at the reference's [50,2,2] and at an M·N·L=1e5 bank, and a
    50-component GSF, on bearings-only tracking, T=500."""
    truth = np.asarray(bot.states)
    for bank in [(50, 2, 2), BIG_BANK]:
        fn, c = bot.fn("agsf", bank)
        out, _, s = _timed(fn, bot.em)
        if bank == (50, 2, 2):
            # reference: the same call on the CPU, float32, same key (so the
            # same random draws)
            ref = on_cpu(bot.agsf_call(bank), bot.params, bot.em, bot.inputs,
                         f64=False)
            ref_name = "cpu_f32"
        else:
            # a CPU run at 1e5 components would dominate the script: the
            # reference is the plain XLA bank path on the card
            xfn, _ = bot.fn("agsf", bank, "xla")
            ref = _block(xfn(bot.em))
            ref_name = "card_xla"
        report(f"2_agsf_{'x'.join(map(str, bank))}_T{T_BOT}", c, s,
               _gap(out, ref), GAP_TOL,
               compared=f"first{PREFIX}steps_vs_{ref_name}_in_spreads",
               rmse=f"{_rmse(out[0], truth):.3f}",
               ref_rmse=f"{_rmse(ref[0], truth):.3f}")
    fn, c = bot.fn("gsf", 50)
    out, _, s = _timed(fn, bot.em)
    ref = on_cpu(bot.gsf_call(50), bot.params, bot.em, bot.inputs, f64=False)
    # no resampling: the whole trajectory is deterministic; card vs CPU in
    # float32 differ only by summation order (measured 2e-6 on the CPU)
    report(f"2_gsf_M50_T{T_BOT}", c, s, _rel(out[0], ref[0]), 1e-3,
           compared="all_steps_vs_cpu_f32",
           rmse=f"{_rmse(out[0], truth):.3f}",
           ref_rmse=f"{_rmse(ref[0], truth):.3f}")


def phase3_single_stream(bot):
    """Single-stream EKF and UKF at dx=64 (T=1000), and the EKF at dx=512,
    dy=256 with the chunked update (T=200). Compile time matters here."""
    model, params, _ = zoo.lorenz96(64, 32)
    em = lorenz_data(64, 32, T_LORENZ, 1)[0]
    runs = [("ekf_dx64", lambda p, e: gf.extended_kalman_filter(
        p, e).filtered_means)]
    for method in ("cholesky", "sqrtm"):
        up = ParamsUKF(1.0, 0.0, 0.0, sqrt_method=method)
        runs.append((f"ukf_{method}_dx64",
                     lambda p, e, up=up: gf.unscented_kalman_filter(
                         p, up, e, additive=True).filtered_means))
    for name, call in runs:
        out, c, s = _timed(jax.jit(lambda e, call=call: call(params, e)), em)
        ref = on_cpu(call, params, em)
        # measured f32-vs-f64 on the CPU: 7e-7 (EKF), 2e-6 (UKF)
        report(f"3_{name}_T{T_LORENZ}", c, s, _rel(out, ref), 1e-3,
               steps_per_s=f"{T_LORENZ / s:.1f}")

    p5 = zoo.lorenz96(512, 256)[1]
    em5 = lorenz_data(512, 256, T_DX512, 1)[0]
    call = lambda p, e: gf.extended_kalman_filter(
        p, e, update_chunk=128).filtered_means
    out, c, s = _timed(jax.jit(lambda e: call(p5, e)), em5)
    ref = on_cpu(call, p5, em5[:20])
    report(f"3_ekf_dx512_dy256_chunk128_T{T_DX512}", c, s,
           _rel(out[:20], ref), 1e-3, compared="first20steps_vs_cpu_f64",
           steps_per_s=f"{T_DX512 / s:.1f}")


def phase4_associative(bot):
    """Associative KF and RTS at T=2^20 (chunked schedule), and the parallel
    IEKS on the BOT experiment."""
    T = T_ASSOC
    lg = zoo.linear_gaussian_lgssm(4, 2)
    model, params, _ = zoo.linear_gaussian(4, 2)
    em = _block(jax.jit(lambda k: model.sample(params, k, T)[1])(
        jr.PRNGKey(3)))
    # the sequential references take ~1M dependent steps: time them once
    # the sequential reference (~1M dependent steps, filter + RTS) runs once;
    # its wall includes its compile
    t0 = time.perf_counter()
    seq = _block(jax.jit(lambda e: kalman_smoother(lg, e))(em))
    seq_s = time.perf_counter() - t0
    par_f, pc, ps = _timed(jax.jit(lambda e: parallel_kalman_filter(lg, e)),
                           em)
    # f32 scans over 1M steps of a stable filter: both forget rounding;
    # relative to the largest mean/covariance entry.
    err = max(_rel(par_f.filtered_means, seq.filtered_means),
              _rel(par_f.filtered_covariances, seq.filtered_covariances))
    report(f"4_parallel_kf_dx4_T{T}", pc, ps, err, 1e-3,
           sequential_smoother_first_call_s=f"{seq_s:.3f}",
           steps_per_s=f"{T / ps:.1f}")
    par_s, pc, ps = _timed(
        jax.jit(lambda e: parallel_kalman_smoother(lg, e)), em)
    err = max(_rel(par_s.smoothed_means, seq.smoothed_means),
              _rel(par_s.smoothed_covariances, seq.smoothed_covariances))
    report(f"4_parallel_rts_dx4_T{T}", pc, ps, err, 1e-3,
           steps_per_s=f"{T / ps:.1f}")

    # IEKS on the range+bearing BOT experiment at its own length: the model
    # is mildly unstable (1.05·F_CV), and beyond a few thousand steps its
    # state leaves float range — so T=500, not 2^20.
    rb_model, rb_params, _ = zoo.range_bearing_tracking()
    inputs = zoo.bot_experiment_inputs(500)
    states, rb_em = rb_model.sample(rb_params, jr.PRNGKey(1), 500,
                                    inputs=inputs)
    call = lambda p, e, u: gf.parallel_iterated_extended_smoother(
        p, e, 3, u, damping=0.7, nominal="filter")[0].smoothed_means
    out, c, s = _timed(jax.jit(lambda e: call(rb_params, e, inputs)), rb_em)
    ref = on_cpu(call, rb_params, rb_em, inputs)
    # measured f32-vs-f64 on the CPU: 4e-7
    report("4_parallel_ieks3_bot_T500", c, s, _rel(out, ref), 1e-3,
           rmse=f"{_rmse(out, states):.4f}")


def bpf_check(name, out, kf, N, T, c, s):
    """Compare a particle filter's weighted means with the exact KF.

    Monte-Carlo bound: each step's weighted mean has a standard error of
    about σ_t/√ESS_t (σ_t the exact posterior standard deviation). That
    understates the error of a filter that resamples, so the bound is 16
    of them at the worst of T × 8 (step, dim) pairs; measured on the CPU at
    16k–131k particles over 5 seeds: worst 7–12, median 1.0–1.2 (printed,
    and the thing to watch: a biased filter moves the median)."""
    ess = np.asarray(out["ess"])
    sigma = np.sqrt(np.diagonal(np.asarray(kf.filtered_covariances),
                                axis1=1, axis2=2))
    z = (np.abs(np.asarray(out["means"]) - np.asarray(kf.filtered_means))
         / (sigma / np.sqrt(ess[:, None])))
    finite = np.isfinite(z).all()
    report(name, c, s, float(z.max()) if finite else math.inf, 16.0,
           median=f"{float(np.median(z)):.3f}" if finite else "nan",
           resampled_steps=int((ess < 0.5 * N).sum()),
           particle_steps_per_s=f"{N * T / s:.4e}")


def bpf_problem(T=100):
    """dx=8 linear-Gaussian model, its emissions, and the exact KF in the
    particle filter's convention: the PF propagates its initial particles
    once before the first weighting (the reference's order), so the KF's
    prior is the initial distribution pushed through the dynamics once."""
    model, params, bpf = zoo.linear_gaussian(8, 8)
    lg = zoo.linear_gaussian_lgssm(8, 8)
    F, Q = lg.dynamics_matrix, lg.dynamics_covariance
    lg = lg._replace(initial_mean=F @ lg.initial_mean,
                     initial_covariance=F @ lg.initial_covariance @ F.T + Q)
    _, em = model.sample(params, jr.PRNGKey(1), T)
    return bpf, em, kalman_filter(lg, em)


def phase5_bpf(bot):
    """Bootstrap PF, 1M particles, dx=8 linear-Gaussian, T=100, summary
    store, against the exact Kalman filter."""
    N, T = N_BPF, 100
    bpf, em, kf = bpf_problem(T)
    out, c, s = _timed(jax.jit(lambda e: gf.bootstrap_particle_filter(
        bpf, e, N, jr.PRNGKey(2), store="summary")), em)
    bpf_check(f"5_bpf_N{N}_dx8_T{T}", out, kf, N, T, c, s)


def phase6_bank_kernel(bot):
    """The Triton bank kernels: compiled at their band edges against the XLA
    reference, then timed inside the full filters against the plain XLA
    bank path, in turns (kernel, xla, xla, kernel)."""
    # Random banks of 1e5 components include ill-conditioned innovation
    # covariances, where any two float32 summation orders part by more
    # than rounding. So the kernel and the plain XLA version are both
    # compared with a float64 CPU run of the reference, and the kernel must
    # be at least half as accurate as XLA (err ≤ 2·err_xla, floor 1e-5).
    M = M_KERNEL
    edge = bank_update.MAX_DIM
    for dx, dy in [(1, 1), (edge, edge), (edge, 1), (1, edge)]:
        args = [jnp.asarray(a) for a in _bank_args(M, dx, dy)]
        fn = jax.jit(lambda *a: bank_update._update_pallas(*a, 0.0))
        out, c, s = _timed(fn, *args)
        xla = jax.jit(lambda *a: bank_update._update_xla(*a, 0.0))(*args)
        ref = on_cpu(lambda *a: bank_update._update_xla(*a, 0.0), *args)
        err = max(_rel(o, r) for o, r in zip(out, ref))
        err_xla = max(_rel(o, r) for o, r in zip(xla, ref))
        report(f"6_update_kernel_M{M}_dx{dx}_dy{dy}", c, s, err,
               max(2 * err_xla, 1e-5), compared="cpu_f64",
               xla_err=f"{err_xla:.3e}")
    for dx, dq in [(1, 1), (edge, edge), (4, 2)]:
        args = _predict_args(M, dx, dq)
        out, c, s = _timed(jax.jit(bank_update._predict_pallas), *args)
        ref = on_cpu(bank_update._predict_xla, *args)
        err_xla = _rel(jax.jit(bank_update._predict_xla)(*args), ref)
        report(f"6_predict_kernel_M{M}_dx{dx}_dq{dq}", c, s, _rel(out, ref),
               max(2 * err_xla, 1e-5), compared="cpu_f64",
               xla_err=f"{err_xla:.3e}")
    # vmapped: a batch of banks becomes a second grid axis
    args = [jnp.stack([a, 1.01 * a]) for a in _bank_args(1000, 4, 1)]
    out, c, s = _timed(jax.jit(jax.vmap(
        lambda *a: bank_update._update_pallas(*a, 0.0))), *args)
    ref = jax.jit(jax.vmap(lambda *a: bank_update._update_xla(*a, 0.0)))(
        *args)
    report("6_update_kernel_vmapped_2x1000", c, s,
           max(_rel(o, r) for o, r in zip(out, ref)), 1e-4)

    for kind, size in [("agsf", (50, 2, 2)), ("agsf", BIG_BANK),
                       ("gsf", 50)]:
        ker, kc = bot.fn(kind, size)
        xla, xc = bot.fn(kind, size, "xla")
        times = {"kernel": [], "xla": []}
        for name, fn in [("kernel", ker), ("xla", xla), ("xla", xla),
                         ("kernel", ker)]:
            _block(fn(bot.em))
            t0 = time.perf_counter()
            _block(fn(bot.em))
            times[name].append(time.perf_counter() - t0)
        k, x = min(times["kernel"]), min(times["xla"])
        label = "x".join(map(str, size)) if kind == "agsf" else f"M{size}"
        out, ref = _block(ker(bot.em)), _block(xla(bot.em))
        err, tol = ((_gap(out, ref), GAP_TOL) if kind == "agsf"
                    else (_rel(out[0], ref[0]), 1e-3))
        report(f"6_{kind}_{label}_kernel_vs_xla_T{T_BOT}", kc, k, err, tol,
               kernel_s=f"{k:.6f}", xla_s=f"{x:.6f}",
               xla_compile_s=f"{xc:.3f}", speedup=f"{x / k:.3f}")


def _bank_args(M, dx, dy, seed=12):
    k = jr.split(jr.PRNGKey(seed), 5)
    ms = jr.normal(k[0], (M, dx))
    a = jr.normal(k[1], (M, dx, dx))
    Ps = jnp.einsum("mik,mjk->mij", a, a) + 0.5 * jnp.eye(dx)
    Hx = jr.normal(k[2], (M, dy, dx))
    b = jr.normal(k[3], (M, dy, dy))
    Rt = jnp.einsum("mik,mjk->mij", b, b) * 0.1 + 0.05 * jnp.eye(dy)
    return ms, Ps, Hx, Rt, jr.normal(k[4], (M, dy))


def _predict_args(M, dx, dq, seed=13):
    k = jr.split(jr.PRNGKey(seed), 3)
    a = jr.normal(k[1], (M, dx, dx))
    return (jr.normal(k[0], (M, dx, dx)),
            jnp.einsum("mik,mjk->mij", a, a) + jnp.eye(dx),
            jr.normal(k[2], (M, dx, dq)), jnp.diag(jnp.arange(1.0, dq + 1)))


PHASES = {1: phase1_batched_ekf, 2: phase2_mixture, 3: phase3_single_stream,
          4: phase4_associative, 5: phase5_bpf, 6: phase6_bank_kernel}


# ---------------------------------------------------------------------------
# Four cards: only the paths that exist across cards
# ---------------------------------------------------------------------------

def _spans_all(x, n):
    devs = {d for leaf in jax.tree_util.tree_leaves(x)
            for d in leaf.sharding.device_set}
    if len(devs) < n:
        raise PhaseFailed(f"output lives on {len(devs)} of {n} devices")


def four_cards():
    from jax.sharding import NamedSharding, PartitionSpec as P

    from bayesianfiltering_tpu import parallel
    from bayesianfiltering_tpu.parallel.mixture import sharded_agsf

    n = len(jax.devices())
    if n != 4:
        raise PhaseFailed(f"--four-cards needs 4 GPUs, JAX sees {n}")

    # batched EKF, B=2048 split four ways
    mesh = parallel.make_mesh((4,), ("batch",))
    model, params, _ = zoo.lorenz96(64, 32)
    em = lorenz_data(64, 32, T_LORENZ, BATCH_4X)
    run = lambda e: parallel.batched_filter(
        gf.extended_kalman_filter, params, e, mesh=mesh).filtered_means
    out, c, s = _timed(run, em)
    _spans_all(out, 4)
    one = _block(jax.jit(jax.vmap(
        lambda e: gf.extended_kalman_filter(params, e).filtered_means))(em))
    # the same program per sequence on each card, but XLA may pick other
    # kernels for B/4 than for B: equal to f32 rounding, which this stable
    # filter forgets (f32 vs f64 measured 7e-7 on the CPU)
    report(f"4x_batched_ekf_dx64_B{BATCH_4X}_T{T_LORENZ}", c, s,
           _rel(out, one), 1e-4, compared="one_card",
           timestep_equiv_per_s=f"{BATCH_4X * T_LORENZ / s:.1f}")

    # particle-sharded BPF, 4 × 1M particles, vs the exact KF
    N, T = 4 * N_BPF, 100
    pmesh = parallel.make_mesh((4,), ("particle",))
    bpf, lem, kf = bpf_problem(T)
    run = lambda e: parallel.sharded_bootstrap_particle_filter(
        bpf, e, N, pmesh, jr.PRNGKey(2))
    out, c, s = _timed(run, lem, reps=1)
    bpf_check(f"4x_sharded_bpf_N{N}_dx8_T{T}", out, kf, N, T, c, s)

    # mixture-sharded AGSF at M·N·L = 1e5, gathered and local reduction
    bot = Bot()
    truth = np.asarray(bot.states)
    one, _ = bot.fn("agsf", BIG_BANK, reduction="systematic")
    one_out = _block(one(bot.em))
    mmesh = parallel.make_mesh((4,), ("mixture",))
    # "systematic" gathers the bank and re-runs the one-card reduction: the
    # prefix criterion above. "local" resamples each shard's slice on its
    # own and keeps each shard's mass — the same filter in distribution, not
    # in draws; its early point estimates sit about half a spread from the
    # global ones on this benchmark (measured 0.53–0.56 on a 4-device CPU
    # mesh at 400 and 2500 components: the gap does not shrink with the
    # bank), so it gets one spread.
    for reduction, tol in (("systematic", GAP_TOL), ("local", 1.0)):
        run = jax.jit(lambda e, r=reduction: _mixture_summary(sharded_agsf(
            bot.params, e, list(BIG_BANK), mmesh, jr.PRNGKey(1),
            inputs=bot.inputs, reduction=r)))
        out, c, s = _timed(run, bot.em, reps=1)
        report(f"4x_sharded_agsf_{'x'.join(map(str, BIG_BANK))}_{reduction}"
               f"_T{T_BOT}", c, s, _gap(out, one_out), tol,
               compared=f"one_card_systematic_first{PREFIX}_in_spreads",
               rmse=f"{_rmse(out[0], truth):.3f}",
               one_card_rmse=f"{_rmse(one_out[0], truth):.3f}")

    # time-sharded associative KF at T=2^20
    T = T_ASSOC
    tmesh = parallel.make_mesh((4,), ("time",))
    lg4 = zoo.linear_gaussian_lgssm(4, 2)
    m4, p4, _ = zoo.linear_gaussian(4, 2)
    em4 = _block(jax.jit(lambda k: m4.sample(p4, k, T)[1])(jr.PRNGKey(3)))
    sharded = jax.device_put(em4, NamedSharding(tmesh, P("time", None)))
    run = jax.jit(lambda e: parallel_kalman_filter(lg4, e).filtered_means)
    out, c, s = _timed(run, sharded)
    _spans_all(out, 4)
    one = _block(jax.jit(lambda e: parallel_kalman_filter(
        lg4, e).filtered_means)(em4))
    report(f"4x_time_sharded_parallel_kf_dx4_T{T}", c, s, _rel(out, one),
           1e-4, compared="one_card", steps_per_s=f"{T / s:.1f}")


# ---------------------------------------------------------------------------

def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded paths, on four GPUs")
    ap.add_argument("--phases", default="1,2,3,4,5,6",
                    help="comma-separated one-card phases to run")
    args = ap.parse_args()

    enable_compile_cache()
    print(diagnostics.card_name_and_power_limit(), flush=True)
    dev = diagnostics.require_gpu()
    print(f"platform={dev.platform} kind={dev.device_kind} "
          f"count={len(jax.devices())} jax={jax.__version__}", flush=True)

    if args.four_cards:
        four_cards()
    else:
        bot = Bot()
        for p in sorted({int(x) for x in args.phases.split(",")}):
            PHASES[p](bot)

    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()
