"""Benchmark the log-depth (associative-scan) Kalman family vs sequential.

Measures, on the GPU (prints the card):

  * sequential ``ops.linear.kalman_filter`` (lax.scan) at T=1M
  * ``ops.associative.parallel_kalman_filter`` — native and Woodbury solvers
  * ``ops.associative.parallel_kalman_smoother`` (filter + log-depth RTS)
  * ``ops.parallel_iterated.parallel_iterated_extended_smoother`` — a
    3-iteration nonlinear MAP smoother over T=1M as ONE jitted program

Rationale: the reference has no long-sequence story at all (its longest
committed run is T=500, ``/root/reference/docs/notebooks/BOTExperiment
.ipynb``); this is the §5.7 long-context subsystem. Usage:
``python experiments/parallel_kf_bench.py [--T 1000000] [--quick]``.

Timing protocol: the warm-up fetches a concrete value, and every timed rep
ends with ``block_until_ready`` and a one-element device_get.
"""
from __future__ import annotations

import argparse
import functools
import time

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np


def _force(out):
    """Synchronize by fetching one element of the first output leaf."""
    leaf = jax.tree_util.tree_leaves(out)[0]
    np.asarray(jax.device_get(leaf.ravel()[0]))


def _median_time(fn, reps):
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        jax.block_until_ready(out)
        _force(out)
        ts.append(time.perf_counter() - t0)
    ts.sort()
    return ts[len(ts) // 2]


def _first_call_time(jitted, *args):
    """Wall of the first call INCLUDING the async compile, synced by a
    value fetch. The compile column reported is first-call − steady wall."""
    t0 = time.perf_counter()
    _force(jitted(*args))
    return time.perf_counter() - t0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--T", type=int, default=1_000_000)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--quick", action="store_true",
                    help="T=100k smoke run")
    ap.add_argument("--skip", default="",
                    help="semicolon-separated row-name substrings to skip")
    args = ap.parse_args()
    T = 100_000 if args.quick else args.T
    skip = [s for s in args.skip.split(";") if s]

    from bayesianfiltering_tpu.models import zoo
    from bayesianfiltering_tpu.ops import associative, linear
    from bayesianfiltering_tpu.ops.parallel_iterated import (
        parallel_iterated_extended_smoother,
    )

    from bayesianfiltering_tpu import diagnostics
    from bayesianfiltering_tpu.config import enable_compile_cache

    enable_compile_cache()
    print(diagnostics.card_name_and_power_limit())
    dev = diagnostics.require_gpu()
    print(f"platform={dev.platform} kind={dev.device_kind} devices={jax.devices()} T={T}")

    # --- linear workload: dx=4/dy=2 constant-velocity-style system -------
    dx, dy = 4, 2
    key = jr.PRNGKey(0)
    F = 0.99 * jnp.eye(dx) + 0.01 * jr.normal(key, (dx, dx)) / dx
    H = jr.normal(jr.fold_in(key, 1), (dy, dx)) / dx
    params = linear.ParamsLGSSM(
        initial_mean=jnp.zeros(dx),
        initial_covariance=jnp.eye(dx),
        dynamics_matrix=F,
        dynamics_covariance=0.1 * jnp.eye(dx),
        emission_matrix=H,
        emission_covariance=0.1 * jnp.eye(dy),
    )
    ys = jr.normal(jr.fold_in(key, 2), (T, dy))

    rows = []

    def row(name, fn, *fargs):
        if any(s in name for s in skip):
            return
        print(f"... compiling {name}", flush=True)
        jitted = jax.jit(fn)
        first = _first_call_time(jitted, *fargs)
        print(f"... first call (compile+run) {first:.1f} s, timing",
              flush=True)
        wall = _median_time(lambda: jitted(*fargs), args.reps)
        ct = max(first - wall, 0.0)
        rows.append((name, T / wall, ct, wall))
        print(f"{name:42s} {T / wall:12,.0f} steps/s   compile {ct:6.1f} s"
              f"   wall {wall:7.3f} s", flush=True)

    row("sequential scan KF",
        lambda p, y: linear.kalman_filter(p, y).filtered_means, params, ys)
    row("associative KF (native solve)",
        lambda p, y: associative.parallel_kalman_filter(
            p, y, solver="native").filtered_means, params, ys)
    row("associative KF (woodbury)",
        lambda p, y: associative.parallel_kalman_filter(
            p, y, solver="woodbury").filtered_means, params, ys)
    for chunk in (64, 128, 256):
        row(f"chunked KF (woodbury, chunk={chunk})",
            functools.partial(
                lambda p, y, c: associative.parallel_kalman_filter(
                    p, y, chunk=c).filtered_means, c=chunk), params, ys)
    row("sequential KF + RTS smoother",
        lambda p, y: linear.kalman_smoother(p, y).smoothed_means, params, ys)
    row("associative KF + log-depth RTS (flat)",
        lambda p, y: associative.parallel_kalman_smoother(
            p, y, chunk=None).smoothed_means, params, ys)
    row("chunked KF + RTS (chunk=128)",
        lambda p, y: associative.parallel_kalman_smoother(
            p, y, chunk=128).smoothed_means, params, ys)

    # --- nonlinear workload: scalar growth (UNGM), 3-iteration IEKS ------
    # nl_params holds FUNCTION fields (dynamics/emission callables), so it
    # must be closed over, not passed as a jit argument.
    _, nl_params, _ = zoo.scalar_growth()
    nl_ys = jr.normal(jr.fold_in(key, 3), (T, 1))
    row("parallel IEKS, 3 iterations (flat)",
        lambda y: parallel_iterated_extended_smoother(
            nl_params, y, num_iter=3, chunk=None)[0].smoothed_means,
        nl_ys)
    row("parallel IEKS, 3 iterations (chunk=128)",
        lambda y: parallel_iterated_extended_smoother(
            nl_params, y, num_iter=3, chunk=128)[0].smoothed_means,
        nl_ys)

    print("\n| workload | steps/s | compile |")
    print("|---|---|---|")
    for name, sps, ct, _ in rows:
        print(f"| {name} | {sps:,.0f} | {ct:.0f} s |")


if __name__ == "__main__":
    main()
