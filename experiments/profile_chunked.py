"""Decompose the chunked parallel KF's wall at T=1M: element construction,
the chunked scan itself, and the loglik/predicted-moment epilogue."""
import sys
import time

import jax
import jax.numpy as jnp
import jax.random as jr

from bayesianfiltering_tpu import diagnostics
from bayesianfiltering_tpu.config import enable_compile_cache
from bayesianfiltering_tpu.diagnostics import benchmark
from bayesianfiltering_tpu.ops import associative as A, linear

enable_compile_cache()
print(diagnostics.card_name_and_power_limit())
print("device:", diagnostics.require_gpu().device_kind)

T = 1_000_000
dx, dy = 4, 2
key = jr.PRNGKey(0)
F = 0.99 * jnp.eye(dx) + 0.01 * jr.normal(key, (dx, dx)) / dx
H = jr.normal(jr.fold_in(key, 1), (dy, dx)) / dx
params = linear.ParamsLGSSM(jnp.zeros(dx), jnp.eye(dx), F, 0.1 * jnp.eye(dx),
                            H, 0.1 * jnp.eye(dy))
ys = jr.normal(jr.fold_in(key, 2), (T, dy))



def elements(y):
    return A._elements_time_invariant(params, y)


def elements_vmapped(y):
    """The pre-round-3 per-step construction (kept for the A/B row)."""
    first = A._first_element(params, y[0])
    rest = jax.vmap(lambda yy: A._generic_element(params, yy))(y[1:])
    return tuple(jnp.concatenate([f[None], r], 0) for f, r in zip(first, rest))


def scan_only(es):
    return A.chunked_associative_scan(
        A._combine, es, A._filter_identity(dx, es[0].dtype), chunk=128)


def filt(y):
    return A.parallel_kalman_filter(params, y, chunk=128)


def smooth(y):
    return A.parallel_kalman_smoother(params, y, chunk=128)


def ss_filt(y):
    from bayesianfiltering_tpu.ops import steady_state as SS
    return SS.steady_state_kalman_filter(params, y)


def ss_smooth(y):
    from bayesianfiltering_tpu.ops import steady_state as SS
    return SS.steady_state_kalman_smoother(params, y)


# Row selection: one invocation per row keeps each run's compiles short.
# No arg = the cheap dispatch-inclusive A/B rows.
which = sys.argv[1] if len(sys.argv) > 1 else "walls"

if which == "walls":
    es = jax.jit(elements)(ys)
    jax.device_get(es[0].ravel()[0])

    for name, fn, arg in (
        ("elements only", elements, ys),
        ("chunked scan only", scan_only, es),
        ("elements+scan+epilogue (full filter)", filt, ys),
    ):
        r = benchmark(fn, arg, num_runs=3)
        print(f"{name:40s} best {r.best:7.3f} s   first "
              f"{r.compile_time:6.1f} s", flush=True)
else:
    # The slope harness cancels the per-dispatch overhead
    # (diagnostics.benchmark_on_device).
    from bayesianfiltering_tpu.diagnostics import benchmark_on_device

    K = 4
    ys_all = jr.normal(jr.fold_in(key, 3), (K, T, dy))
    fn = {"elements": elements, "filter": filt, "smoother": smooth,
          "ss_filter": ss_filt, "ss_smoother": ss_smooth}[which]
    r = benchmark_on_device(fn, ys_all, reps=(1, K))
    print(f"[on-device] {which:28s} {r.per_call*1e3:8.2f} ms/call "
          f"({T/r.per_call/1e6:6.2f}M steps/s)   walls {r.walls}",
          flush=True)
