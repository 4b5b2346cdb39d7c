"""Observability: profiling, benchmarking, and numerical-failure detection.

Replacements for the reference's ad-hoc practices (SURVEY.md §5):
the committed one-off xplane trace (§5.1) becomes a ``trace`` context
manager around real ``jax.profiler`` runs; the trace-time ``time.time``
deltas baked into scan bodies become :func:`benchmark`
(``block_until_ready``-based, compile excluded); the silent NaN guards
become :func:`check_finite` / the ``debug_nans`` context.
"""
from __future__ import annotations

import contextlib
import subprocess
import time
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp


class BenchmarkResult(NamedTuple):
    best: float          # best steady-state wall-clock (s)
    mean: float
    compile_time: float  # first-call wall-clock (compile + run)
    num_runs: int

    def steps_per_sec(self, num_steps: int) -> float:
        return num_steps / self.best


def _force(out):
    """Synchronize by fetching one element of the first output leaf: a
    device→host value fetch cannot return before the program has run."""
    leaf = jax.tree_util.tree_leaves(out)[0]
    jax.device_get(jnp.ravel(leaf)[0])


def benchmark(fn: Callable, *args, num_runs: int = 3, jit: bool = True,
              **kwargs) -> BenchmarkResult:
    """Time ``fn(*args)`` correctly on an async backend.

    Jits once, runs to completion (synced by a one-element value fetch) for
    the compile measurement, then takes best/mean of ``num_runs``
    steady-state calls, each ended by ``block_until_ready``.
    This is the discipline the reference's in-scan ``time.time()`` deltas
    violate (they record trace-time constants, ref:
    gaussfiltax/inference.py:598).
    """
    run = jax.jit(fn) if jit else fn
    t0 = time.perf_counter()
    _force(run(*args, **kwargs))
    compile_time = time.perf_counter() - t0
    times = []
    for _ in range(num_runs):
        t0 = time.perf_counter()
        out = run(*args, **kwargs)
        jax.block_until_ready(out)
        _force(out)
        times.append(time.perf_counter() - t0)
    return BenchmarkResult(min(times), sum(times) / len(times), compile_time,
                           num_runs)


class OnDeviceResult(NamedTuple):
    per_call: float       # on-device seconds per fn call (overhead-free)
    walls: tuple          # best wall for each K in reps
    reps: tuple

    def steps_per_sec(self, num_steps: int) -> float:
        return num_steps / self.per_call


def benchmark_on_device(fn: Callable, inputs, reps=(2, 10),
                        num_runs: int = 3) -> OnDeviceResult:
    """Isolate the ON-DEVICE wall of ``fn`` from per-dispatch overhead.

    Every dispatch+fetch costs host time, which swamps sub-millisecond
    programs (:func:`benchmark` can only report dispatch-inclusive walls).
    This builds, for each ``K`` in ``reps``,
    ONE jitted program that runs ``fn`` K times inside ``lax.fori_loop``
    — each iteration reads a different loop-counter-indexed slice of
    ``inputs`` (so XLA cannot hoist the body out of the loop) and folds
    ``jnp.sum`` of every output leaf into the scalar carry. The full
    reduction matters: folding a single output ELEMENT lets XLA
    dead-code-eliminate everything that element doesn't depend on
    (measured: the element-construction row collapsed to a scalar slice
    and timed ~0). The sum adds one read pass over the outputs — any
    real consumer pays at least that. The per-call time is the slope
    ``(wall_K2 − wall_K1) / (K2 − K1)``: dispatch and fetch overhead
    cancel exactly.

    ``inputs`` is a pytree whose leaves carry a leading axis of size
    ≥ ``max(reps)`` (stack ``max(reps)`` variants of the argument;
    repeats-with-jitter are fine). ``fn`` receives one slice.
    """
    from jax import lax

    n = jax.tree_util.tree_leaves(inputs)[0].shape[0]
    if n < max(reps):
        raise ValueError(f"inputs leading axis {n} < max(reps)={max(reps)}")

    def program(k):
        def body(i, acc):
            sl = jax.tree_util.tree_map(lambda x: x[i], inputs)
            out = fn(sl)
            for leaf in jax.tree_util.tree_leaves(out):
                acc = acc + jnp.sum(leaf).astype(jnp.float32)
            return acc
        return jax.jit(lambda: lax.fori_loop(0, k, body, jnp.float32(0.0)))

    walls = []
    for k in reps:
        run = program(k)
        jax.device_get(run())                      # compile + first result
        best = float("inf")
        for _ in range(num_runs):
            t0 = time.perf_counter()
            jax.device_get(run())
            best = min(best, time.perf_counter() - t0)
        walls.append(best)

    per_call = (walls[-1] - walls[0]) / (reps[-1] - reps[0])
    return OnDeviceResult(per_call, tuple(walls), tuple(reps))


def card_name_and_power_limit() -> str:
    """``nvidia-smi``'s ``name, power.limit`` line for the first card.

    Runs ``nvidia-smi`` as a child that never imports JAX, so it opens no
    second JAX process on the card. A card may be capped below its maximum
    power and then runs slower under load: print this beside every number.
    """
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def require_gpu():
    """The first JAX device, which must be a GPU. A measurement that finds
    no card fails instead of timing the CPU under a device metric's name."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"no GPU: JAX's first device is {dev.platform!r}; this script "
            "measures the card and has no CPU path")
    return dev


@contextlib.contextmanager
def trace(logdir: str):
    """Capture an XLA profiler trace (TensorBoard xplane) around a block.

    The reference repo ships exactly one such trace as a committed artifact
    (ref: trace/plugins/profile/.../Kostass-MBP.xplane.pb) with no code
    producing it; this is the reproducible version.
    """
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Raise on the first NaN produced inside the block (jax_debug_nans)."""
    prev = jax.config.jax_debug_nans
    jax.config.update("jax_debug_nans", enable)
    try:
        yield
    finally:
        jax.config.update("jax_debug_nans", prev)


def check_finite(tree, name: str = "pytree") -> None:
    """Host-side assertion that every leaf of ``tree`` is finite.

    Explicit failure detection for filter outputs — the reference's policy
    is to silently mask NaNs (ref: gaussfiltax/containers.py:83) or filter
    NaN rows out of experiment results.
    """
    bad = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        arr = jnp.asarray(leaf)
        if jnp.issubdtype(arr.dtype, jnp.floating) and not bool(
            jnp.all(jnp.isfinite(arr))
        ):
            bad.append(jax.tree_util.keystr(path))
    if bad:
        raise FloatingPointError(f"non-finite values in {name} at: {bad}")


def ess_diagnostics(weights: jax.Array) -> dict:
    """Weight-health metrics for mixture/particle banks: ESS, max weight,
    entropy."""
    w = weights / jnp.sum(weights, axis=-1, keepdims=True)
    ess = 1.0 / jnp.sum(jnp.square(w), axis=-1)
    entropy = -jnp.sum(jnp.where(w > 0, w * jnp.log(w), 0.0), axis=-1)
    return {"ess": ess, "max_weight": jnp.max(w, axis=-1), "entropy": entropy}


__all__ = ["BenchmarkResult", "benchmark", "trace", "debug_nans",
           "check_finite", "ess_diagnostics", "card_name_and_power_limit",
           "require_gpu"]
