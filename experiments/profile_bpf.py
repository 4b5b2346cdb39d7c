"""1M-particle BPF step anatomy under the slope protocol: the cost of each
stage of the in-scan resampling, measured as wall(T2) − wall(T1) over
chained scans, which cancels dispatch latency and warm-up artifacts.

Stages (each a chained scan; every stage feeds its result into the next
step's weights so nothing is DCE'd):
  base      propagate-ish weight churn + normalize (no resampling)
  counts    + the closed-form cumulative-count build (cumsum + ceil)
  parents   + counts→parents (scatter-add + cumsum)  <-- the accused op
  gather    + the particle row gather
  full      the real bootstrap_particle_filter, resampling every step

Usage: python experiments/profile_bpf.py [--n 1000000] [--dx 8]
       [--T1 50] [--T2 200]
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np

from bayesianfiltering_tpu.utils.resampling import (
    _scatter_counts_to_parents as _counts_to_parents,
)


def _wall(fn, *args):
    """Compile, value-fetch warmup, then best-of-3 block-timed walls."""
    out = fn(*args)
    np.asarray(jax.tree_util.tree_leaves(out)[0]).ravel()[:1]  # materialize
    best = np.inf
    for _ in range(3):
        t0 = time.perf_counter()
        out = fn(*args)
        jax.block_until_ready(out)
        np.asarray(jax.tree_util.tree_leaves(out)[0]).ravel()[:1]
        best = min(best, time.perf_counter() - t0)
    return best


def _slope(make_fn, T1, T2, *args):
    w1 = _wall(make_fn(T1), *args)
    w2 = _wall(make_fn(T2), *args)
    return (w2 - w1) / (T2 - T1), w1, w2


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--dx", type=int, default=8)
    ap.add_argument("--T1", type=int, default=50)
    ap.add_argument("--T2", type=int, default=200)
    args = ap.parse_args()
    n, dx = args.n, args.dx
    from bayesianfiltering_tpu import diagnostics
    from bayesianfiltering_tpu.config import enable_compile_cache

    enable_compile_cache()
    print(diagnostics.card_name_and_power_limit())
    dev = diagnostics.require_gpu()
    print(f"kind={dev.device_kind}  n={n}  dx={dx}  "
          f"T1={args.T1} T2={args.T2}")

    key = jr.PRNGKey(0)
    particles0 = jr.normal(key, (n, dx))
    lw0 = jnp.full((n,), -jnp.log(n))

    def stage_scan(stage):
        """Chained scan whose step runs the pipeline up to `stage`."""

        def step(carry, t):
            lw, p = carry
            # weight churn standing in for propagate+weight (cheap, fused)
            lw = lw + 0.01 * jnp.tanh(p[:, 0])
            lw = lw - jax.scipy.special.logsumexp(lw)
            w = jnp.exp(lw)
            if stage == "base":
                return (lw, p), w[0]
            u0 = jnp.float32(0.3)
            cdf = jnp.cumsum(w)
            cdf = cdf / cdf[-1]
            counts = jax.lax.cummax(jnp.clip(jnp.ceil(n * cdf - u0), 0, n))
            if stage == "counts":
                # feed counts back so the build isn't DCE'd
                lw = lw + 1e-9 * counts[n // 2]
                return (lw, p), w[0]
            parents = _counts_to_parents(counts, n)
            if stage == "parents":
                lw = lw + 1e-9 * parents[n // 2].astype(lw.dtype)
                return (lw, p), w[0]
            gathered = jnp.take(p, parents, axis=0)
            return (jnp.full((n,), -jnp.log(n)), gathered), w[0]

        def make(T):
            @jax.jit
            def run(lw, p):
                return jax.lax.scan(step, (lw, p), jnp.arange(T))[1]

            return run

        return make

    rows = []
    for stage in ("base", "counts", "parents", "gather"):
        try:
            sl, w1, w2 = _slope(stage_scan(stage), args.T1, args.T2,
                                lw0, particles0)
        except Exception as e:  # report a stage that fails to compile
            print(f"{stage:8s} FAILED: {str(e)[:120]}", flush=True)
            continue
        rows.append((stage, sl))
        print(f"{stage:8s} {sl * 1e3:8.3f} ms/step   "
              f"(T1 wall {w1:6.3f} s, T2 wall {w2:6.3f} s)", flush=True)
    for (a, sa), (b, sb) in zip(rows, rows[1:]):
        print(f"  Δ {b:8s} − {a:8s} = {(sb - sa) * 1e3:8.3f} ms/step")

    # the real filter, resampling every step (ess_threshold > 1 forces it)
    from bayesianfiltering_tpu.inference import bootstrap_particle_filter
    from bayesianfiltering_tpu.models import zoo

    _, _, bpfp = zoo.lorenz96(dx, max(dx // 2, 1))
    dmodel, dparams, _ = zoo.lorenz96(dx, max(dx // 2, 1), integrator="rk4")
    em_T2 = jax.jit(lambda k: dmodel.sample(dparams, k, args.T2)[1])(
        jr.PRNGKey(3))

    def real(T, ess_threshold=2.0):
        em = em_T2[:T]

        @jax.jit
        def _run(e):
            return bootstrap_particle_filter(
                bpfp, e, n, jr.PRNGKey(1), ess_threshold=ess_threshold,
                store="summary")["means"]

        return lambda: _run(em)

    sl, w1, w2 = _slope(real, args.T1, args.T2)
    print(f"{'full BPF':8s} {sl * 1e3:8.3f} ms/step  = {1.0 / sl:,.0f} "
          f"steps/s  (T1 wall {w1:6.3f} s, T2 wall {w2:6.3f} s)")

    # the never-resample baseline: what resampling costs in the filter
    sl0, _, _ = _slope(lambda T: real(T, ess_threshold=0.0),
                       args.T1, args.T2)
    print(f"{'never-resample':8s} {sl0 * 1e3:8.3f} ms/step  "
          f"(resampling costs {(sl - sl0) * 1e3:.3f} ms/step)")


if __name__ == "__main__":
    main()
