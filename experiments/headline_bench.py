"""Time the headline rows on the card under the fetch-synced protocol.

Rows:
  * batched EKF  Lorenz-96 dx=64/dy=32, B=512, T=1000  (north star row)
  * batched UKF  additive + non-additive (augmented), same workload
  * single-stream EKF dx=64
  * single-stream UKF dx=64 (sqrtm + cholesky factor)
  * EKF / UKF at dx=512 (BASELINE config 5)
  * 1M-particle bootstrap PF, dx=8

Usage: python experiments/headline_bench.py [--rows ekf,ukf,...]
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax
import jax.numpy as jnp
import jax.random as jr

from bayesianfiltering_tpu.diagnostics import benchmark


def _data(model, data_params, T, batch, key=0):
    sample = jax.jit(lambda k: jax.vmap(
        lambda kk: model.sample(data_params, kk, T)[1])(jr.split(k, batch)))
    em = sample(jr.PRNGKey(key))
    assert bool(jnp.isfinite(em).all())
    return em


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", default="")
    ap.add_argument("--T", type=int, default=1000)
    args = ap.parse_args()
    only = set(filter(None, args.rows.split(",")))

    import bayesianfiltering_tpu.inference as gf
    from bayesianfiltering_tpu.models import zoo
    from bayesianfiltering_tpu.ops import ParamsUKF

    from bayesianfiltering_tpu import diagnostics
    from bayesianfiltering_tpu.config import enable_compile_cache

    enable_compile_cache()
    print(diagnostics.card_name_and_power_limit())
    dev = diagnostics.require_gpu()
    print(f"platform={dev.platform} kind={dev.device_kind} devices={jax.devices()}")
    T = args.T

    def report(name, fn, *a, steps=None):
        if only and name not in only:
            return
        r = benchmark(fn, *a, num_runs=3)
        print(f"{name:40s} {steps / r.best:12,.0f} steps/s   "
              f"best {r.best:7.3f} s   first-call {r.compile_time:6.1f} s",
              flush=True)

    # dx=64 workloads (data from RK4 model so emissions are finite).
    model, params, _ = zoo.lorenz96(64, 32)
    dmodel, dparams, _ = zoo.lorenz96(64, 32, integrator="rk4")
    B = 512
    em = _data(dmodel, dparams, T, B)

    report("EKF batched dx=64 B=512",
           lambda e: jax.vmap(lambda x: gf.extended_kalman_filter(
               params, x).filtered_means)(e), em, steps=B * T)
    up = ParamsUKF(1.0, 0.0, 0.0, sqrt_method="cholesky")
    report("UKF additive batched dx=64 B=512",
           lambda e: jax.vmap(lambda x: gf.unscented_kalman_filter(
               params, up, x, additive=True).filtered_means)(e),
           em, steps=B * T)
    report("UKF augmented batched dx=64 B=512",
           lambda e: jax.vmap(lambda x: gf.unscented_kalman_filter(
               params, up, x, additive=False).filtered_means)(e),
           em, steps=B * T)

    report("EKF single-stream dx=64",
           lambda e: gf.extended_kalman_filter(params, e).filtered_means,
           em[0], steps=T)
    report("UKF single-stream dx=64 (cholesky)",
           lambda e: gf.unscented_kalman_filter(
               params, up, e, additive=True).filtered_means,
           em[0], steps=T)
    ups = ParamsUKF(1.0, 0.0, 0.0, sqrt_method="sqrtm")
    report("UKF single-stream dx=64 (sqrtm)",
           lambda e: gf.unscented_kalman_filter(
               params, ups, e, additive=True).filtered_means,
           em[0], steps=T)

    # dx=512 (BASELINE config 5)
    if not only or {"ekf512", "ukf512"} & only:
        m5, p5, _ = zoo.lorenz96(512, 256)
        d5, dp5, _ = zoo.lorenz96(512, 256, integrator="rk4")
        em5 = _data(d5, dp5, 200, 1)[0]
        report("ekf512", lambda e: gf.extended_kalman_filter(
            p5, e).filtered_means, em5, steps=200)
        report("ukf512", lambda e: gf.unscented_kalman_filter(
            p5, up, e, additive=True).filtered_means, em5, steps=200)

    # 1M-particle BPF dx=8
    if not only or "bpf" in only:
        mb, pb, bpfp = zoo.lorenz96(8, 4)
        db, dpb, _ = zoo.lorenz96(8, 4, integrator="rk4")
        emb = _data(db, dpb, 100, 1)[0]
        report("bpf 1M particles dx=8",
               lambda e: gf.bootstrap_particle_filter(
                   bpfp, e, 1_000_000, jr.PRNGKey(1),
                   store="summary")["means"],
               emb, steps=100)


if __name__ == "__main__":
    main()
