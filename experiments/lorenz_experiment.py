"""Lorenz-63/96 experiments (chaotic attractors, quadratic observations).

Rebuild of ref: docs/experiments/exp_lorentz63.py plus the Lorenz-96
high-dimensional sweep that BASELINE config 5 targets (dx up to 512, batched
sequences). The batched mode exercises the data-parallel path
(:mod:`bayesianfiltering_tpu.parallel.batch`).

Usage:
    python experiments/lorenz_experiment.py                  # Lorenz-63 comparison
    python experiments/lorenz_experiment.py --l96 --dx 512 --batch 64
"""
import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax
import jax.numpy as jnp
import jax.random as jr

import bayesianfiltering_tpu.inference as gf
from bayesianfiltering_tpu.models import zoo
from bayesianfiltering_tpu.ops import ParamsUKF
from experiments.common import print_summary, run_comparison


def lorenz63_comparison(args):
    model, params, bpf_params = zoo.lorenz63()
    T, M = args.seq_length, args.num_components

    def sample_fn(key):
        return model.sample(params, key, T)

    def point(post):
        return jnp.einsum("mt,mtd->td", post.weights, post.means)

    filters = {
        "EKF": lambda e, k: gf.extended_kalman_filter(params, e).filtered_means,
        # ParamsUKF(1,0,0): the default alpha=1e-3 gives W0c ~ -1e6 and
        # diverges on stiff models (EXPERIMENTS.md Notes; the reference's
        # own notebooks switch to (1,0,0) too)
        "UKF": lambda e, k: gf.unscented_kalman_filter(
            params, ParamsUKF(1.0, 0.0, 0.0), e
        ).filtered_means,
        "GSF": lambda e, k: point(gf.gaussian_sum_filter(params, e, M, 1)),
        "AGSF": lambda e, k: point(
            gf.augmented_gaussian_sum_filter(params, e, [M, 2, 2], k)[0]
        ),
        "BPF": lambda e, k: gf.bootstrap_particle_filter(
            bpf_params, e, args.bpf_particles, k, store="summary"
        )["means"],
    }
    summary = run_comparison(sample_fn, filters, n_sim=args.n_sim)
    print_summary(summary, f"Lorenz-63, T={T}, M={M}")


def lorenz96_sweep(args):
    """High-dim EKF/UKF throughput + accuracy over a batch of sequences."""
    model, params, _ = zoo.lorenz96(args.dx, args.dx // 2)
    T, B = args.seq_length, args.batch
    keys = jr.split(jr.PRNGKey(0), B)
    sample = jax.jit(
        lambda ks: jax.vmap(lambda k: model.sample(params, k, T))(ks)
    )
    states, emissions = jax.block_until_ready(sample(keys))

    filt = jax.jit(jax.vmap(
        lambda e: gf.extended_kalman_filter(params, e).filtered_means
    ))
    # Fetch-synced warm-up: no compile lands in the timed run.
    float(filt(emissions).ravel()[0])
    t0 = time.perf_counter()
    means = jax.block_until_ready(filt(emissions))
    float(means.ravel()[0])
    dt = time.perf_counter() - t0
    from bayesianfiltering_tpu.utils import rmse

    rmses = jax.vmap(rmse)(means, states)
    print(
        f"L96 dx={args.dx} B={B} T={T}: EKF {B*T/dt:,.0f} timestep-equiv/s, "
        f"RMSE {float(jnp.nanmean(rmses)):.3f}"
    )


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--l96", action="store_true")
    ap.add_argument("--dx", type=int, default=64)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--seq-length", type=int, default=100)
    ap.add_argument("--n-sim", type=int, default=5)
    ap.add_argument("--num-components", type=int, default=10)
    ap.add_argument("--bpf-particles", type=int, default=10_000)
    args = ap.parse_args()
    if args.l96:
        lorenz96_sweep(args)
    else:
        lorenz63_comparison(args)


if __name__ == "__main__":
    main()
