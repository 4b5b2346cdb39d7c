"""Smoother comparison at the flagship BOT workload (NEW surface).

The reference ships NO smoother for its nonlinear models (its only
backward-pass artifact is the dead dynamax import,
ref: gaussfiltax/distributions.py:6); this driver benchmarks the rebuild's
smoother family on the reference's canonical range-bearing tracking model
(ref: docs/notebooks/BOTExperiment.ipynb cell 2 config):

* ERTS / URTS — sequential RTS passes (inference.py);
* parallel IEKS — log-depth iterated extended smoother, rollout init
  (ops/parallel_iterated.py, arXiv 2102.00514);
* parallel LM-IEKS — the accept/reject trust-region variant;
* parallel IPLS — iterated sigma-point (unscented SLR) smoother;
* EKF filter means — the no-smoothing baseline.

Usage:  python experiments/smoother_experiment.py [--seq-length 500]
        [--n-sim 20] [--num-iter 8]
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax.numpy as jnp

import bayesianfiltering_tpu.inference as gf
from bayesianfiltering_tpu.models import zoo
from bayesianfiltering_tpu.ops import (
    ParamsUKF,
    parallel_iterated_extended_smoother,
    parallel_iterated_sigma_point_smoother,
)
from experiments.common import latex_table, print_summary, run_comparison


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seq-length", type=int, default=500,
                    help="the canonical T=500 works since deviation-space "
                         "recentering + SLR PSD projection (round 3); "
                         "earlier builds were f32-limited above ~T=200")
    ap.add_argument("--n-sim", type=int, default=20)
    ap.add_argument("--num-iter", type=int, default=8)
    ap.add_argument("--latex", action="store_true")
    args = ap.parse_args()

    model, params, _ = zoo.range_bearing_tracking()
    inputs = zoo.bot_experiment_inputs(args.seq_length)
    uparams = ParamsUKF(1.0, 0.0, 0.0, "cholesky")
    ni = args.num_iter

    def sample_fn(key):
        return model.sample(params, key, args.seq_length, inputs=inputs)

    filters = {
        "EKF filter": lambda e, k: gf.extended_kalman_filter(
            params, e, inputs=inputs).filtered_means,
        "ERTS": lambda e, k: gf.extended_rts_smoother(
            params, e, inputs=inputs).smoothed_means,
        "URTS": lambda e, k: gf.unscented_rts_smoother(
            params, uparams, e, inputs=inputs).smoothed_means,
        # nominal="filter": the deterministic-rollout seed diverges from
        # the data exponentially on this UNSTABLE (1.05-drift) model —
        # seed-dependent heavy tails at T=100.
        "IEKS": lambda e, k: parallel_iterated_extended_smoother(
            params, e, num_iter=ni, inputs=inputs, nominal="filter",
            damping=0.7)[0].smoothed_means,
        "LM-IEKS": lambda e, k: parallel_iterated_extended_smoother(
            params, e, num_iter=ni, inputs=inputs, nominal="filter",
            lm_lambda=100.0)[0].smoothed_means,
        "IPLS": lambda e, k: parallel_iterated_sigma_point_smoother(
            params, uparams, e, num_iter=ni, inputs=inputs,
            nominal="filter")[0].smoothed_means,
    }

    summary = run_comparison(sample_fn, filters, n_sim=args.n_sim)
    title = (f"BOT smoothing, T={args.seq_length}, "
             f"{ni} iterations, n_sim={args.n_sim}")
    print_summary(summary, title)
    if args.latex:
        print(latex_table(summary, caption=title))


if __name__ == "__main__":
    main()
