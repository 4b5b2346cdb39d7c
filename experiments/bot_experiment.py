"""BOT T=500 tracking benchmark (range+bearing, maneuvering target).

Rebuild of the reference's canonical experiment
(ref: docs/notebooks/BOTExperiment.ipynb cells 2/6/7, BASELINE.md "BOT
tracking" rows). The notebook's exact configuration is the default:

* model ``zoo.range_bearing_tracking()`` — 1.05·F_CV maneuvering dynamics,
  emission (bearing, range), Q=1e-5, R=2.5e-5, T=500, maneuver schedule
  2/5–1/5–2/5 with u ∈ {1, 0, 2};
* GSF/UGSF with M=100, ParamsUKF(1,0,0);
* AGSF-ref: [2,2,2], opt_args=(0.8,0.8), multinomial reduction — the
  notebook's cell-6 settings (reported 3.09±0.63 over Nsim=10);
* AGSF-rec: [16,2,2], opt_args=(0.9,0.9), systematic reduction — this package's
  recommended configuration (Nsim=100 sweep, EXPERIMENTS.md round 2): iid
  multinomial reduction at M=2 occasionally kills the only on-track
  component (catastrophic RMSE outliers), and top-k stays heavy-tailed at
  narrow banks (mean 14.2 at [8,2,2], 2.45 at [16,2,2]); low-variance
  systematic reduction over the component weights gives mean 1.71
  [1.40, 2.08] — 1.8× better than the reference's headline;
* UAGSF-rec: the same [16,2,2]+(0.9,0.9)+systematic recipe applied to the
  UKF-moment AGSF — mean 1.87 [1.53, 2.25], median 1.31, zero divergent at
  Nsim=100, 96 ms/run (the reference's UAGSF diverges: 498±260 at 2.44 s);
* BPF with 10k particles (notebook cell 6).

Reference per-sim AGSF values (committed notebook output): 3.78, 7.50,
2.56, 4.90, 1.37, 4.30, 0.48, 4.10, 0.40, 2.26 → 3.09±0.63 (bootstrap).

Usage:  python experiments/bot_experiment.py [--seq-length 500] [--n-sim 100]
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax.numpy as jnp

import bayesianfiltering_tpu.inference as gf
from bayesianfiltering_tpu.models import zoo
from bayesianfiltering_tpu.ops import ParamsUKF
from experiments.common import latex_table, print_summary, run_comparison


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seq-length", type=int, default=500)
    ap.add_argument("--n-sim", type=int, default=100,
                    help="reference script uses 100 "
                         "(BOT_Experiment_script.py:70); its notebook 10")
    ap.add_argument("--num-components", type=int, default=100,
                    help="M for GSF/UGSF (notebook cell 6)")
    ap.add_argument("--bpf-particles", type=int, default=10_000)
    ap.add_argument("--latex", action="store_true")
    ap.add_argument("--variant", choices=["bearing", "range-bearing"],
                    default="range-bearing",
                    help="'range-bearing' is the reference's T=500 notebook "
                         "config (observable range); 'bearing' the "
                         "test-suite bearing-only config (unobservable "
                         "range, diverges at long horizons)")
    args = ap.parse_args()

    if args.variant == "range-bearing":
        model, params, bpf_params = zoo.range_bearing_tracking()
        inputs = zoo.bot_experiment_inputs(args.seq_length)
    else:
        model, params, bpf_params = zoo.bearings_only_tracking()
        inputs = zoo.bot_maneuver_inputs(args.seq_length)
    M = args.num_components
    uparams = ParamsUKF(1.0, 0.0, 0.0)

    def sample_fn(key):
        return model.sample(params, key, args.seq_length, inputs=inputs)

    def point(post):
        return jnp.einsum("mt,mtd->td", post.weights, post.means)

    filters = {
        "GSF": lambda e, k: point(
            gf.gaussian_sum_filter(params, e, M, 1, inputs)
        ),
        "UGSF": lambda e, k: point(
            gf.unscented_gaussian_sum_filter(params, uparams, e, M, 1, inputs)
        ),
        # The notebook's exact AGSF settings.
        "AGSF-ref": lambda e, k: point(
            gf.augmented_gaussian_sum_filter(
                params, e, [2, 2, 2], k, 1, (0.8, 0.8), inputs,
                reduction="multinomial",
            )[0]
        ),
        # This package's recommended configuration (EXPERIMENTS.md sweep).
        "AGSF-rec": lambda e, k: point(
            gf.augmented_gaussian_sum_filter(
                params, e, [16, 2, 2], k, 1, (0.9, 0.9), inputs,
                reduction="systematic",
            )[0]
        ),
        "UAGSF": lambda e, k: point(
            gf.unscented_agsf(
                params, uparams, e, [2, 2, 2], k, 1, (0.8, 0.8), inputs
            )[0]
        ),
        "UAGSF-rec": lambda e, k: point(
            gf.unscented_agsf(
                params, uparams, e, [16, 2, 2], k, 1, (0.9, 0.9), inputs,
                reduction="systematic",
            )[0]
        ),
        "BPF": lambda e, k: gf.bootstrap_particle_filter(
            bpf_params, e, args.bpf_particles, k, inputs, store="summary"
        )["means"],
    }

    summary = run_comparison(sample_fn, filters, n_sim=args.n_sim)
    print_summary(summary, f"BOT tracking, T={args.seq_length}, "
                           f"GSF M={M}, BPF={args.bpf_particles}, "
                           f"n_sim={args.n_sim}")
    if args.latex:
        print(latex_table(summary, caption="BOT range-bearing tracking"))


if __name__ == "__main__":
    main()
