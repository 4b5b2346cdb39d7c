"""Shared experiment harness: Monte-Carlo filter comparison with bootstrap
confidence intervals and LaTeX table output.

Rebuilds the reference's experiment scaffolding
(ref: docs/experiments/BOT_Experiment_script.py:150-246): run ``n_sim``
independent simulations, compute per-filter RMSE against ground truth and
wall-clock, bootstrap the mean RMSE CI, print a LaTeX table. NaN runs are
filtered out per filter (ref: docs/experiments/adaptive_experiment.py uses
``jnp.argwhere(jnp.isnan(...))`` similarly).

Timing discipline (unlike the reference's trace-time ``time.time`` deltas,
SURVEY.md §5.1): every filter is jitted once per experiment, warmed up, and
timed with ``jax.block_until_ready``.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Tuple

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np


def bootstrap_ci(values: np.ndarray, n_boot: int = 1000, seed: int = 0,
                 alpha: float = 0.05) -> Tuple[float, float, float]:
    """(mean, lo, hi) bootstrap CI of the mean
    (ref: docs/experiments/BOT_Experiment_script.py:184-196)."""
    rng = np.random.default_rng(seed)
    values = np.asarray(values)
    means = np.array([
        rng.choice(values, size=len(values), replace=True).mean()
        for _ in range(n_boot)
    ])
    return float(values.mean()), float(np.quantile(means, alpha / 2)), float(
        np.quantile(means, 1 - alpha / 2)
    )


def run_comparison(
    sample_fn: Callable,          # key -> (states, emissions)
    filters: Dict[str, Callable], # name -> (emissions, key) -> point estimates (T, dx)
    n_sim: int = 10,
    seed: int = 0,
) -> Dict[str, Dict]:
    """Monte-Carlo comparison: per-filter RMSE stats + steady-state runtime."""
    from bayesianfiltering_tpu.config import enable_compile_cache
    from bayesianfiltering_tpu.utils import rmse

    enable_compile_cache()
    jitted = {name: jax.jit(fn) for name, fn in filters.items()}

    # Warm-up compile on one dataset, synced by a value fetch, so no
    # compile lands in a timed rep.
    key0 = jr.PRNGKey(seed)
    states0, emissions0 = sample_fn(key0)
    for name, fn in jitted.items():
        out0 = fn(emissions0, key0)
        jax.device_get(jnp.ravel(jax.tree_util.tree_leaves(out0)[0])[0])

    results = {name: {"rmse": [], "time": []} for name in filters}
    for i in range(n_sim):
        key = jr.fold_in(jr.PRNGKey(seed), i)
        states, emissions = sample_fn(key)
        for name, fn in jitted.items():
            t0 = time.perf_counter()
            est = jax.block_until_ready(fn(emissions, key))
            dt = time.perf_counter() - t0
            results[name]["rmse"].append(float(rmse(est, states)))
            results[name]["time"].append(dt)

    summary = {}
    for name, r in results.items():
        arr = np.asarray(r["rmse"])
        ok = np.isfinite(arr)
        n_bad = int((~ok).sum())
        stats = {}
        if ok.any():
            mean, lo, hi = bootstrap_ci(arr[ok])
            stats.update(rmse_mean=mean, rmse_lo=lo, rmse_hi=hi,
                         rmse_median=float(np.median(arr[ok])))
        else:
            stats.update(rmse_mean=float("nan"), rmse_lo=float("nan"),
                         rmse_hi=float("nan"), rmse_median=float("nan"))
        stats.update(
            time_mean=float(np.mean(r["time"])),
            time_std=float(np.std(r["time"])),
            n_divergent=n_bad,
        )
        summary[name] = stats
    return summary


def latex_table(summary: Dict[str, Dict], caption: str = "") -> str:
    """LaTeX table like the reference's experiment output
    (ref: docs/experiments/BOT_Experiment_script.py:226-243)."""
    lines = [
        r"\begin{table}[h]",
        r"\centering",
        r"\begin{tabular}{lccc}",
        r"\hline",
        r"Filter & RMSE (95\% CI) & time [s] & divergent \\",
        r"\hline",
    ]
    for name, s in summary.items():
        lines.append(
            f"{name} & {s['rmse_mean']:.2f} "
            f"({s['rmse_lo']:.2f}--{s['rmse_hi']:.2f}) & "
            f"{s['time_mean']:.3f} $\\pm$ {s['time_std']:.3f} & "
            f"{s['n_divergent']} \\\\"
        )
    lines += [r"\hline", r"\end{tabular}",
              rf"\caption{{{caption}}}", r"\end{table}"]
    return "\n".join(lines)


def print_summary(summary: Dict[str, Dict], title: str):
    print(f"\n== {title} ==")
    for name, s in summary.items():
        print(
            f"{name:>8}: RMSE {s['rmse_mean']:8.3f} "
            f"[{s['rmse_lo']:.3f}, {s['rmse_hi']:.3f}] "
            f"median {s.get('rmse_median', float('nan')):8.3f}  "
            f"time {s['time_mean']*1e3:8.1f} ms  divergent {s['n_divergent']}"
        )


__all__ = ["bootstrap_ci", "run_comparison", "latex_table", "print_summary"]
