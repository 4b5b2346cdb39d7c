"""Sharded-AGSF scale check: gathered vs shard-local reduction at M·N·L ≥ 1e5.

Substantiates the ``reduction="local"`` scaling story
(parallel/mixture.py::sharded_agsf docstring) at the bank size it sells
(M ≥ 1e5 components in flight), on the 8-virtual-device CPU mesh — the
same validation surface the driver's dryrun uses. Reports:

  * wall/step for the gathered (``all_gather`` of the full M·N·L bank)
    and local (two scalar collectives only) reductions,
  * the analytic per-step collective payload of each mode,
  * agreement of the mixture point estimates between the two modes.

Provenance note: CPU-mesh walls validate the *collective structure* and
give an A/B of gathered-vs-local overhead on that mesh; they are not
device numbers.

Usage: python experiments/sharded_agsf_scale.py [--M 6400] [--N 4] [--L 4]
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--M", type=int, default=6400)
    ap.add_argument("--N", type=int, default=4)
    ap.add_argument("--L", type=int, default=4)
    ap.add_argument("--T", type=int, default=12)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()

    import __graft_entry__ as g

    if not g._force_cpu_devices(8):
        raise SystemExit(
            "backend already committed to a non-CPU platform — run in a "
            "fresh process (see __graft_entry__.dryrun_multichip)"
        )

    import jax
    import jax.numpy as jnp
    import jax.random as jr
    import numpy as np

    from bayesianfiltering_tpu.models import zoo
    from bayesianfiltering_tpu.parallel import make_mesh
    from bayesianfiltering_tpu.parallel.mixture import sharded_agsf

    assert len(jax.devices()) >= 8, jax.devices()
    mesh = make_mesh((8,), ("mixture",))

    model, params, _ = zoo.bearings_only_tracking()
    T = args.T
    inputs = zoo.bot_maneuver_inputs(T)
    _, emissions = model.sample(params, jr.PRNGKey(2), T, inputs=inputs)
    nc = [args.M, args.N, args.L]
    bank = args.M * args.N * args.L
    dx = 4
    gathered_bytes = bank * (dx * dx + dx + 1) * 4
    print(f"mesh=8  M·N·L = {args.M}·{args.N}·{args.L} = {bank}  dx={dx}")
    print(f"gathered-mode collective payload: {gathered_bytes / 1e6:.1f} "
          f"MB/step (all_gather of the full bank) + 2 scalars")
    print("local-mode collective payload: 2 scalars/step (pmax + psum)")

    results = {}
    for mode in ("systematic", "local"):
        run = jax.jit(lambda e: sharded_agsf(
            params, e, nc, mesh, key=jr.PRNGKey(7), opt_args=(0.1, 0.1),
            inputs=inputs, reduction=mode))
        t0 = time.perf_counter()
        out = run(emissions)
        np.asarray(out.means[0, 0])      # value fetch: compile + first run
        compile_s = time.perf_counter() - t0
        best = min(
            _timed(run, emissions, out) for _ in range(args.reps)
        )
        results[mode] = (out, best)
        print(f"{mode:12s} wall {best * 1e3:8.1f} ms  "
              f"({best / T * 1e3:6.2f} ms/step)  first-call {compile_s:5.1f} s",
              flush=True)

    (ref, _), (loc, _) = results["systematic"], results["local"]
    pt_ref = np.einsum("mt,mtd->td", ref.weights, ref.means)
    pt_loc = np.einsum("mt,mtd->td", loc.weights, loc.means)
    # per-(t,d) mixture std of the gathered mode (bit-equal to the
    # single-device engine, so it serves as the reference posterior)
    spread_td = np.sqrt(np.einsum(
        "mt,mtdd->td", ref.weights, ref.covariances))
    norm_gap = float(np.max(np.abs(pt_ref - pt_loc) / (spread_td + 0.05)))
    print(f"max point-estimate gap {np.max(np.abs(pt_ref - pt_loc)):.4f}; "
          f"max gap/posterior-std {norm_gap:.3f} "
          f"(mean spread {spread_td.mean():.4f})")
    # the local reduction must agree with the gathered posterior to within
    # its own posterior spread (estimator-level, not bit-level, agreement)
    assert norm_gap < 1.25, norm_gap
    np.testing.assert_allclose(np.sum(loc.weights, axis=0), np.ones(T),
                               rtol=1e-5)
    print("OK: modes agree at resampling-noise level; weights normalized")


def _timed(run, emissions, proto):
    import jax
    import numpy as np
    import time

    t0 = time.perf_counter()
    out = run(emissions)
    jax.block_until_ready(out)
    np.asarray(out.means[0, 0])
    return time.perf_counter() - t0


if __name__ == "__main__":
    main()
