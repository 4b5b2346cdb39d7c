"""Factorization sweep on the card: which Cholesky + triangular inverse, and
which PSD square root, a filter step should use at each size.

Per-step cost of ``(L, L⁻¹)`` for each implementation, by the chained-scan
slope protocol: K chained steps inside one ``lax.scan`` (each step's output
feeds the next input, so nothing is hoisted or dead-code-eliminated), timed
at two K; the slope ``(wall_K2 − wall_K1)/(K2 − K1)`` is the per-step
device cost with dispatch overhead cancelled.

Rows:
* batched ``(B, n, n)`` — the layout of vmapped filters and mixture banks;
* unbatched ``(n, n)`` inside a scan — the single-stream filters;
* PSD square root: Newton–Schulz (matmuls only) vs ``eigh``.

Usage: python experiments/chol_crossover.py [--B 512]
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

from bayesianfiltering_tpu import diagnostics
from bayesianfiltering_tpu.config import enable_compile_cache
from bayesianfiltering_tpu.utils import linalg as la


def _native(S):
    L = jnp.linalg.cholesky(S)
    eye = jnp.broadcast_to(jnp.eye(S.shape[-1], dtype=S.dtype), S.shape)
    return L, jax.scipy.linalg.solve_triangular(L, eye, lower=True)


def _unrolled(S):
    L = la._chol_unrolled(S)
    return L, la._tri_inv_unrolled(L)


_IMPLS = {"native": _native, "unrolled": _unrolled,
          "dispatch": la.chol_and_inv_lower}     # what factor_impl picks


def _time(run, S):
    t0 = time.perf_counter()
    jax.block_until_ready(run(S))
    compile_s = time.perf_counter() - t0
    best = np.inf
    for _ in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(run(S))
        best = min(best, time.perf_counter() - t0)
    return best, compile_s


def _chain_factor(fn, K):
    def step(S, _):
        L, Li = fn(S)
        # rebuild a PSD matrix from both outputs so the chain needs them
        S2 = jnp.einsum("...ji,...jk->...ik", Li, Li) + L
        S2 = 0.5 * (S2 + jnp.swapaxes(S2, -1, -2))
        n = S.shape[-1]
        S2 = S2 @ jnp.swapaxes(S2, -1, -2)
        S2 = S2 / (jnp.trace(S2, axis1=-2, axis2=-1)[..., None, None] / n)
        return S2 + 0.1 * jnp.eye(n, dtype=S.dtype), L[..., 0, 0]

    return jax.jit(lambda S: jax.lax.scan(step, S, jnp.arange(K))[1])


def _chain_sqrt(fn, K):
    def step(S, _):
        R = fn(S)
        n = S.shape[-1]
        S2 = R @ jnp.swapaxes(R, -1, -2) + 0.1 * jnp.eye(n, dtype=S.dtype)
        S2 = S2 / (jnp.trace(S2, axis1=-2, axis2=-1)[..., None, None] / n)
        return S2, R[..., 0, 0]

    return jax.jit(lambda S: jax.lax.scan(step, S, jnp.arange(K))[1])


def _psd(batch, n, seed):
    a = jr.normal(jr.PRNGKey(seed), batch + (n, n))
    return jnp.einsum("...ik,...jk->...ij", a, a) / n + jnp.eye(n)


def _row(label, chain, fn, S, k1, k2):
    try:
        (w1, c1), (w2, _) = _time(chain(fn, k1), S), _time(chain(fn, k2), S)
        slope = (w2 - w1) / (k2 - k1)
        print(f"{label:44s} {slope * 1e6:10.2f} us/step  "
              f"compile {c1:7.2f} s", flush=True)
    except Exception as e:  # report and go on: one impl may not lower
        print(f"{label:44s} FAILED {type(e).__name__}: {str(e)[:160]}",
              flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--B", type=int, default=512)
    ap.add_argument("--K1", type=int, default=20)
    ap.add_argument("--K2", type=int, default=120)
    ap.add_argument("--batched-ns", default="4,8,16,32,64,128")
    ap.add_argument("--unbatched-ns", default="4,8,64,128,512")
    ap.add_argument("--impls", default="unrolled,native,dispatch")
    ap.add_argument("--unrolled-max", type=int, default=16,
                    help="largest n timed in the unrolled form (its graph "
                         "grows as n³ and compiles for tens of seconds)")
    args = ap.parse_args()
    enable_compile_cache()
    print(diagnostics.card_name_and_power_limit())
    dev = diagnostics.require_gpu()
    print(f"platform={dev.platform} kind={dev.device_kind} "
          f"count={len(jax.devices())} B={args.B} K={args.K1},{args.K2}")
    impls = args.impls.split(",")

    with jax.default_matmul_precision("highest"):
        for n in [int(x) for x in args.batched_ns.split(",")]:
            S = _psd((args.B,), n, n)
            for name in impls:
                if name == "unrolled" and n > args.unrolled_max:
                    continue
                _row(f"chol+inv batched B={args.B} n={n} {name}",
                     _chain_factor, _IMPLS[name], S, args.K1, args.K2)
        for n in [int(x) for x in args.unbatched_ns.split(",")]:
            S = _psd((), n, n)
            for name in impls:
                if name == "unrolled" and n > args.unrolled_max:
                    continue
                _row(f"chol+inv unbatched n={n} {name}",
                     _chain_factor, _IMPLS[name], S, args.K1, args.K2)
        for batch, n in [((args.B,), 4), ((args.B,), 8), ((args.B,), 32),
                         ((args.B,), 64), ((), 64), ((), 128)]:
            S = _psd(batch, n, 7 * n)
            tag = f"B={batch[0]}" if batch else "unbatched"
            _row(f"sqrtm {tag} n={n} newton_schulz", _chain_sqrt,
                 la.sqrtm_psd_ns, S, args.K1, args.K2)
            _row(f"sqrtm {tag} n={n} eigh", _chain_sqrt,
                 la.sqrtm_psd_eigh, S, args.K1, args.K2)


if __name__ == "__main__":
    main()
