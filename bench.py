"""Headline benchmark: batched EKF throughput at dx=64 (BASELINE config 2).

Metric: timestep-equivalents per second of a jitted EKF on the dx=64,
dy=32 Lorenz-96 model, vmapped over 512 independent sequences of 1000
steps (the many-independent-tracks layout: one card, ``vmap`` over
sequences).

Runs on the GPU only: with no card it exits non-zero instead of timing the
CPU. Prints the platform, device kind, device count and the card's name and
power limit, then ONE JSON line ``{"metric", "value", "unit", "compile_s",
"device"}``. Compilation is set-up time, reported separately; the
persistent compile cache (``JAX_COMPILATION_CACHE_DIR``, else
``<repo>/.jax_cache``) shortens it on a second run.
"""
import json
import time

import jax

from bayesianfiltering_tpu import diagnostics
from bayesianfiltering_tpu.config import enable_compile_cache

STATE_DIM = 64
EMISSION_DIM = 32
NUM_STEPS = 1_000
BATCH = 512


def main():
    enable_compile_cache()
    card = diagnostics.card_name_and_power_limit()
    dev = diagnostics.require_gpu()

    import jax.random as jr

    import bayesianfiltering_tpu.inference as gf
    from bayesianfiltering_tpu.models import zoo

    model, params, _ = zoo.lorenz96(STATE_DIM, EMISSION_DIM)
    # Data comes from the RK4-integrated model: the reference-style Euler
    # step is unstable at dt=0.01 (most noisy trajectories leave f32 range
    # mid-sequence). The FILTER still runs the Euler dynamics above, so the
    # measured workload is unchanged; the emissions are finite.
    data_model, data_params, _ = zoo.lorenz96(STATE_DIM, EMISSION_DIM,
                                              integrator="rk4")
    sample = jax.jit(
        lambda k: jax.vmap(
            lambda kk: data_model.sample(data_params, kk, NUM_STEPS)[1]
        )(jr.split(k, BATCH))
    )
    emissions = jax.block_until_ready(sample(jr.PRNGKey(0)))
    if not bool(jax.numpy.all(jax.numpy.isfinite(emissions))):
        raise SystemExit("non-finite emissions")

    filt = jax.jit(
        jax.vmap(lambda e: gf.extended_kalman_filter(params, e).filtered_means)
    )
    t0 = time.perf_counter()
    out = jax.block_until_ready(filt(emissions))
    compile_s = time.perf_counter() - t0
    if not bool(jax.numpy.all(jax.numpy.isfinite(out))):
        raise SystemExit("non-finite filter output")

    best = float("inf")
    for _ in range(5):
        t0 = time.perf_counter()
        jax.block_until_ready(filt(emissions))
        best = min(best, time.perf_counter() - t0)

    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    print(f"platform={device['platform']} kind={device['kind']} "
          f"count={device['count']}")
    print(card)
    print(json.dumps({
        "metric": "ekf_dx64_batched_timesteps_per_sec",
        "value": BATCH * NUM_STEPS / best,
        "unit": "timestep-equiv/s",
        "compile_s": compile_s,
        "device": device,
    }))


if __name__ == "__main__":
    main()
