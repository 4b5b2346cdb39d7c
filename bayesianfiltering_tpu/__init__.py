"""bayesianfiltering_tpu — a Bayesian filtering framework on JAX.

A from-scratch JAX/XLA/Pallas rebuild of the capability surface of
kostastsa/BayesianFiltering ("gaussfiltax"): Gaussian filters (EKF / UKF /
Monte-Carlo), Gaussian-sum filters, the Augmented Gaussian-Sum Filter (AGSF)
family with adaptive component splitting, and bootstrap particle filters —
plus the state-space-model definition layer (SSM base class, parameter
constraint system, EM/SGD fitting).

Design stance (see SURVEY.md):
  * struct-of-arrays Gaussian mixtures, static shapes, `lax.scan` over time,
    `vmap` over components/particles/sigma points;
  * Cholesky-based PSD solves and eigh-based matrix square roots (no Schur);
  * systematic resampling via parallel cumsum and one scatter;
  * explicit PRNG keys everywhere, with compat flags reproducing reference
    quirks where they matter for parity;
  * multi-device scaling via `jax.sharding.Mesh` + `shard_map` (batch- and
    particle-sharded filtering) — see `bayesianfiltering_tpu.parallel`.

Public API mirrors the reference's module-path layout:

    import bayesianfiltering_tpu.inference as gf
    from bayesianfiltering_tpu.models import ParamsNLSSM, ParamsBPF, NonlinearSSM
    from bayesianfiltering_tpu.inference import ParamsUKF
    import bayesianfiltering_tpu.utils as utils
    import bayesianfiltering_tpu.containers as containers
"""

__version__ = "0.1.0"

from bayesianfiltering_tpu import utils as utils
from bayesianfiltering_tpu import containers as containers
from bayesianfiltering_tpu import distributions as distributions
from bayesianfiltering_tpu import inference as inference
from bayesianfiltering_tpu import models as models
from bayesianfiltering_tpu import ops as ops
from bayesianfiltering_tpu import parallel as parallel
from bayesianfiltering_tpu import streaming as streaming
from bayesianfiltering_tpu import diagnostics as diagnostics
from bayesianfiltering_tpu import legacy as legacy
from bayesianfiltering_tpu import config as config

from bayesianfiltering_tpu.models import (
    ParamsNLSSM,
    ParamsBPF,
    NonlinearSSM,
    NonlinearGaussianSSM,
)
from bayesianfiltering_tpu.inference import ParamsUKF, PosteriorGaussianSumFiltered

__all__ = [
    "utils",
    "containers",
    "distributions",
    "inference",
    "models",
    "ops",
    "parallel",
    "streaming",
    "diagnostics",
    "legacy",
    "config",
    "ParamsNLSSM",
    "ParamsBPF",
    "NonlinearSSM",
    "NonlinearGaussianSSM",
    "ParamsUKF",
    "PosteriorGaussianSumFiltered",
]
