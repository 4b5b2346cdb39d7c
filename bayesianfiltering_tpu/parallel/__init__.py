"""Multi-device scaling: mesh-batched filtering and sharded particle banks.

The reference is single-device only (``pmap`` is imported once and never
called, ref: gaussfiltax/inference.py:6; SURVEY.md §2.4). This package adds
the scaling layer: ``jax.sharding.Mesh`` + ``shard_map`` with XLA
collectives, which XLA hands to NCCL on GPUs.
"""
from bayesianfiltering_tpu.parallel.batch import batched_filter, make_mesh
from bayesianfiltering_tpu.parallel.mixture import sharded_gaussian_sum_filter
from bayesianfiltering_tpu.parallel.particle import sharded_bootstrap_particle_filter

__all__ = [
    "batched_filter",
    "make_mesh",
    "sharded_bootstrap_particle_filter",
    "sharded_gaussian_sum_filter",
]
