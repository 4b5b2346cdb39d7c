"""Data-parallel filtering over batches of independent sequences.

BASELINE config 5 runs 1k Lorenz-96 sequences; the shape for that is
``vmap`` over the sequence axis jitted under a sharding that lays the batch
across a flat mesh axis — XLA then runs each device's shard locally with no
collectives (embarrassingly parallel; only the final gather crosses devices).
"""
from __future__ import annotations

from functools import lru_cache
from typing import Callable, Optional, Sequence

import jax
import jax.tree_util as jtu
import numpy as np
from jax import vmap
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(axis_sizes: Sequence[int], axis_names: Sequence[str],
              devices=None) -> Mesh:
    """Build a :class:`jax.sharding.Mesh` over the available devices."""
    devices = jax.devices() if devices is None else devices
    n = int(np.prod(axis_sizes))
    if n > len(devices):
        raise ValueError(f"mesh of size {n} exceeds {len(devices)} devices")
    grid = np.asarray(devices[:n]).reshape(tuple(axis_sizes))
    return Mesh(grid, tuple(axis_names))


def _is_array(x) -> bool:
    return isinstance(x, (jax.Array, np.ndarray))


def _canon(x):
    if isinstance(x, list):
        return ("__list__",) + tuple(_canon(i) for i in x)
    if isinstance(x, tuple):
        return ("__tuple__",) + tuple(_canon(i) for i in x)
    hash(x)  # raises TypeError for unhashable statics -> uncached fallback
    return x


class _Static:
    """Hashable wrapper for a static value (lists hashed by content); the
    wrapped original is what gets passed back into the filter call."""

    __slots__ = ("value", "_key")

    def __init__(self, value):
        self._key = _canon(value)
        self.value = value

    def __hash__(self):
        return hash(self._key)

    def __eq__(self, other):
        return isinstance(other, _Static) and self._key == other._key


@lru_cache(maxsize=128)
def _cached_batched_fn(filter_fn, treedef, leaf_mask, static_leaves,
                       args_mask, static_args, kw_names, kw_mask, static_kw,
                       has_inputs):
    """Build (once per configuration) the jitted batched filter.

    Arrays — params leaves, PRNG keys, time-varying noise stacks — stay
    *traced* arguments, so repeated calls with new data reuse the compiled
    executable instead of re-tracing a fresh closure per call. Callables and scalar hyper-parameters are
    closed over statically (they shape the computation).
    """

    def rebuild(masks, arrays, statics):
        arrays, statics = iter(arrays), iter(statics)
        return [next(arrays) if m else next(statics).value for m in masks]

    def fn(arr_leaves, batch_emissions, batch_inputs, arr_args, arr_kw):
        params = jtu.tree_unflatten(
            treedef, rebuild(leaf_mask, arr_leaves, static_leaves)
        )
        f_args = rebuild(args_mask, arr_args, static_args)
        kw_vals = rebuild(kw_mask, arr_kw, static_kw)
        kwargs = dict(zip(kw_names, kw_vals))

        def single(emissions, inputs):
            return filter_fn(params, emissions, *f_args, inputs=inputs,
                             **kwargs)

        if has_inputs:
            return vmap(single)(batch_emissions, batch_inputs)
        return vmap(lambda e: single(e, None))(batch_emissions)

    return jax.jit(fn)


def batched_filter(
    filter_fn: Callable,
    params,
    batch_emissions: jax.Array,
    *filter_args,
    mesh: Optional[Mesh] = None,
    axis_name: str = "batch",
    batch_inputs: Optional[jax.Array] = None,
    **filter_kwargs,
):
    """Run ``filter_fn(params, emissions, *args, inputs=..., **kwargs)`` over
    a leading batch of sequences, sharded across ``mesh[axis_name]``.

    ``batch_emissions`` has shape (B, T, dy); outputs keep the leading B
    axis. Without a mesh this is a plain jitted vmap (single device).
    Repeated calls with the same filter/hyper-parameter configuration hit the
    jit cache — only array contents may change without recompiling.
    """
    leaves, treedef = jtu.tree_flatten(params)
    leaf_mask = tuple(_is_array(l) for l in leaves)
    arr_leaves = [l for l in leaves if _is_array(l)]
    args_mask = tuple(_is_array(a) for a in filter_args)
    arr_args = [a for a in filter_args if _is_array(a)]
    kw_items = sorted(filter_kwargs.items())
    kw_names = tuple(k for k, _ in kw_items)
    kw_mask = tuple(_is_array(v) for _, v in kw_items)
    arr_kw = [v for _, v in kw_items if _is_array(v)]

    try:
        fn = _cached_batched_fn(
            filter_fn, treedef, leaf_mask,
            tuple(_Static(l) for l in leaves if not _is_array(l)),
            args_mask,
            tuple(_Static(a) for a in filter_args if not _is_array(a)),
            kw_names, kw_mask,
            tuple(_Static(v) for _, v in kw_items if not _is_array(v)),
            batch_inputs is not None,
        )
    except TypeError:
        # Unhashable static somewhere: fall back to a one-shot closure.
        def fn(arr_leaves, batch_emissions, batch_inputs, arr_args, arr_kw):
            def single(emissions, inputs):
                return filter_fn(params, emissions, *filter_args,
                                 inputs=inputs, **filter_kwargs)

            if batch_inputs is not None:
                return vmap(single)(batch_emissions, batch_inputs)
            return vmap(lambda e: single(e, None))(batch_emissions)

    if mesh is not None:
        shard = lambda a: jax.device_put(
            a, NamedSharding(mesh, P(axis_name, *([None] * (a.ndim - 1))))
        )
        batch_emissions = shard(batch_emissions)
        if batch_inputs is not None:
            batch_inputs = shard(batch_inputs)
        # Output shardings are propagated by XLA from the sharded inputs.
    return fn(arr_leaves, batch_emissions, batch_inputs, arr_args, arr_kw)


__all__ = ["make_mesh", "batched_filter"]
