"""Mesh helpers: one place to build `jax.sharding.Mesh`es.

Design per the scaling-book recipe: pick a mesh, annotate shardings with
NamedSharding, let XLA insert the collectives.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(shape: dict[str, int], devices=None) -> Mesh:
    """Build a mesh with named axes, e.g. ``{"data": 4, "model": 2}``."""
    devices = jax.devices() if devices is None else devices
    sizes = list(shape.values())
    n = int(np.prod(sizes))
    if n > len(devices):
        raise ValueError(f"mesh needs {n} devices, have {len(devices)}")
    arr = np.asarray(devices[:n]).reshape(sizes)
    return Mesh(arr, tuple(shape.keys()))


def corpus_mesh(n_shards: int | None = None, axis: str = "shard") -> Mesh:
    """1-D mesh over which the corpus rows are sharded (DP-of-the-database)."""
    devices = jax.devices()
    n = len(devices) if n_shards is None else n_shards
    return make_mesh({axis: n}, devices)


def slice_mesh(n_slices: int, per_slice: int | None = None, *,
               dcn_axis: str = "dcn", ici_axis: str = "shard",
               devices=None) -> Mesh:
    """2-D mesh for multi-slice deployments: ``(dcn, ici)`` axes.

    The outer axis spans slices (DCN links between them), the inner axis the
    chips within a slice (ICI). On real multi-slice hardware pass the device
    array from ``jax.experimental.mesh_utils.create_hybrid_device_mesh`` so
    the inner axis actually maps to intra-slice chips; on a single slice or
    the virtual CPU mesh, the reshape below produces the same logical layout
    (device order groups each slice's chips contiguously — jax.devices()
    orders devices by (slice, chip)).
    """
    devices = jax.devices() if devices is None else devices
    if per_slice is None:
        if len(devices) % n_slices:
            raise ValueError(
                f"{len(devices)} devices do not divide into {n_slices} slices")
        per_slice = len(devices) // n_slices
    return make_mesh({dcn_axis: n_slices, ici_axis: per_slice}, devices)
