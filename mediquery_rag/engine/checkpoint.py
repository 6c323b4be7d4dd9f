"""Orbax checkpointing: sharded index + train state.

SURVEY §5 called for a 4th checkpoint mechanism beyond the reference's
three host-side stores: persist the *index* (sharded device arrays) so
build time amortizes across restarts. Orbax writes each shard from its
owning device (no host gather) and restores straight into a NamedSharding
layout over whatever mesh the loader provides — the accelerator-native path.
"""

from __future__ import annotations

import json
import os

import jax
import numpy as np
import orbax.checkpoint as ocp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from mediquery_rag.config import EngineConfig
from mediquery_rag.engine.sharded import ShardedFlatIndex, _shard_axes


def _arrays_dir(path: str) -> str:
    return os.path.join(os.path.abspath(path), "arrays")


def save_sharded_index(index: ShardedFlatIndex, path: str) -> None:
    """Write the sharded corpus (+scales) with orbax; meta as JSON."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    tree = {"corpus": index.corpus}
    if index.corpus_scale is not None:
        tree["scale"] = index.corpus_scale
    with ocp.PyTreeCheckpointer() as ckptr:
        ckptr.save(_arrays_dir(path), tree, force=True)
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump({
            "n": index.n,
            "n_pad": int(index.corpus.shape[0]),
            "d": int(index.corpus.shape[1]),
            "has_scale": index.corpus_scale is not None,
            "cfg": index.cfg.__dict__,
            "kind": "sharded_flat",
        }, f)


def load_sharded_index(path: str, mesh: Mesh) -> ShardedFlatIndex:
    """Restore straight into the mesh's sharded layout."""
    path = os.path.abspath(path)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    cfg = EngineConfig.from_saved(meta["cfg"])
    axis = _shard_axes(cfg, mesh)     # (ici,) or (dcn, ici): restores into
    import jax.numpy as jnp           # the hierarchical layout when set

    # int4 corpora are row-pair packed in int8 bytes: meta's "n_pad" is the
    # stored PHYSICAL byte-row count, and scales are [2, n_pad] planes
    # (even/odd logical rows) sharded along axis 1
    dtype = jnp.int8 if cfg.dtype in ("int8", "int4") else jnp.dtype(cfg.dtype)
    target = {
        "corpus": jax.ShapeDtypeStruct(
            (meta["n_pad"], meta["d"]), dtype,
            sharding=NamedSharding(mesh, P(axis, None))),
    }
    if meta["has_scale"]:
        if cfg.dtype == "int4":
            target["scale"] = jax.ShapeDtypeStruct(
                (2, meta["n_pad"]), jnp.float32,
                sharding=NamedSharding(mesh, P(None, axis)))
        else:
            target["scale"] = jax.ShapeDtypeStruct(
                (meta["n_pad"],), jnp.float32,
                sharding=NamedSharding(mesh, P(axis)))
    with ocp.PyTreeCheckpointer() as ckptr:
        restored = ckptr.restore(_arrays_dir(path), target)
    return ShardedFlatIndex(
        corpus=restored["corpus"], n=meta["n"], cfg=cfg, mesh=mesh,
        corpus_scale=restored.get("scale"),
    )


def save_sharded_ivf(index, path: str) -> None:
    """Checkpoint a ShardedIVFIndex: per-shard bucket arrays written by
    their owning devices (SURVEY §5's 'persist IVF centroids/assignments'),
    meta as JSON. Restores with :func:`load_sharded_ivf`."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    tree = {
        "centroids": index.centroids,
        "buckets": index.buckets,
        "bucket_ids": index.bucket_ids,
    }
    if index.bucket_scales is not None:
        tree["bucket_scales"] = index.bucket_scales
    with ocp.PyTreeCheckpointer() as ckptr:
        ckptr.save(_arrays_dir(path), tree, force=True)
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump({
            "n": index.n, "cap": index.cap, "nlist": index.nlist,
            "per_shard": index.per_shard,
            "rows": int(index.buckets.shape[0]),
            "d": int(index.buckets.shape[1]),
            "has_scales": index.bucket_scales is not None,
            "cfg": index.cfg.__dict__,
            "kind": "sharded_ivf",
        }, f)


def load_sharded_ivf(path: str, mesh: Mesh):
    from mediquery_rag.engine.sharded_ivf import ShardedIVFIndex
    import jax.numpy as jnp

    path = os.path.abspath(path)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    cfg = EngineConfig.from_saved(meta["cfg"])
    axis = _shard_axes(cfg, mesh)
    dtype = jnp.int8 if cfg.dtype in ("int8", "int4") else jnp.dtype(cfg.dtype)
    sh_rows = NamedSharding(mesh, P(axis, None))
    repl = NamedSharding(mesh, P())
    # meta["rows"] is the stored PHYSICAL row count: int4 buckets hold
    # cap/2 packed byte-rows per bucket, ids/scales stay [n_buckets, cap]
    per_bucket = meta["cap"] // 2 if cfg.dtype == "int4" else meta["cap"]
    n_buckets = meta["rows"] // per_bucket
    target = {
        "centroids": jax.ShapeDtypeStruct(
            (meta["nlist"], meta["d"]), jnp.float32, sharding=repl),
        "buckets": jax.ShapeDtypeStruct(
            (meta["rows"], meta["d"]), dtype, sharding=sh_rows),
        "bucket_ids": jax.ShapeDtypeStruct(
            (n_buckets, meta["cap"]), jnp.int32, sharding=sh_rows),
    }
    if meta["has_scales"]:
        target["bucket_scales"] = jax.ShapeDtypeStruct(
            (n_buckets, meta["cap"]), jnp.float32, sharding=sh_rows)
    with ocp.PyTreeCheckpointer() as ckptr:
        restored = ckptr.restore(_arrays_dir(path), target)
    return ShardedIVFIndex(
        centroids=restored["centroids"], buckets=restored["buckets"],
        bucket_ids=restored["bucket_ids"], n=meta["n"], cap=meta["cap"],
        nlist=meta["nlist"], per_shard=meta["per_shard"], cfg=cfg, mesh=mesh,
        bucket_scales=restored.get("bucket_scales"),
    )


def save_train_state(state, path: str) -> None:
    """Checkpoint a models.trainer.TrainState (params + opt + step)."""
    with ocp.PyTreeCheckpointer() as ckptr:
        ckptr.save(os.path.abspath(path),
                   {"params": state.params,
                    "opt_state": state.opt_state,
                    "step": np.asarray(state.step)},
                   force=True)


def load_train_state(path: str, template):
    """Restore into the structure/shardings of ``template`` (a TrainState)."""
    import jax.numpy as jnp

    from mediquery_rag.models.trainer import TrainState

    target = {
        "params": template.params,
        "opt_state": template.opt_state,
        "step": np.asarray(template.step),
    }
    abstract = jax.tree_util.tree_map(ocp.utils.to_shape_dtype_struct, target)
    with ocp.PyTreeCheckpointer() as ckptr:
        restored = ckptr.restore(os.path.abspath(path), abstract)
    return TrainState(restored["params"], restored["opt_state"],
                      jnp.asarray(restored["step"]))
