"""Sharded flat index: corpus rows distributed over a device mesh.

The multi-device scale path (BASELINE config 5's 10M x 768, and past one
device's memory). Each device holds ``N/S`` rows and scores only its shard
with the flat scan (ops/scoring.py); the tiny per-shard top-k lists are
merged via all-gather (parallel/collectives.py). This is the TP-of-the-database pattern from
SURVEY §2c — the corpus axis is the sharded axis, queries are replicated.

Multi-slice deployments (cfg.dcn_axis set, mesh from parallel.slice_mesh):
rows shard over the ``(dcn, ici)`` axis product and the merge goes
hierarchical — wide candidate all-gather stays on ICI within each slice,
only the k per-slice finalists cross the slow DCN links
(collectives.hierarchical_topk_merge).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

import numpy as np

from mediquery_rag.config import EngineConfig
from mediquery_rag.engine.flat import (
    as_query_batch, bucket_queries, l2_normalize, prep_rows, _round_up,
)
from mediquery_rag.ops.scoring import flat_search
from mediquery_rag.ops.quant import int4_flat_search, int8_flat_search
from mediquery_rag.parallel.collectives import grouped_topk_merge


def _shard_axes(cfg: EngineConfig, mesh: Mesh) -> tuple[str, ...]:
    """Mesh axes the corpus rows shard over: ``(ici,)`` single-slice, or
    ``(dcn, ici)`` when cfg.dcn_axis names an axis of the mesh (rows are
    partitioned row-major over the product; the merge is hierarchical)."""
    if cfg.dcn_axis:
        if cfg.dcn_axis not in mesh.axis_names:
            raise ValueError(
                f"cfg.dcn_axis={cfg.dcn_axis!r} is not an axis of the mesh "
                f"{tuple(mesh.axis_names)}")
        return (cfg.dcn_axis, cfg.mesh_axis)
    return (cfg.mesh_axis,)


def _linear_shard_id(axes: tuple[str, ...], sizes: tuple[int, ...]):
    """This device's row-major rank over ``axes`` (inside shard_map)."""
    sid = jax.lax.axis_index(axes[0])
    for a, sz in zip(axes[1:], sizes[1:]):
        sid = sid * sz + jax.lax.axis_index(a)
    return sid


@dataclass
class ShardedFlatIndex:
    corpus: jax.Array          # [N_pad, D] sharded over mesh axis (rows)
    n: int                     # global valid rows
    cfg: EngineConfig
    mesh: Mesh
    corpus_scale: jax.Array | None = None   # [N_pad] f32, int8 only (sharded)

    @classmethod
    def build(cls, vectors, mesh: Mesh, cfg: EngineConfig = EngineConfig()):
        """Normalize + cast/quantize + pad in one program whose outputs are
        laid out row-sharded over the mesh (engine/flat.py:prep_rows). A
        ``vectors`` array already row-sharded over the same mesh is
        prepared in place on each device: no device ever holds the whole
        corpus, nor an f32 copy of its own shard."""
        v = vectors if isinstance(vectors, jax.Array) else jnp.asarray(vectors)
        n, d = v.shape
        axes = _shard_axes(cfg, mesh)
        s = int(np.prod([mesh.shape[a] for a in axes]))
        # pad so each shard holds a whole number of top-k blocks
        n_pad = _round_up(max(n, s * cfg.corpus_tile), s * cfg.corpus_tile)
        if cfg.dtype == "int4" and cfg.corpus_tile % 2:
            raise ValueError("int4 needs an even corpus_tile")
        rows_pad = n_pad // 2 if cfg.dtype == "int4" else n_pad
        rows_sh = NamedSharding(mesh, P(axes, None))
        scale_sh = {"int4": NamedSharding(mesh, P(None, axes)),
                    "int8": NamedSharding(mesh, P(axes))}.get(cfg.dtype)
        prep = jax.jit(
            partial(prep_rows, cosine=cfg.metric == "cosine",
                    dtype=cfg.dtype, rows_pad=rows_pad),
            out_shardings=(rows_sh, scale_sh, None))
        # int4 pads BEFORE packing inside prep_rows' quantize so row pairs
        # never straddle shard borders (n_pad is even per shard)
        if cfg.dtype == "int4" and n_pad != n:
            v = jnp.pad(v, ((0, n_pad - n), (0, 0)))
        v, scale, _ = prep(v)
        return cls(corpus=v, n=n, cfg=cfg, mesh=mesh, corpus_scale=scale)

    def search(self, queries, k: int | None = None):
        """Global top-k over all shards. Queries replicated, ``[B, k]`` out.

        Host-bucketed batch + single-trace dispatch (normalize inside the
        jit), same serving rationale as ``FlatIndex.search``.
        """
        k = self.cfg.top_k if k is None else k
        queries, squeeze = as_query_batch(queries)
        q_pad, b = bucket_queries(queries)
        cosine = self.cfg.metric == "cosine"
        axes = _shard_axes(self.cfg, self.mesh)
        if self.corpus_scale is not None:
            s, i = _sharded_search_quant(
                q_pad, self.corpus, self.corpus_scale, jnp.int32(self.n),
                mesh=self.mesh, axes=axes, k=k,
                corpus_tile=self.cfg.corpus_tile, cosine=cosine,
                kind=self.cfg.dtype,
            )
        else:
            s, i = _sharded_search(
                q_pad, self.corpus, jnp.int32(self.n),
                mesh=self.mesh, axes=axes, k=k,
                corpus_tile=self.cfg.corpus_tile, cosine=cosine,
            )
        s, i = s[:b], i[:b]
        if squeeze:
            return s[0], i[0]
        return s, i

    @property
    def nbytes(self) -> int:
        n = self.corpus.size * self.corpus.dtype.itemsize
        if self.corpus_scale is not None:
            n += self.corpus_scale.size * 4
        return n


@partial(
    jax.jit,
    static_argnames=("mesh", "axes", "k", "corpus_tile",
                     "cosine"),
)
def _sharded_search(q, corpus, n_valid, *, mesh, axes, k, corpus_tile,
                    cosine):
    sizes = tuple(mesh.shape[a] for a in axes)
    per_shard = corpus.shape[0] // int(np.prod(sizes))
    q = q.astype(jnp.float32)
    if cosine:
        q = l2_normalize(q)
    q = q.astype(corpus.dtype)

    def local(qb, shard, nv):
        sid = _linear_shard_id(axes, sizes)
        offset = sid * per_shard
        # valid rows in this shard: clamp(n - offset, 0, per_shard)
        local_valid = jnp.clip(nv[0] - offset, 0, per_shard)
        s, i = flat_search(
            qb, shard, k,
            n_valid=local_valid,
            corpus_tile=corpus_tile,
        )
        return grouped_topk_merge(s, i + offset, k, axes)

    return shard_map(
        local,
        mesh=mesh,
        in_specs=(P(), P(axes, None), P()),
        out_specs=(P(), P()),
        check_vma=False,
    )(q, corpus, n_valid.reshape((1,)))


@partial(
    jax.jit,
    static_argnames=("mesh", "axes", "k", "corpus_tile",
                     "cosine", "kind"),
)
def _sharded_search_quant(q, corpus, scale, n_valid, *, mesh, axes, k,
                          corpus_tile, cosine, kind="int8"):
    # int4 shards are row-pair packed: corpus rows are PHYSICAL byte-rows,
    # each holding two logical rows — ids/offsets/valid counts are logical
    sizes = tuple(mesh.shape[a] for a in axes)
    mult = 2 if kind == "int4" else 1
    per_shard = (corpus.shape[0] // int(np.prod(sizes))) * mult
    q = q.astype(jnp.float32)
    if cosine:
        q = l2_normalize(q)
    kernel = int8_flat_search if kind == "int8" else int4_flat_search

    def local(qb, shard, sh_scale, nv):
        sid = _linear_shard_id(axes, sizes)
        offset = sid * per_shard
        local_valid = jnp.clip(nv[0] - offset, 0, per_shard)
        s, i = kernel(
            qb, shard, sh_scale, k,
            n_valid=local_valid,
            corpus_tile=corpus_tile,
        )
        return grouped_topk_merge(s, i + offset, k, axes)

    scale_spec = P(None, axes) if kind == "int4" else P(axes)
    return shard_map(
        local,
        mesh=mesh,
        in_specs=(P(), P(axes, None), scale_spec, P()),
        out_specs=(P(), P()),
        check_vma=False,
    )(q, corpus, scale, n_valid.reshape((1,)))
