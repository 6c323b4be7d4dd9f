"""Sharded IVF: clusters partitioned across the device mesh.

The low-latency path at multi-chip scale (BASELINE config 5 with IVF):
centroids are replicated (tiny); each chip owns a contiguous range of
clusters and holds only their buckets in HBM. A query's probe list is
computed globally, then each chip serves the probes it owns — probes owned
by other chips are routed to a reserved *empty sentinel bucket* (ids = -1,
which the probe kernel masks natively), keeping shapes static. Per-chip
partial top-k lists merge via the same all-gather-over-ICI pattern as the
sharded flat index.

Worst-case skew (all nprobe probes on one chip) degrades latency to the
single-chip case, never correctness.

Multi-slice (cfg.dcn_axis set): cluster ranges distribute over the
``(dcn, ici)`` device product in row-major order and partial top-k lists
merge hierarchically — ICI all-gather within the slice, k-finalist
exchange over DCN (engine/sharded.py notes).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from mediquery_rag.config import EngineConfig
from mediquery_rag.engine.flat import (
    as_query_batch, bucket_queries, l2_normalize,
)
from mediquery_rag.engine.ivf import IVFIndex
from mediquery_rag.ops.ivf_probe import ivf_probe_search
from mediquery_rag.engine.sharded import _linear_shard_id, _shard_axes
from mediquery_rag.parallel.collectives import grouped_topk_merge


@dataclass
class ShardedIVFIndex:
    centroids: jax.Array      # [nlist, D] f32, replicated
    buckets: jax.Array        # [S*(per+1)*cap, D] rows sharded over mesh
    bucket_ids: jax.Array     # [S*(per+1), cap] sharded; last bucket/shard empty
    n: int
    cap: int
    nlist: int                # real clusters (pre-padding)
    per_shard: int            # clusters per shard (excl. sentinel)
    cfg: EngineConfig
    mesh: Mesh
    bucket_scales: jax.Array | None = None   # [S*(per+1), cap] f32, int8 only

    @classmethod
    def build(cls, vectors, mesh: Mesh, cfg: EngineConfig = EngineConfig(),
              *, key=None) -> "ShardedIVFIndex":
        """Build the single-chip IVF layout, then scatter cluster ranges
        (with one sentinel empty bucket per shard) across the mesh."""
        return cls.from_single(IVFIndex.build(vectors, cfg, key=key), mesh)

    @classmethod
    def from_single(cls, base: IVFIndex, mesh: Mesh) -> "ShardedIVFIndex":
        """Shard an existing single-chip IVF index (e.g. one produced by
        ``IVFIndex.build_streaming`` at a scale where the in-memory build
        cannot run) across the mesh."""
        cfg = base.cfg
        axes = _shard_axes(cfg, mesh)
        s = int(np.prod([mesh.shape[a] for a in axes]))
        nlist, cap = base.bucket_ids.shape
        d = base.buckets.shape[1]
        per = -(-nlist // s)                       # clusters per shard
        # int4 buckets are split-half packed: cap/2 byte-rows per bucket;
        # ids/scales stay slot-ordered [*, cap] like every other dtype
        rows = cap // 2 if cfg.dtype == "int4" else cap

        # host-side relayout: [s, per+1, rows, ...] with sentinel appended
        bids = np.full((s, per + 1, cap), -1, dtype=np.int32)
        bvecs = np.zeros((s, per + 1, rows, d),
                         dtype=np.asarray(base.buckets[:1]).dtype)
        src_ids = np.asarray(base.bucket_ids)
        # streaming-built indexes carry one dummy tail bucket — drop it
        src_vecs = np.asarray(base.buckets)[: nlist * rows].reshape(
            nlist, rows, d)
        int8 = base.bucket_scales is not None
        bscales = np.zeros((s, per + 1, cap), np.float32) if int8 else None
        src_scales = np.asarray(base.bucket_scales) if int8 else None
        for sh in range(s):
            lo, hi = sh * per, min((sh + 1) * per, nlist)
            bids[sh, : hi - lo] = src_ids[lo:hi]
            bvecs[sh, : hi - lo] = src_vecs[lo:hi]
            if int8:
                bscales[sh, : hi - lo] = src_scales[lo:hi]

        sharding_b = NamedSharding(mesh, P(axes, None))
        buckets = jax.device_put(
            jnp.asarray(bvecs.reshape(s * (per + 1) * rows, d)),
            sharding_b)
        bucket_ids = jax.device_put(
            jnp.asarray(bids.reshape(s * (per + 1), cap)), sharding_b)
        scales = None
        if int8:
            scales = jax.device_put(
                jnp.asarray(bscales.reshape(s * (per + 1), cap)), sharding_b)
        return cls(
            centroids=base.centroids, buckets=buckets, bucket_ids=bucket_ids,
            n=base.n, cap=cap, nlist=nlist, per_shard=per, cfg=cfg, mesh=mesh,
            bucket_scales=scales,
        )

    @classmethod
    def build_streaming(cls, make_chunks, n: int, mesh: Mesh,
                        cfg: EngineConfig = EngineConfig(), *, key=None,
                        chunk_rows: int = 65536,
                        transfer_dtype: str = "float32",
                        timings: dict | None = None,
                        sample_rows=None) -> "ShardedIVFIndex":
        """``IVFIndex.build_streaming`` straight into the sharded layout:
        same passes and layout plan (``make_chunks`` is iterated three
        times), but the bucket rows scatter into a buffer already
        row-sharded over the mesh, so no device ever holds more than its
        own clusters. Float and int8 storage."""
        from mediquery_rag.engine.ivf import _scatter_pass, _stream_layout

        if cfg.dtype == "int4":
            raise ValueError("sharded streaming build supports float and "
                             "int8 storage; int4: build_streaming + "
                             "from_single")
        plan = _stream_layout(make_chunks, n, cfg, key=key,
                              chunk_rows=chunk_rows,
                              transfer_dtype=transfer_dtype,
                              timings=timings, sample_rows=sample_rows)
        nlist, cap = plan["nlist"], plan["cap"]
        axes = _shard_axes(cfg, mesh)
        s = int(np.prod([mesh.shape[a] for a in axes]))
        per = -(-nlist // s)
        # global bucket g -> shard g // per, local bucket g % per; every
        # shard keeps one empty sentinel bucket (index per) after its own
        g = np.arange(nlist)
        g_new = (g // per) * (per + 1) + g % per
        pos = plan["positions"]
        pos = g_new[pos // cap] * cap + pos % cap
        bids = np.full((s * (per + 1), cap), -1, np.int32)
        bids[g_new] = plan["bucket_ids"]
        sharding = NamedSharding(mesh, P(axes, None))
        buckets, scales = _scatter_pass(
            make_chunks, pos, cfg, total_rows=s * (per + 1) * cap,
            # padded tail rows land in the last shard's sentinel bucket,
            # whose ids stay -1: never scored
            pad_pos=(s * (per + 1) - 1) * cap,
            chunk_rows=chunk_rows, transfer_dtype=transfer_dtype,
            sharding=sharding)
        plan["mark"]("scatter_s", plan["t"], sync=buckets)
        bucket_ids = jax.device_put(jnp.asarray(bids), sharding)
        if scales is not None:
            scales = jax.device_put(scales.reshape(s * (per + 1), cap),
                                    sharding)
        return cls(
            centroids=plan["centroids"], buckets=buckets,
            bucket_ids=bucket_ids, n=n, cap=cap, nlist=nlist,
            per_shard=per, cfg=cfg, mesh=mesh, bucket_scales=scales)

    def search(self, queries, k: int | None = None,
               nprobe: int | None = None):
        k = self.cfg.top_k if k is None else k
        nprobe = self.cfg.ivf_nprobe if nprobe is None else nprobe
        nprobe = min(nprobe, self.nlist)
        queries, squeeze = as_query_batch(queries)
        q_pad, b = bucket_queries(queries)
        quant = self.cfg.dtype if self.bucket_scales is not None else "none"
        scales = (self.bucket_scales if quant != "none"
                  else jnp.zeros((0, self.cap), jnp.float32))
        # replicate the small operands explicitly: a checkpoint-restored
        # index is committed to the whole mesh, and jit refuses to mix
        # committed multi-device args with single-device ones
        repl = NamedSharding(self.mesh, P())
        q_pad = jax.device_put(jnp.asarray(q_pad), repl)
        cents = jax.device_put(self.centroids, repl)
        s, i = _sharded_ivf_search(
            q_pad, cents, self.buckets,
            self.bucket_ids, scales,
            mesh=self.mesh, axes=_shard_axes(self.cfg, self.mesh), k=k,
            nprobe=nprobe,
            per_shard=self.per_shard, cap=self.cap,
            quant=quant, cosine=self.cfg.metric == "cosine",
        )
        s, i = s[:b], i[:b]
        if squeeze:
            return s[0], i[0]
        return s, i

    @property
    def nbytes(self) -> int:
        return (self.buckets.size * self.buckets.dtype.itemsize
                + self.bucket_ids.size * 4 + self.centroids.size * 4)


@partial(jax.jit, static_argnames=("mesh", "axes", "k", "nprobe", "per_shard",
                                   "cap", "quant", "cosine"))
def _sharded_ivf_search(q, cents, buckets, bucket_ids, scales, *, mesh, axes,
                        k, nprobe, per_shard, cap, quant, cosine):
    sizes = tuple(mesh.shape[a] for a in axes)
    q = q.astype(jnp.float32)
    if cosine:
        q = l2_normalize(q)

    def local(qb, cents_r, bk, bids, bsc):
        sid = _linear_shard_id(axes, sizes)
        cs = jnp.dot(qb, cents_r.T, preferred_element_type=jnp.float32)
        _, pid = jax.lax.top_k(cs, nprobe)               # global cluster ids
        lo = sid * per_shard
        local_pid = pid - lo
        mine = (local_pid >= 0) & (local_pid < per_shard)
        # foreign probes -> the sentinel empty bucket (index per_shard)
        local_pid = jnp.where(mine, local_pid, per_shard).astype(jnp.int32)
        s, i = ivf_probe_search(
            local_pid, qb, bk, bids, k=k,
            bucket_scales=bsc if quant != "none" else None, quant=quant)
        return grouped_topk_merge(s, i, k, axes)

    return shard_map(
        local,
        mesh=mesh,
        in_specs=(P(), P(), P(axes, None), P(axes, None), P(axes, None)),
        out_specs=(P(), P()),
        check_vma=False,
    )(q, cents, buckets, bucket_ids, scales)
