"""IVF probe-and-score: gather the probed buckets, score, top-k.

The replacement for hnswlib's graph traversal (reference:
medical_engine.py:52 via Chroma). Probed cluster ids — a tiny centroid
matmul + top-k, computed by the caller — select which buckets each query
scores, so a query touches ``nprobe x cap`` corpus rows instead of all N.

Plain XLA on every platform (ops/route.py): each query gathers its probed
bucket rows, scores them with one product and keeps the top ``k``. Queries
run through ``lax.map`` in groups of ``group`` so the gathered rows stay a
bounded transient (``group * nprobe * cap * D`` storage bytes) at any
batch size.

Bucket storage (engine/ivf.py): ``buckets`` holds ``cap`` rows per bucket
(``cap/2`` split-half packed byte-rows for int4), ``bucket_ids [nlist, cap]``
the global doc id of each slot (-1 = empty, scored ``-inf``) and, for int8
and int4, ``bucket_scales [nlist, cap]`` the per-slot row scales.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from mediquery_rag.ops import route
from mediquery_rag.ops.quant import int4_pair_scores, quantize_rows
from mediquery_rag.ops.scoring import matmul_precision

NEG_INF = float("-inf")
# rows of bucket storage gathered per map step, summed over the group's
# queries: bounds the transient to ~1 GB of int8 at 768-d
_GATHER_ROWS = 1 << 20


def _probe_one(q, pids, buckets, bucket_ids, scales, *, k, quant):
    """One query: ``q`` [D] (int8 codes for int8/int4), ``pids`` [nprobe]."""
    cap = bucket_ids.shape[1]
    rows = cap // 2 if quant == "int4" else cap
    ridx = (pids[:, None] * rows
            + jnp.arange(rows, dtype=jnp.int32)[None, :]).reshape(-1)
    vecs = jnp.take(buckets, ridx, axis=0)                 # [nprobe*rows, D]
    ids = bucket_ids[pids]                                 # [nprobe, cap]
    if quant == "int4":
        lo, hi = int4_pair_scores(q[None, :], vecs)        # [1, nprobe*rows]
        sc = scales[pids]                                  # [nprobe, cap]
        s = jnp.concatenate([lo.reshape(-1, rows) * sc[:, :rows],
                             hi.reshape(-1, rows) * sc[:, rows:]], axis=1)
    elif quant == "int8":
        raw = jax.lax.dot_general(vecs, q, (((1,), (0,)), ((), ())),
                                  preferred_element_type=jnp.int32)
        s = raw.astype(jnp.float32).reshape(-1, cap) * scales[pids]
    else:
        s = jax.lax.dot_general(vecs, q.astype(vecs.dtype),
                                (((1,), (0,)), ((), ())),
                                preferred_element_type=jnp.float32,
                                precision=matmul_precision(vecs.dtype))
        s = s.reshape(-1, cap)
    s = jnp.where(ids >= 0, s, NEG_INF).reshape(-1)
    vals, pos = jax.lax.top_k(s, k)
    return vals, ids.reshape(-1)[pos]


@functools.partial(jax.jit, static_argnames=("k", "quant"))
def _probe_search(probe_ids, queries, buckets, bucket_ids, scales, *, k,
                  quant):
    if quant == "none":
        q, qs = queries, None
    else:
        q, qs = quantize_rows(queries)
    nprobe = probe_ids.shape[1]
    cap = bucket_ids.shape[1]
    group = max(1, _GATHER_ROWS // max(1, nprobe * cap))
    one = functools.partial(_probe_one, buckets=buckets,
                            bucket_ids=bucket_ids, scales=scales, k=k,
                            quant=quant)
    s, i = jax.lax.map(lambda a: one(*a), (q, probe_ids.astype(jnp.int32)),
                       batch_size=min(group, q.shape[0]))
    if qs is not None:
        s = s * qs[:, None]
    return s, i


def ivf_probe_search(probe_ids, queries, buckets, bucket_ids, *, k,
                     bucket_scales=None, quant: str = "none"):
    """Score each query against its probed buckets, top-k.

    ``quant``: "none" (float buckets; ``queries`` cast to their dtype),
    "int8" or "int4" (``queries`` f32, int8-quantized here; returned scores
    include the per-query scale). Returns (scores [B,k] f32, global doc
    indices [B,k] i32; ``-inf`` where fewer than k real docs were probed).
    """
    route.impl("ivf_probe_search")
    if quant not in ("none", "int8", "int4"):
        raise ValueError(f"quant must be none|int8|int4, got {quant!r}")
    if quant != "none" and bucket_scales is None:
        raise ValueError(f"quant={quant!r} needs bucket_scales")
    nlist, cap = bucket_ids.shape
    rows = cap // 2 if quant == "int4" else cap
    if buckets.shape[0] < nlist * rows:
        raise ValueError(
            f"buckets has {buckets.shape[0]} rows, {quant} storage needs "
            f"nlist*rows={nlist * rows}")
    scales = (bucket_scales if bucket_scales is not None
              else jnp.zeros((nlist, cap), jnp.float32))
    return _probe_search(probe_ids, queries, buckets, bucket_ids, scales,
                         k=k, quant=quant)


def ivf_probe_search_int8(probe_ids, queries, buckets, bucket_ids,
                          bucket_scales, *, k):
    """int8 probe search (``queries`` f32 [B, D])."""
    return ivf_probe_search(probe_ids, queries, buckets, bucket_ids, k=k,
                            bucket_scales=bucket_scales, quant="int8")


def ivf_probe_search_int4(probe_ids, queries, buckets, bucket_ids,
                          bucket_scales, *, k):
    """int4 probe search over split-half packed buckets
    (ops/quant.py:ivf_pack_slots_int4)."""
    return ivf_probe_search(probe_ids, queries, buckets, bucket_ids, k=k,
                            bucket_scales=bucket_scales, quant="int4")


@functools.partial(jax.jit, static_argnames=("k",))
def ivf_probe_search_xla(probe_ids, queries, buckets, bucket_ids, *, k):
    """Gather-based f32 oracle over float buckets (memory-heavy; for tests
    and small shapes only)."""
    nlist, cap = bucket_ids.shape
    d = queries.shape[1]
    bk = buckets[: nlist * cap].reshape(nlist, cap, d)
    vecs = bk[probe_ids]                       # [B, nprobe, cap, D]
    ids = bucket_ids[probe_ids]                # [B, nprobe, cap]
    scores = jnp.einsum(
        "bd,bpcd->bpc", queries.astype(jnp.float32),
        vecs.astype(jnp.float32), precision=jax.lax.Precision.HIGHEST)
    scores = jnp.where(ids >= 0, scores, NEG_INF)
    b = queries.shape[0]
    flat_s = scores.reshape(b, -1)
    flat_i = ids.reshape(b, -1)
    vals, pos = jax.lax.top_k(flat_s, k)
    return vals, jnp.take_along_axis(flat_i, pos, axis=-1)
