"""IVF (inverted-file) index: coarse quantization on the device.

Replaces Chroma's HNSW ANN at scale (BASELINE config 3: 1M x 768, nlist
sweep). Build = on-device spherical k-means (ops/kmeans.py) + a one-pass
bucket layout; there is no graph to construct, so build time is a few Lloyd
matmul iterations. Search = tiny centroid matmul + top-nprobe, then the
probe op (ops/ivf_probe.py), which reads only the probed buckets.

When to use vs FlatIndex: the flat scan reads all N rows once per *batch*,
the IVF probe reads B * nprobe * cap rows. IVF therefore wins at small batch / large N
(low-latency serving); flat wins at large batch (bulk scoring). The engine
exposes both and `app` picks per call site.
"""

from __future__ import annotations

import functools
import json
import os
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from mediquery_rag.config import EngineConfig
from mediquery_rag.engine.flat import (
    MAX_K, as_query_batch, bucket_queries, host_rerank, l2_normalize,
)
from mediquery_rag.ops.kmeans import (
    assign_clusters, assign_clusters_topr, kmeans, split_oversized,
)
from mediquery_rag.ops.ivf_probe import ivf_probe_search


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _rebalance_overflow(assign, counts, top_ids, top_scores, cap_limit):
    """Bounded-cap placement, vectorized (runs on host ints at 10M scale).

    Overloaded clusters keep their ``cap_limit`` best-scoring rows; each
    overflow row moves to its next-best centroid with free space (one
    sorted cumcount pass per candidate rank, no per-row Python loop), with
    a least-filled fallback for the rare row whose whole candidate list is
    full.
    """
    nlist = counts.shape[0]
    # collect overflow: per overloaded cluster, evict the lowest-scoring
    # rows. One global sort gives every cluster's rows as a slice — a
    # per-cluster np.where(assign == c) re-scanned all 10M rows per
    # overloaded cluster (~50 s of layout_s at 10M with ~3K overfull
    # clusters after the r5 balanced split).
    order_all = np.argsort(assign, kind="stable")
    slice_starts = np.concatenate(([0], np.cumsum(counts)))
    overflow_parts = []
    for c in np.where(counts > cap_limit)[0]:
        rows = order_all[slice_starts[c]:slice_starts[c + 1]]
        order = np.argsort(-top_scores[rows, 0], kind="stable")
        overflow_parts.append(rows[order[cap_limit:]])
        counts[c] = cap_limit
    pending = np.concatenate(overflow_parts)

    r_alt = top_ids.shape[1]
    for r in range(1, r_alt):
        if len(pending) == 0:
            break
        cand = top_ids[pending, r]
        room = cap_limit - counts                     # free slots per cluster
        order = np.argsort(cand, kind="stable")
        sorted_c = cand[order]
        # rank of each row within its candidate cluster group
        starts = np.searchsorted(sorted_c, np.arange(nlist), side="left")
        rank_in_c = np.arange(len(sorted_c)) - starts[sorted_c]
        fits = rank_in_c < room[sorted_c]
        placed_rows = pending[order[fits]]
        assign[placed_rows] = sorted_c[fits]
        counts += np.bincount(sorted_c[fits], minlength=nlist)
        pending = pending[order[~fits]]
    # fallback: spread leftovers over the emptiest clusters
    for row in pending:
        c2 = int(np.argmin(counts))
        assign[row] = c2
        counts[c2] += 1
    return assign, counts


def _plan_layout(top_ids, top_scores, nlist, n, cap_limit):
    """Bucket layout from a top-r assignment (host ints only).

    Returns (bucket_ids [nlist, cap] i32 with -1 empties, positions [n] i64
    mapping global row -> flat bucket slot, cap).
    """
    assign = top_ids[:, 0].copy()
    counts = np.bincount(assign, minlength=nlist)
    if cap_limit and counts.max() > cap_limit:
        assign, counts = _rebalance_overflow(
            assign, counts, top_ids, top_scores, cap_limit)
    cap = _round_up(max(int(counts.max()), 32), 32)
    order = np.argsort(assign, kind="stable")
    bucket_ids = np.full((nlist, cap), -1, dtype=np.int32)
    cluster_of = assign[order]
    # position within cluster = rank among same cluster
    ranks = np.arange(n) - np.concatenate(([0], np.cumsum(counts)))[cluster_of]
    bucket_ids[cluster_of, ranks] = order.astype(np.int32)
    positions = np.empty(n, dtype=np.int64)
    positions[order] = cluster_of.astype(np.int64) * cap + ranks
    return bucket_ids, positions, cap


@functools.partial(jax.jit, donate_argnums=(0,))
def _scatter_rows(buf, pos, rows):
    """In-place (donated) scatter of prepared rows into the bucket buffer."""
    return buf.at[pos].set(rows)


@functools.partial(jax.jit, donate_argnums=(0,))
def _scatter_scalars(buf, pos, vals):
    return buf.at[pos].set(vals)


def _h2d_chunks(chunks, chunk_rows: int, transfer_dtype: str = "float32"):
    """Double-buffered host→device chunk feed for ``build_streaming``.

    Yields ``(device_chunk [chunk_rows, D], valid_rows)``. Chunk i+1's
    ``jax.device_put`` (async) is dispatched BEFORE chunk i is yielded, so
    its transfer overlaps chunk i's compute + result pull, instead of one
    synchronous host round trip per chunk. ``transfer_dtype="bfloat16"``
    halves the bytes on the wire (cast on host via ml_dtypes; device math
    stays f32)."""
    if transfer_dtype == "bfloat16":
        import ml_dtypes
        np_dt = ml_dtypes.bfloat16
    elif transfer_dtype == "float32":
        np_dt = np.float32
    else:
        raise ValueError(f"transfer_dtype must be float32|bfloat16, "
                         f"got {transfer_dtype!r}")

    def put(c):
        if isinstance(c, jax.Array):       # already device-resident (e.g.
            m = c.shape[0]                 # scale10m's on-device generator):
            if m != chunk_rows:            # no host hop, pad on device
                c = jnp.pad(c, ((0, chunk_rows - m), (0, 0)))
            return c, m
        c_np = np.asarray(c)
        m = c_np.shape[0]
        if m != chunk_rows:                          # pad the short tail
            c_np = np.pad(c_np, ((0, chunk_rows - m), (0, 0)))
        return jax.device_put(c_np.astype(np_dt, copy=False)), m

    prev = None
    for c in chunks:
        cur = put(c)
        if prev is not None:
            yield prev
        prev = cur
    if prev is not None:
        yield prev


@functools.partial(jax.jit, static_argnames=("cosine", "quant", "storage"))
def _prep_chunk(x, *, cosine, quant, storage="float32"):
    """Normalize (+quantize/cast) one corpus chunk for scattering.

    ``quant``: "none" | "int8" | "int4" — int4 yields unpacked CODES (one
    int8 byte each); the builder packs slot pairs after layout.
    """
    v = x.astype(jnp.float32)
    if cosine:
        v = l2_normalize(v)
    if quant == "int8":
        from mediquery_rag.ops.quant import quantize_rows
        return quantize_rows(v)
    if quant == "int4":
        from mediquery_rag.ops.quant import int4_codes
        return int4_codes(v)
    return v.astype(jnp.dtype(storage)), jnp.zeros((v.shape[0],), jnp.float32)


@functools.partial(
    jax.jit, static_argnames=("k", "nprobe", "quant", "cosine")
)
def _ivf_dispatch(q_pad, cents, buckets, bucket_ids, scales, *,
                  k, nprobe, quant, cosine):
    """Single-trace IVF dispatch: normalize + centroid probe + bucket scan.

    Keeping the whole pipeline in one jit (with host-bucketed batch sizes)
    matters for serving: the eager version re-dispatched 3-4 ops per novel
    batch size, each a fresh compile.
    """
    q = q_pad.astype(jnp.float32)
    if cosine:
        q = l2_normalize(q)
    cs = jnp.dot(q, cents.T, preferred_element_type=jnp.float32)
    _, pid = jax.lax.top_k(cs, nprobe)
    return ivf_probe_search(
        pid.astype(jnp.int32), q, buckets, bucket_ids, k=k,
        bucket_scales=scales if quant != "none" else None, quant=quant)


def _stream_layout(make_chunks, n, cfg, *, key, chunk_rows, transfer_dtype,
                   timings, sample_rows):
    """Passes 1-2 of the streaming build plus the host layout plan:
    sample + k-means, top-r assignment chunk by chunk, bounded-cap bucket
    layout. Returns a dict with centroids, bucket_ids [nlist, cap],
    positions [n] (row -> flat bucket slot), cap, nlist and the phase
    clock (``mark``, ``t``) for the caller's scatter pass."""
    import time as _time

    def _mark(name, t0, sync=None):
        if timings is None:
            return None
        if sync is not None:
            jax.block_until_ready(sync)
        now = _time.perf_counter()
        if name:
            timings[name] = round(now - t0, 3)
        return now

    t_ph = _mark(None, 0.0)
    key = jax.random.PRNGKey(0) if key is None else key
    nlist = min(cfg.ivf_nlist, max(1, n // 8))
    cosine = cfg.metric == "cosine"

    # pass 1: stride-sample for k-means. With ``sample_rows`` (a
    # callable: sorted row indices -> [len, D] host rows — a memmap'd
    # corpus, a DB, or a synthetic-source regenerator) the full-corpus
    # iteration is skipped entirely: the r4 breakdown charged 70 s of
    # a 237 s 10M build to generating all 160 chunks just to KEEP
    # 2.6%% of their rows. Without it, the slice happens WHERE the
    # chunk lives (host numpy slicing, or a device gather for
    # device-resident chunks — never a full-chunk D2H pull), and all
    # sample parts are fetched in one deferred device_get.
    target = min(cfg.ivf_sample, n)
    stride = max(1, n // target)
    if sample_rows is not None:
        idx = np.arange(0, n, stride, dtype=np.int64)[:target]
        sample = jnp.asarray(sample_rows(idx))[:target]
    else:
        parts = []
        seen = 0
        for chunk in make_chunks():
            first = (-seen) % stride
            parts.append(chunk[first::stride])
            seen += chunk.shape[0]
            if len(parts) % 16 == 0 and isinstance(parts[-1], jax.Array):
                jax.block_until_ready(parts[-1])   # back-pressure (below)
        assert seen == n, f"make_chunks yielded {seen} rows, expected {n}"
        parts = [np.asarray(p) for p in jax.device_get(parts)]
        sample = jnp.asarray(np.concatenate(parts, axis=0)[:target])
    sample = l2_normalize(sample.astype(jnp.float32)) if cosine \
        else sample.astype(jnp.float32)
    t_ph = _mark("sample_s", t_ph, sync=sample)
    cents = kmeans(sample, key, nlist=nlist, iters=cfg.ivf_kmeans_iters,
                   balance=cfg.ivf_balance)
    cap_limit = 0
    if cfg.ivf_cap_factor:
        cap_limit = _round_up(
            max(int(cfg.ivf_cap_factor * n / nlist), 32), 32)
        if cfg.ivf_split_oversized:
            cents = split_oversized(sample, cents, cap_rows=cap_limit,
                                    n_total=n,
                                    balance=max(cfg.ivf_balance, 0.1))
    t_ph = _mark("kmeans_s", t_ph, sync=cents)
    del sample

    # pass 2: top-r assignment, chunk by chunk (prefetched H2D). The
    # per-chunk results stay ON DEVICE: a synchronous np.asarray pull per
    # chunk would serialize the whole pass on host round trips; deferring
    # to ONE pull lets the device queue pipeline every chunk's dispatches.
    # Assignment buffers are small ([chunk_rows, 8] i32+f32 per chunk —
    # ~0.6 GB total at 10M).
    r_alt = min(8, nlist)
    ids_parts, score_parts, valid = [], [], []
    for x, m in _h2d_chunks(make_chunks(), chunk_rows, transfer_dtype):
        v, _ = _prep_chunk(x, cosine=cosine, quant="none",
                           storage="float32")
        ti, ts = assign_clusters_topr(v, cents, r=r_alt)
        ids_parts.append(ti)
        score_parts.append(ts)
        valid.append(m)
        if len(ids_parts) % 16 == 0:
            # back-pressure: without an occasional sync the host can
            # enqueue chunks far ahead of execution and pile up live
            # chunk buffers (200 MB each at 10M scale)
            jax.block_until_ready(ti)
    t_ph = _mark("assign_s", t_ph)
    ids_np, scores_np = jax.device_get((ids_parts, score_parts))
    t_ph = _mark("assign_pull_s", t_ph)
    top_ids = np.concatenate(
        [a[:m] for a, m in zip(ids_np, valid)], axis=0)
    top_scores = np.concatenate(
        [a[:m] for a, m in zip(scores_np, valid)], axis=0)
    del ids_parts, score_parts, ids_np, scores_np

    bucket_ids, positions, cap = _plan_layout(
        top_ids, top_scores, nlist, n, cap_limit)
    if timings is not None:
        # placement quality: a row in its first-choice bucket is found
        # whenever that bucket is probed; an alt-choice (rank 1..r-1)
        # row needs the probe list to reach its fallback centroid; a
        # rank<0 row was placed by the least-filled fallback and is
        # effectively unreachable — the recall ceiling at high nprobe
        # is ~1 - fallback - (alt beyond probe reach).
        b_of = (positions // cap).astype(np.int32)
        in_r = top_ids == b_of[:, None]
        rank = np.where(in_r.any(1), in_r.argmax(1), -1)
        timings["placement"] = {
            "first_choice": round(float((rank == 0).mean()), 4),
            "alt_choice": round(float((rank > 0).mean()), 4),
            "fallback": round(float((rank < 0).mean()), 4),
        }
    del top_ids, top_scores
    t_ph = _mark("layout_s", t_ph)
    return {"centroids": cents, "bucket_ids": bucket_ids,
            "positions": positions, "cap": cap, "nlist": nlist,
            "mark": _mark, "t": t_ph}


def _scatter_pass(make_chunks, positions, cfg, *, total_rows, pad_pos,
                  chunk_rows, transfer_dtype, sharding=None):
    """Pass 3 of the streaming build: normalize/quantize every chunk and
    scatter its rows to ``positions`` in a ``[total_rows, D]`` buffer
    (laid out with ``sharding`` when given; chunk rows then replicate to
    every device, each keeping the rows of its own shard). Padded tail rows
    go to ``pad_pos``, a slot no probe ever reads. Returns (buckets,
    scales or None)."""
    quant = cfg.dtype if cfg.dtype in ("int8", "int4") else "none"
    cosine = cfg.metric == "cosine"
    storage = jnp.int8 if quant != "none" else jnp.dtype(cfg.dtype)
    d = cfg.dim
    if sharding is None:
        buckets = jnp.zeros((total_rows, d), storage)
        scales = (jnp.zeros((total_rows,), jnp.float32)
                  if quant != "none" else None)
        repl = None
    else:
        from jax.sharding import NamedSharding, PartitionSpec as P
        buckets = jax.jit(lambda: jnp.zeros((total_rows, d), storage),
                          out_shardings=sharding)()
        scales = None
        if quant != "none":
            axes = sharding.spec[0]
            scales = jax.jit(lambda: jnp.zeros((total_rows,), jnp.float32),
                             out_shardings=NamedSharding(sharding.mesh,
                                                         P(axes)))()
        repl = NamedSharding(sharding.mesh, P())
    row0 = 0
    nchunk = 0
    for x, m in _h2d_chunks(make_chunks(), chunk_rows, transfer_dtype):
        rows, sc = _prep_chunk(x, cosine=cosine, quant=quant,
                               storage=cfg.dtype)
        pos = np.full(chunk_rows, pad_pos, dtype=np.int64)
        pos[:m] = positions[row0:row0 + m]
        pos_j = jnp.asarray(pos)
        if repl is not None:
            rows, sc, pos_j = jax.device_put((rows, sc, pos_j), repl)
        buckets = _scatter_rows(buckets, pos_j, rows)
        if quant != "none":
            scales = _scatter_scalars(scales, pos_j, sc)
        row0 += m
        nchunk += 1
        if nchunk % 8 == 0:
            # back-pressure: without an occasional sync the host enqueues
            # chunks far ahead of execution and piles up live chunk buffers
            jax.block_until_ready(buckets)
    return buckets, scales


@dataclass
class IVFIndex:
    centroids: jax.Array     # [nlist, D] f32
    buckets: jax.Array       # [nlist * cap, D]; int4: [nlist * cap/2, D]
                             # split-half packed (ops/quant.py)
    bucket_ids: jax.Array    # [nlist, cap] i32 global doc id, -1 = empty
    n: int
    cap: int
    cfg: EngineConfig
    bucket_scales: jax.Array | None = None   # [nlist, cap] f32, int8/int4
    _next_id: int | None = None              # None = n (no mutations yet)
    # host-RAM f16 copy indexed by STABLE DOC ID for two-stage refinement
    # (int8 + cfg.rerank_factor): rows are never removed (ids are stable),
    # adds append, so len(refine) == next_id always holds
    refine: np.ndarray | None = None

    @classmethod
    def build(
        cls,
        vectors,
        cfg: EngineConfig = EngineConfig(),
        *,
        key: jax.Array | None = None,
    ) -> "IVFIndex":
        host_src = vectors if isinstance(vectors, np.ndarray) else None
        v = jnp.asarray(vectors)
        n, d = v.shape
        nlist = min(cfg.ivf_nlist, max(1, n // 8))
        if cfg.metric == "cosine":
            v = l2_normalize(v.astype(jnp.float32))
        v32 = v.astype(jnp.float32)
        refine = None
        if cfg.dtype in ("int8", "int4") and cfg.rerank_factor:
            from mediquery_rag.engine.flat import _refine_copy
            refine = _refine_copy(host_src, v32, cfg.metric == "cosine")

        key = jax.random.PRNGKey(0) if key is None else key
        sample = v32
        if n > cfg.ivf_sample:
            idx = jax.random.choice(key, n, (cfg.ivf_sample,), replace=False)
            sample = v32[idx]
        cents = kmeans(sample, key, nlist=nlist, iters=cfg.ivf_kmeans_iters,
                       balance=cfg.ivf_balance)

        # the bucket cap is set by the LARGEST cluster — unbounded, a skewed
        # clustering multiplies both HBM footprint and probe DMA by cap/avg.
        # Bounded layout: cap <= cap_factor * avg; each overloaded cluster
        # keeps its cap best-scoring rows and overflow falls back to the
        # next-best cluster with space (found only when that cluster is
        # probed — the standard balanced-IVF recall trade, kept small by the
        # k-means balance penalty).
        cap_limit = 0
        if cfg.ivf_cap_factor:
            cap_limit = _round_up(
                max(int(cfg.ivf_cap_factor * n / nlist), 32), 32)
            if cfg.ivf_split_oversized:
                cents = split_oversized(sample, cents, cap_rows=cap_limit,
                                        n_total=n,
                                        balance=max(cfg.ivf_balance, 0.1))
        r_alt = min(8, nlist)
        top_ids, top_scores = assign_clusters_topr(v32, cents, r=r_alt)
        top_ids, top_scores = np.asarray(top_ids), np.asarray(top_scores)
        # bucket layout: id permutation on host (cheap, ints only), the
        # [nlist*cap, D] vector gather on device at HBM bandwidth
        bucket_ids, _, cap = _plan_layout(
            top_ids, top_scores, nlist, n, cap_limit)
        quant = cfg.dtype if cfg.dtype in ("int8", "int4") else "none"
        storage = jnp.int8 if quant != "none" else jnp.dtype(cfg.dtype)
        total = nlist * cap
        chunk = 65536
        pad_rows = _round_up(total, chunk)
        flat_rows = np.full(pad_rows, -1, dtype=np.int32)
        flat_rows[:total] = bucket_ids.reshape(-1)
        # chunked gather: cast/quantize each chunk to the storage dtype
        # immediately so the f32 intermediate stays ~chunk*D instead of
        # nlist*cap*D (OOM at 1M x 768 otherwise). int4 gathers CODES
        # (one byte each) and packs slot pairs once the layout is complete.
        def gather_chunk(rows):
            g = jnp.take(v32, jnp.maximum(rows, 0), axis=0)
            g = jnp.where((rows >= 0)[:, None], g, 0.0)
            if quant == "int8":
                from mediquery_rag.ops.quant import quantize_rows
                return quantize_rows(g)
            if quant == "int4":
                from mediquery_rag.ops.quant import int4_codes
                return int4_codes(g)
            return g.astype(storage), jnp.zeros((rows.shape[0],), jnp.float32)

        parts, part_scales = jax.lax.map(
            gather_chunk, jnp.asarray(flat_rows.reshape(-1, chunk)))
        buckets = parts.reshape(pad_rows, d)[:total]
        scales = None
        if quant != "none":
            scales = part_scales.reshape(pad_rows)[:total].reshape(nlist, cap)
        if quant == "int4":
            from mediquery_rag.ops.quant import ivf_pack_slots_int4
            buckets = ivf_pack_slots_int4(buckets, nlist, cap)

        return cls(
            centroids=cents,
            buckets=buckets,
            bucket_ids=jnp.asarray(bucket_ids),
            n=n,
            cap=cap,
            cfg=cfg,
            bucket_scales=scales,
            refine=refine,
        )

    @classmethod
    def build_streaming(
        cls,
        make_chunks,
        n: int,
        cfg: EngineConfig = EngineConfig(),
        *,
        key: jax.Array | None = None,
        chunk_rows: int = 65536,
        transfer_dtype: str = "float32",
        timings: dict | None = None,
        sample_rows=None,
    ) -> "IVFIndex":
        """Build WITHOUT materializing the f32 corpus on device.

        At BASELINE config-5 scale (10M x 768) the f32 source is 30 GB —
        it cannot sit in a 16 GB HBM next to the bucket array. This builder
        streams: ``make_chunks()`` must return a fresh iterator of
        ``[chunk_rows, D]`` arrays (host numpy or device; the last chunk may
        be short) and is iterated THREE times — (1) stride-sample rows for
        k-means (host slicing only), (2) top-r assignment per chunk,
        (3) normalize/quantize per chunk and scatter into the pre-allocated
        bucket buffer via donated in-place updates. Peak HBM = buckets +
        one chunk. For expensive chunk sources (a device embedder) wrap the
        generator with an on-disk cache (np.memmap) — regenerating
        embeddings three times is the caller's trade to make.

        Passes 2 and 3 double-buffer the H2D copy (chunk i+1's transfer is
        dispatched before chunk i's compute/pull blocks).
        ``transfer_dtype="bfloat16"`` additionally halves the transferred
        bytes — the large-scale build knob (benchmarks/scale10m.py): the
        host chunk is cast to bf16 before upload, everything downstream
        still normalizes/quantizes in f32 on device. Assignment ties and
        int8 codes can shift by a bf16 rounding (~0.4%% relative, well
        under the quantization step); the default stays exact so
        streaming == in-memory equality holds bit-for-bit.

        ``refine`` is not built here (a 10M f16 copy is 15 GB host RAM);
        set it explicitly afterwards if the host has room.

        ``sample_rows`` (optional): random-access row fetch
        ``(sorted int64 indices) -> [len, D] host array`` — skips pass 1's
        full-corpus iteration (use for memmap'd / regenerable corpora).

        ``timings`` (optional): pass a dict to receive a wall-clock phase
        breakdown — sample_s / kmeans_s / assign_s / assign_pull_s /
        layout_s / scatter_s. Phase boundaries sync the device only when
        requested, so the shipping path's pipelining is unchanged.
        """
        plan = _stream_layout(make_chunks, n, cfg, key=key,
                              chunk_rows=chunk_rows,
                              transfer_dtype=transfer_dtype,
                              timings=timings, sample_rows=sample_rows)
        nlist, cap = plan["nlist"], plan["cap"]
        quant = cfg.dtype if cfg.dtype in ("int8", "int4") else "none"
        # pass 3: scatter prepared rows into the bucket buffer. One extra
        # dummy bucket at the end absorbs the padded tail rows (probe ids
        # are always < nlist, so it is never read). int4 scatters CODE
        # bytes here and pairs them into nibbles in one final pass
        # (per-slot nibble RMW scatter would be a read-modify-write mess).
        total = (nlist + 1) * cap
        buckets, scales = _scatter_pass(
            make_chunks, plan["positions"], cfg, total_rows=total,
            pad_pos=nlist * cap, chunk_rows=chunk_rows,
            transfer_dtype=transfer_dtype)
        if quant == "int4":
            # (donating the code buffer is futile: the packed output has a
            # different shape, so XLA cannot alias it — peak memory here is
            # codes + packed = 1.5x the int8 build's buffer, still far under
            # the f32 corpus this builder exists to avoid)
            from mediquery_rag.ops.quant import ivf_pack_slots_int4
            buckets = jax.jit(ivf_pack_slots_int4,
                              static_argnums=(1, 2))(buckets, nlist + 1, cap)
        plan["mark"]("scatter_s", plan["t"], sync=buckets)
        cents, bucket_ids = plan["centroids"], plan["bucket_ids"]

        return cls(
            centroids=cents,
            buckets=buckets,          # includes the dummy tail bucket
            bucket_ids=jnp.asarray(bucket_ids),
            n=n,
            cap=cap,
            cfg=cfg,
            bucket_scales=(scales.reshape(nlist + 1, cap)[:nlist]
                           if quant != "none" else None),
        )

    def search(self, queries, k: int | None = None,
               nprobe: int | None = None):
        """Probe search: the ``nprobe`` nearest centroids per query, then an
        exact scan of their buckets (ops/ivf_probe.py)."""
        k = self.cfg.top_k if k is None else k
        if k > MAX_K:
            raise ValueError(f"k={k} > {MAX_K}, the engine's top-k cap")
        nprobe = self.cfg.ivf_nprobe if nprobe is None else nprobe
        nprobe = min(nprobe, self.centroids.shape[0])
        queries, squeeze = as_query_batch(queries)
        q_pad, b = bucket_queries(queries)
        quant = self.cfg.dtype if self.bucket_scales is not None else "none"
        scales = (self.bucket_scales if quant != "none"
                  else jnp.zeros((0, self.cap), jnp.float32))
        cosine = self.cfg.metric == "cosine"
        rerank = self.refine is not None and self.cfg.rerank_factor > 0
        kk = min(MAX_K, self.cfg.rerank_factor * k, self.n) if rerank else k
        kk = max(kk, k)
        s, i = _ivf_dispatch(
            q_pad, self.centroids, self.buckets, self.bucket_ids, scales,
            k=kk, nprobe=nprobe, quant=quant, cosine=cosine,
        )
        s, i = s[:b], i[:b]
        if rerank:
            # refine is indexed by stable doc id (what the probe kernels
            # return); see flat.host_rerank for the shared routine
            s, i = host_rerank(self.refine, np.asarray(queries),
                               np.asarray(s), np.asarray(i), k, cosine)
            s, i = jnp.asarray(s), jnp.asarray(i)
        if squeeze:
            return s[0], i[0]
        return s, i

    # -- incremental mutation (Chroma/hnswlib capability parity) --------------
    #
    # The IVF layout makes mutation cheap: a delete is slot-masking (the
    # probe op natively skips ids == -1), an insert is a nearest-centroid
    # assignment + scatter into a free slot. No graph repair, no
    # re-clustering — centroids drift only matters after massive churn, at
    # which point rebuild() is one on-device k-means.

    @property
    def next_id(self) -> int:
        """First unused doc id (ids are never reused after delete)."""
        return self.n if self._next_id is None else self._next_id

    @property
    def live(self) -> int:
        """Number of live (non-deleted) docs."""
        return int((np.asarray(self.bucket_ids) >= 0).sum())

    def delete(self, doc_ids) -> "IVFIndex":
        """Mask docs by stable id (returns a new index). O(slots) compare —
        the vectors stay in HBM but are never scored (ids < 0 slots are
        -inf in every kernel). Unknown ids are ignored."""
        gone = np.asarray(jnp.asarray(doc_ids)).reshape(-1)
        ids = np.asarray(self.bucket_ids)
        hit = np.isin(ids, gone) & (ids >= 0)
        if not hit.any():
            return self
        new_ids = jnp.asarray(np.where(hit, -1, ids))
        from dataclasses import replace
        return replace(self, bucket_ids=new_ids, _next_id=self.next_id)

    def add(self, vectors) -> "IVFIndex":
        """Insert vectors (returns a new index). Assigns each to its nearest
        centroid and scatters into a free bucket slot; grows ``cap`` (one
        HBM re-pad pass) only when a bucket fills. New docs get consecutive
        stable ids from ``next_id``."""
        from dataclasses import replace

        v = jnp.asarray(vectors)
        m, d = v.shape
        if self.cfg.metric == "cosine":
            v = l2_normalize(v.astype(jnp.float32))
        v32 = v.astype(jnp.float32)
        assign = np.asarray(assign_clusters(v32, self.centroids))

        nlist = self.bucket_ids.shape[0]
        ids = np.asarray(self.bucket_ids)
        used = (ids >= 0).sum(axis=1)                   # live slots per bucket
        # host-side slot planning (ints only): new rows fill from the first
        # free slot upward; free slots are compacted to the tail below
        need = np.bincount(assign, minlength=nlist)
        new_cap = self.cap
        if (used + need).max() > self.cap:
            new_cap = _round_up(int((used + need).max()), 32)

        # compact each bucket's live ids to the front (delete leaves holes),
        # then append the new rows — all as one host permutation + device pad.
        # int4 buckets unpack to slot-ordered code bytes first (a nibble
        # cannot be gathered), mutate as codes, and repack at the end.
        int4 = self.cfg.dtype == "int4"
        src = self.buckets
        if int4:
            from mediquery_rag.ops.quant import ivf_unpack_slots_int4
            # build_streaming keeps a dummy tail bucket (packed rows beyond
            # nlist*cap/2) that the unpack reshape must not see; int8/f32
            # paths are immune because jnp.take ignores the tail.
            src = ivf_unpack_slots_int4(
                self.buckets[: nlist * self.cap // 2], nlist, self.cap)
        order = np.argsort(ids < 0, axis=1, kind="stable")   # live first
        ids_c = np.take_along_axis(ids, order, axis=1)
        gather = order + (np.arange(nlist) * self.cap)[:, None]
        gj = jnp.asarray(gather.reshape(-1), jnp.int32)
        bk = jnp.take(src, gj, axis=0).reshape(nlist, self.cap, d)
        sc = (jnp.take(self.bucket_scales.reshape(-1), gj)
              .reshape(nlist, self.cap) if self.bucket_scales is not None
              else None)
        if new_cap != self.cap:
            bk = jnp.pad(bk, ((0, 0), (0, new_cap - self.cap), (0, 0)))
            ids_c = np.pad(ids_c, ((0, 0), (0, new_cap - self.cap)),
                           constant_values=-1)
            if sc is not None:
                sc = jnp.pad(sc, ((0, 0), (0, new_cap - self.cap)))

        # slot for the i-th new row: rank within its bucket after the used rows
        offs = np.zeros(nlist, np.int64)
        slots = np.empty(m, np.int64)
        for i, b in enumerate(assign):
            slots[i] = used[b] + offs[b]
            offs[b] += 1
        flat_pos = jnp.asarray(assign * new_cap + slots, jnp.int32)

        refine = self.refine
        if refine is not None:
            refine = np.concatenate(
                [refine, np.asarray(v32, dtype=np.float16)], axis=0)
        if self.bucket_scales is not None:
            from mediquery_rag.ops.quant import int4_codes, quantize_rows
            rows_new, s_new = (int4_codes(v32) if int4
                               else quantize_rows(v32))
            bk = bk.reshape(nlist * new_cap, d).at[flat_pos].set(rows_new)
            sc = sc.reshape(-1).at[flat_pos].set(s_new).reshape(nlist, new_cap)
        else:
            bk = bk.reshape(nlist * new_cap, d).at[flat_pos].set(
                v32.astype(self.buckets.dtype))

        if int4:
            from mediquery_rag.ops.quant import ivf_pack_slots_int4
            bk = ivf_pack_slots_int4(bk.reshape(nlist * new_cap, d),
                                     nlist, new_cap)
        else:
            bk = bk.reshape(nlist * new_cap, d)
        new_ids = ids_c.reshape(-1).copy()
        new_ids[np.asarray(flat_pos)] = self.next_id + np.arange(m)
        return replace(
            self, buckets=bk, bucket_ids=jnp.asarray(new_ids.reshape(nlist, new_cap)),
            bucket_scales=sc, n=self.n + m, cap=new_cap,
            _next_id=self.next_id + m, refine=refine,
        )

    @property
    def nbytes(self) -> int:
        nb = (
            self.buckets.size * self.buckets.dtype.itemsize
            + self.centroids.size * 4
            + self.bucket_ids.size * 4
        )
        if self.bucket_scales is not None:
            nb += self.bucket_scales.size * 4
        return nb

    # -- persistence ---------------------------------------------------------

    def save(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        # fetch raw storage — no device compute in save (see FlatIndex.save)
        buckets = np.asarray(self.buckets)
        if buckets.dtype.name == "bfloat16":        # npz has no bf16
            buckets = buckets.view(np.uint16)
        arrays = {
            "centroids": np.asarray(self.centroids),
            "buckets": buckets,
            "bucket_ids": np.asarray(self.bucket_ids),
        }
        if self.bucket_scales is not None:
            arrays["bucket_scales"] = np.asarray(self.bucket_scales)
        if self.refine is not None:
            arrays["refine"] = self.refine
        np.savez(os.path.join(path, "ivf.npz"), **arrays)
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(
                {"n": self.n, "cap": self.cap, "kind": "ivf",
                 "next_id": self.next_id, "cfg": self.cfg.__dict__},
                f,
            )

    @classmethod
    def load(cls, path: str) -> "IVFIndex":
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        cfg = EngineConfig.from_saved(meta["cfg"])
        z = np.load(os.path.join(path, "ivf.npz"))
        storage = jnp.dtype("int8" if cfg.dtype in ("int8", "int4")
                            else cfg.dtype)
        raw = z["buckets"]
        if storage == jnp.bfloat16:
            import ml_dtypes
            # new format stores the raw bf16 bits as uint16; legacy stored
            # f32 — both convert on HOST (no device cast round trip)
            raw = (raw.view(ml_dtypes.bfloat16) if raw.dtype == np.uint16
                   else raw.astype(ml_dtypes.bfloat16))
        elif raw.dtype != storage.name:
            raw = raw.astype(storage.name)
        return cls(
            centroids=jnp.asarray(z["centroids"]),
            buckets=jnp.asarray(raw),
            bucket_ids=jnp.asarray(z["bucket_ids"]),
            n=meta["n"],
            cap=meta["cap"],
            cfg=cfg,
            bucket_scales=(jnp.asarray(z["bucket_scales"])
                           if "bucket_scales" in z.files else None),
            _next_id=meta.get("next_id"),
            refine=(z["refine"] if "refine" in z.files else None),
        )
