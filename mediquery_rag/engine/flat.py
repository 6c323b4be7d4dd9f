"""Flat (exact brute-force) index — the engine's ground-truth path.

Replaces Chroma's persistent HNSW collection (reference:
medical_engine.py:52, ingest_medical.py:106-110). Exact search over a
resident ``[N, D]`` matrix at device-memory bandwidth beats graph ANN up to
tens of millions of vectors — there is no pointer-chasing structure to build, so
"index build" is normalize + cast + pad: one pass at HBM speed
(BASELINE.json: "index build at HBM-bandwidth speed-of-light").
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
from mediquery_rag.ops.scoring import flat_search
from mediquery_rag.ops.quant import (
    dequantize_int4, int4_flat_search, int8_flat_search, quantize_rows,
    quantize_rows_int4,
)


# per-query result cap of every index (rerank overfetch included)
MAX_K = 128


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def l2_normalize(x: jax.Array, eps: float = 1e-12) -> jax.Array:
    n = jnp.linalg.norm(x.astype(jnp.float32), axis=-1, keepdims=True)
    return (x / jnp.maximum(n, eps)).astype(x.dtype)


def as_query_batch(queries):
    """Normalize any query input (1-D/2-D list, numpy, jax) to a 2-D array.

    Returns (queries_2d, squeeze) — shared by every index's search so plain
    Python lists keep working (a bare ``getattr(q, 'ndim', 2)`` check broke
    them).
    """
    if not isinstance(queries, jax.Array):
        queries = np.asarray(queries)
    squeeze = queries.ndim == 1
    if squeeze:
        queries = queries[None, :]
    return queries, squeeze


def host_rerank(refine: np.ndarray, q: np.ndarray, s: np.ndarray,
                cand_ids: np.ndarray, k: int, cosine: bool):
    """Exact host re-score of kernel candidates against the f16 refinement
    copy (shared by FlatIndex/IVFIndex; ``cand_ids`` index ``refine`` rows).
    Returns the true top-k (scores, ids) among the candidates.

    Uses the OpenMP C++ kernel (native/rerank.cpp — fused f16-convert+dot,
    parallel over queries, ~10x the numpy gather+einsum) when the library
    is buildable; the numpy path is the portable fallback and the test
    oracle (tests/test_native.py asserts bit-equal results)."""
    q32 = np.asarray(q, dtype=np.float32)
    if cosine:
        q32 = q32 / np.maximum(np.linalg.norm(q32, axis=1, keepdims=True),
                               1e-12)
    cand_ids = np.asarray(cand_ids)
    s = np.asarray(s)
    if refine.dtype == np.float16 and cand_ids.shape[1] <= 512:
        from mediquery_rag.native.rerank import (
            native_rerank, rerank_available)
        if rerank_available():
            return native_rerank(refine, q32, s, cand_ids, k)
    safe = np.clip(cand_ids, 0, len(refine) - 1)
    cand = refine[safe].astype(np.float32)          # [b, kk, d]
    exact = np.einsum("bd,bkd->bk", q32, cand, optimize=True)
    exact = np.where(s > -np.inf, exact, -np.inf)
    top = np.argsort(-exact, axis=1, kind="stable")[:, :k]
    return (np.take_along_axis(exact, top, axis=1),
            np.take_along_axis(cand_ids, top, axis=1))


def bucket_queries(queries, tile: int = 16):
    """Pad a query batch to the next bucket size on the HOST.

    The serving path sees arbitrary batch sizes (the micro-batcher coalesces
    whatever arrived); without bucketing every new size dispatches a fresh
    set of eager ops + kernel shapes — seconds of (remote) compiles each.
    The ladder is 1, 4, 8, then ``tile`` multiples: small buckets stay tight
    because the IVF query-major kernel pays probe DMA per padded row (a B=1
    probe padded to 16 rows would cost 16x the bucket traffic), while the
    flat kernel pads to its query tile internally either way. Returns
    (padded [Bp, D] array, real b).
    """
    q = np.asarray(queries) if not isinstance(queries, jax.Array) else queries
    b = q.shape[0]
    if b <= 8:
        bp = next(s for s in (1, 4, 8) if s >= b)
    else:
        bp = _round_up(b, tile)
    if bp != b:
        pad = [(0, bp - b), (0, 0)]
        q = (np.pad(q, pad) if isinstance(q, np.ndarray) else jnp.pad(q, pad))
    return q, b


def _refine_copy(host_src: np.ndarray | None, v_dev, cosine: bool) -> np.ndarray:
    """f16 refinement copy of the normalized vectors, built on the HOST when
    the source is a host array (zero device pull — the ingest path always
    hands numpy), else pulled from device pre-cast to f16 (half the bytes
    of an f32 pull)."""
    if host_src is not None:
        r = host_src.astype(np.float32)
        if cosine:
            r = r / np.maximum(np.linalg.norm(r, axis=1, keepdims=True), 1e-12)
        return r.astype(np.float16)
    return np.asarray(v_dev.astype(jnp.float16))


@functools.partial(jax.jit, static_argnames=("k", "ct", "cosine"))
def _flat_dispatch(q_pad, corpus, n_valid, *, k, ct, cosine):
    """Single-trace search dispatch: normalize + scan, nothing eager."""
    q = q_pad.astype(jnp.float32)
    if cosine:
        q = l2_normalize(q)
    return flat_search(q, corpus, k, n_valid=n_valid, corpus_tile=ct)


@functools.partial(jax.jit, static_argnames=("k", "ct", "cosine"))
def _int8_dispatch(q_pad, corpus, scale, n_valid, *, k, ct, cosine):
    q = q_pad.astype(jnp.float32)
    if cosine:
        q = l2_normalize(q)
    return int8_flat_search(q, corpus, scale, k, n_valid=n_valid,
                            corpus_tile=ct)


@functools.partial(jax.jit, static_argnames=("k", "ct", "cosine"))
def _int4_dispatch(q_pad, corpus, scale, n_valid, *, k, ct, cosine):
    q = q_pad.astype(jnp.float32)
    if cosine:
        q = l2_normalize(q)
    return int4_flat_search(q, corpus, scale, k, n_valid=n_valid,
                            corpus_tile=ct)


@functools.partial(jax.jit,
                   static_argnames=("cosine", "dtype", "rows_pad", "refine"))
def prep_rows(v, *, cosine, dtype, rows_pad, refine=False):
    """Normalize (cosine) + cast/quantize + pad raw rows in ONE program, so
    XLA fuses the f32 math into the passes that read the input: no f32
    copy of the corpus is ever materialized (a 10M x 768 f32 copy is
    30.7 GB). Returns (rows [rows_pad, D], scale or None, f16 refine copy
    of the normalized rows or None)."""
    x = v.astype(jnp.float32)
    if cosine:
        x = l2_normalize(x)
    ref = x.astype(jnp.float16) if refine else None
    scale = None
    if dtype == "int8":
        x, scale = quantize_rows(x)
    elif dtype == "int4":
        x, scale = quantize_rows_int4(x)
    else:
        x = x.astype(jnp.dtype(dtype))
    if rows_pad != x.shape[0]:
        x = jnp.pad(x, ((0, rows_pad - x.shape[0]), (0, 0)))
    if scale is not None:
        if dtype == "int4":              # scale planes [2, P] pad on axis 1
            scale = jnp.pad(scale, ((0, 0), (0, rows_pad - scale.shape[1])))
        else:
            scale = jnp.pad(scale, ((0, rows_pad - scale.shape[0]),))
    return x, scale, ref


@dataclass
class FlatIndex:
    """Exact search over an HBM-resident, tile-padded corpus matrix.

    ``cfg.dtype == "int8"`` stores a symmetric per-row quantized corpus
    (half the HBM traffic of bf16, BASELINE config 4); ``"int4"`` packs two
    logical rows per byte-row — corpus shape ``[N_pad/2, D]``, 1/4 the
    traffic and measurably FASTER than int8 (ops/quant.py) — pair with
    ``rerank_factor`` to buy the recall back. ``corpus_scale`` is None for
    float dtypes.
    """

    corpus: jax.Array          # [N_pad, D] ([N_pad/2, D] int4), pad rows zero
    n: int                     # valid rows
    cfg: EngineConfig
    corpus_scale: jax.Array | None = None   # int8: [N_pad] f32; int4: [2, N_pad/2] planes
    # row -> stable doc id; None = identity (build/add keep ids consecutive,
    # only delete() compacts rows and materializes the map — hnswlib-style
    # stable labels without paying a gather in the common case)
    ids: jax.Array | None = None            # [N_pad] i32
    _next_id: int | None = None             # None = n (no deletes yet)
    # host-RAM float16 copy for two-stage refinement (int8 +
    # cfg.rerank_factor > 0): the HBM scan stays int8-fast, the top
    # rerank_factor*k candidates are re-scored exactly on host
    refine: np.ndarray | None = None        # [n] rows, f16, row-aligned

    @classmethod
    def build(cls, vectors, cfg: EngineConfig = EngineConfig()) -> "FlatIndex":
        """Build from ``[N, D]`` raw vectors: normalize (cosine), cast, pad."""
        host_src = vectors if isinstance(vectors, np.ndarray) else None
        v = jnp.asarray(vectors)
        n, d = v.shape
        if d != cfg.dim:
            cfg = EngineConfig(**{**cfg.__dict__, "dim": d})
        n_pad = _round_up(max(n, cfg.corpus_tile), cfg.corpus_tile)
        if cfg.dtype == "int4" and cfg.corpus_tile % 2:
            raise ValueError("int4 needs an even corpus_tile (row-pair packing)")
        cosine = cfg.metric == "cosine"
        quant = cfg.dtype in ("int8", "int4")
        rerank = quant and bool(cfg.rerank_factor)
        rows_pad = n_pad // 2 if cfg.dtype == "int4" else n_pad
        v, scale, ref = prep_rows(
            v, cosine=cosine, dtype=cfg.dtype, rows_pad=rows_pad,
            refine=rerank and host_src is None)
        refine = None
        if rerank:
            refine = (_refine_copy(host_src, None, cosine)
                      if host_src is not None else np.asarray(ref))
        return cls(corpus=v, n=n, cfg=cfg, corpus_scale=scale, refine=refine)

    def search(self, queries, k: int | None = None):
        """Top-k search. Returns (scores [B,k] f32, indices [B,k] i32).

        The batch is host-bucketed to a 16-multiple and the whole dispatch
        (normalize + quantize + kernel) runs as ONE jitted call — arbitrary
        serving batch sizes reuse ~4 compiled shapes instead of tracing
        fresh eager ops per size (see ``bucket_queries``).
        """
        return self._finish_stage(*self._scan_stage(queries, k))

    def search_stream(self, batches, k: int | None = None, depth: int = 2):
        """Pipelined two-stage search over an iterable of query batches.

        Stage 1 is the device scan (async JAX dispatch); stage 2 is the
        host-side exact f16 rerank (``rerank_factor``). Issuing batch
        ``i+1``'s scan BEFORE pulling batch ``i``'s candidates overlaps the
        OpenMP rerank with device compute, so steady-state throughput is
        max(stage) instead of sum(stage): when the two stages take
        similar times the rerank becomes ~free. ``depth``
        bounds in-flight device work (2 = classic double buffering).

        Yields one ``(scores, indices)`` pair per input batch, in order;
        results are bit-identical to per-batch :meth:`search`.
        """
        from collections import deque

        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        pending: deque = deque()
        for qb in batches:
            pending.append(self._scan_stage(qb, k))
            if len(pending) > depth:
                yield self._finish_stage(*pending.popleft())
        while pending:
            yield self._finish_stage(*pending.popleft())

    def _scan_stage(self, queries, k: int | None):
        """Dispatch the device scan (async); returns finalize-stage args."""
        k = self.cfg.top_k if k is None else k
        if k > MAX_K:
            raise ValueError(f"k={k} > {MAX_K}, the engine's top-k cap")
        queries, squeeze = as_query_batch(queries)
        q_pad, b = bucket_queries(queries)
        cosine = self.cfg.metric == "cosine"
        n_valid = jnp.asarray(self.n, jnp.int32)
        rerank = self.refine is not None and self.cfg.rerank_factor > 0
        kk = min(MAX_K, self.cfg.rerank_factor * k, self.n) if rerank else k
        kk = max(kk, k)
        if self.cfg.dtype == "int4":
            s, i = _int4_dispatch(
                q_pad, self.corpus, self.corpus_scale, n_valid,
                k=kk, ct=self.cfg.corpus_tile, cosine=cosine)
        elif self.corpus_scale is not None:
            s, i = _int8_dispatch(
                q_pad, self.corpus, self.corpus_scale, n_valid,
                k=kk, ct=self.cfg.corpus_tile, cosine=cosine)
        else:
            s, i = _flat_dispatch(
                q_pad, self.corpus, n_valid,
                k=kk, ct=self.cfg.corpus_tile, cosine=cosine)
        return queries, s[:b], i[:b], squeeze, rerank, k, cosine

    def _finish_stage(self, queries, s, i, squeeze, rerank, k, cosine):
        """Pull candidates to host, exact-rerank, map stable ids."""
        if rerank:
            # even at kk == k (k at the kernel cap) the exact re-score
            # corrects the int8 ordering of the candidates
            s, i = host_rerank(self.refine, np.asarray(queries),
                               np.asarray(s), np.asarray(i), k, cosine)
            s, i = jnp.asarray(s), jnp.asarray(i)
        if self.ids is not None:
            i = jnp.where(s > -jnp.inf, self.ids[i], i)
        if squeeze:
            return s[0], i[0]
        return s, i

    def _dequantized(self) -> jax.Array:
        """Valid rows as f32 (identity for float dtypes)."""
        if self.cfg.dtype == "int4":
            return dequantize_int4(self.corpus, self.corpus_scale, self.n)
        rows = self.corpus[: self.n].astype(jnp.float32)
        if self.corpus_scale is not None:
            rows = rows * self.corpus_scale[: self.n, None]
        return rows

    @property
    def next_id(self) -> int:
        """First unused doc id (ids are never reused after delete)."""
        if self._next_id is not None:
            return self._next_id
        return self.n

    def add(self, vectors) -> "FlatIndex":
        """Append vectors (returns a new index; arrays are immutable in JAX).

        New rows get consecutive doc ids starting at ``next_id`` — stable
        labels that survive later deletes, like hnswlib's (the reference's
        incremental-insert path, ingest_medical.py:104-110 via Chroma).
        Cost: one HBM concat+pad pass, no structure to rebuild.
        """
        v = jnp.asarray(vectors)
        m = v.shape[0]
        if self.cfg.metric == "cosine":
            v = l2_normalize(v.astype(jnp.float32))
        n = self.n + m
        scale = None
        refine = self.refine
        if self.corpus_scale is not None:
            if refine is not None:
                refine = np.concatenate(
                    [refine, np.asarray(v, dtype=np.float16)], axis=0)
            if self.cfg.dtype == "int4":
                # row-pair packing straddles rows: requantize through f32
                # (bit-stable for existing rows — codes and scales reproduce
                # exactly, only the pairing shifts)
                merged, scale = quantize_rows_int4(jnp.concatenate(
                    [self._dequantized(), v.astype(jnp.float32)], axis=0))
            else:
                q8, s_new = quantize_rows(v.astype(jnp.float32))
                merged = jnp.concatenate([self.corpus[: self.n], q8], axis=0)
                scale = jnp.concatenate([self.corpus_scale[: self.n], s_new])
        else:
            merged = jnp.concatenate(
                [self.corpus[: self.n], v.astype(self.corpus.dtype)], axis=0)
        ids = None
        if self.ids is not None or self._next_id not in (None, self.n):
            old = (self.ids[: self.n] if self.ids is not None
                   else jnp.arange(self.n, dtype=jnp.int32))
            ids = jnp.concatenate(
                [old, self.next_id + jnp.arange(m, dtype=jnp.int32)])
        return self._repad(merged, n, scale, ids, self.next_id + m, refine)

    def delete(self, doc_ids) -> "FlatIndex":
        """Remove docs by stable id (returns a new index).

        Order-preserving compaction: one gather pass over the kept rows at
        HBM bandwidth — still orders of magnitude cheaper than an HNSW
        graph repair, and the n_valid scalar keeps the same compiled kernel.
        Unknown ids are ignored (Chroma semantics).
        """
        want_gone = np.asarray(jnp.asarray(doc_ids)).reshape(-1)
        cur = (np.asarray(self.ids[: self.n]) if self.ids is not None
               else np.arange(self.n, dtype=np.int32))
        keep = np.where(~np.isin(cur, want_gone))[0]
        if len(keep) == self.n:
            return self
        if len(keep) == 0:
            raise ValueError("delete would empty the index")
        keep_j = jnp.asarray(keep, dtype=jnp.int32)
        if self.cfg.dtype == "int4":
            # packed byte-rows hold two logical rows: compact in f32, repack
            merged, scale = quantize_rows_int4(
                jnp.take(self._dequantized(), keep_j, axis=0))
        else:
            merged = jnp.take(self.corpus, keep_j, axis=0)
            scale = (jnp.take(self.corpus_scale, keep_j)
                     if self.corpus_scale is not None else None)
        ids = jnp.asarray(cur[keep], dtype=jnp.int32)
        refine = self.refine[keep] if self.refine is not None else None
        return self._repad(merged, len(keep), scale, ids, self.next_id,
                           refine)

    def _repad(self, merged, n, scale, ids, next_id,
               refine=None) -> "FlatIndex":
        # rows are already normalized/quantized — re-pad only
        n_pad = _round_up(max(n, self.cfg.corpus_tile), self.cfg.corpus_tile)
        rows_pad = n_pad // 2 if self.cfg.dtype == "int4" else n_pad
        if rows_pad != merged.shape[0]:
            merged = jnp.pad(merged, ((0, rows_pad - merged.shape[0]), (0, 0)))
        if scale is not None:
            if self.cfg.dtype == "int4":
                pw = rows_pad - scale.shape[1]
                if pw:
                    scale = jnp.pad(scale, ((0, 0), (0, pw)))
            elif n_pad != n:
                scale = jnp.pad(scale, ((0, n_pad - n),))
        if n_pad != n and ids is not None:
            ids = jnp.pad(ids, ((0, n_pad - n),))
        return FlatIndex(corpus=merged, n=n, cfg=self.cfg, corpus_scale=scale,
                         ids=ids, _next_id=next_id, refine=refine)

    # -- persistence (index checkpoint: SURVEY §5 "add a 4th mechanism") -----

    def save(self, path: str) -> None:
        """Persist the RAW stored representation (bf16/int8/int4 bytes +
        scale planes) — a device->host fetch with ZERO device compute.

        The previous format dequantized to f32 on device first: novel-shape
        eager ops (slice + cast at n rows), each a fresh compile. Raw is
        also lossless and 2-8x smaller on disk."""
        os.makedirs(path, exist_ok=True)
        raw = np.asarray(self.corpus)          # fetch only
        if raw.dtype.name == "bfloat16":       # np.save chokes on ml_dtypes
            np.save(os.path.join(path, "corpus_raw.npy"),
                    raw.view(np.uint16))
        else:
            np.save(os.path.join(path, "corpus_raw.npy"), raw)
        if self.corpus_scale is not None:
            np.save(os.path.join(path, "scales.npy"),
                    np.asarray(self.corpus_scale))
        if self.ids is not None:
            np.save(os.path.join(path, "ids.npy"),
                    np.asarray(self.ids[: self.n]))
        if self.refine is not None:
            np.save(os.path.join(path, "refine.npy"), self.refine)
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump({"n": self.n, "kind": "flat", "cfg": self.cfg.__dict__,
                       "next_id": self.next_id, "format": 2}, f)

    @classmethod
    def load(cls, path: str) -> "FlatIndex":
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        cfg = EngineConfig.from_saved(meta["cfg"])
        if meta.get("format", 1) >= 2:
            raw = np.load(os.path.join(path, "corpus_raw.npy"))
            if cfg.dtype == "bfloat16":
                import ml_dtypes
                raw = raw.view(ml_dtypes.bfloat16)
            corpus = jnp.asarray(raw)
            scale = None
            sc_path = os.path.join(path, "scales.npy")
            if os.path.exists(sc_path):
                scale = jnp.asarray(np.load(sc_path))
            idx = cls(corpus=corpus, n=meta["n"], cfg=cfg, corpus_scale=scale)
        else:   # legacy format: dequantized f32 corpus, re-quantize via build
            arr = np.load(os.path.join(path, "corpus.npy"))
            idx = cls.build(arr, cfg)
        ids_path = os.path.join(path, "ids.npy")
        ids = None
        if os.path.exists(ids_path):
            raw_ids = np.load(ids_path)
            # ids are per LOGICAL row; int4 corpora store n_pad/2 byte-rows
            n_pad = idx.corpus.shape[0] * (2 if cfg.dtype == "int4" else 1)
            ids = jnp.asarray(np.pad(raw_ids, (0, n_pad - len(raw_ids))),
                              jnp.int32)
        # the saved refine copy carries the ORIGINAL f16 rows; a legacy
        # build() above could only reconstruct a dequantized-int8 one
        refine = idx.refine
        ref_path = os.path.join(path, "refine.npy")
        if os.path.exists(ref_path):
            refine = np.load(ref_path)
        return cls(corpus=idx.corpus, n=idx.n, cfg=idx.cfg,
                   corpus_scale=idx.corpus_scale, ids=ids,
                   _next_id=meta.get("next_id"), refine=refine)

    @property
    def nbytes(self) -> int:
        n = self.corpus.size * self.corpus.dtype.itemsize
        if self.corpus_scale is not None:
            n += self.corpus_scale.size * 4
        return n
