"""Recall-parity harness: device engine vs in-repo C++ HNSW at equal memory.

The BASELINE target is "recall@10 >= Chroma-HNSW parity at equal memory with
>=10x QPS". Chroma's engine is hnswlib; the comparable CPU-side engine here
is native/hnsw.cpp. This harness builds both over the same corpus and
reports recall (vs exact f32 oracle), memory, and QPS for:

  - CPU HNSW (M, ef sweep)  — the reference-stack stand-in
  - device flat bf16 / int8 — exact scan
  - device IVF (nprobe sweep) — coarse-quantized

Run: python benchmarks/parity.py [--n 200000] [--d 768] [--b 64]
Outputs one JSON line per configuration.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=200_000)
    ap.add_argument("--d", type=int, default=768)
    ap.add_argument("--b", type=int, default=64)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--clusters", type=int, default=1024)
    args = ap.parse_args()
    n, d, b, k = args.n, args.d, args.b, args.k

    rng = np.random.default_rng(0)
    centers = rng.standard_normal((args.clusters, d)).astype(np.float32)
    asg = rng.integers(0, args.clusters, n)
    x = centers[asg] + 0.35 * rng.standard_normal((n, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = x[rng.integers(0, n, b)] + 0.05 * rng.standard_normal((b, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)

    import jax
    import jax.numpy as jnp
    from mediquery_rag.config import EngineConfig
    from mediquery_rag.engine import FlatIndex, IVFIndex
    from mediquery_rag.obs import recall_at_k
    from mediquery_rag.obs.metrics import device_time
    from mediquery_rag.ops import flat_search_xla

    xj = jnp.asarray(x)
    qj = jnp.asarray(q)
    _, i_ref = flat_search_xla(qj, xj, k)
    i_ref = np.asarray(i_ref)

    iters = 8
    qs = jnp.asarray(
        np.stack([q + 0.001 * t for t in range(iters)]).astype(np.float32))

    def emit(engine, recall, qps, mem_mb, extra=None):
        row = {"engine": engine, "n": n, "d": d, "batch": b, "k": k,
               "recall_at_10": round(float(recall), 4),
               "qps": round(float(qps), 1),
               "memory_mb": round(mem_mb, 1)}
        row.update(extra or {})
        print(json.dumps(row))

    # --- CPU HNSW (the Chroma/hnswlib stand-in) ---------------------------
    from mediquery_rag.native import HNSWIndex, hnsw_available
    if hnsw_available():
        h = HNSWIndex(d, M=16, ef_construction=200)
        t0 = time.perf_counter()
        h.add(x)
        t_build = time.perf_counter() - t0
        n_threads = os.cpu_count() or 1
        for ef in (32, 64, 128):
            t0 = time.perf_counter()
            _, ih = h.search(q, k, ef=ef, threads=n_threads)
            t_q = (time.perf_counter() - t0) / b
            emit("cpu_hnsw", recall_at_k(ih, i_ref), 1.0 / t_q,
                 h.nbytes / 1e6, {"ef": ef, "build_s": round(t_build, 2),
                                  "threads": n_threads})

    # NOTE: big arrays must be *arguments* of the timed fn (not closures) —
    # closure constants are baked into the compiled program.

    # --- device flat -------------------------------------------------------
    from mediquery_rag.ops.scoring import flat_search
    from mediquery_rag.ops.quant import int8_flat_search
    for dtype in ("bfloat16", "int8"):
        cfg = EngineConfig(dim=d, dtype=dtype)
        t0 = time.perf_counter()
        fi = FlatIndex.build(xj, cfg)
        jax.block_until_ready(fi.corpus)
        t_build = time.perf_counter() - t0
        _, i_got = fi.search(qj, k=k)
        tile = fi.cfg.corpus_tile
        if dtype == "int8":
            t = device_time(
                lambda qb, corp, sc: int8_flat_search(
                    qb, corp, sc, k, n_valid=fi.n, corpus_tile=tile),
                qs, fi.corpus, fi.corpus_scale)
        else:
            t = device_time(
                lambda qb, corp: flat_search(
                    qb, corp, k, n_valid=fi.n, corpus_tile=tile),
                qs, fi.corpus)
        emit(f"device_flat_{dtype}", recall_at_k(np.asarray(i_got), i_ref),
             b / t, fi.nbytes / 1e6, {"build_s": round(t_build, 2)})

    # --- device IVF --------------------------------------------------------
    from mediquery_rag.ops.ivf_probe import ivf_probe_search
    cfg = EngineConfig(dim=d, dtype="bfloat16",
                       ivf_nlist=min(1024, n // 64), ivf_kmeans_iters=8)
    t0 = time.perf_counter()
    iv = IVFIndex.build(xj, cfg)
    jax.block_until_ready(iv.buckets)
    t_build = time.perf_counter() - t0
    for nprobe in (8, 16, 32, 64):
        nprobe = min(nprobe, iv.centroids.shape[0])
        _, i_got = iv.search(qj, k=k, nprobe=nprobe)

        def ivf_fn(qb, cents, buckets, bids, np_=nprobe):
            cs = jnp.dot(qb, cents.T, preferred_element_type=jnp.float32)
            _, pid = jax.lax.top_k(cs, np_)
            return ivf_probe_search(pid.astype(jnp.int32),
                                    qb.astype(buckets.dtype),
                                    buckets, bids, k=k)

        t = device_time(ivf_fn, qs, iv.centroids, iv.buckets, iv.bucket_ids)
        emit("device_ivf_bf16", recall_at_k(np.asarray(i_got), i_ref),
             b / t, iv.nbytes / 1e6,
             {"nprobe": nprobe, "nlist": iv.centroids.shape[0],
              "build_s": round(t_build, 2)})


if __name__ == "__main__":
    main()
