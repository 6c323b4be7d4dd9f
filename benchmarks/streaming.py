"""Beyond-HBM streaming tier benchmark (engine/streaming.py).

Measures the host→device streamed exact search: corpus in host RAM as
int8 chunks, double-buffered device_put + fused-kernel folds. Reports
ms/pass, effective streamed GB/s, and QPS at the given query batch —
the tier's speed-of-light is the HOST LINK, so QPS scales with batch
size (the chunk bytes are paid once per pass regardless of B).

The streamed GB/s depends on the host-to-device link (PCIe generation,
pinned memory, co-tenants); report it with the host it was measured on.

Correctness proxy at scale: planted-row hit rate (same methodology as
scale10m.py).
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
    ap.add_argument("--n", type=int, default=20_000_000)
    ap.add_argument("--d", type=int, default=768)
    ap.add_argument("--b", type=int, default=256)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--chunk-rows", type=int, default=2_000_000)
    ap.add_argument("--passes", type=int, default=3)
    ap.add_argument("--sync", action="store_true",
                    help="also time prefetch=False (synchronous copies) — "
                         "reports what the double-buffer overlap buys")
    ap.add_argument("--prep", default="host", choices=("host", "device"),
                    help="where the build quantizes; 'host' keeps the build "
                         "off the device entirely (engine/streaming.py)")
    args = ap.parse_args()
    n, d, b, k = args.n, args.d, args.b, args.k

    import jax
    import jax.numpy as jnp

    from mediquery_rag.config import EngineConfig
    from mediquery_rag.engine.streaming import StreamingFlatIndex

    cfg = EngineConfig(dim=d, dtype="int8", corpus_tile=2048)
    rng = np.random.default_rng(0)

    # host-side corpus, built block-wise (float master never materializes)
    def blocks():
        for i in range(0, n, 1_000_000):
            m = min(1_000_000, n - i)
            x = rng.standard_normal((m, d), dtype=np.float32)
            yield x / np.linalg.norm(x, axis=1, keepdims=True)

    t0 = time.perf_counter()
    idx = StreamingFlatIndex.build_from_blocks(blocks(), cfg,
                                               chunk_rows=args.chunk_rows,
                                               prep=args.prep)
    t_build = time.perf_counter() - t0

    # queries: noisy copies of known rows (planted-neighbor recall proxy)
    plant = rng.integers(0, n, size=b)
    q = np.stack([
        np.asarray(idx.chunks[p // idx.chunk_rows][p % idx.chunk_rows],
                   np.float32)
        * np.asarray(idx.scales[p // idx.chunk_rows][p % idx.chunk_rows])
        for p in plant])
    q = q + 0.05 * rng.standard_normal(q.shape).astype(np.float32)

    idx.search(q[:1], k=k)                      # compile
    t0 = time.perf_counter()
    for _ in range(args.passes):
        s, ids = idx.search(q, k=k)
        ids = np.asarray(jax.block_until_ready(ids))
    t_pass = (time.perf_counter() - t0) / args.passes

    hit = float(np.mean([plant[r] in ids[r] for r in range(b)]))
    streamed_gb = idx.nbytes_host / 1e9

    t_sync = None
    if args.sync:
        t0 = time.perf_counter()
        for _ in range(args.passes):
            s2, ids2 = idx.search(q, k=k, prefetch=False)
            np.asarray(jax.block_until_ready(ids2))
        t_sync = (time.perf_counter() - t0) / args.passes

    print(json.dumps({
        "metric": "streaming_exact_search",
        "n": n, "d": d, "b": b, "k": k,
        "chunk_rows": idx.chunk_rows, "n_chunks": len(idx.chunks),
        "host_bytes_gb": round(streamed_gb, 2),
        "build_s": round(t_build, 1),
        "ms_per_pass": round(t_pass * 1e3, 1),
        "streamed_gb_per_s": round(streamed_gb / t_pass, 2),
        "qps": round(b / t_pass, 1),
        "planted_hit_rate": hit,
        **({"sync_ms_per_pass": round(t_sync * 1e3, 1),
            "overlap_speedup": round(t_sync / t_pass, 2)}
           if t_sync is not None else {}),
        "backend": jax.default_backend(),
    }))


if __name__ == "__main__":
    main()
