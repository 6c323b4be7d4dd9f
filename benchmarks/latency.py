"""Single-query latency: flat scan vs IVF probe (the IVF raison d'être).

At B=1 the flat kernel still reads all N rows; IVF reads nprobe buckets.
One JSON line per engine config. Run on the real chip.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--d", type=int, default=768)
    ap.add_argument("--k", type=int, default=10)
    args = ap.parse_args()
    n, d, k = args.n, args.d, args.k

    import jax
    import jax.numpy as jnp

    from mediquery_rag.config import EngineConfig
    from mediquery_rag.engine import FlatIndex, IVFIndex
    from mediquery_rag.obs.metrics import device_time, recall_at_k
    from mediquery_rag.ops.scoring import flat_search
    from mediquery_rag.ops.quant import int8_flat_search
    from mediquery_rag.ops.ivf_kernel import ivf_probe_search

    rng = np.random.default_rng(0)
    centers = rng.standard_normal((1024, d)).astype(np.float32)
    asg = rng.integers(0, 1024, n)
    x = centers[asg] + 0.35 * rng.standard_normal((n, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    xj = jnp.asarray(x)
    iters = 64
    qs = jnp.asarray(
        (x[rng.integers(0, n, iters)] +
         0.05 * rng.standard_normal((iters, d))).astype(np.float32))
    qs = qs / jnp.linalg.norm(qs, axis=1, keepdims=True)
    qs1 = qs[:, None, :]                                  # [iters, 1, d]

    from mediquery_rag.ops import flat_search_xla
    _, i_ref = flat_search_xla(qs, xj, k)
    i_ref = np.asarray(i_ref)

    def emit(engine, t, recall, extra=None):
        row = {"engine": engine, "n": n, "batch": 1, "k": k,
               "latency_us": round(t * 1e6, 1),
               "qps_single_stream": round(1 / t, 1),
               "recall_at_10": round(float(recall), 4)}
        row.update(extra or {})
        print(json.dumps(row))

    # flat bf16
    fb = FlatIndex.build(xj, EngineConfig(dim=d, dtype="bfloat16"))
    _, ig = fb.search(qs, k=k)
    t = device_time(
        lambda q, corp: flat_search(q, corp, k, n_valid=fb.n),
        qs1, fb.corpus)
    emit("flat_bf16", t, recall_at_k(np.asarray(ig), i_ref))

    # flat int8
    fi = FlatIndex.build(xj, EngineConfig(dim=d, dtype="int8"))
    _, ig = fi.search(qs, k=k)
    t = device_time(
        lambda q, corp, sc: int8_flat_search(q, corp, sc, k, n_valid=fi.n),
        qs1, fi.corpus, fi.corpus_scale)
    emit("flat_int8", t, recall_at_k(np.asarray(ig), i_ref))

    # IVF (free the flat indexes first — HBM is shared)
    del fb, fi
    iv = IVFIndex.build(xj, EngineConfig(dim=d, dtype="bfloat16",
                                         ivf_nlist=1024, ivf_kmeans_iters=8))
    for nprobe in (4, 8, 16, 32):
        _, ig = iv.search(qs, k=k, nprobe=nprobe)

        def ivf_fn(q, cents, buckets, bids, np_=nprobe):
            cs = jnp.dot(q, cents.T, preferred_element_type=jnp.float32)
            _, pid = jax.lax.top_k(cs, np_)
            return ivf_probe_search(pid.astype(jnp.int32),
                                    q.astype(buckets.dtype), buckets, bids, k=k)

        t = device_time(ivf_fn, qs1, iv.centroids, iv.buckets, iv.bucket_ids)
        emit("ivf_bf16", t, recall_at_k(np.asarray(ig), i_ref),
             {"nprobe": nprobe, "cap": iv.cap})


if __name__ == "__main__":
    main()
