"""Embedding-forward benchmark (BASELINE config 2: query batch 1/8/64).

Measures the device encoder's embed throughput/latency at the three batch
sizes the reference's Ollama HTTP round trip served one-at-a-time.
One JSON line per batch size.
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
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--peak-tflops", type=float, default=None,
                    help="the device's published peak (dense TFLOP/s at "
                         "this dtype) for the MFU column; omitted if unset")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from mediquery_rag.config import EmbedderConfig
    from mediquery_rag.models import Embedder, HashCharTokenizer
    from mediquery_rag.obs.metrics import (
        device_time, lm_matmul_flops, mfu)

    cfg = EmbedderConfig(layers=args.layers)
    model = Embedder(cfg)
    params = model.init(jax.random.PRNGKey(0))
    tok = HashCharTokenizer(cfg.vocab_size, cfg.max_len)

    texts = ["高血压患者的饮食建议" * 4] * 64
    ids, mask = tok.batch_encode(texts, max_len=args.seq)

    for b in (1, 8, 64):
        iters = max(16, 256 // b)          # small batches need amortization
        # rotate the window so every scan iteration sees different tokens
        xs = (jnp.asarray(np.stack([np.roll(ids[:b], t, axis=1)
                                    for t in range(iters)])),
              jnp.asarray(np.stack([mask[:b]] * iters)))

        def fn(x, p):
            i, m = x
            return model.apply(p, i, m)

        t = device_time(fn, xs, params)
        print(json.dumps({
            "metric": "embed_forward",
            "batch": b,
            "seq": int(ids.shape[1]),
            "layers": cfg.layers,
            "hidden": cfg.hidden,
            "latency_ms": round(t * 1e3, 3),
            "texts_per_s": round(b / t, 1),
            # fwd-only model FLOPs: bidirectional attention (causal=False),
            # embed-table lookups excluded, output proj ~ vocab term
            "mfu_pct": round(100 * mfu(
                lm_matmul_flops(hidden=cfg.hidden, layers=cfg.layers,
                                mlp_dim=cfg.mlp_dim, vocab=768,
                                heads=cfg.heads, kv_heads=None,
                                seq_len=int(ids.shape[1]), causal=False,
                                swiglu=False),
                b * int(ids.shape[1]) / t, args.peak_tflops * 1e12), 1)
            if args.peak_tflops else None,
            "device": jax.devices()[0].device_kind,
        }))


if __name__ == "__main__":
    main()
