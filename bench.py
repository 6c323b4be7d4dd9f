"""Headline benchmark: flat exact search QPS/chip at recall@10 (BASELINE).

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...extras}

- corpus: 1M x 768 (int8+scales for the headline; bf16 and int4 beside
  it), query batch 64, k=10.
- value: int8 flat-scan QPS on the device JAX finds (named in the line).
- vs_baseline: speedup over the measured naive XLA path (materialize [B,N]
  scores + lax.top_k) on the same chip — the honest stand-in for the
  reference's retrieval stack, which cannot run here (Chroma/hnswlib are
  CPU-side C++; typical hnswlib throughput at this recall is O(1e3-1e4) QPS
  on a full CPU host, see BASELINE.md).
- recall@10 is computed against an f32 brute-force oracle on-device.

Timing uses obs.metrics.device_time (N iterations inside one jitted scan,
one scalar fetched, a measured no-op round trip subtracted).

The prep + search wiring lives in importable functions (`prep_corpus`,
`run_searches`) so `tests/test_bench_smoke.py` can execute this exact
pad/tile arithmetic at tiny N on CPU — a tile retune can never again ship
a crashing headline artifact (the round-3 failure mode: int8 corpus was
padded to a multiple of TC=2048 while TC8 had been retuned to 4096).
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp

from mediquery_rag.obs.metrics import device_time, recall_at_k
from mediquery_rag.ops.scoring import flat_search, flat_search_xla

N, D, B, K = 1_000_000, 768, 64, 10
TC = TC8 = TC4 = 2048   # top-k block (rows) per storage dtype
RERANK = 4   # int4 ships with rerank_factor=4 (engine/flat.py) — candidate
             # generation at 1/4 the bytes, exact f32 re-score of the top 4k
ITERS = 32   # two-point timing differences 32 vs 16 iterations; a larger
             # span amortizes host round-trip jitter better


def pads(n: int, tc: int, tc8: int, tc4: int) -> tuple[int, int, int]:
    """Padded row counts per dtype — each to a multiple of ITS OWN tile."""
    return -(-n // tc) * tc, -(-n // tc8) * tc8, -(-n // tc4) * tc4


def prep_corpus(n: int = N, d: int = D, b: int = B, iters: int = ITERS,
                tc: int = TC, tc8: int = TC8, tc4: int = TC4):
    """Build normalized corpus + per-dtype padded copies + query batches.

    Returns (c_f32, c_bf16, c_pad_bf16, c8_pad, cs8_pad, c4_pad, cs4_pad,
    queries[iters, b, d]). All prep runs in ONE traced program: XLA frees
    the int32 quantization temporaries (3 GB each at 1M x 768) between
    steps — eagerly they coexist with every resident copy and OOM the chip.
    """
    from mediquery_rag.ops.quant import quantize_rows, quantize_rows_int4

    n_pad, n_pad8, n_pad4 = pads(n, tc, tc8, tc4)

    @jax.jit
    def _mk():
        c = jax.random.normal(jax.random.PRNGKey(0), (n, d), jnp.float32)
        c = c / jnp.linalg.norm(c, axis=-1, keepdims=True)
        c_bf16 = c.astype(jnp.bfloat16)
        c_pad = jnp.pad(c_bf16, ((0, n_pad - n), (0, 0)))
        c8, cs = quantize_rows(c)
        c8p = jnp.pad(c8, ((0, n_pad8 - n), (0, 0)))
        csp = jnp.pad(cs, ((0, n_pad8 - n),))
        c4, cs4 = quantize_rows_int4(c)
        c4p = jnp.pad(c4, ((0, n_pad4 // 2 - c4.shape[0]), (0, 0)))
        cs4p = jnp.pad(cs4, ((0, 0), (0, n_pad4 // 2 - cs4.shape[1])))
        q = jax.random.normal(jax.random.PRNGKey(1), (iters, b, d),
                              jnp.float32)
        q = q / jnp.linalg.norm(q, axis=-1, keepdims=True)
        return c, c_bf16, c_pad, c8p, csp, c4p, cs4p, q

    return jax.block_until_ready(_mk())


def run_searches(data, n: int = N, k: int = K, tc: int = TC,
                 tc8: int = TC8, tc4: int = TC4, rerank: int = RERANK):
    """One search per path + recalls vs the f32 oracle (the exact wiring
    main() times). Returns a dict of recalls + the rerank indices."""
    c, c_bf16, c_pad, c8p, csp, c4p, cs4p, qs = data
    from mediquery_rag.ops.quant import int4_flat_search, int8_flat_search

    _, i_ref = flat_search_xla(qs[0], c, k)
    _, i_bf = flat_search(qs[0], c_pad, k, n_valid=n, corpus_tile=tc)
    _, i_i8 = int8_flat_search(qs[0], c8p, csp, k, n_valid=n, corpus_tile=tc8)
    _, i_i4 = int4_flat_search(qs[0], c4p, cs4p, k, n_valid=n, corpus_tile=tc4)

    # the SHIPPING int4 config (engine/flat.py rerank_factor=4): the int4
    # scan generates rerank*k candidates, an exact re-score picks the final
    # k. Recall measured with an exact f32 re-score on device; the serving
    # engine re-scores on HOST against the f16 refine copy (host_rerank),
    # whose stage time is measured separately in main() (device row-gather
    # via XLA is ~µs/row and NOT the shipping path).
    @jax.jit
    def _int4_rerank(q, cp, sp, corpus):
        _, cand = int4_flat_search(q, cp, sp, rerank * k, n_valid=n,
                                   corpus_tile=tc4)
        rows = jnp.take(corpus, cand, axis=0)          # [B, RK, D] f32
        exact = jnp.einsum("bd,bkd->bk", q, rows)
        s, j = jax.lax.top_k(exact, k)
        return s, jnp.take_along_axis(cand, j, axis=1)

    _, i_rr = jax.block_until_ready(_int4_rerank(qs[0], c4p, cs4p, c))
    return {
        "recall_bf16": recall_at_k(i_bf, i_ref),
        "recall_int8": recall_at_k(i_i8, i_ref),
        "recall_int4": recall_at_k(i_i4, i_ref),
        "recall_int4_rr": recall_at_k(i_rr, i_ref),
        "i_rr": i_rr,
    }


def main() -> None:
    from mediquery_rag import compile_cache
    from mediquery_rag.ops.quant import int4_flat_search, int8_flat_search

    compile_cache.enable()
    n_pad, n_pad8, n_pad4 = pads(N, TC, TC8, TC4)
    data = prep_corpus()
    c, c_bf16, c_pad, c8p, csp, c4p, cs4p, qs = data
    r = run_searches(data)

    # host rerank stage time (content-independent: same shapes/dtype as the
    # engine's f16 refine copy; zeros avoid denormal slowdowns)
    import time as _time

    import numpy as np
    from mediquery_rag.engine.flat import host_rerank
    refine_shape = np.zeros((N, D), np.float16)
    q_h = np.asarray(qs[0])
    s_h = np.zeros((B, RERANK * K), np.float32)
    i_h = np.asarray(r["i_rr"])
    i_h = np.tile(i_h, (1, RERANK))[:, : RERANK * K]
    host_rerank(refine_shape, q_h, s_h, i_h, K, cosine=False)  # warm
    t0 = _time.perf_counter()
    for _ in range(10):
        host_rerank(refine_shape, q_h, s_h, i_h, K, cosine=False)
    t_rr_host = (_time.perf_counter() - t0) / 10

    # a single measurement per dtype is exposed to in-session drift:
    # interleave REPS full passes over every path and report the BEST per
    # path, plus the spread.
    REPS = 3
    timers = {
        "bf16": lambda: device_time(
            lambda q, cp: flat_search(q, cp, K, n_valid=N, corpus_tile=TC),
            qs, c_pad),
        "int8": lambda: device_time(
            lambda q, cp, sp: int8_flat_search(
                q, cp, sp, K, n_valid=N, corpus_tile=TC8), qs, c8p, csp),
        "int4": lambda: device_time(
            lambda q, cp, sp: int4_flat_search(
                q, cp, sp, K, n_valid=N, corpus_tile=TC4),
            qs, c4p, cs4p),
        "xla": lambda: device_time(
            lambda q, cc: flat_search_xla(q, cc, K), qs, c_bf16),
    }
    samples = {name: [] for name in timers}
    for _ in range(REPS):
        for name, fn in timers.items():
            samples[name].append(fn())
    best = {name: min(v) for name, v in samples.items()}
    spread = {name: round((max(v) - min(v)) / min(v) * 100, 1)
              for name, v in samples.items()}
    t_bf16, t_int8, t_int4, t_xla = (best["bf16"], best["int8"],
                                     best["int4"], best["xla"])

    result = {
        "metric": "exact_search_qps_per_chip_int8",
        "value": round(B / t_int8, 1),
        "unit": "QPS (1M x 768-d int8+scales, B=64, k=10)",
        "vs_baseline": round(t_xla / t_int8, 3),
        "recall_at_10_int8_vs_f32": r["recall_int8"],
        "recall_at_10_bf16_vs_f32": r["recall_bf16"],
        "int8_ms_per_batch": round(t_int8 * 1e3, 3),
        "bf16_ms_per_batch": round(t_bf16 * 1e3, 3),
        "bf16_qps": round(B / t_bf16, 1),
        "int4_ms_per_batch": round(t_int4 * 1e3, 3),
        "int4_qps": round(B / t_int4, 1),
        "recall_at_10_int4_vs_f32": r["recall_int4"],
        "recall_at_10_int4_rerank4_vs_f32": r["recall_int4_rr"],
        "int4_rerank_host_stage_ms": round(t_rr_host * 1e3, 3),
        # steady-state e2e of the pipelined two-stage path, DERIVED as
        # B/max(stage) from the two separately measured stages above
        # (engine/flat.py search_stream: batch i's host rerank overlaps
        # batch i+1's device scan). The _derived suffix marks it as
        # computed, not a wall-clock measurement.
        "int4_rerank_stream_qps_derived": round(
            B / max(t_int4, t_rr_host), 1),
        "xla_naive_bf16_ms_per_batch": round(t_xla * 1e3, 3),
        "timing_reps": REPS,
        "in_session_drift_pct": spread,
        "corpus_bytes": {"bf16": n_pad * D * 2, "int8": n_pad8 * (D + 4),
                         "int4": n_pad4 * (D // 2 + 4)},
        "device": {"platform": jax.devices()[0].platform,
                   "kind": jax.devices()[0].device_kind,
                   "count": len(jax.devices())},
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
