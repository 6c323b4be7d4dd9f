"""Sustained-load serving benchmark (r4 VERDICT item 7).

Every prior serving number was a fixed 16-request backlog of identical
128-token requests. This harness drives `serve/llm.py` the way deployment
traffic actually arrives:

- **Poisson arrivals** at a configurable rate (one pre-generated,
  seed-deterministic schedule shared by every config, so slot/chunk A/Bs
  compare the same workload).
- **Mixed lengths**: prompt tokens log-uniform in [128, 3456], output
  tokens log-uniform in [32, 512].
- **Metrics**: p50/p99 TTFT (submit -> first streamed delta), p50/p99
  per-output-token latency (stream span / tokens it covers), goodput
  (completed output tokens / makespan), and completion counts. Requests
  run with ``ignore_eos=True`` so output lengths follow the schedule
  (random/under-trained weights would otherwise EOS at random points).
- **A/Bs**: slots in {4, 8, 16} and chunked prefill on (prefill_chunk
  256, long admissions interleave with decode) vs off (one-piece
  prefills, head-of-line blocking back).

Default model: the 7B-class shipping serving config (int8 weights, int8
KV, flash attention). Wall clock on purpose — the scheduler and dispatch
latency ARE serving latency.

    python benchmarks/serve_load.py --slots 4,8,16 --rate 1.0

One JSON line per config. Reference seam: the reference served every
request one-at-a-time through a blocking Ollama HTTP client
(/root/reference/src/medical_engine.py:46).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

MODELS = {
    "tiny": (64, 2, 4, None, 128, "bf16"),
    "1B-class": (2048, 16, 16, None, 5632, "bf16"),
    "7B-class": (3584, 28, 28, 4, 18944, "int8"),
}


def build_schedule(n, rate, pmin, pmax, omin, omax, seed, corpus_text):
    """Seed-deterministic (arrival_s, prompt, max_new) triples."""
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / rate, n))
    plens = np.exp(rng.uniform(np.log(pmin), np.log(pmax), n)).astype(int)
    olens = np.exp(rng.uniform(np.log(omin), np.log(omax), n)).astype(int)
    reqs = []
    for i in range(n):
        start = int(rng.integers(0, max(len(corpus_text) - plens[i], 1)))
        # byte tokenizer: ~1 token/byte; slice the corpus text by bytes
        prompt = corpus_text.encode("utf-8")[start:start + plens[i]] \
            .decode("utf-8", errors="ignore")
        reqs.append((float(arrivals[i]), prompt, int(olens[i])))
    return reqs


def run_config(server, schedule, chunk):
    lock = threading.Lock()
    recs = {}

    class Rec:
        __slots__ = ("t_sub", "t_first", "t_last", "max_new", "done", "err")

        def __init__(self, t_sub, max_new):
            self.t_sub = t_sub
            self.t_first = None
            self.t_last = None
            self.max_new = max_new
            self.done = False
            self.err = None

    t0 = time.perf_counter()
    futs = []
    for arrival, prompt, max_new in schedule:
        now = time.perf_counter() - t0
        if arrival > now:
            time.sleep(arrival - now)
        rec = Rec(time.perf_counter(), max_new)

        def on_text(delta, rec=rec):
            now = time.perf_counter()
            with lock:
                if rec.t_first is None:
                    rec.t_first = now
                rec.t_last = now

        fut = server.submit(prompt, max_new_tokens=max_new,
                            on_text=on_text, ignore_eos=True)
        recs[id(fut)] = rec
        futs.append(fut)
    for fut in futs:
        rec = recs[id(fut)]
        try:
            fut.result(timeout=1200.0)
            rec.done = True
            # prefer the server's own token timestamps: on_text only
            # fires when tokens decode to VISIBLE text, and a random/
            # under-trained model's greedy attractor token may be a
            # noise id that never renders (6/40 requests in the first
            # 7B run "failed" for exactly this reason)
            if getattr(fut, "t_first_token", None) is not None:
                rec.t_first = fut.t_first_token
                rec.t_last = fut.t_done
        except Exception as e:                      # noqa: BLE001
            rec.err = repr(e)
    makespan = time.perf_counter() - t0

    # ignore_eos makes output token counts exact-by-construction
    # (= max_new), so goodput is token-based. TPOT divides the token span
    # (first token -> completion) by the tokens it covers: both stamps
    # land at chunk boundaries, and the first already carries ~chunk
    # tokens.
    ttft, tpot, toks = [], [], 0
    fails = 0
    for rec in recs.values():
        if not rec.done or rec.t_first is None:
            fails += 1
            continue
        ttft.append(rec.t_first - rec.t_sub)
        toks += rec.max_new
        if rec.max_new > chunk and rec.t_last > rec.t_first:
            tpot.append((rec.t_last - rec.t_first) / (rec.max_new - chunk))

    def pct(xs, q):
        return round(float(np.percentile(xs, q)), 4) if xs else None

    return {
        "completed": len(ttft), "failed": fails,
        "makespan_s": round(makespan, 1),
        "goodput_tok_per_s": round(toks / makespan, 1),
        "ttft_p50_s": pct(ttft, 50), "ttft_p99_s": pct(ttft, 99),
        "tpot_p50_ms": (round(pct(tpot, 50) * 1e3, 2) if tpot else None),
        "tpot_p99_ms": (round(pct(tpot, 99) * 1e3, 2) if tpot else None),
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="7B-class", choices=sorted(MODELS))
    ap.add_argument("--slots", default="4,8,16")
    ap.add_argument("--requests", type=int, default=40)
    ap.add_argument("--rate", type=float, default=1.0,
                    help="Poisson arrival rate, requests/s")
    ap.add_argument("--prompt-range", default="128,3456")
    ap.add_argument("--output-range", default="32,512")
    ap.add_argument("--max-len", type=int, default=4096)
    ap.add_argument("--chunk", type=int, default=32)
    ap.add_argument("--prefill-chunks", default="256,0",
                    help="prefill_chunk values to A/B; 0 = one-piece "
                         "prefill (chunked prefill OFF)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from mediquery_rag.config import DecoderConfig
    from mediquery_rag.ingest import parse_corpus_file
    from mediquery_rag.models.generate import Generator
    from mediquery_rag.serve.llm import LLMServer

    h, l_, heads, kvh, mlp, wq = MODELS[args.model]
    cfg = DecoderConfig(hidden=h, layers=l_, heads=heads, kv_heads=kvh,
                        mlp_dim=mlp, max_len=args.max_len,
                        param_dtype="bfloat16",
                        kv_dtype="int8" if wq == "int8" else "",
                        attn_impl="flash")
    if wq == "int8":
        # one jitted init+quantize program (big-model init rule: eager
        # init dispatches ~7*layers ops)
        from mediquery_rag.models.decoder import Decoder
        from mediquery_rag.ops.matvec import quantize_decoder_params
        params = jax.jit(lambda k: quantize_decoder_params(
            Decoder(cfg).init(k), 8))(jax.random.PRNGKey(0))
        gen = Generator(cfg, params=params)
    else:
        gen = Generator(cfg).to_serving_dtype()

    pmin, pmax = (int(x) for x in args.prompt_range.split(","))
    omin, omax = (int(x) for x in args.output_range.split(","))
    corpus_text = "\n".join(
        c.text for c in parse_corpus_file("data/medical_data.txt")) * 8
    schedule = build_schedule(args.requests, args.rate, pmin,
                              min(pmax, args.max_len - omax - 64),
                              omin, omax, args.seed, corpus_text)

    for pfc in (int(x) for x in args.prefill_chunks.split(",")):
        for slots in (int(x) for x in args.slots.split(",")):
            srv = LLMServer(gen, slots=slots, chunk=args.chunk,
                            prefill_chunk=pfc or args.max_len)
            try:
                srv.complete("预热", max_new_tokens=32)     # compile warm
                row = run_config(srv, schedule, args.chunk)
            finally:
                srv.close()
            row.update({
                "metric": "serve_sustained_load", "model": args.model,
                "weights": wq, "slots": slots,
                "chunked_prefill": bool(pfc),
                "rate_req_per_s": args.rate, "requests": args.requests,
                "prompt_tokens": [pmin, min(pmax, args.max_len - omax - 64)],
                "output_tokens": [omin, omax],
            })
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
