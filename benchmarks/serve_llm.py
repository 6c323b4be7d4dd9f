"""Continuous-batching LLM serving throughput (serve/llm.py).

Scenario: a backlog of N requests (the many-sessions case — consultation
triage calls, graph grade/generate calls, science-QA users — all sharing
one device). Sequential B=1 lockstep decoding is what the reference's
one-request-at-a-time Ollama client did; the continuous-batching server
interleaves them through one decode loop. Decode is weight-bandwidth
bound, so lanes share each weight read and aggregate tok/s scales ~with
occupancy until the tensor cores saturate.

Wall-clock timing (not device_time): the scheduler's host work and the
host round trip per chunk are part of serving latency, so they belong in
the number. One JSON line per (model, slots).

Run on the GPU:  python benchmarks/serve_llm.py --model 1B-class
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

MODELS = {
    # name: (hidden, layers, heads, kv_heads, mlp_dim) — as benchmarks/decode.py
    "tiny": (64, 2, 4, None, 128),      # CPU smoke runs only
    "base-60M": (512, 8, 8, None, 1536),
    "1B-class": (2048, 16, 16, None, 5632),
    "7B-class": (3584, 28, 28, 4, 18944),
}

PROMPTS = [
    "高血压患者的饮食建议是什么？",
    "糖尿病如何运动？",
    "头痛三天了，怎么办？",
    "BMI 怎么计算？",
    "咳嗽有痰，需要就医吗？",
    "体检报告里的血脂偏高说明什么？",
    "失眠有什么非药物的改善方法？",
    "儿童发烧到多少度需要去医院？",
]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="1B-class", choices=sorted(MODELS))
    ap.add_argument("--slots", default="1,4,8")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=128)
    ap.add_argument("--chunk", type=int, default=32)
    ap.add_argument("--weights", choices=("bf16", "int8", "int4"),
                    default="bf16")
    ap.add_argument("--draft", choices=sorted(MODELS) + ["self"],
                    default=None,
                    help="speculative serving: draft model (e.g. base-60M). "
                         "Untrained drafts bracket the envelope the same way "
                         "benchmarks/speculative.py does: a random small "
                         "draft is the nothing-accepted worst case; 'self' "
                         "(draft = the target's own weights) exercises the "
                         "all-accepted round mechanics at full draft cost")
    ap.add_argument("--gamma", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=1024)
    ap.add_argument("--cache-layout", choices=("auto", "xs"), default="auto",
                    help="xs forces the pre-r4 scan-xs cache layout for a "
                         "same-session A/B against the size-gated stacked "
                         "zero-copy layout (models/decoder.py _use_stacked)")
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from mediquery_rag.config import DecoderConfig
    from mediquery_rag.models.generate import Generator
    from mediquery_rag.serve.llm import LLMServer

    if args.cache_layout == "xs":
        from mediquery_rag.models import decoder
        decoder._STACKED_MIN_CACHE_BYTES = 1 << 62

    h, l_, heads, kvh, mlp = MODELS[args.model]
    cfg = DecoderConfig(hidden=h, layers=l_, heads=heads, kv_heads=kvh,
                        mlp_dim=mlp, max_len=args.max_len,
                        param_dtype="bfloat16")
    gen = Generator(cfg)
    if args.weights != "bf16":
        gen.quantize_weights(bits=8 if args.weights == "int8" else 4)

    draft = None
    if args.draft == "self":
        draft = Generator(cfg, params=gen.params)
    elif args.draft:
        dh, dl, dheads, dkvh, dmlp = MODELS[args.draft]
        draft = Generator(DecoderConfig(
            hidden=dh, layers=dl, heads=dheads, kv_heads=dkvh, mlp_dim=dmlp,
            max_len=1024, param_dtype="bfloat16"),
            key=jax.random.PRNGKey(7))

    reqs = [PROMPTS[i % len(PROMPTS)] for i in range(args.requests)]
    for slots in (int(s) for s in args.slots.split(",")):
        srv = LLMServer(gen, slots=slots, chunk=args.chunk,
                        draft=draft, gamma=args.gamma)
        # warm the compile caches (one prefill bucket + the chunk program),
        # then drop the warm request from the latency stats — its TTFT is
        # dominated by compilation and would land in the p99
        srv.complete(reqs[0], max_new_tokens=args.chunk, timeout=1200)
        srv._lat_first.clear()
        srv._lat_total.clear()
        t0 = time.perf_counter()
        futs = [srv.submit(p, max_new_tokens=args.max_new) for p in reqs]
        outs = [f.result(timeout=2400) for f in futs]
        dt = time.perf_counter() - t0
        toks = srv.stats["tokens_out"]
        stats = dict(srv.stats)
        lat = srv.latency()
        srv.close()
        # tokens_out includes the warmup request's tokens; subtract
        toks -= min(args.chunk, args.max_new)
        row = {
            "metric": "serve_llm_tok_per_s",
            "model": args.model,
            "weights": args.weights,
            "slots": slots,
            "requests": args.requests,
            "max_new": args.max_new,
            "value": round(toks / dt, 1),
            "unit": "aggregate generated tok/s (wall clock incl. scheduling)",
            "wall_s": round(dt, 2),
            "completed": sum(1 for o in outs if isinstance(o, str)),
            "ttft_p50_s": (None if lat["ttft_p50_s"] is None
                           else round(lat["ttft_p50_s"], 3)),
            "ttft_p99_s": (None if lat["ttft_p99_s"] is None
                           else round(lat["ttft_p99_s"], 3)),
        }
        if draft is not None:
            row["draft"] = args.draft
            row["gamma"] = args.gamma
            row["spec_tok_per_round"] = (
                round(stats["spec_tokens"] / stats["spec_rounds"], 2)
                if stats["spec_rounds"] else None)
        print(json.dumps(row))


if __name__ == "__main__":
    main()
