"""Speculative decoding latency (models/speculative.py).

B=1 decode is weight-bandwidth bound (benchmarks/decode.py) — speculation
is the lever past that wall: one target weight-read verifies gamma+1
candidate tokens. Acceptance rate (how often the draft agrees with the
target) sets the realized speedup, and acceptance is a property of the
WEIGHTS, which are random here (zero egress — no pretrained pairs). So
this bench brackets the envelope instead of pretending:

- ``self``-draft (target drafts for itself): acceptance mechanics check —
  every proposal accepted (gamma+1 tokens/round). NOT a speed bound: the
  draft is full-size, so each round pays G+1 full weight reads.
- ``tiny`` random draft: the real ROUND COST (G cheap drafts + one target
  verify) at the worst-case acceptance of 1 token/round — shows
  speculation degrades gracefully, not catastrophically.
- ``projected``: tiny-draft round time x self-draft acceptance — the
  throughput a TRAINED draft with full agreement would realize; a real
  qwen2.5 7B + 0.5B pair typically accepts 2-4 of gamma=4, i.e. between
  ``tiny`` and ``projected``.

One JSON line per mode. Run on the real chip.

Timing note: obs.metrics.device_time (two-point scan timing) cannot wrap a
speculative generate — the program's round count is data-dependent, so it
cannot be scanned a fixed K times. Each timed call is instead ONE jitted
dispatch + one result fetch; every mode pays the same constant, which
biases speedup_vs_plain slightly TOWARD 1 — the reported speedups are
conservative.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

MODELS = {
    "base-60M": (512, 8, 8, None, 1536),
    "1B-class": (2048, 16, 16, None, 5632),
    "7B-class": (3584, 28, 28, 4, 18944),
}

PROMPT = "高血压患者的饮食建议是什么？请详细说明。"


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="1B-class", choices=sorted(MODELS))
    ap.add_argument("--draft", default="base-60M", choices=sorted(MODELS))
    ap.add_argument("--gamma", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=192)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()

    import jax

    from mediquery_rag.config import DecoderConfig
    from mediquery_rag.models.generate import Generator
    from mediquery_rag.models.speculative import SpeculativeGenerator

    def build(name, key):
        h, l_, heads, kvh, mlp = MODELS[name]
        cfg = DecoderConfig(hidden=h, layers=l_, heads=heads, kv_heads=kvh,
                            mlp_dim=mlp, max_len=1024,
                            param_dtype="bfloat16")
        return Generator(cfg, key=jax.random.PRNGKey(key))

    target = build(args.model, 0)
    tiny = build(args.draft, 7)

    def timed(fn):
        fn()                          # warm the compile cache
        t0 = time.perf_counter()
        for _ in range(args.reps):
            fn()
        return (time.perf_counter() - t0) / args.reps

    results = []
    t_plain = timed(lambda: target.generate(
        [PROMPT], max_new_tokens=args.max_new))
    results.append(("plain", t_plain, None))

    stats = {}
    for mode, draft in (("self", target), ("tiny", tiny)):
        spec = SpeculativeGenerator(target, draft, gamma=args.gamma)
        t = timed(lambda: spec.generate([PROMPT],
                                        max_new_tokens=args.max_new))
        stats[mode] = (t, spec.last_stats)
        results.append((mode, t, spec.last_stats["tokens_per_round"]))

    # projection: the tiny draft's measured per-round cost at the
    # self-draft's (perfect) acceptance. last_stats reflects the final
    # rep's single generate() call, so rounds there pair with t (per-rep).
    t_tiny, s_tiny = stats["tiny"]
    _, s_self = stats["self"]
    round_s = t_tiny / max(s_tiny["rounds"], 1)
    acc = s_self["tokens_per_round"]
    t_proj = (args.max_new / acc) * round_s
    results.append(("projected", t_proj, acc))

    for mode, t, tpr in results:
        print(json.dumps({
            "metric": "speculative_decode",
            "model": args.model, "draft": args.draft, "gamma": args.gamma,
            "mode": mode,
            "tok_per_s": round(args.max_new / t, 1),
            "speedup_vs_plain": round(t_plain / t, 3),
            "accepted_tokens_per_round": tpr,
            "max_new": args.max_new,
        }))


if __name__ == "__main__":
    main()
