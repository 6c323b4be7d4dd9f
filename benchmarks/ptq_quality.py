"""PTQ quality on a TRAINED target (r4 VERDICT item 4).

The int8/int4 weight-only serving claims rested on "top-1 logits agree
>=90% with float on the tiny test model" — random weights. This harness
measures quantization quality on the corpus-trained 300M-class target
(`benchmarks/corpus_train_1b.py --model mid-300M --out checkpoints/
lm300m_r5`), the model class the distill pipeline serves:

1. **Greedy-output divergence** over the chat-template prompt set (the
   distill recipe's prompts: rendered titles + mid-text prefixes):
   exact-match rate vs the bf16 reference and mean shared-prefix length.
2. **Perplexity deltas**, teacher-forced: on train text (memorized) and
   on genuinely-unseen text (held-out paraphrase queries x gold answers).
3. **Speculative acceptance under a quantized target**: the bf16 model
   proposes, the quantized model verifies — acceptance per round is a
   direct, mechanics-level measure of how far quantization moved the
   greedy path (gamma=4; 5.0 = quantization-invisible).

    python benchmarks/ptq_quality.py [--ckpt checkpoints/lm300m_r5]

One JSON line per quantization config. Reference seam: Ollama served
GGML-quantized qwen2.5:7b (/root/reference/src/medical_engine.py:46) —
its quantization quality was somebody else's problem; here it is measured.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", default="checkpoints/lm300m_r5")
    ap.add_argument("--corpus", default="data/medical_data.txt")
    ap.add_argument("--heldout", default="data/heldout_queries.tsv")
    ap.add_argument("--max-new", type=int, default=96)
    ap.add_argument("--max-prompts", type=int, default=256)
    ap.add_argument("--gamma", type=int, default=4)
    ap.add_argument("--spec-requests", type=int, default=8)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from mediquery_rag.ingest import parse_corpus_file
    from mediquery_rag.llm.messages import ai, user
    from mediquery_rag.llm.device_client import render_chat
    from mediquery_rag.models.eval import load_heldout
    from mediquery_rag.models.generate import Generator
    from mediquery_rag.models.train_lm import LMLoader, lm_loss

    base = Generator.from_checkpoint(args.ckpt).to_serving_dtype()
    chunks = parse_corpus_file(args.corpus)
    by_id = {c.chunk_id: c for c in chunks}

    # the distill recipe's prompt distribution: chat-rendered titles +
    # mid-text prefixes (distill_serving.py)
    prompts = [render_chat([user(c.title)]) for c in chunks if c.title]
    for c in chunks:
        if not c.title:
            continue
        text = render_chat([user(c.title), ai(c.content)],
                           for_training=True)
        for start in (0, max(len(text) // 2 - 12, 0)):
            p = text[start:start + 24].strip()
            if len(p) >= 8:
                prompts.append(p)
    prompts = prompts[: args.max_prompts]

    # teacher-forced eval texts
    train_texts = [render_chat([user(c.title), ai(c.content)],
                               for_training=True) for c in chunks[:64]]
    heldout = load_heldout(args.heldout)
    unseen_texts = [render_chat([user(q), ai(by_id[cid].content)],
                                for_training=True)
                    for cid, q in heldout[:64]]

    def ppl(gen: Generator, texts) -> float:
        loader = LMLoader(texts, gen.tokenizer, batch_size=8)
        losses, weights = [], []
        apply_fn = jax.jit(lambda p, i, m: lm_loss(
            gen.model.apply(p, i, m), i, m))
        for batch in loader.batches(epochs=1):
            losses.append(float(apply_fn(gen.params, batch.ids, batch.mask)))
            weights.append(float(batch.mask.sum()))
        return float(np.exp(np.average(losses, weights=weights)))

    def shared_prefix(a: str, b: str) -> int:
        n = 0
        for x, y in zip(a, b):
            if x != y:
                break
            n += 1
        return n

    def gen_all(g, ps, bs=64):
        # slice the prompt set: a 512-lane bucketed program fails to
        # compile on-chip; 64-lane slices reuse one jit cache entry
        out = []
        for i in range(0, len(ps), bs):
            out += g.generate(ps[i:i + bs], max_new_tokens=args.max_new)
        return out

    ref_out = gen_all(base, prompts)
    ppl_train_ref = ppl(base, train_texts)
    ppl_unseen_ref = ppl(base, unseen_texts)

    from mediquery_rag.models.speculative import SpeculativeGenerator

    for label, bits in (("bf16", 0), ("int8", 8), ("int4", 4)):
        # quantize_weights mutates its Generator (leaf-by-leaf, returns
        # self) — load a FRESH tree per config; `base` stays bf16 for the
        # reference outputs and the spec draft
        gen = base if bits == 0 else Generator.from_checkpoint(
            args.ckpt).to_serving_dtype().quantize_weights(bits)
        out = gen_all(gen, prompts)
        exact = sum(a == b for a, b in zip(out, ref_out))
        pref = [shared_prefix(a, b) / max(len(b), 1)
                for a, b in zip(out, ref_out)]
        row = {
            "metric": "ptq_quality", "ckpt": args.ckpt, "weights": label,
            "prompts": len(prompts), "max_new": args.max_new,
            "greedy_exact_match_vs_bf16": round(exact / len(prompts), 4),
            "mean_shared_prefix_frac": round(float(np.mean(pref)), 4),
            "ppl_train": round(ppl(gen, train_texts), 4),
            "ppl_unseen": round(ppl(gen, unseen_texts), 4),
            "ppl_train_bf16": round(ppl_train_ref, 4),
            "ppl_unseen_bf16": round(ppl_unseen_ref, 4),
        }
        if bits:
            # spec mechanics: bf16 proposes, the QUANTIZED target verifies
            # — tokens landed per round (max gamma+1) measures how far
            # quantization moved the greedy path, in the exact mechanics
            # the serving pipeline uses
            spec = SpeculativeGenerator(gen, base, gamma=args.gamma)
            spec.generate(prompts[: args.spec_requests],
                          max_new_tokens=args.max_new)
            row["spec_tokens_per_round_bf16_draft"] = round(
                spec.last_stats["tokens_per_round"], 2)
            row["spec_round_max"] = args.gamma + 1
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
