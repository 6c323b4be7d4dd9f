"""Trained-draft speculative serving: the low-occupancy win, end to end.

VERDICT r2 item 4: the speculative envelope was bracketed with untrained
drafts (benchmarks/speculative.py, serve_llm.py); this benchmark closes
the loop with a *trained* (distilled, not self) draft where speculation
should pay — slots 1-2, per-request latency:

1. train the TARGET LM on the corpus (models/train_lm recipe, byte vocab);
2. distill a small draft on the target's own greedy continuations of
   corpus-title prompts (models/distill.py) — held-out titles are kept
   out of the distillation set;
3. serve the SAME held-out requests through ``LLMServer`` plain vs
   ``LLMServer(draft=...)`` at slots 1 and 2, greedy — outputs must be
   identical (speculation is lossless); report per-request latency,
   speedup, and accepted tokens/round.

    python benchmarks/distill_serving.py     # on the GPU:
    #   corpus-train mid-300M target (32 ep) -> corpus-pretrain draft-20M
    #   (128 ep) -> rehearsal-distill on chat-template prompts (60 ep)
    #   -> lockstep + LLMServer phases.

Reference seam: the qwen2.5:7b chat completions the reference rented from
Ollama (/root/reference/src/medical_engine.py:46) had no draft path at all.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

MODELS = {
    "tiny": (128, 2, 4, None, 256),         # CPU smoke only
    "mid-300M": (1024, 12, 16, None, 2816),
    "1B-class": (2048, 16, 16, None, 5632),
}
DRAFTS = {
    "draft-tiny": (64, 1, 2, None, 128),    # CPU smoke only
    "draft-20M": (256, 4, 4, None, 768),
    "draft-60M": (512, 8, 8, None, 1536),
}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--corpus", default="data/medical_data.txt")
    # mid-300M is the largest target whose f32 Adam state + activations
    # fit next to serving caches in 16 GB HBM (1B-class OOMs in training)
    ap.add_argument("--target", default="mid-300M", choices=sorted(MODELS))
    ap.add_argument("--draft", default="draft-20M", choices=sorted(DRAFTS))
    ap.add_argument("--target-epochs", type=int, default=32)
    ap.add_argument("--target-batch", type=int, default=8)
    ap.add_argument("--target-optimizer", choices=("adamw", "adafactor"),
                    default="adamw",
                    help="adafactor's factored opt state lets the "
                         "1B-class target train on one 16 GB chip "
                         "(adamw m+v OOMs there)")
    ap.add_argument("--target-lr", type=float, default=None,
                    help="override the target lr (default 3e-4 adamw / "
                         "1e-2 adafactor — adafactor scales updates by "
                         "RMS(param) and wants a much hotter peak)")
    ap.add_argument("--distill-epochs", type=int, default=60)
    ap.add_argument("--distill-new", type=int, default=96,
                    help="target continuation length distilled on")
    ap.add_argument("--augment-prefixes", action="store_true", default=True,
                    help="add mid-text prefixes of train chunks to the "
                         "distillation prompt set (wider state coverage)")
    ap.add_argument("--no-augment-prefixes", dest="augment_prefixes",
                    action="store_false")
    ap.add_argument("--max-distill-prompts", type=int, default=512)
    ap.add_argument("--draft-pretrain-epochs", type=int, default=128,
                    help="corpus-LM pretrain the draft before distilling "
                         "(production recipe: target and draft share the "
                         "pretraining corpus, so the draft can track the "
                         "target's memorized-text regurgitation)")
    ap.add_argument("--qa-format", action="store_true", default=True,
                    help="wrap title prompts in the chat template the LM "
                         "trained on (render_chat: <|user|>\\n{t}<|end|>"
                         "<|assistant|>\\n) — the format DeviceLLMClient "
                         "serves; bare titles are out-of-format, so both "
                         "models continue them erratically and acceptance "
                         "plateaus on model disagreement")
    ap.add_argument("--gamma", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=96)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", default="1,2")
    ap.add_argument("--skip-serve", action="store_true",
                    help="skip the LLMServer phase (e.g. to re-measure "
                         "lockstep only)")
    ap.add_argument("--no-lockstep", action="store_true",
                    help="skip the B=1 lockstep phase")
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from mediquery_rag.config import DecoderConfig, TrainConfig
    from mediquery_rag.ingest import parse_corpus_file
    from mediquery_rag.models.byte_tokenizer import ByteTokenizer
    from mediquery_rag.models.distill import distill_draft
    from mediquery_rag.models.generate import Generator
    from mediquery_rag.models.train_lm import (
        LMLoader, LMTrainer, corpus_lm_texts)
    from mediquery_rag.serve.llm import LLMServer

    # -- 1. corpus-train the target -------------------------------------------
    h, l_, heads, kvh, mlp = MODELS[args.target]
    tcfg = DecoderConfig(hidden=h, layers=l_, heads=heads, kv_heads=kvh,
                         mlp_dim=mlp, max_len=1024)
    chunks = parse_corpus_file(args.corpus)
    texts = corpus_lm_texts(chunks)
    tok = ByteTokenizer(tcfg.max_len)
    loader = LMLoader(texts, tok, args.target_batch, seed=0)
    # adafactor scales updates by RMS(param) — it wants ~30x Adam's lr
    t_lr = args.target_lr or (
        3e-4 if args.target_optimizer == "adamw" else 1e-2)
    trainer = LMTrainer(tcfg, TrainConfig(batch_size=args.target_batch,
                                          lr=t_lr, warmup_steps=20,
                                          optimizer=args.target_optimizer))
    state = trainer.init_state(jax.random.PRNGKey(0))
    t0 = time.time()
    step = 0
    for batch in loader.batches(epochs=args.target_epochs):
        state, metrics = trainer.train_step(state, batch)
        step += 1
    loss = float(metrics["loss"])
    print(f"target {args.target}: {step} steps, loss {loss:.3f}, "
          f"{time.time() - t0:.0f}s", flush=True)
    # serving params in bf16 (training masters are f32)
    params = jax.tree_util.tree_map(
        lambda x: x.astype("bfloat16") if x.dtype == jax.numpy.float32
        and x.ndim >= 2 else x, jax.device_get(state.params))
    del state, trainer
    target = Generator(tcfg, params=params, tokenizer=tok)

    # -- 2. distill the draft on target continuations -------------------------
    titles = [c.title for c in chunks if c.title]
    split = max(args.requests, len(titles) // 5)
    if args.qa_format:
        from mediquery_rag.llm.messages import user
        from mediquery_rag.llm.device_client import render_chat
        fmt = lambda t: render_chat([user(t)])
    else:
        fmt = lambda t: t
    eval_prompts = [fmt(t) for t in titles[:split][: args.requests]]
    train_prompts = [fmt(t) for t in titles[split:]]
    if args.augment_prefixes:
        # widen the distillation state distribution beyond title openings:
        # mid-text prefixes of TRAIN chunks put the draft in the decision
        # states the target actually visits mid-generation. Held-out
        # titles' chunks are excluded (their text is what eval
        # continuations reproduce).
        held = set(titles[:split][: args.requests])   # raw held-out titles
        if args.qa_format:
            from mediquery_rag.llm.messages import ai
            render = lambda ch: render_chat([user(ch.title), ai(ch.content)],
                                            for_training=True)
        else:
            render = lambda ch: ch.text
        for ch in chunks:
            if not ch.title or ch.title in held:
                continue
            text = render(ch)  # CJK text: slice by characters, not words
            for start in (0, max(len(text) // 2 - 12, 0)):
                p = text[start:start + 24].strip()
                if len(p) >= 8:
                    train_prompts.append(p)
        train_prompts = train_prompts[: args.max_distill_prompts]
    dh_, dl_, dheads_, dkvh_, dmlp_ = DRAFTS[args.draft]
    dcfg = DecoderConfig(hidden=dh_, layers=dl_, heads=dheads_,
                         kv_heads=dkvh_, mlp_dim=dmlp_, max_len=1024)
    dinit = None
    if args.draft_pretrain_epochs:
        t0 = time.time()
        dtrainer = LMTrainer(dcfg, TrainConfig(batch_size=args.target_batch,
                                               lr=3e-3, warmup_steps=20))
        dloader = LMLoader(texts, tok, args.target_batch, seed=1)
        dstate = dtrainer.init_state(jax.random.PRNGKey(2))
        for batch in dloader.batches(epochs=args.draft_pretrain_epochs):
            dstate, dmetrics = dtrainer.train_step(dstate, batch)
        dinit = jax.device_get(dstate.params)
        print(f"draft pretrain: loss {float(dmetrics['loss']):.3f}, "
              f"{time.time() - t0:.0f}s", flush=True)
        del dstate, dtrainer
    t0 = time.time()
    draft = distill_draft(
        target, dcfg, train_prompts, max_new_tokens=args.distill_new,
        epochs=args.distill_epochs, init_params=dinit,
        # rehearsal: keep the pretrained draft's corpus memory alive while
        # distilling (the corpus is shared training data for BOTH models —
        # the production 7B+0.5B situation; the held-out split only
        # excludes eval TRAFFIC, i.e. target continuations of eval prompts)
        extra_texts=(texts if args.draft_pretrain_epochs else None),
        train_cfg=TrainConfig(lr=3e-3, warmup_steps=20, remat=False))
    print(f"draft {args.draft}: distilled on {len(train_prompts)} prompts, "
          f"loss {draft.last_loss:.3f}, {time.time() - t0:.0f}s", flush=True)

    # -- 3. B=1 lockstep: the regime where speculation pays --------------------
    # The continuous-batching server below packs `chunk` plain tokens into
    # ONE dispatch, so where per-dispatch latency dominates speculation
    # competes against already-amortized plain quanta. The lockstep loop is the per-token-latency regime: the whole
    # propose->verify->accept loop is ONE on-device lax.while_loop either
    # way, so the trained draft's acceptance shows up undiluted.
    if not args.no_lockstep:
        from mediquery_rag.models.speculative import SpeculativeGenerator

        spec = SpeculativeGenerator(target, draft, gamma=args.gamma)

        def timed_over_prompts(fn):
            # warm EVERY prompt: prompts of different lengths hit different
            # jit buckets, and one leaked compile would dwarf the
            # measurement for both sides
            for p in eval_prompts:
                fn(p)
            t0 = time.time()
            outs = [fn(p) for p in eval_prompts]
            return (time.time() - t0) / len(eval_prompts), outs

        t_plain, outs_plain = timed_over_prompts(
            lambda p: target.generate([p], max_new_tokens=args.max_new)[0])
        tprs = []

        def spec_one(p):
            out = spec.generate([p], max_new_tokens=args.max_new)[0]
            tprs.append(spec.last_stats["tokens_per_round"])
            return out

        t_spec, outs_spec = timed_over_prompts(spec_one)

        # device-only per-request time (scan-amortized, free of host
        # wall-clock noise): N reps of each compiled program inside ONE
        # jitted scan
        import jax.numpy as jnp

        ids0, mask0 = target.tokenizer.batch_encode([eval_prompts[0]])
        S0 = ids0.shape[1]
        from mediquery_rag.models.generate import _round_up
        mn = min(_round_up(args.max_new, 64), target.cfg.max_len - S0)
        prun = target._compiled(1, S0, mn)
        srun = spec._compiled(S0, mn)
        zero = jnp.zeros((1,), jnp.int32)
        pargs = (target.params, jnp.asarray(ids0), jnp.asarray(mask0),
                 jnp.float32(0.0), jax.random.PRNGKey(0),
                 zero, zero[:, None], zero, jnp.int32(0))
        sargs = (target.params, draft.params, jnp.asarray(ids0),
                 jnp.asarray(mask0))
        N = 3

        def scanned(fn, pick):
            @jax.jit
            def many(*a):
                def body(acc, _):
                    return acc + pick(fn(*a)), None
                acc, _ = jax.lax.scan(body, jnp.float32(0), None, length=N)
                return acc
            return many

        pmany = scanned(prun, lambda o: o.sum().astype(jnp.float32))
        smany = scanned(srun, lambda o: o[0].sum().astype(jnp.float32))
        jax.block_until_ready(pmany(*pargs))
        t0 = time.time()
        jax.block_until_ready(pmany(*pargs))
        dev_plain = (time.time() - t0) / N
        jax.block_until_ready(smany(*sargs))
        t0 = time.time()
        jax.block_until_ready(smany(*sargs))
        dev_spec = (time.time() - t0) / N
        # greedy equality modulo bf16 tie-flips: decode-step and
        # verify-extend compute the same position through different kernel
        # shapes, so a near-tie argmax can flip and the suffix diverges —
        # report how many requests matched exactly, not just a bool
        n_same = sum(a == b for a, b in zip(outs_plain, outs_spec))
        print(json.dumps({
            "metric": "distilled_draft_lockstep",
            "requests_identical": f"{n_same}/{len(outs_plain)}",
            "target": args.target, "draft": args.draft,
            "gamma": args.gamma, "max_new": args.max_new,
            "requests": len(eval_prompts),
            "plain_per_request_s": round(t_plain, 3),
            "spec_per_request_s": round(t_spec, 3),
            "speedup": round(t_plain / t_spec, 2),
            "plain_device_s": round(dev_plain, 3),
            "spec_device_s": round(dev_spec, 3),
            "device_speedup": round(dev_plain / dev_spec, 2),
            "accepted_per_round": round(sum(tprs[1:]) / max(len(tprs) - 1, 1), 2),
            "lossless": outs_plain == outs_spec,
            "backend": jax.default_backend(),
        }), flush=True)

    # -- 4. serve held-out prompts: plain vs speculative ----------------------
    if args.skip_serve:
        return
    for slots in (int(s) for s in args.slots.split(",")):
        rows = {}
        for mode, dr in (("plain", None), ("distilled", draft)):
            srv = LLMServer(target, slots=slots, chunk=32, draft=dr,
                            gamma=args.gamma)
            for p in eval_prompts:   # warm every prompt-length bucket
                srv.complete(p, max_new_tokens=32, timeout=1200)
            lat, outs = [], []
            t0 = time.time()
            for p in eval_prompts:        # low occupancy: sequential
                t1 = time.time()
                outs.append(srv.complete(p, max_new_tokens=args.max_new,
                                         timeout=2400))
                lat.append(time.time() - t1)
            stats = dict(srv.stats)
            srv.close()
            rows[mode] = {
                "per_request_s": round(sum(lat) / len(lat), 3),
                "outs": outs,
                "tok_per_round": (
                    round(stats["spec_tokens"] / stats["spec_rounds"], 2)
                    if stats.get("spec_rounds") else None),
            }
        lossless = rows["plain"]["outs"] == rows["distilled"]["outs"]
        n_same = sum(a == b for a, b in zip(rows["plain"]["outs"],
                                            rows["distilled"]["outs"]))
        print(json.dumps({
            "metric": "distilled_draft_serving",
            "requests_identical": f"{n_same}/{len(eval_prompts)}",
            "target": args.target, "draft": args.draft,
            "gamma": args.gamma, "slots": slots,
            "max_new": args.max_new, "requests": len(eval_prompts),
            "plain_per_request_s": rows["plain"]["per_request_s"],
            "spec_per_request_s": rows["distilled"]["per_request_s"],
            "speedup": round(rows["plain"]["per_request_s"]
                             / rows["distilled"]["per_request_s"], 2),
            "accepted_per_round": rows["distilled"]["tok_per_round"],
            "lossless": lossless,
            "backend": jax.default_backend(),
        }), flush=True)


if __name__ == "__main__":
    main()
