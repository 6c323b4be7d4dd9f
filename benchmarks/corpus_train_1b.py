"""1B-class from-scratch corpus training — convergence run (r4 VERDICT 3).

The r4 story was "adafactor RUNS 2560 steps at 1B but 3e-3 undertrained,
1e-2 plateaued at random". Root cause: the lr schedule's cosine horizon
was hardcoded to 10k steps, so a 2560-step run trained at ~peak lr the
whole time, and warmup was 20 steps. This harness trains with the horizon
set to the RUN length (TrainConfig.decay_steps), longer warmup, and the
r5 "names" remat policy, logging a loss curve with wall-clock so the
1B-vs-300M at-equal-wall-clock comparison is a read-off.

    python benchmarks/corpus_train_1b.py --model mid-300M --optimizer adamw \
        --epochs 32 --batch 8                      # the r4 baseline target
    python benchmarks/corpus_train_1b.py --model 1B-class --epochs 48 \
        --budget-s 600 --out checkpoints/lm1b      # the 1B run

One JSON line per log point + a final summary line. ``--out`` saves a
Generator checkpoint the distill pipeline consumes
(benchmarks/distill_serving.py --target-ckpt).

Reference seam: qwen2.5:7b was the reference's core model asset
(/root/reference/src/medical_engine.py:46); zero-egress training is this
framework's substitute.
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


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--corpus", default="data/medical_data.txt")
    ap.add_argument("--model", default="1B-class", choices=sorted(MODELS))
    ap.add_argument("--epochs", type=int, default=48)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--lr", type=float, default=None,
                    help="peak lr (default 3e-4 adamw / 3e-3 adafactor)")
    ap.add_argument("--optimizer", choices=("adamw", "adafactor"),
                    default="adafactor")
    ap.add_argument("--remat", choices=("full", "names"), default="names")
    ap.add_argument("--warmup", type=int, default=100)
    ap.add_argument("--budget-s", type=float, default=0,
                    help="stop after this many seconds of stepping "
                         "(0 = run all epochs); the schedule still spans "
                         "the full epoch count")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--peak-tflops", type=float, default=None,
                    help="the device's published peak (dense TFLOP/s at "
                         "this dtype) for the MFU column; omitted if unset")
    ap.add_argument("--out", default="",
                    help="save a Generator checkpoint here when done")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from mediquery_rag.config import DecoderConfig, TrainConfig
    from mediquery_rag.ingest import parse_corpus_file
    from mediquery_rag.models.byte_tokenizer import ByteTokenizer
    from mediquery_rag.models.train_lm import (
        LMLoader, LMTrainer, corpus_lm_texts)
    from mediquery_rag.obs.metrics import lm_matmul_flops, mfu

    h, l_, heads, kvh, mlp = MODELS[args.model]
    cfg = DecoderConfig(hidden=h, layers=l_, heads=heads, kv_heads=kvh,
                        mlp_dim=mlp, max_len=1024, attn_impl="flash")
    chunks = parse_corpus_file(args.corpus)
    texts = corpus_lm_texts(chunks)
    tok = ByteTokenizer(cfg.max_len)
    loader = LMLoader(texts, tok, args.batch, seed=args.seed)
    steps_per_epoch = -(-len(texts) // args.batch)
    total_steps = steps_per_epoch * args.epochs
    lr = args.lr or (3e-4 if args.optimizer == "adamw" else 3e-3)
    remat = "names" if args.remat == "names" else True
    warmup = min(args.warmup, max(total_steps // 10, 1))
    trainer = LMTrainer(cfg, TrainConfig(
        batch_size=args.batch, lr=lr, warmup_steps=warmup,
        decay_steps=total_steps, optimizer=args.optimizer, remat=remat))
    state = trainer.init_state(jax.random.PRNGKey(args.seed))
    n_params = sum(int(np.prod(p.shape))
                   for p in jax.tree_util.tree_leaves(state.params))
    fpt = 3 * lm_matmul_flops(hidden=h, layers=l_, mlp_dim=mlp, vocab=384,
                              heads=heads, kv_heads=kvh,
                              seq_len=loader.seq_len)
    print(json.dumps({
        "metric": "corpus_train", "model": args.model, "params": n_params,
        "optimizer": args.optimizer, "lr": lr, "remat": str(remat),
        "batch": args.batch, "seq_len": loader.seq_len,
        "steps_per_epoch": steps_per_epoch, "total_steps": total_steps,
        "warmup": warmup}), flush=True)

    step, t0 = 0, None
    curve = []
    stop = False
    for batch in loader.batches(epochs=args.epochs):
        state, metrics = trainer.train_step(state, batch)
        step += 1
        if step == 1:               # exclude compile from wall clock
            jax.block_until_ready(metrics["loss"])
            t0 = time.time()
        if step % args.log_every == 0 or step == total_steps:
            loss = float(metrics["loss"])
            wall = time.time() - t0
            curve.append((step, round(wall, 1), round(loss, 4)))
            toks = (step - 1) * args.batch * loader.seq_len
            print(json.dumps({
                "step": step, "wall_s": round(wall, 1),
                "loss": round(loss, 4),
                "grad_norm": round(float(metrics["grad_norm"]), 3),
                "tok_per_s": round(toks / max(wall, 1e-9), 1),
                "mfu_pct": round(100 * mfu(
                    fpt, toks / max(wall, 1e-9),
                    args.peak_tflops * 1e12), 1)
                if args.peak_tflops else None,
            }), flush=True)
            if args.budget_s and wall > args.budget_s:
                stop = True
        if stop:
            break

    if args.out:
        from mediquery_rag.models.generate import Generator
        gen = Generator(cfg, params=jax.device_get(state.params))
        gen.save(args.out)
        print(f"saved -> {args.out}", flush=True)


if __name__ == "__main__":
    main()
