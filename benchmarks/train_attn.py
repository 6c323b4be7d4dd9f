"""Long-context training-step cost: einsum vs flash attention.

Compares ``DecoderConfig.attn_impl`` "einsum" and "flash" (ops/attention.py)
on a full-model gradient step (value_and_grad of the LM loss through
Decoder.apply with remat, the exact shape of LMTrainer/LoraTrainer's
loss_fn).

Timing is obs.metrics.device_time (two-point scan); params ride as explicit
device_time consts, never closures (a closed-over weight tree would be
baked into the compiled program as a constant).

Run on the GPU:  python benchmarks/train_attn.py --model 1B-class
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

MODELS = {
    # name: (hidden, layers, heads, kv_heads, mlp_dim) — as benchmarks/decode.py
    "tiny": (64, 2, 4, None, 128),      # CPU smoke runs only
    "base-60M": (512, 8, 8, None, 1536),
    "1B-class": (2048, 16, 16, None, 5632),
}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="1B-class", choices=sorted(MODELS))
    ap.add_argument("--seqs", default="1024,2048,4096")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--remat-policy", default="full",
                    choices=("full", "dots", "names"),
                    help="'dots' = jax.checkpoint with dots_with_no_batch_"
                         "dims_saveable: matmul outputs are SAVED and only "
                         "elementwise work recomputed in bwd — trades "
                         "~B*S*(2h+3*mlp) bytes/layer of activation HBM "
                         "for skipping the whole recompute forward "
                         "(hardware FLOPs drop from ~8N to ~6N per token)")
    ap.add_argument("--optimizer", default="",
                    choices=("", "adafactor", "adamw"),
                    help="time the FULL LMTrainer step (grad + optimizer "
                         "update fused in one jit) instead of grad-only")
    ap.add_argument("--impls", default="einsum,flash",
                    help="comma subset of einsum,flash")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--peak-tflops", type=float, default=None,
                    help="the device's published peak (dense TFLOP/s at "
                         "this dtype) for the MFU column; omitted if unset")
    args = ap.parse_args()

    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")
    import jax
    import jax.numpy as jnp
    import numpy as np
    from mediquery_rag.config import DecoderConfig
    from mediquery_rag.models.decoder import Decoder
    from mediquery_rag.models.train_lm import lm_loss
    from mediquery_rag.obs.metrics import (
        device_time, lm_matmul_flops, mfu)

    seqs = [int(s) for s in args.seqs.split(",")]
    hidden, layers, heads, kvh, mlp = MODELS[args.model]
    remat = False if args.no_remat else (
        args.remat_policy if args.remat_policy != "full" else True)

    def cfg(impl, max_len):
        return DecoderConfig(hidden=hidden, layers=layers, heads=heads,
                             kv_heads=kvh, mlp_dim=mlp, max_len=max_len,
                             attn_impl=impl)

    # params are impl-independent; init once, ONE jitted program
    model = Decoder(cfg("einsum", max(seqs)))
    params = jax.jit(model.init)(jax.random.PRNGKey(0))
    jax.block_until_ready(params)
    n_params = sum(int(np.prod(p.shape))
                   for p in jax.tree_util.tree_leaves(params))

    rng = np.random.default_rng(0)
    for S in seqs:
        ids = jnp.asarray(
            rng.integers(3, 259, (args.iters, args.batch, S)), jnp.int32)
        mask = jnp.ones((args.iters, args.batch, S), jnp.float32)
        row = {"model": args.model, "params": n_params, "B": args.batch,
               "S": S, "remat": str(remat)}
        # model-FLOPs (fwd + 2x bwd, NO remat recompute — MFU convention)
        fpt = 3 * lm_matmul_flops(hidden=hidden, layers=layers,
                                  mlp_dim=mlp, vocab=384, heads=heads,
                                  kv_heads=kvh, seq_len=S)
        for impl in args.impls.split(","):
            m = Decoder(cfg(impl, S))

            if args.optimizer:
                # time the FULL step with state as the scan CARRY: each
                # iteration's loss consumes the previous update, so XLA
                # cannot DCE the optimizer chain (returning only the loss
                # of a state-constant step let it elide the entire update
                # AND most of backward — 225% "MFU")
                from mediquery_rag.config import TrainConfig
                from mediquery_rag.models.train_lm import (
                    LMBatch, LMTrainer)
                import time as _time
                trainer = LMTrainer(cfg(impl, S),
                                    TrainConfig(optimizer=args.optimizer,
                                                remat=remat))
                import optax
                from mediquery_rag.models.train_lm import LMTrainState
                state = trainer.init_state(jax.random.PRNGKey(0))
                mm_ = Decoder(cfg(impl, S))

                # the step INLINED into the timing scan (no inner jit
                # boundary): the scan carry aliases state buffers, so one
                # params copy lives instead of two — the difference
                # between the names-policy optimizer step fitting and
                # OOMing at 1B on one chip
                @jax.jit
                def many(xs, st):
                    def body(st_, batch):
                        b = LMBatch(*batch)

                        def loss_fn(p):
                            return lm_loss(
                                mm_.apply(p, b.ids, b.mask, remat=remat),
                                b.ids, b.mask)

                        loss, grads = jax.value_and_grad(loss_fn)(
                            st_.params)
                        updates, opt_state = trainer.tx.update(
                            grads, st_.opt_state, st_.params)
                        params = optax.apply_updates(st_.params, updates)
                        return (LMTrainState(params, opt_state,
                                             st_.step + 1), loss)
                    st_f, losses = jax.lax.scan(body, st, xs)
                    probe = sum(jnp.sum(l).astype(jnp.float32) for l in
                                jax.tree_util.tree_leaves(st_f.params))
                    return losses.sum() + probe  # probe forces the LAST update too

                n = ids.shape[0]
                half = n // 2
                float(many((ids, mask), state))          # compile + warm
                float(many((ids[:half], mask[:half]), state))

                def best(xs_):
                    b = float("inf")
                    for _ in range(3):
                        t0 = _time.perf_counter()
                        float(many(xs_, state))
                        b = min(b, _time.perf_counter() - t0)
                    return b

                t = (best((ids, mask)) - best((ids[:half], mask[:half]))) \
                    / (n - half)
            else:
                def grad_step(batch, p, m=m):
                    ids_, mask_ = batch
                    def loss(p_):
                        return lm_loss(m.apply(p_, ids_, mask_,
                                               remat=remat), ids_, mask_)
                    return jax.grad(loss)(p)

                t = device_time(grad_step, (ids, mask), params)
            row[f"{impl}_ms"] = round(t * 1e3, 2)
            row[f"{impl}_tok_per_s"] = round(args.batch * S / t, 1)
            if args.peak_tflops:
                row[f"{impl}_mfu_pct"] = round(100 * mfu(
                    fpt, args.batch * S / t, args.peak_tflops * 1e12), 1)
        if "einsum_ms" in row and "flash_ms" in row:
            row["speedup"] = round(row["einsum_ms"] / row["flash_ms"], 2)
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
