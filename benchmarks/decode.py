"""on-device LM decode throughput (the serving loop the reference rented
from Ollama's CPU GGML runtime, medical_engine.py:46).

Decode at small batch is weight-BANDWIDTH bound: every token re-reads all
params from HBM, so tokens/s/seq ~ HBM_BW / param_bytes. bf16 weights
(Generator.to_serving_dtype / DecoderConfig.param_dtype) are therefore 2x
f32 tok/s. One JSON line per (model, batch); run on the real chip.

Tokens/s counts ACTUALLY emitted tokens (random weights can hit EOS by
chance; finished rows decode masked PAD into dead slots at full cost, so
per-sequence tok/s is conservative).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

MODELS = {
    # name: (hidden, layers, heads, kv_heads, mlp_dim)
    "base-60M": (512, 8, 8, None, 1536),
    "1B-class": (2048, 16, 16, None, 5632),
    "7B-class": (3584, 28, 28, 4, 18944),   # qwen2.5-7b dims incl. GQA 28q/4kv
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--models", default="base-60M,1B-class,7B-class")
    ap.add_argument("--batches", default="1,8")
    ap.add_argument("--max-new", type=int, default=256)
    ap.add_argument("--prompt-len", type=int, default=96)
    ap.add_argument("--weights", choices=("bf16", "int8", "int4"),
                    default="bf16")
    ap.add_argument("--kv-dtype", choices=("", "int8"), default="",
                    help="KV-cache storage dtype (DecoderConfig.kv_dtype); "
                         "int8 halves the per-token attention cache reads "
                         "vs bf16 — visible at long context x batch")
    ap.add_argument("--max-len", type=int, default=512,
                    help="cache capacity; raise for long-context runs "
                         "(e.g. --prompt-len 3968 --max-len 4096)")
    ap.add_argument("--attn-impl", choices=("einsum", "flash"),
                    default="einsum",
                    help="prefill attention (DecoderConfig.attn_impl)")
    ap.add_argument("--peak-tflops", type=float, default=None,
                    help="the device's published peak (dense TFLOP/s at "
                         "this dtype) for the MFU column; omitted if unset")
    ap.add_argument("--prefill-only", action="store_true",
                    help="time Decoder.prefill alone (TTFT proxy) instead "
                         "of the full prefill+decode generation loop")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from mediquery_rag.config import DecoderConfig
    from mediquery_rag.models.byte_tokenizer import PAD_ID
    from mediquery_rag.models.generate import Generator, _round_up
    from mediquery_rag.obs.metrics import device_time
    from mediquery_rag.obs.metrics import (
        lm_matmul_flops as _flops, mfu as _mfu)

    for name in args.models.split(","):
        h, l_, heads, kvh, mlp = MODELS[name]
        cfg = DecoderConfig(hidden=h, layers=l_, heads=heads, kv_heads=kvh,
                            mlp_dim=mlp, max_len=args.max_len,
                            param_dtype="bfloat16", kv_dtype=args.kv_dtype,
                            attn_impl=args.attn_impl)
        if args.weights in ("int8", "int4"):
            # compose init+quantize under ONE jit so the bf16 tree never
            # coexists with the quantized one (14 GB + 7 GB would OOM at 7B)
            from mediquery_rag.models.decoder import Decoder
            from mediquery_rag.ops.matvec import quantize_decoder_params
            bits = 8 if args.weights == "int8" else 4
            model = Decoder(cfg)
            params = jax.jit(
                lambda k: quantize_decoder_params(model.init(k), bits))(
                    jax.random.PRNGKey(0))
            gen = Generator(cfg, params=params)
        else:
            gen = Generator(cfg)
        n_params = sum(x.size for x in jax.tree_util.tree_leaves(gen.params))
        bytes_ = sum(x.nbytes for x in jax.tree_util.tree_leaves(gen.params))
        for b in (int(x) for x in args.batches.split(",")):
            S = _round_up(args.prompt_len, 128)
            max_new = _round_up(args.max_new, 64)
            ids = np.full((b, S), 65, np.int32)        # 'A' bytes
            mask = np.ones((b, S), np.float32)
            if args.prefill_only:
                # TTFT proxy: time ONE prefill program (what --attn-impl
                # changes); decode attends over the cache and is unaffected
                import functools
                cl = min(_round_up(S + max_new, 128), cfg.max_len)
                pf = jax.jit(functools.partial(gen.model.prefill,
                                               cache_len=cl))
                rngs = jnp.stack([jax.random.PRNGKey(i) for i in range(4)])
                t = device_time(
                    lambda r, i_, m, pp: (pf(pp, i_, m)[0][0, 0]
                                          + r[0].astype(jnp.float32)),
                    rngs, jnp.asarray(ids), jnp.asarray(mask), gen.params,
                    reps=3)
                print(json.dumps({
                    "model": name, "weights": args.weights,
                    "attn_impl": args.attn_impl, "batch": b,
                    "prompt_len": S, "cache_len": cl,
                    "prefill_ms": round(t * 1e3, 2),
                    "prefill_tokens_per_s": round(b * S / t, 1),
                    "prefill_mfu_pct": round(100 * _mfu(
                        _flops(hidden=cfg.hidden, layers=cfg.layers,
                               mlp_dim=cfg.mlp_dim, vocab=cfg.vocab_size,
                               heads=cfg.heads, kv_heads=cfg.kv_heads,
                               seq_len=S), b * S / t,
                        args.peak_tflops * 1e12), 1)
                    if args.peak_tflops else None,
                }), flush=True)
                continue
            run = gen._compiled(b, S, max_new)
            zero = jnp.zeros((1,), jnp.int32)
            # unconstrained placeholders (same shape contract as
            # Generator.generate's no-constraint branch)
            tables = (zero, zero[:, None], zero, jnp.int32(0))
            out = run(gen.params, jnp.asarray(ids), jnp.asarray(mask),
                      jnp.float32(1.0), jax.random.PRNGKey(0), *tables)
            emitted = int((np.asarray(out) != PAD_ID).sum())
            if emitted == 0:
                emitted = b * max_new        # degenerate; count loop length

            rngs = jnp.stack([jax.random.PRNGKey(i) for i in range(4)])
            # params must be an explicit argument: a closure would bake the
            # full weight tree into the compiled program as a constant
            t = device_time(
                lambda r, i_, m, pp: run(pp, i_, m, jnp.float32(1.0), r,
                                         *tables),
                rngs, jnp.asarray(ids), jnp.asarray(mask), gen.params,
                reps=3)
            cache_len = min(_round_up(S + max_new, 128), cfg.max_len)
            kvh_eff = kvh or heads
            dh = h // heads
            kv_bytes = (2 * l_ * b * kvh_eff * cache_len * dh
                        * (1 if args.kv_dtype == "int8" else 2)
                        + (2 * l_ * b * kvh_eff * cache_len * 4
                           if args.kv_dtype == "int8" else 0))
            print(json.dumps({
                "model": name,
                "weights": args.weights,
                "kv_dtype": args.kv_dtype or "bf16",
                "cache_len": cache_len,
                "kv_cache_gb": round(kv_bytes / 1e9, 3),
                "params_m": round(n_params / 1e6, 1),
                "weight_gb": round(bytes_ / 1e9, 2),
                "batch": b,
                "prompt_len": S,
                "emitted_tokens": emitted,
                "seconds_per_call": round(t, 4),
                "tokens_per_s_total": round(emitted / t, 1),
                "tokens_per_s_per_seq": round(emitted / b / t, 1),
            }), flush=True)
        del gen


if __name__ == "__main__":
    main()
