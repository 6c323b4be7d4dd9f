"""Time each op's implementations against each other on the GPU.

    python benchmarks/route_timing.py [--reps N]

Prints one JSON line per comparison, with the card's name and power limit:

- int8 weight-only matvec, Triton kernel vs XLA dequant-into-dot, at the
  Qwen2.5-7B decode shapes (stacked [28, F, D] weights, layer picked by
  index inside a loop over all 28 layers, 4/16/32 rows): qkv 3584->4608,
  gate|up 3584->37888, down 18944->3584. Effective weight GB/s beside the
  time.
- int8 decode step of the whole 7B-shaped model (4 lanes) with the
  matvec routed each way, in turns (kernel, XLA, kernel).
- flat scan at 10M x 768 bf16: the matmul alone, matmul + XLA two-stage
  top-k, and matmul + the Triton block top-k kernel, B=8 and B=64.
- prefill attention at S=4096 (28 q heads, 4 KV heads, dh 128, B=1, left
  padding): einsum with jnp.repeat vs cuDNN (ops/attention.py), and a
  decode step over a 4096-column cache, grouped vs repeated heads.

Times are medians of ``--reps`` calls, each ending in block_until_ready.
Needs a CUDA GPU; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _median_time(fn, *args, reps: int) -> float:
    import jax
    jax.block_until_ready(fn(*args))          # compile + warm up
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    ts.sort()
    return ts[len(ts) // 2]


def matvec(reps: int, card: str):
    import jax
    import jax.numpy as jnp

    from mediquery_rag.ops.matvec import quant_matvec, triton_blocks

    L = 28
    key = jax.random.PRNGKey(0)
    for name, d, f in (("qkv", 3584, 4608), ("gate_up", 3584, 37888),
                       ("down", 18944, 3584)):
        w8 = jax.random.randint(key, (L, f, d), -127, 128, jnp.int8)
        s = jax.random.uniform(key, (L, f), jnp.float32) * 1e-2
        for rows in (4, 16, 32):
            x = jax.random.normal(key, (rows, d), jnp.bfloat16)
            out = {"op": "quant_matvec", "matrix": name, "in": d, "out": f,
                   "layers": L, "rows": rows, "card": card,
                   "triton_blocks": triton_blocks(f, d, -(-rows // 16) * 16)}

            def run(impl):
                @jax.jit
                def f_(x, w8, s):
                    def body(i, acc):
                        y = quant_matvec(x, w8, s, layer=i, impl=impl)
                        return acc + y[:, :1].sum()
                    return jax.lax.fori_loop(0, L, body, jnp.float32(0))
                return f_

            for impl in ("xla", "triton"):
                t = _median_time(run(impl), x, w8, s, reps=reps)
                out[f"{impl}_s_per_layer"] = t / L
                out[f"{impl}_weight_GBps"] = f * d / (t / L) / 1e9
            print(json.dumps(out), flush=True)
        del w8


def decode(reps: int, card: str):
    """Decode steps of the Qwen2.5-7B-shaped int8 model, 4 lanes, with
    the matvec routed to the Triton kernel and then to XLA: the end-to-end
    effect of the kernel. A step's time is the difference of a 72- and an
    8-token greedy generation over 64 tokens."""
    import jax

    from chip_smoke import MAX_LEN, QWEN25_7B
    from mediquery_rag.config import DecoderConfig
    from mediquery_rag.models.generate import Generator
    from mediquery_rag.ops import route

    fields = set(DecoderConfig.__dataclass_fields__)
    cfg = DecoderConfig(**{k: v for k, v in QWEN25_7B.items() if k in fields},
                        max_len=MAX_LEN, dtype="bfloat16",
                        param_dtype="bfloat16", attn_impl="flash")
    gen = Generator(cfg, key=jax.random.PRNGKey(0)).quantize_weights(bits=8)
    prompts = [("Patient notes on blood pressure, diet and sleep. " * 12)
               [:500 + 100 * j] for j in range(4)]
    out = {"op": "decode_int8", "model": "Qwen2.5-7B shape", "lanes": 4,
           "card": card}
    saved = route.ROUTES["quant_matvec"]["gpu"]
    try:
        for impl in ("triton", "xla", "triton"):
            route.ROUTES["quant_matvec"]["gpu"] = impl
            gen._jit_cache.clear()
            jax.clear_caches()
            t = {n: _median_time(lambda n=n: gen.generate_tokens(
                prompts, max_new_tokens=n), reps=reps) for n in (8, 72)}
            out.setdefault(f"{impl}_step_s", []).append(
                (t[72] - t[8]) / 64)
    finally:
        route.ROUTES["quant_matvec"]["gpu"] = saved
    print(json.dumps(out), flush=True)
    del gen


def flat_scan(reps: int, card: str):
    import jax
    import jax.numpy as jnp

    from mediquery_rag.ops.scoring import scores_xt
    from mediquery_rag.ops.topk import masked_topk, two_stage_topk

    n, d, nv = 10_000_384, 768, 10_000_000     # 10M padded to 2048-blocks
    c = jax.random.normal(jax.random.PRNGKey(0), (n, d), jnp.bfloat16)
    for b, k in ((8, 10), (64, 10)):
        q = jax.random.normal(jax.random.PRNGKey(1), (b, d), jnp.float32)
        out = {"op": "flat_search", "rows": n, "dim": d, "batch": b, "k": k,
               "card": card}
        mm = jax.jit(lambda q, c: scores_xt(q, c).max(axis=1))
        out["matmul_rowmax_s"] = _median_time(mm, q, c, reps=reps)

        def xla2(q, c, k=k):
            s = scores_xt(q, c)
            col = jax.lax.broadcasted_iota(jnp.int32, s.shape, 1)
            return two_stage_topk(jnp.where(col < nv, s, -jnp.inf), k,
                                  2048)
        out["xla_two_stage_s"] = _median_time(jax.jit(xla2), q, c,
                                              reps=reps)
        ref = jax.jit(xla2)(q, c)
        def tri(q, c, k=k):
            return masked_topk(scores_xt(q, c), nv, k, 2048)
        got = jax.jit(tri)(q, c)
        out["triton_block_topk_s"] = _median_time(jax.jit(tri), q, c,
                                                  reps=reps)
        out["triton_same_ids"] = bool((got[1] == ref[1]).all())
        print(json.dumps(out), flush=True)
    del c


def attention(reps: int, card: str):
    import jax
    import jax.numpy as jnp

    from mediquery_rag.ops import attention as att

    B, H, KH, S, dh = 1, 28, 4, 4096, 128
    k0 = jax.random.PRNGKey(0)
    q = jax.random.normal(k0, (B, H, S, dh), jnp.bfloat16)
    k = jax.random.normal(jax.random.PRNGKey(1), (B, KH, S, dh),
                          jnp.bfloat16)
    v = jax.random.normal(jax.random.PRNGKey(2), (B, KH, S, dh),
                          jnp.bfloat16)
    mask = jnp.ones((B, S), jnp.float32).at[:, :100].set(0.0)  # left pad
    out = {"op": "prefill_attention", "B": B, "H": H, "KH": KH, "S": S,
           "dh": dh, "left_pad": 100, "card": card}
    ein = jax.jit(lambda q, k, v, m: att.mha_reference(q, k, v, m,
                                                        dh ** -0.5))
    fl = jax.jit(lambda q, k, v, m: att.flash_attention(q, k, v, m))
    out["einsum_repeat_s"] = _median_time(ein, q, k, v, mask, reps=reps)
    out["cudnn_s"] = _median_time(fl, q, k, v, mask, reps=reps)
    ref = ein(q, k, v, mask)[:, :, 100:].astype(jnp.float32)
    got = fl(q, k, v, mask).astype(jnp.float32)
    out["cudnn_max_abs_diff_real_rows"] = float(
        jnp.max(jnp.abs(got[:, :, 100:] - ref)))
    out["cudnn_pad_rows_finite"] = bool(jnp.isfinite(got).all())
    g = jax.jit(jax.grad(lambda q_: att.flash_attention(
        q_, k, v, mask).astype(jnp.float32).sum()))(q)
    out["cudnn_grad_finite"] = bool(jnp.isfinite(g.astype(jnp.float32))
                                    .all())
    # decode step: 4 lanes over a 4096-column cache, one layer
    Bd, C = 4, 4096
    qd = jax.random.normal(k0, (Bd, H, 1, dh), jnp.bfloat16)
    kc = jax.random.normal(k0, (Bd, KH, C, dh), jnp.bfloat16)
    vc = jax.random.normal(jax.random.PRNGKey(3), (Bd, KH, C, dh),
                           jnp.bfloat16)
    cm = jnp.ones((Bd, C), jnp.float32)
    grp = jax.jit(lambda q, k, v, m: att.flash_attention_cached(q, k, v, m))
    rep = jax.jit(lambda q, k, v, m: att.mha_reference(
        q, k, v, m, dh ** -0.5, causal=False))
    out["decode_grouped_s"] = _median_time(grp, qd, kc, vc, cm, reps=reps)
    out["decode_einsum_repeat_s"] = _median_time(rep, qd, kc, vc, cm,
                                                 reps=reps)
    print(json.dumps(out), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--only", default="matvec,decode,flat,attention")
    args = ap.parse_args()
    import jax
    if jax.devices()[0].platform != "gpu":
        print("route_timing: needs a CUDA GPU", file=sys.stderr)
        return 2
    from mediquery_rag import compile_cache
    compile_cache.enable()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    only = args.only.split(",")
    if "matvec" in only:
        matvec(args.reps, card)
    if "decode" in only:
        decode(max(3, args.reps // 4), card)
    if "flat" in only:
        flat_scan(args.reps, card)
    if "attention" in only:
        attention(args.reps, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
