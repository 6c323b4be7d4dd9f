"""Causal decoder LM — the on-device chat model.

The reference delegated all chat/JSON-mode inference to the Ollama daemon's
GGML C++ runtime (qwen2.5:7b, reference medical_engine.py:46). SURVEY §2b
keeps the LLM client pluggable but names a on-device model as the optional
completion of that row; this is it — a qwen/llama-class decoder rebuilt
accelerator-first rather than a GGML port:

- RMSNorm + RoPE + SwiGLU + causal MHA (the qwen2.5 architecture class);
- layers stacked ``[L, ...]`` and executed with ``lax.scan`` — one compiled
  block regardless of depth; the KV cache threads through the same scan as
  per-layer xs/ys so single-token decode is one fused XLA program;
- bf16 activations, f32 params/norms/logits; matmuls accumulate in f32
  accumulation (``preferred_element_type``);
- LEFT-padded batches: all sequences end at one shared column, so batched
  decode appends at a single cursor — static shapes, no per-sequence
  dynamic slicing under jit;
- Megatron TP partition specs (qkv/gate/up column-, attn_out/down
  row-sharded) over the ``model`` mesh axis; ``lm_head`` column-sharded —
  XLA all-gathers the [B, V] logits (V=384 — trivial traffic).

Params are a plain pytree; every method is a pure function of (params, ...)
— the natural shape for jit/pjit composition.
"""

from __future__ import annotations

import functools
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from mediquery_rag.config import DecoderConfig

DecoderParams = dict  # nested pytree of jnp arrays


class KVCache(NamedTuple):
    """Preallocated decode state. ``k``/``v``: [L, B, H, C, dh]; ``key_mask``:
    [B, C] (1 = slot holds a real token); ``cursor``: next write column
    (shared — left-padding aligns all sequences); ``next_pos``: per-sequence
    RoPE position of the next token.

    With ``DecoderConfig.kv_dtype == "int8"``, ``k``/``v`` hold int8 codes
    and ``k_scale``/``v_scale`` the per-column-per-head absmax scales
    [L, B, H, C] f32 (None otherwise — the float path is untouched).
    Quantization happens at WRITE time (after RoPE); reads fold the scale
    into the attention einsums (per-column for K logits, into the softmax
    weights for V), so the dequantized cache is never materialized."""

    k: jax.Array
    v: jax.Array
    key_mask: jax.Array
    cursor: jax.Array       # i32 scalar
    next_pos: jax.Array     # [B] i32
    k_scale: jax.Array | None = None
    v_scale: jax.Array | None = None


def _init_dense(key, fan_in, shape):
    return jax.random.normal(key, shape, jnp.float32) * (fan_in ** -0.5)


def _pdt(cfg):
    return jnp.dtype(getattr(cfg, "param_dtype", "float32"))


def _is_quant(w) -> bool:
    return isinstance(w, dict) and ("q" in w or "q4" in w)


def _stream_mats(blocks):
    """The big per-layer matrices that stream through the int8 matvec.
    ``w_gateup`` (the fused gate‖up matrix quantize_decoder_params emits,
    ops/matvec.py) replaces the separate pair when present — one weight
    stream and one kernel launch instead of two."""
    if "w_gateup" in blocks:
        return ("qkv", "attn_out", "w_gateup", "w_down")
    return ("qkv", "attn_out", "w_gate", "w_up", "w_down")


def _split_stream(blocks):
    """Split stacked block params into (streamed big matrices, scan xs).

    The big quantized matrices must NOT ride in ``lax.scan`` xs: scan
    dynamic-slices its xs every iteration and XLA materializes each sliced
    weight slab as an HBM copy — an extra write+read of ALL weight bytes
    per decode step. Instead they stay whole as loop constants and the
    int8 matvec kernel reads the layer's tiles by index
    (``quant_matvec(..., layer=li)``, ops/matvec.py). Returns
    ``(None, blocks)`` when any big mat is unquantized (training/bf16
    path — the plain einsum keeps the scan layout)."""
    names = _stream_mats(blocks)
    if not all(_is_quant(blocks.get(k)) for k in names):
        return None, blocks
    mats = {k: blocks[k] for k in names}
    rest = {k: v for k, v in blocks.items() if k not in names}
    return mats, rest


def _mlp_ff(mm, h, blocks, adt):
    """SwiGLU first stage: ``silu(h @ Wg) * (h @ Wu)``. With a fused
    ``w_gateup`` tree the two projections ride ONE weight stream and
    split after (channel order [gate | up] — quantize_decoder_params
    concatenates along the out axis before quantizing)."""
    if "w_gateup" in blocks:
        gate, up = jnp.split(mm(h, "w_gateup"), 2, axis=-1)
    else:
        gate = mm(h, "w_gate")
        up = mm(h, "w_up")
    return (jax.nn.silu(gate) * up).astype(adt)


def _mm(x, w, adt, layer=None):
    """``x @ W`` for a weight that is a plain ``[in, out]`` float matrix,
    an int8-quantized ``{"q": [out, in] i8, "s": [out] f32}``, or an
    int4-packed ``{"q4": [out/2, in] i8, "s": [2, out/2], "t": [1, in]}``
    (Generator.quantize_weights). Returns f32 (same contraction/accumulation
    as the original einsums). Quantized weights always go through
    ops/matvec.py, whose routes share one arithmetic (exact products, f32
    sums, the scale applied after the sum): a prompt's logits do not depend
    on how its rows were chunked into prefill calls, which is what keeps
    the server's greedy output equal to lockstep generation.

    ``layer`` selects one layer out of STACKED ``[L, ...]`` weights: the
    quantized decode path passes the index through to the matvec kernel
    (zero-copy layer access — see :func:`_split_stream`); a float weight
    has its layer sliced out.
    """
    if not _is_quant(w):
        if layer is not None:
            w = jax.lax.dynamic_index_in_dim(w, layer, 0, keepdims=False)
        return jnp.einsum("...d,df->...f", x, w.astype(adt),
                          preferred_element_type=jnp.float32)
    from mediquery_rag.ops.matvec import quant_matvec, quant_matvec_int4
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if "q4" in w:
        out = quant_matvec_int4(x2, w, layer=layer)
    else:
        out = quant_matvec(x2, w["q"], w["s"], layer=layer)
    return out.reshape(*lead, out.shape[-1])


def _kv_quantize(x):
    """[..., dh] float -> (int8 codes, f32 absmax scales [...]). Per-token
    per-head granularity: one scale per cache column per KV head."""
    xf = x.astype(jnp.float32)
    s = jnp.maximum(jnp.max(jnp.abs(xf), axis=-1), 1e-6) / 127.0
    return jnp.round(xf / s[..., None]).astype(jnp.int8), s


def _rep_s(s, groups):
    """GQA-expand a scale tensor [B, KH, C] along the head axis."""
    return s if groups == 1 else jnp.repeat(s, groups, axis=1)


def _cached_attn(q, k_layer, v_layer, ks, vs, bias, adt, dh,
                 flash_mask=None, flash_col0=None, layer=None):
    """Attention of ``q`` over a cache layer, float or int8+scales.
    The float path is the exact op sequence the cache methods always
    used (bit-identical); the int8 path folds K scales into the logits
    per column and V scales into the softmax weights — no materialized
    dequantized cache. Returns f32 ctx [B, H, S, dh].

    ``flash_mask`` ([B, C] key validity) routes BOTH cache dtypes through
    the grouped-query attention of ops/attention.py — the cache is read at
    its true KH-head size instead of ``jnp.repeat``-expanded to H, the
    dominant HBM cost of long-context GQA decode; the int8 cache
    additionally streams codes at 1 byte/elt with the scales folded
    into the logits and softmax weights. ``flash_col0`` ([B] i32) adds the per-lane causal term
    ``col <= col0 + row`` (extend_slots' verify window); without it
    visibility is the mask alone (decode steps). ``layer`` marks
    k/v (and scales) as the whole STACKED [L, ...] cache: the flash route
    selects the layer inside the attention op; the einsum
    route slices the layer out first (a copy — the cost the flash route
    exists to avoid)."""
    if flash_mask is not None:
        from mediquery_rag.ops.attention import (
            flash_attention_at, flash_attention_cached)
        if flash_col0 is None:
            ctx = flash_attention_cached(q, k_layer, v_layer, flash_mask,
                                         k_scale=ks, v_scale=vs, layer=layer)
        else:
            ctx = flash_attention_at(q, k_layer, v_layer, flash_mask,
                                     flash_col0, k_scale=ks, v_scale=vs,
                                     layer=layer)
        return ctx.astype(jnp.float32)
    if layer is not None:
        sel = functools.partial(jax.lax.dynamic_index_in_dim, index=layer,
                                axis=0, keepdims=False)
        k_layer, v_layer = sel(k_layer), sel(v_layer)
        if ks is not None:
            ks, vs = sel(ks), sel(vs)
    g = q.shape[1] // k_layer.shape[1]
    if ks is None:
        logits = jnp.einsum("bhqd,bhkd->bhqk", q, _repeat_kv(k_layer, g),
                            preferred_element_type=jnp.float32)
        logits = logits * (dh ** -0.5) + bias
        w = jax.nn.softmax(logits, axis=-1).astype(adt)
        return jnp.einsum("bhqk,bhkd->bhqd", w, _repeat_kv(v_layer, g),
                          preferred_element_type=jnp.float32)
    logits = jnp.einsum("bhqd,bhkd->bhqk", q,
                        _repeat_kv(k_layer, g).astype(adt),
                        preferred_element_type=jnp.float32)
    logits = logits * _rep_s(ks, g)[:, :, None, :]
    logits = logits * (dh ** -0.5) + bias
    w = jax.nn.softmax(logits, axis=-1)
    w = (w * _rep_s(vs, g)[:, :, None, :]).astype(adt)
    return jnp.einsum("bhqk,bhkd->bhqd", w, _repeat_kv(v_layer, g),
                      preferred_element_type=jnp.float32)


def _rmsnorm(x, scale, eps=1e-6):
    xf = x.astype(jnp.float32)
    y = xf * jax.lax.rsqrt((xf * xf).mean(-1, keepdims=True) + eps)
    return (y * scale).astype(x.dtype)


def _rope(x, pos, theta):
    """Rotary embedding. x: [B, H, S, dh]; pos: [B, S] i32."""
    dh = x.shape[-1]
    half = dh // 2
    freq = theta ** (-jnp.arange(half, dtype=jnp.float32) / half)   # [half]
    ang = pos[:, None, :, None].astype(jnp.float32) * freq          # [B,1,S,half]
    cos, sin = jnp.cos(ang), jnp.sin(ang)
    x1, x2 = x[..., :half].astype(jnp.float32), x[..., half:].astype(jnp.float32)
    return jnp.concatenate(
        [x1 * cos - x2 * sin, x1 * sin + x2 * cos], axis=-1
    ).astype(x.dtype)


class Decoder:
    """Functional causal LM. All methods are pure given a config."""

    def __init__(self, cfg: DecoderConfig = DecoderConfig()):
        self.cfg = cfg
        if cfg.hidden % cfg.heads:
            raise ValueError("hidden must divide heads")
        if (cfg.hidden // cfg.heads) % 2:
            raise ValueError("head dim must be even for RoPE")
        kvh = cfg.kv_heads or cfg.heads
        if cfg.heads % kvh:
            raise ValueError(f"heads {cfg.heads} % kv_heads {kvh} != 0")
        if cfg.kv_dtype not in ("", "int8"):
            # fail loudly: a typo'd value silently serving a full-precision
            # cache would defeat the memory budget the operator planned for
            raise ValueError(
                f"kv_dtype must be '' or 'int8', got {cfg.kv_dtype!r}")
        if cfg.attn_impl not in ("einsum", "flash"):
            raise ValueError(
                f"attn_impl must be 'einsum' or 'flash', got {cfg.attn_impl!r}")

    # -- params ----------------------------------------------------------------

    def init(self, key: jax.Array) -> DecoderParams:
        c = self.cfg
        pdt = _pdt(c)
        keys = jax.random.split(key, 8)
        L, D, F = c.layers, c.hidden, c.mlp_dim
        kvh = c.kv_heads or c.heads
        dh = D // c.heads
        qkv_out = (c.heads + 2 * kvh) * dh

        def stack(k, fan_in, shape):
            ks = jax.random.split(k, L)
            return jnp.stack([_init_dense(ks[i], fan_in, shape).astype(pdt)
                              for i in range(L)])

        blocks = {
            "rms1": jnp.ones((L, D), pdt),
            "qkv": stack(keys[1], D, (D, qkv_out)),
            "attn_out": stack(keys[2], D, (D, D)),
            "rms2": jnp.ones((L, D), pdt),
            "w_gate": stack(keys[3], D, (D, F)),
            "w_up": stack(keys[4], D, (D, F)),
            "w_down": stack(keys[5], F, (F, D)),
        }
        if c.qkv_bias:
            blocks["qkv_b"] = jnp.zeros((L, qkv_out), pdt)
        return {
            "tok_embed": (jax.random.normal(keys[0], (c.vocab_size, D),
                                            jnp.float32) * 0.02).astype(pdt),
            "blocks": blocks,
            "rms_f": jnp.ones((D,), pdt),
            "lm_head": _init_dense(keys[6], D, (D, c.vocab_size)).astype(pdt),
        }

    def partition_specs(self) -> Any:
        """Megatron TP layout over mesh axes ('data', 'model')."""
        blocks = {
            "rms1": P(None, None),
            "qkv": P(None, None, "model"),       # column parallel
            "attn_out": P(None, "model", None),   # row parallel
            "rms2": P(None, None),
            "w_gate": P(None, None, "model"),     # column parallel
            "w_up": P(None, None, "model"),       # column parallel
            "w_down": P(None, "model", None),     # row parallel
        }
        if self.cfg.qkv_bias:
            blocks["qkv_b"] = P(None, "model")   # follows qkv columns
        return {
            "tok_embed": P(None, None),
            "blocks": blocks,
            "rms_f": P(None),
            "lm_head": P(None, "model"),              # vocab-sharded logits
        }

    # -- training / scoring forward ---------------------------------------------

    def apply(
        self,
        params: DecoderParams,
        ids: jax.Array,          # [B, S] i32
        mask: jax.Array,         # [B, S] f32 (1 = real token; left OR right pad)
        *,
        remat: bool | str = False,
    ) -> jax.Array:
        """Full causal forward. Returns logits [B, S, V] f32.

        ``remat``: False = save all block activations; True = full per-
        block checkpoint (recompute everything in bwd — minimum memory);
        ``"dots"`` = checkpoint with ``dots_with_no_batch_dims_saveable``
        (matmul outputs saved, only elementwise recomputed — skips the
        recompute forward's ~2N FLOPs/token for ~B*S*(2h+3*mlp) bytes per
        layer; the training-MFU choice when activations fit)."""
        c = self.cfg
        adt = jnp.dtype(c.dtype)
        B, S = ids.shape

        pos = jnp.clip(jnp.cumsum(mask, axis=1).astype(jnp.int32) - 1, 0)
        x = params["tok_embed"][ids].astype(adt)
        if c.attn_impl == "flash":
            bias, flash_mask = None, mask   # [B,1,S,S] bias never built
        else:
            causal = jnp.tril(jnp.ones((S, S), jnp.float32))
            bias = (causal[None, None] * mask[:, None, None, :] - 1.0) * 1e9
            flash_mask = None

        block_fn = functools.partial(
            _block_full, heads=c.heads, kv_heads=c.kv_heads or c.heads,
            adt=adt, bias=bias, pos=pos, theta=c.rope_theta, eps=c.rms_eps,
            flash_mask=flash_mask, name_acts=remat == "names",
        )
        if remat == "names":
            block_fn = jax.checkpoint(
                block_fn,
                policy=jax.checkpoint_policies.save_only_these_names(
                    "lm_qkv", "lm_ctx", "lm_attn", "lm_gate", "lm_up",
                    "lm_ff", "flash_out"))
        elif remat == "dots":
            block_fn = jax.checkpoint(
                block_fn,
                policy=jax.checkpoint_policies.dots_with_no_batch_dims_saveable)
        elif remat:
            block_fn = jax.checkpoint(block_fn)
        x, _ = jax.lax.scan(
            lambda carry, lp: (block_fn(carry, lp), None), x, params["blocks"]
        )
        x = _rmsnorm(x, params["rms_f"], c.rms_eps)
        return _mm(x, params["lm_head"], adt)

    # -- KV-cache serving path ----------------------------------------------------

    def prefill(
        self,
        params: DecoderParams,
        ids: jax.Array,          # [B, S] i32, LEFT-padded
        mask: jax.Array,         # [B, S] f32
        cache_len: int,
    ) -> tuple[jax.Array, KVCache]:
        """Process the prompt, build the cache. Returns (last-token logits
        [B, V] f32, cache). Left-padding puts every last prompt token at
        column S-1, so the next-token logits are simply logits[:, -1]."""
        c = self.cfg
        adt = jnp.dtype(c.dtype)
        B, S = ids.shape
        if cache_len < S:
            raise ValueError(f"cache_len {cache_len} < prompt length {S}")
        H, dh = c.heads, c.hidden // c.heads

        pos = jnp.clip(jnp.cumsum(mask, axis=1).astype(jnp.int32) - 1, 0)
        x = params["tok_embed"][ids].astype(adt)
        if c.attn_impl == "flash":
            bias, flash_mask = None, mask
        else:
            causal = jnp.tril(jnp.ones((S, S), jnp.float32))
            bias = (causal[None, None] * mask[:, None, None, :] - 1.0) * 1e9
            flash_mask = None

        quant = c.kv_dtype == "int8"

        def step(carry, lp):
            x = carry
            x, k, v = _block_kv(x, lp, heads=c.heads,
                                kv_heads=c.kv_heads or c.heads, adt=adt,
                                bias=bias, pos=pos, theta=c.rope_theta,
                                eps=c.rms_eps, flash_mask=flash_mask)
            pad = [(0, 0), (0, 0), (0, cache_len - S), (0, 0)]
            if not quant:
                return x, (jnp.pad(k, pad), jnp.pad(v, pad), None, None)
            # attention within the prompt ran in full precision above;
            # only the STORED cache quantizes
            k8, ksc = _kv_quantize(k)
            v8, vsc = _kv_quantize(v)
            return x, (jnp.pad(k8, pad), jnp.pad(v8, pad),
                       jnp.pad(ksc, pad[:-1]), jnp.pad(vsc, pad[:-1]))

        x, (ks, vs, kss, vss) = jax.lax.scan(step, x, params["blocks"])
        x = _rmsnorm(x, params["rms_f"], c.rms_eps)
        logits = _mm(x[:, -1], params["lm_head"], adt)

        key_mask = jnp.pad(mask, [(0, 0), (0, cache_len - S)])
        cache = KVCache(
            k=ks, v=vs, key_mask=key_mask,
            cursor=jnp.int32(S),
            next_pos=jnp.cumsum(mask, axis=1)[:, -1].astype(jnp.int32),
            k_scale=kss, v_scale=vss,
        )
        return logits, cache

    def decode_step(
        self,
        params: DecoderParams,
        cache: KVCache,
        token: jax.Array,        # [B] i32
    ) -> tuple[jax.Array, KVCache]:
        """One generation step: append ``token``, return (logits [B, V] f32,
        updated cache). Static shapes — the cache column written is
        ``cache.cursor``; attention spans the whole preallocated cache with
        invalid slots masked.

        Flash path, big caches: the multi-GB cache is a scan CONSTANT read
        by the grouped-query attention op, which selects the layer
        (``layer=li``); the fresh token's K/V column is folded into the
        softmax OUTSIDE the kernel with the standard flash (o, m, l)
        combine, the scan emits only the tiny per-layer columns, and ONE
        post-scan dynamic_update_slice writes them — the cache never rides
        scan xs/ys (whose per-layer slices/re-stacks XLA materializes as
        full HBM copies: ~1.9 GB read + 1.9 GB write per step at 7B B=8
        C=4096 int8). Small caches keep the xs layout: the stacked read
        pays a fixed per-layer cost while the xs copies shrink with the
        cache — the crossover is gated on the STATIC cache size at trace time
        (_use_stacked). Einsum path: always xs — slicing there is a copy
        either way."""
        if self.cfg.attn_impl == "flash" and _use_stacked(cache):
            return self._decode_step_stacked(params, cache, token)
        return self._decode_step_xs(params, cache, token)

    def _decode_step_stacked(
        self,
        params: DecoderParams,
        cache: KVCache,
        token: jax.Array,        # [B] i32
    ) -> tuple[jax.Array, KVCache]:
        from mediquery_rag.ops.attention import flash_attention_cached

        c = self.cfg
        adt = jnp.dtype(c.dtype)
        L, B, KH, C, dh = cache.k.shape
        quant = cache.k_scale is not None
        kv_dt = cache.k.dtype
        fmask = cache.key_mask   # fresh column folded into the softmax
        pos = cache.next_pos[:, None]                          # [B, 1]

        x = params["tok_embed"][token[:, None]].astype(adt)    # [B, 1, D]
        mats, rest = _split_stream(params["blocks"])
        li = jnp.arange(c.layers, dtype=jnp.int32)

        def layer(carry, xs):
            x = carry                                          # [B, 1, D]
            lp, li_ = xs
            mm = ((lambda h_, n: _mm(h_, mats[n], adt, layer=li_))
                  if mats is not None
                  else (lambda h_, n: _mm(h_, lp[n], adt)))
            h = _rmsnorm(x, lp["rms1"], c.rms_eps)
            qkv = mm(h, "qkv")
            if "qkv_b" in lp:
                qkv = qkv + lp["qkv_b"].astype(jnp.float32)
            qkv = qkv.astype(adt)
            q, k, v = _split_qkv(qkv, B, 1, c.heads, KH, dh)   # [B,*,1,dh]
            q = _rope(q, pos, c.rope_theta)
            k = _rope(k, pos, c.rope_theta)
            if quant:
                kc, ksc = _kv_quantize(k)
                vc, vsc = _kv_quantize(v)
                # combine uses the DEQUANTIZED stored values — the exact
                # numbers the kernel would read back next step
                k_new = kc.astype(jnp.float32) * ksc[..., None]
                v_new = vc.astype(jnp.float32) * vsc[..., None]
            else:
                kc, vc = k.astype(kv_dt), v.astype(kv_dt)
                ksc = vsc = None
                k_new = kc.astype(jnp.float32)
                v_new = vc.astype(jnp.float32)
            # fresh column folded into the softmax (over cache ∪
            # {fresh}): no (m, l) state traffic, no post-kernel combine
            # fusions. Safe at cursor=0 too: every cache logit sits ~1e9
            # below the fresh one, so the cache terms underflow and
            # ctx -> v_new exactly.
            ctx = flash_attention_cached(
                q, cache.k, cache.v, fmask,
                k_scale=cache.k_scale, v_scale=cache.v_scale,
                layer=li_, fresh_k=k_new.astype(adt),
                fresh_v=v_new.astype(adt))                     # [B, H, 1, dh]
            ctx = ctx.astype(adt).transpose(0, 2, 1, 3).reshape(B, 1,
                                                                c.hidden)
            attn = mm(ctx, "attn_out").astype(adt)
            x = x + attn
            h = _rmsnorm(x, lp["rms2"], c.rms_eps)
            ff = _mlp_ff(mm, h, params["blocks"], adt)
            ff = mm(ff, "w_down")
            return x + ff.astype(adt), (kc, vc, ksc, vsc)

        x, (kcol, vcol, kscol, vscol) = jax.lax.scan(layer, x, (rest, li))
        x = _rmsnorm(x, params["rms_f"], c.rms_eps)
        logits = _mm(x[:, 0], params["lm_head"], adt)
        new_cache = KVCache(
            k=jax.lax.dynamic_update_slice(
                cache.k, kcol, (0, 0, 0, cache.cursor, 0)),
            v=jax.lax.dynamic_update_slice(
                cache.v, vcol, (0, 0, 0, cache.cursor, 0)),
            key_mask=jax.lax.dynamic_update_slice(
                cache.key_mask, jnp.ones((B, 1), cache.key_mask.dtype),
                (0, cache.cursor)),
            cursor=cache.cursor + 1,
            next_pos=cache.next_pos + 1,
            k_scale=(None if not quant else jax.lax.dynamic_update_slice(
                cache.k_scale, kscol, (0, 0, 0, cache.cursor))),
            v_scale=(None if not quant else jax.lax.dynamic_update_slice(
                cache.v_scale, vscol, (0, 0, 0, cache.cursor))),
        )
        return logits, new_cache

    def _decode_step_xs(
        self,
        params: DecoderParams,
        cache: KVCache,
        token: jax.Array,        # [B] i32
    ) -> tuple[jax.Array, KVCache]:
        """The original scan-xs cache layout (einsum attention path)."""
        c = self.cfg
        adt = jnp.dtype(c.dtype)
        L, B, H, C, dh = cache.k.shape

        key_mask = jax.lax.dynamic_update_slice(
            cache.key_mask, jnp.ones((B, 1), cache.key_mask.dtype),
            (0, cache.cursor))
        # flash: GQA-folded kernel reads the cache at KH heads (no
        # jnp.repeat expansion), int8 codes at 1 byte/elt with scales
        # folded in-kernel
        fmask = key_mask if c.attn_impl == "flash" else None
        bias = (None if fmask is not None
                else (key_mask[:, None, None, :] - 1.0) * 1e9)  # [B,1,1,C]
        pos = cache.next_pos[:, None]                          # [B, 1]

        x = params["tok_embed"][token[:, None]].astype(adt)    # [B, 1, D]

        mats, rest = _split_stream(params["blocks"])
        li = jnp.arange(c.layers, dtype=jnp.int32)

        # decode attends over the cache, not the fresh S=1 K/V, so the layer
        # body differs from _block_kv in the attention span only.
        # NOTE the cache stays in scan xs/ys even though xs slices
        # materialize as HBM copies: carrying the whole cache and updating
        # it in place was tried and measured WORSE — the read blocks carry
        # aliasing (a defensive copy per step) and the while_loop
        # double-buffers the carry (OOM at B=8 C=4096).
        def layer(carry, xs):
            x = carry                                          # [B, 1, D]
            lp, li_, k_layer, v_layer, ksl, vsl = xs
            mm = ((lambda h_, n: _mm(h_, mats[n], adt, layer=li_))
                  if mats is not None
                  else (lambda h_, n: _mm(h_, lp[n], adt)))
            h = _rmsnorm(x, lp["rms1"], c.rms_eps)
            qkv = mm(h, "qkv")
            if "qkv_b" in lp:
                qkv = qkv + lp["qkv_b"].astype(jnp.float32)
            qkv = qkv.astype(adt)
            kvh = c.kv_heads or c.heads
            q, k, v = _split_qkv(qkv, B, 1, c.heads, kvh, dh)  # [B,*,1,dh]
            q = _rope(q, pos, c.rope_theta)
            k = _rope(k, pos, c.rope_theta)
            if ksl is not None:
                k, ksc = _kv_quantize(k)
                v, vsc = _kv_quantize(v)
                ksl = jax.lax.dynamic_update_slice(
                    ksl, ksc, (0, 0, cache.cursor))
                vsl = jax.lax.dynamic_update_slice(
                    vsl, vsc, (0, 0, cache.cursor))
            k_layer = jax.lax.dynamic_update_slice(
                k_layer, k, (0, 0, cache.cursor, 0))
            v_layer = jax.lax.dynamic_update_slice(
                v_layer, v, (0, 0, cache.cursor, 0))

            ctx = _cached_attn(q, k_layer, v_layer, ksl, vsl, bias, adt,
                               dh, flash_mask=fmask).astype(adt)
            ctx = ctx.transpose(0, 2, 1, 3).reshape(B, 1, c.hidden)
            attn = mm(ctx, "attn_out").astype(adt)
            x = x + attn

            h = _rmsnorm(x, lp["rms2"], c.rms_eps)
            ff = _mlp_ff(mm, h, params["blocks"], adt)
            ff = mm(ff, "w_down")
            return x + ff.astype(adt), (k_layer, v_layer, ksl, vsl)

        x, (ks, vs, kss, vss) = jax.lax.scan(
            layer, x, (rest, li, cache.k, cache.v,
                       cache.k_scale, cache.v_scale))
        x = _rmsnorm(x, params["rms_f"], c.rms_eps)
        logits = _mm(x[:, 0], params["lm_head"], adt)
        new_cache = KVCache(
            k=ks, v=vs, key_mask=key_mask,
            cursor=cache.cursor + 1,
            next_pos=cache.next_pos + 1,
            k_scale=kss, v_scale=vss,
        )
        return logits, new_cache


    def prefill_extend(
        self,
        params: DecoderParams,
        k_row: jax.Array,        # [L, KH, C, dh] — ONE lane's cache
        v_row: jax.Array,
        key_mask_row: jax.Array,  # [C] f32
        ids: jax.Array,          # [S] i32, RIGHT-padded extension tokens
        mask: jax.Array,         # [S] f32
        col0: jax.Array,         # i32 — first cache column to write
        pos0: jax.Array,         # i32 — RoPE position of the first new token
        all_logits: bool = False,
        k_scale_row: jax.Array | None = None,   # [L, KH, C] (int8 cache)
        v_scale_row: jax.Array | None = None,
    ) -> tuple:
        """Prefill a CONTINUATION into an existing lane — the prefix-cache
        primitive (serve/llm.py ChatSession): multi-turn chats re-send the
        whole growing transcript, and re-prefilling the shared prefix every
        turn wastes prefill FLOPs linear in conversation length. Here only
        the new suffix is processed: fresh tokens attend to the lane's
        cached prefix (columns < col0) plus themselves causally, and their
        K/V land at columns [col0, col0+S).

        Cache columns at/after ``col0`` are masked DEAD first, which makes
        ``col0`` a rollback point: the caller can rewind a lane past stale
        content (e.g. the EOS the previous turn appended, which the re-
        rendered transcript does not contain) without touching the prefix.

        Right-padded on purpose (vs the left-padded batch prefill): real
        tokens occupy [0, n) so they map to contiguous cache columns; pad
        columns get garbage K/V with key_mask 0 — the same invariant
        ``decode_step_slots`` relies on. Returns (last-real-token logits
        [V], k_row, v_row, key_mask_row, k_scale_row, v_scale_row) — the
        scale rows are None unless the cache is int8 (pass the lane's
        scale rows in); with ``all_logits=True`` the logits are [S, V]
        (one distribution per fed token — the verify pass of speculative
        decoding, models/speculative.py, which needs the target's
        next-token prediction AFTER each candidate).
        """
        c = self.cfg
        adt = jnp.dtype(c.dtype)
        L, KH, C, dh = k_row.shape
        (S,) = ids.shape

        cols = jnp.arange(C)
        # rollback: kill everything at/after the write point, then bring the
        # fresh columns up with the extension's own validity mask
        key_mask_row = jnp.where(cols < col0, key_mask_row, 0.0)
        fresh = (cols >= col0) & (cols < col0 + S)
        ext_mask = jnp.zeros((C,), mask.dtype)
        ext_mask = jax.lax.dynamic_update_slice(ext_mask, mask, (col0,))
        key_mask_row = jnp.where(fresh, ext_mask, key_mask_row)

        # flash for both cache dtypes: the int8 cache's per-column scales
        # fold into the kernel's logits/weights (ops/attention.py quant mode)
        use_flash = c.attn_impl == "flash"
        if use_flash:
            bias = None                                    # never built
        else:
            # query j sees: cached prefix + fresh tokens 0..j (col <= col0+j)
            vis = (cols[None, :] <= col0 + jnp.arange(S)[:, None]).astype(
                jnp.float32) * key_mask_row[None, :]
            bias = (vis[None, None] - 1.0) * 1e9           # [1, 1, S, C]

        pos = (pos0 + jnp.clip(
            jnp.cumsum(mask).astype(jnp.int32) - 1, 0))[None, :]  # [1, S]
        x = params["tok_embed"][ids[None, :]].astype(adt)         # [1, S, D]

        mats, rest = _split_stream(params["blocks"])
        li = jnp.arange(c.layers, dtype=jnp.int32)

        def layer(carry, xs):
            x = carry
            lp, li_, k_layer, v_layer, ksl, vsl = xs     # [KH, C, dh]
            mm = ((lambda h_, n: _mm(h_, mats[n], adt, layer=li_))
                  if mats is not None
                  else (lambda h_, n: _mm(h_, lp[n], adt)))
            h = _rmsnorm(x, lp["rms1"], c.rms_eps)
            qkv = mm(h, "qkv")
            if "qkv_b" in lp:
                qkv = qkv + lp["qkv_b"].astype(jnp.float32)
            qkv = qkv.astype(adt)
            kvh = c.kv_heads or c.heads
            q, k, v = _split_qkv(qkv, 1, S, c.heads, kvh, dh)
            q = _rope(q, pos, c.rope_theta)
            k = _rope(k, pos, c.rope_theta)
            if ksl is not None:
                k, ksc = _kv_quantize(k)                 # ksc [1, KH, S]
                v, vsc = _kv_quantize(v)
                ksl = jax.lax.dynamic_update_slice(ksl, ksc[0], (0, col0))
                vsl = jax.lax.dynamic_update_slice(vsl, vsc[0], (0, col0))
            k_layer = jax.lax.dynamic_update_slice(
                k_layer, k[0], (0, col0, 0))
            v_layer = jax.lax.dynamic_update_slice(
                v_layer, v[0], (0, col0, 0))

            if use_flash:
                from mediquery_rag.ops.attention import flash_attention_at
                ctx = flash_attention_at(
                    q, k_layer[None], v_layer[None], key_mask_row[None],
                    jnp.asarray(col0, jnp.int32)[None],
                    scale=dh ** -0.5,
                    k_scale=None if ksl is None else ksl[None],
                    v_scale=None if vsl is None else vsl[None]).astype(adt)
            else:
                ctx = _cached_attn(
                    q, k_layer[None], v_layer[None],
                    None if ksl is None else ksl[None],
                    None if vsl is None else vsl[None],
                    bias, adt, dh).astype(adt)
            ctx = ctx.transpose(0, 2, 1, 3).reshape(1, S, c.hidden)
            attn = mm(ctx, "attn_out").astype(adt)
            x = x + attn

            h = _rmsnorm(x, lp["rms2"], c.rms_eps)
            ff = _mlp_ff(mm, h, params["blocks"], adt)
            ff = mm(ff, "w_down")
            return x + ff.astype(adt), (k_layer, v_layer, ksl, vsl)

        x, (ks, vs, kss, vss) = jax.lax.scan(
            layer, x, (rest, li, k_row, v_row,
                       k_scale_row, v_scale_row))
        x = _rmsnorm(x, params["rms_f"], c.rms_eps)
        if all_logits:
            logits = _mm(x[0], params["lm_head"], adt)       # [S, V]
        else:
            last = jnp.clip(jnp.sum(mask).astype(jnp.int32) - 1, 0)
            logits = _mm(x[0, last], params["lm_head"], adt)
        return logits, ks, vs, key_mask_row, kss, vss

    def extend_slots(
        self,
        params: DecoderParams,
        cache: KVCache,
        toks: jax.Array,         # [B, G] i32 — G new tokens per lane
        active: jax.Array,       # [B] bool
    ) -> tuple[jax.Array, KVCache]:
        """Batched multi-column extend at PER-LANE cursors — the verify/
        propose primitive of speculative continuous batching (serve/llm.py
        spec quantum). Lane ``b`` writes its G tokens' K/V at columns
        ``cursor[b] .. cursor[b]+G-1`` (RoPE positions ``next_pos[b]+i``)
        and gets one next-token distribution per fed token ([B, G, V] —
        ``prefill_extend(all_logits=True)`` batched over lanes).

        Cursor/positions advance by the FULL G for active lanes; the
        caller owns acceptance and rolls back by setting cursor to
        ``old + n_acc`` and re-masking ``key_mask`` to columns < cursor —
        the invariant this method assumes on entry (it masks the fresh G
        columns up for active lanes and nothing else). Inactive lanes
        write garbage K/V at their columns with key_mask left 0, exactly
        like ``decode_step_slots``. All G tokens are treated as real (no
        intra-extension padding); the caller must guarantee
        ``cursor[b] + G <= C`` for active lanes.

        Flash path, big caches (``_use_stacked``): stacked zero-copy cache
        layout (see ``decode_step``). The cache part needs NO causal term
        — on entry every mask-live column is < cursor[b], visible to all G
        fresh queries — so the kernel runs mask-only with ``return_ml``;
        the fresh G x G causal block is computed in plain XLA (G is the
        speculative gamma+1, single digits) and folded in with the
        (o, m, l) combine, gated by ``active``.
        """
        if self.cfg.attn_impl == "flash" and _use_stacked(cache):
            return self._extend_slots_stacked(params, cache, toks, active)
        return self._extend_slots_xs(params, cache, toks, active)

    def _extend_slots_stacked(
        self,
        params: DecoderParams,
        cache: KVCache,
        toks: jax.Array,         # [B, G] i32
        active: jax.Array,       # [B] bool
    ) -> tuple[jax.Array, KVCache]:
        from mediquery_rag.ops.attention import flash_attention_cached

        c = self.cfg
        adt = jnp.dtype(c.dtype)
        L, B, KH, C, dh = cache.k.shape
        G = toks.shape[1]
        rows = jnp.arange(B)
        quant = cache.k_scale is not None
        kv_dt = cache.k.dtype
        fmask = cache.key_mask        # live cols < cursor[b] on entry
        scale = dh ** -0.5
        g = c.heads // KH
        act = active[:, None, None, None].astype(jnp.float32)  # [B,1,1,1]

        cur = cache.cursor[:, None]                        # [B, 1]
        pos = cache.next_pos[:, None] + jnp.arange(G)[None, :]   # [B, G]
        ccols = cur + jnp.arange(G)[None, :]               # [B, G]
        # fresh-block causal mask: query i sees fresh cols j <= i
        tri = (jnp.arange(G)[None, :] <= jnp.arange(G)[:, None])
        tri = (tri.astype(jnp.float32) - 1.0) * 1e9        # [G, G]

        x = params["tok_embed"][toks].astype(adt)          # [B, G, D]
        mats, rest = _split_stream(params["blocks"])
        li = jnp.arange(c.layers, dtype=jnp.int32)

        def layer(carry, xs):
            x = carry                                      # [B, G, D]
            lp, li_ = xs
            mm = ((lambda h_, n: _mm(h_, mats[n], adt, layer=li_))
                  if mats is not None
                  else (lambda h_, n: _mm(h_, lp[n], adt)))
            h = _rmsnorm(x, lp["rms1"], c.rms_eps)
            qkv = mm(h, "qkv")
            if "qkv_b" in lp:
                qkv = qkv + lp["qkv_b"].astype(jnp.float32)
            qkv = qkv.astype(adt)
            q, k, v = _split_qkv(qkv, B, G, c.heads, KH, dh)  # [B,*,G,dh]
            q = _rope(q, pos, c.rope_theta)
            k = _rope(k, pos, c.rope_theta)
            if quant:
                kc, ksc = _kv_quantize(k)                  # ksc [B, KH, G]
                vc, vsc = _kv_quantize(v)
                k_new = kc.astype(jnp.float32) * ksc[..., None]
                v_new = vc.astype(jnp.float32) * vsc[..., None]
            else:
                kc, vc = k.astype(kv_dt), v.astype(kv_dt)
                ksc = vsc = None
                k_new = kc.astype(jnp.float32)
                v_new = vc.astype(jnp.float32)
            o1, m1, l1 = flash_attention_cached(
                q, cache.k, cache.v, fmask,
                k_scale=cache.k_scale, v_scale=cache.v_scale,
                layer=li_, return_ml=True)                 # [B, H, G, ...]
            # fresh G x G causal block in f32 (G is tiny)
            sf = jnp.einsum("bhid,bhjd->bhij", q.astype(jnp.float32),
                            _repeat_kv(k_new, g)) * scale + tri
            m2 = jnp.max(sf, axis=-1)                      # [B, H, G]
            p = jnp.exp(sf - m2[..., None])                # [B, H, G, G]
            l2 = jnp.sum(p, axis=-1)                       # [B, H, G]
            o2num = jnp.einsum("bhij,bhjd->bhid", p,
                               _repeat_kv(v_new, g))       # un-normalized
            m_ = jnp.maximum(m1, m2)
            a1 = jnp.exp(m1 - m_) * l1
            e2 = jnp.exp(m2 - m_)
            # gate the fresh block by `active`: inactive lanes attend over
            # the cache alone (their fresh K/V is garbage)
            num = (o1.astype(jnp.float32) * a1[..., None]
                   + o2num * e2[..., None] * act)
            den = a1 + e2 * l2 * act[..., 0]
            ctx = num / den[..., None]                     # [B, H, G, dh]
            ctx = ctx.astype(adt).transpose(0, 2, 1, 3).reshape(B, G,
                                                                c.hidden)
            attn = mm(ctx, "attn_out").astype(adt)
            x = x + attn
            h = _rmsnorm(x, lp["rms2"], c.rms_eps)
            ff = _mlp_ff(mm, h, params["blocks"], adt)
            ff = mm(ff, "w_down")
            return x + ff.astype(adt), (kc, vc, ksc, vsc)

        x, (kcol, vcol, kscol, vscol) = jax.lax.scan(layer, x, (rest, li))
        x = _rmsnorm(x, params["rms_f"], c.rms_eps)
        logits = _mm(x, params["lm_head"], adt)            # [B, G, V]
        cols = jnp.arange(C)[None, :]
        key_mask = jnp.where((cols >= cur) & (cols < cur + G)
                             & active[:, None], 1.0, cache.key_mask)
        # multi-column scatter: lane b, slot i -> column ccols[b, i]; the
        # advanced indices broadcast to [B, G] and lead the value shape
        new_k = cache.k.at[:, rows[:, None], :, ccols].set(
            kcol.transpose(1, 3, 0, 2, 4))                 # [B,G,L,KH,dh]
        new_v = cache.v.at[:, rows[:, None], :, ccols].set(
            vcol.transpose(1, 3, 0, 2, 4))
        adv = G * active.astype(jnp.int32)
        new_cache = KVCache(
            k=new_k, v=new_v, key_mask=key_mask,
            cursor=cache.cursor + adv,
            next_pos=cache.next_pos + adv,
            k_scale=(None if not quant else
                     cache.k_scale.at[:, rows[:, None], :, ccols].set(
                         kscol.transpose(1, 3, 0, 2))),    # [B, G, L, KH]
            v_scale=(None if not quant else
                     cache.v_scale.at[:, rows[:, None], :, ccols].set(
                         vscol.transpose(1, 3, 0, 2))),
        )
        return logits, new_cache

    def _extend_slots_xs(
        self,
        params: DecoderParams,
        cache: KVCache,
        toks: jax.Array,         # [B, G] i32
        active: jax.Array,       # [B] bool
    ) -> tuple[jax.Array, KVCache]:
        """The original scan-xs cache layout (einsum attention path)."""
        c = self.cfg
        adt = jnp.dtype(c.dtype)
        L, B, KH, C, dh = cache.k.shape
        G = toks.shape[1]
        rows = jnp.arange(B)
        cols = jnp.arange(C)[None, :]                      # [1, C]
        cur = cache.cursor[:, None]                        # [B, 1]

        fresh = (cols >= cur) & (cols < cur + G)           # [B, C]
        key_mask = jnp.where(fresh & active[:, None],
                             1.0, cache.key_mask)
        # query i of lane b sees: mask-live columns <= cursor[b] + i —
        # exactly the flash kernel's per-lane offset-causal rule, so the
        # flash route passes col0=cursor and no bias tensor (both cache
        # dtypes; int8 scales fold in-kernel)
        fmask = key_mask if c.attn_impl == "flash" else None
        if fmask is None:
            vis = ((cols[:, None, :]
                    <= cur[:, :, None] + jnp.arange(G)[None, :, None])
                   .astype(jnp.float32) * key_mask[:, None, :])  # [B, G, C]
            bias = (vis[:, None] - 1.0) * 1e9              # [B, 1, G, C]
        else:
            bias = None
        pos = cache.next_pos[:, None] + jnp.arange(G)[None, :]   # [B, G]
        ccols = cur + jnp.arange(G)[None, :]               # [B, G]

        x = params["tok_embed"][toks].astype(adt)          # [B, G, D]

        mats, rest = _split_stream(params["blocks"])
        li = jnp.arange(c.layers, dtype=jnp.int32)

        def layer(carry, xs):
            x = carry                                      # [B, G, D]
            lp, li_, k_layer, v_layer, ksl, vsl = xs
            mm = ((lambda h_, n: _mm(h_, mats[n], adt, layer=li_))
                  if mats is not None
                  else (lambda h_, n: _mm(h_, lp[n], adt)))
            h = _rmsnorm(x, lp["rms1"], c.rms_eps)
            qkv = mm(h, "qkv")
            if "qkv_b" in lp:
                qkv = qkv + lp["qkv_b"].astype(jnp.float32)
            qkv = qkv.astype(adt)
            kvh = c.kv_heads or c.heads
            q, k, v = _split_qkv(qkv, B, G, c.heads, kvh, dh)  # [B,*,G,dh]
            q = _rope(q, pos, c.rope_theta)
            k = _rope(k, pos, c.rope_theta)
            if ksl is not None:
                k, ksc = _kv_quantize(k)                   # ksc [B, KH, G]
                v, vsc = _kv_quantize(v)
                ksl = ksl.at[rows[:, None], :, ccols].set(
                    ksc.transpose(0, 2, 1))
                vsl = vsl.at[rows[:, None], :, ccols].set(
                    vsc.transpose(0, 2, 1))
            # batched 2-d scatter: lane b, slot i -> column ccols[b, i]
            k_layer = k_layer.at[rows[:, None], :, ccols, :].set(
                k.transpose(0, 2, 1, 3))
            v_layer = v_layer.at[rows[:, None], :, ccols, :].set(
                v.transpose(0, 2, 1, 3))

            ctx = _cached_attn(q, k_layer, v_layer, ksl, vsl, bias, adt,
                               dh, flash_mask=fmask,
                               flash_col0=cache.cursor).astype(adt)
            ctx = ctx.transpose(0, 2, 1, 3).reshape(B, G, c.hidden)
            attn = mm(ctx, "attn_out").astype(adt)
            x = x + attn

            h = _rmsnorm(x, lp["rms2"], c.rms_eps)
            ff = _mlp_ff(mm, h, params["blocks"], adt)
            ff = mm(ff, "w_down")
            return x + ff.astype(adt), (k_layer, v_layer, ksl, vsl)

        x, (ks, vs, kss, vss) = jax.lax.scan(
            layer, x, (rest, li, cache.k, cache.v,
                       cache.k_scale, cache.v_scale))
        x = _rmsnorm(x, params["rms_f"], c.rms_eps)
        logits = _mm(x, params["lm_head"], adt)            # [B, G, V]
        adv = G * active.astype(jnp.int32)
        new_cache = KVCache(
            k=ks, v=vs, key_mask=key_mask,
            cursor=cache.cursor + adv,
            next_pos=cache.next_pos + adv,
            k_scale=kss, v_scale=vss,
        )
        return logits, new_cache

    def decode_step_slots(
        self,
        params: DecoderParams,
        cache: KVCache,
        token: jax.Array,        # [B] i32
        active: jax.Array,       # [B] bool — slots currently serving a request
    ) -> tuple[jax.Array, KVCache]:
        """``decode_step`` generalized to PER-SLOT cursors — the building
        block of continuous batching (serve/llm.py): each batch row is an
        independent request at its own sequence position, so requests can
        join/leave the batch without restarting anyone else's decode.

        ``cache.cursor`` is [B] here (vs the scalar shared cursor of the
        lockstep path). Inactive rows still write their (garbage) K/V at
        their cursor column — unconditional scatter is cheaper than a
        gather+select, and their ``key_mask`` stays 0 so attention never
        sees it; admission overwrites the whole row. Cursor/positions only
        advance for active rows.

        Flash path, big caches (``_use_stacked``): stacked zero-copy cache
        layout (see ``decode_step``) — the fresh column's softmax term is
        gated by ``active`` so inactive rows attend over the cache alone.
        """
        if self.cfg.attn_impl == "flash" and _use_stacked(cache):
            return self._decode_step_slots_stacked(params, cache, token,
                                                   active)
        return self._decode_step_slots_xs(params, cache, token, active)

    def _decode_step_slots_stacked(
        self,
        params: DecoderParams,
        cache: KVCache,
        token: jax.Array,        # [B] i32
        active: jax.Array,       # [B] bool
    ) -> tuple[jax.Array, KVCache]:
        from mediquery_rag.ops.attention import flash_attention_cached

        c = self.cfg
        adt = jnp.dtype(c.dtype)
        L, B, KH, C, dh = cache.k.shape
        rows = jnp.arange(B)
        quant = cache.k_scale is not None
        kv_dt = cache.k.dtype
        fmask = cache.key_mask   # fresh column folded into the softmax
        pos = cache.next_pos[:, None]                          # [B, 1]

        x = params["tok_embed"][token[:, None]].astype(adt)    # [B, 1, D]
        mats, rest = _split_stream(params["blocks"])
        li = jnp.arange(c.layers, dtype=jnp.int32)

        def layer(carry, xs):
            x = carry                                          # [B, 1, D]
            lp, li_ = xs
            mm = ((lambda h_, n: _mm(h_, mats[n], adt, layer=li_))
                  if mats is not None
                  else (lambda h_, n: _mm(h_, lp[n], adt)))
            h = _rmsnorm(x, lp["rms1"], c.rms_eps)
            qkv = mm(h, "qkv")
            if "qkv_b" in lp:
                qkv = qkv + lp["qkv_b"].astype(jnp.float32)
            qkv = qkv.astype(adt)
            q, k, v = _split_qkv(qkv, B, 1, c.heads, KH, dh)   # [B,*,1,dh]
            q = _rope(q, pos, c.rope_theta)
            k = _rope(k, pos, c.rope_theta)
            if quant:
                kc, ksc = _kv_quantize(k)
                vc, vsc = _kv_quantize(v)
                k_new = kc.astype(jnp.float32) * ksc[..., None]
                v_new = vc.astype(jnp.float32) * vsc[..., None]
            else:
                kc, vc = k.astype(kv_dt), v.astype(kv_dt)
                ksc = vsc = None
                k_new = kc.astype(jnp.float32)
                v_new = vc.astype(jnp.float32)
            # fresh column folded into the softmax; fresh_gate zeroes
            # inactive lanes' fresh term (cache-only attention), and the
            # mask bias keeps the inactive-lane +
            # empty-cache row finite garbage, never NaN
            ctx = flash_attention_cached(
                q, cache.k, cache.v, fmask,
                k_scale=cache.k_scale, v_scale=cache.v_scale,
                layer=li_, fresh_k=k_new.astype(adt),
                fresh_v=v_new.astype(adt),
                fresh_gate=active.astype(jnp.float32))         # [B, H, 1, dh]
            ctx = ctx.astype(adt).transpose(0, 2, 1, 3).reshape(B, 1,
                                                                c.hidden)
            attn = mm(ctx, "attn_out").astype(adt)
            x = x + attn
            h = _rmsnorm(x, lp["rms2"], c.rms_eps)
            ff = _mlp_ff(mm, h, params["blocks"], adt)
            ff = mm(ff, "w_down")
            return x + ff.astype(adt), (kc, vc, ksc, vsc)

        x, (kcol, vcol, kscol, vscol) = jax.lax.scan(layer, x, (rest, li))
        x = _rmsnorm(x, params["rms_f"], c.rms_eps)
        logits = _mm(x[:, 0], params["lm_head"], adt)
        # per-row column scatter: row b's column is cache.cursor[b]; the
        # advanced indices (rows, cursor) are separated by a sliced axis,
        # so the broadcast [B] subspace leads the value shape
        new_k = cache.k.at[:, rows, :, cache.cursor].set(
            kcol[:, :, :, 0, :].transpose(1, 0, 2, 3))         # [B, L, KH, dh]
        new_v = cache.v.at[:, rows, :, cache.cursor].set(
            vcol[:, :, :, 0, :].transpose(1, 0, 2, 3))
        adv = active.astype(jnp.int32)
        new_cache = KVCache(
            k=new_k, v=new_v,
            key_mask=cache.key_mask.at[rows, cache.cursor].max(
                active.astype(cache.key_mask.dtype)),
            cursor=jnp.minimum(cache.cursor + adv, C - 1),
            next_pos=cache.next_pos + adv,
            k_scale=(None if not quant else
                     cache.k_scale.at[:, rows, :, cache.cursor].set(
                         kscol[:, :, :, 0].transpose(1, 0, 2))),
            v_scale=(None if not quant else
                     cache.v_scale.at[:, rows, :, cache.cursor].set(
                         vscol[:, :, :, 0].transpose(1, 0, 2))),
        )
        return logits, new_cache

    def _decode_step_slots_xs(
        self,
        params: DecoderParams,
        cache: KVCache,
        token: jax.Array,        # [B] i32
        active: jax.Array,       # [B] bool
    ) -> tuple[jax.Array, KVCache]:
        """The original scan-xs cache layout (einsum attention path)."""
        c = self.cfg
        adt = jnp.dtype(c.dtype)
        L, B, H, C, dh = cache.k.shape
        rows = jnp.arange(B)

        key_mask = cache.key_mask.at[rows, cache.cursor].max(
            active.astype(cache.key_mask.dtype))
        fmask = key_mask if c.attn_impl == "flash" else None
        bias = (None if fmask is not None
                else (key_mask[:, None, None, :] - 1.0) * 1e9)  # [B,1,1,C]
        pos = cache.next_pos[:, None]                          # [B, 1]

        x = params["tok_embed"][token[:, None]].astype(adt)    # [B, 1, D]

        mats, rest = _split_stream(params["blocks"])
        li = jnp.arange(c.layers, dtype=jnp.int32)

        def layer(carry, xs):
            x = carry                                          # [B, 1, D]
            lp, li_, k_layer, v_layer, ksl, vsl = xs
            mm = ((lambda h_, n: _mm(h_, mats[n], adt, layer=li_))
                  if mats is not None
                  else (lambda h_, n: _mm(h_, lp[n], adt)))
            h = _rmsnorm(x, lp["rms1"], c.rms_eps)
            qkv = mm(h, "qkv")
            if "qkv_b" in lp:
                qkv = qkv + lp["qkv_b"].astype(jnp.float32)
            qkv = qkv.astype(adt)
            kvh = c.kv_heads or c.heads
            q, k, v = _split_qkv(qkv, B, 1, c.heads, kvh, dh)  # [B,*,1,dh]
            q = _rope(q, pos, c.rope_theta)
            k = _rope(k, pos, c.rope_theta)
            if ksl is not None:
                k, ksc = _kv_quantize(k)
                v, vsc = _kv_quantize(v)
                ksl = ksl.at[rows, :, cache.cursor].set(ksc[:, :, 0])
                vsl = vsl.at[rows, :, cache.cursor].set(vsc[:, :, 0])
            # batched scatter: row b writes its column cache.cursor[b]
            k_layer = k_layer.at[rows, :, cache.cursor, :].set(k[:, :, 0, :])
            v_layer = v_layer.at[rows, :, cache.cursor, :].set(v[:, :, 0, :])

            ctx = _cached_attn(q, k_layer, v_layer, ksl, vsl, bias, adt,
                               dh, flash_mask=fmask).astype(adt)
            ctx = ctx.transpose(0, 2, 1, 3).reshape(B, 1, c.hidden)
            attn = mm(ctx, "attn_out").astype(adt)
            x = x + attn

            h = _rmsnorm(x, lp["rms2"], c.rms_eps)
            ff = _mlp_ff(mm, h, params["blocks"], adt)
            ff = mm(ff, "w_down")
            return x + ff.astype(adt), (k_layer, v_layer, ksl, vsl)

        x, (ks, vs, kss, vss) = jax.lax.scan(
            layer, x, (rest, li, cache.k, cache.v,
                       cache.k_scale, cache.v_scale))
        x = _rmsnorm(x, params["rms_f"], c.rms_eps)
        logits = _mm(x[:, 0], params["lm_head"], adt)
        adv = active.astype(jnp.int32)
        new_cache = KVCache(
            k=ks, v=vs, key_mask=key_mask,
            cursor=jnp.minimum(cache.cursor + adv, C - 1),
            next_pos=cache.next_pos + adv,
            k_scale=kss, v_scale=vss,
        )
        return logits, new_cache


_STACKED_MIN_CACHE_BYTES = 32 * 1024 * 1024


def _use_stacked(cache: KVCache) -> bool:
    """Trace-time layout choice for the flash decode/extend paths: the
    stacked zero-copy layout pays a fixed per-layer cost to avoid copying
    the cache through scan xs/ys, so it wins when the cache is big. The
    32 MB break-even was set for an earlier attention kernel and has not
    been re-measured on the GPU. Static shapes make this a compile-time
    decision."""
    return cache.k.nbytes + cache.v.nbytes >= _STACKED_MIN_CACHE_BYTES


def _repeat_kv(t, groups):
    """[B, KH, S, dh] -> [B, KH*groups, S, dh] (GQA: share KV across the
    query-head group; the CACHE stays at KH heads — only the attention
    compute expands, and XLA fuses the broadcast into the einsum)."""
    return t if groups == 1 else jnp.repeat(t, groups, axis=1)


def _attend(q, k, v, bias, adt, dh):
    g = q.shape[1] // k.shape[1]
    k, v = _repeat_kv(k, g), _repeat_kv(v, g)
    logits = jnp.einsum("bhqd,bhkd->bhqk", q, k,
                        preferred_element_type=jnp.float32) * (dh ** -0.5)
    if bias is not None:
        logits = logits + bias
    w = jax.nn.softmax(logits, axis=-1).astype(adt)
    return jnp.einsum("bhqk,bhkd->bhqd", w, v,
                      preferred_element_type=jnp.float32).astype(adt)


def _split_qkv(qkv, B, S, heads, kv_heads, dh):
    qd, kvd = heads * dh, kv_heads * dh
    q = qkv[..., :qd].reshape(B, S, heads, dh).transpose(0, 2, 1, 3)
    k = qkv[..., qd:qd + kvd].reshape(B, S, kv_heads, dh).transpose(0, 2, 1, 3)
    v = qkv[..., qd + kvd:].reshape(B, S, kv_heads, dh).transpose(0, 2, 1, 3)
    return q, k, v


def _block_kv(x, lp, *, heads, kv_heads, adt, bias, pos, theta, eps=1e-6,
              flash_mask=None, name_acts=False):
    """Transformer block returning (x_out, k, v) — shared by apply/prefill.

    ``flash_mask`` ([B, S] key validity) switches the attention to the
    Pallas flash kernel (``DecoderConfig.attn_impl == "flash"``); ``bias``
    is None in that mode — the [B,1,S,S] bias is never materialized.

    ``name_acts`` (the training-MFU path, ``apply(remat="names")``): every
    matmul output is rounded to the activation dtype and tagged with
    ``checkpoint_name`` so ``save_only_these_names`` keeps the bf16 copies
    and the backward recomputes only elementwise work — no matmul ever
    runs twice (full remat re-runs the whole forward, ~2N extra FLOPs per
    token; the ``dots`` policy saves f32 matmul outputs, 2x the HBM).
    The one numeric change vs name_acts=False: silu/mul read the bf16-
    rounded gate/up instead of the f32 accumulators (standard bf16
    activation training; fwd and replay see identical values)."""
    from jax.ad_checkpoint import checkpoint_name

    def nm(t, tag):
        return checkpoint_name(t, tag) if name_acts else t

    B, S, D = x.shape
    dh = D // heads

    h = _rmsnorm(x, lp["rms1"], eps)
    qkv = _mm(h, lp["qkv"], adt)
    if "qkv_b" in lp:
        qkv = qkv + lp["qkv_b"].astype(jnp.float32)
    qkv = nm(qkv.astype(adt), "lm_qkv")
    q, k, v = _split_qkv(qkv, B, S, heads, kv_heads, dh)
    q = _rope(q, pos, theta)
    k = _rope(k, pos, theta)

    if flash_mask is not None:
        from mediquery_rag.ops.attention import flash_attention
        ctx = flash_attention(q, k, v, flash_mask,
                              scale=dh ** -0.5).astype(adt)
    else:
        ctx = _attend(q, k, v, bias, adt, dh)   # f32 (cast only if named)
    ctx = ctx.transpose(0, 2, 1, 3).reshape(B, S, D)
    if name_acts:
        ctx = checkpoint_name(ctx.astype(adt), "lm_ctx")
    attn = nm(_mm(ctx, lp["attn_out"], adt).astype(adt), "lm_attn")
    x = x + attn

    h = _rmsnorm(x, lp["rms2"], eps)
    if "w_gateup" in lp:                 # fused quantized tree (prefill path)
        gate, up = jnp.split(_mm(h, lp["w_gateup"], adt), 2, axis=-1)
    else:
        gate = _mm(h, lp["w_gate"], adt)
        up = _mm(h, lp["w_up"], adt)
    if name_acts:
        gate = checkpoint_name(gate.astype(adt), "lm_gate")
        up = checkpoint_name(up.astype(adt), "lm_up")
    ff = nm((jax.nn.silu(gate) * up).astype(adt), "lm_ff")
    ff = _mm(ff, lp["w_down"], adt)
    return x + ff.astype(adt), k, v


def _block_full(x, lp, *, heads, kv_heads, adt, bias, pos, theta, eps=1e-6,
                flash_mask=None, name_acts=False):
    out, _, _ = _block_kv(x, lp, heads=heads, kv_heads=kv_heads, adt=adt,
                          bias=bias, pos=pos, theta=theta, eps=eps,
                          flash_mask=flash_mask, name_acts=name_acts)
    return out
