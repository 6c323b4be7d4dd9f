"""Grouped-query attention over a mask, in plain XLA.

The decoder's attention has three shapes (models/decoder.py):

- ``flash_attention``: causal + key-mask attention over a prompt — prefill
  and training (``DecoderConfig.attn_impl == "flash"``); differentiable.
  On the GPU it is cuDNN's fused attention (``jax.nn.dot_product_attention``),
  which never writes the ``[B, H, S, S]`` logits.
- ``flash_attention_at``: a fresh suffix of S tokens over the lane's whole
  cache, query ``r`` seeing cache columns ``c <= col0 + r`` — chunked
  prefill, prefix-cache continuation and speculative verify windows.
- ``flash_attention_cached``: decode-step queries over the cache, the key
  mask alone deciding visibility.

All three fold each KV head's ``g = H / KH`` query heads into one grouped
product (``q`` viewed as ``[B, KH, g, S, dh]``), so the cache is read at
its true KH-head size instead of being ``jnp.repeat``-expanded to H. An
int8 cache (``k_scale``/``v_scale``) is cast in the product and its
per-column scales fold into the logits (K) and the softmax weights (V):
the dequantized cache is never materialized. ``layer`` selects one layer
of a STACKED ``[L, B, KH, C, dh]`` cache.

Masking follows the einsum path: logits get ``(visible - 1) * 1e9``, so a
row with no visible keys softmaxes to finite uniform garbage (never NaN);
callers ignore such rows.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from mediquery_rag.ops import route


def _select_layer(layer, *arrays):
    if layer is None:
        return arrays
    layer = jnp.asarray(layer, jnp.int32).reshape(())
    return tuple(None if a is None else jax.lax.dynamic_index_in_dim(
        a, layer, 0, keepdims=False) for a in arrays)


def _grouped_attention(q, k, v, visible, scale, k_scale=None, v_scale=None,
                       fresh=None):
    """Core: q [B, H, S, dh]; k/v [B, KH, C, dh]; ``visible`` broadcastable
    to [B, 1, 1, S, C] (bool). ``fresh`` = (k_new, v_new, gate) appends one
    extra always-visible column per lane (gated by ``gate`` [B]).
    Returns ([B, H, S, dh] f32 context, m, l) with m/l the softmax max and
    denominator [B, H, S]."""
    B, H, S, dh = q.shape
    KH = k.shape[1]
    g = H // KH
    qg = q.reshape(B, KH, g, S, dh)
    cdt = q.dtype
    s = jnp.einsum("bkgsd,bkcd->bkgsc", qg, k.astype(cdt),
                   preferred_element_type=jnp.float32) * scale
    if k_scale is not None:
        s = s * k_scale[:, :, None, None, :]
    s = s + (visible.astype(jnp.float32) - 1.0) * 1e9
    if fresh is not None:
        k_new, v_new, gate = fresh                        # [B, KH, 1, dh]
        s_new = jnp.einsum("bkgsd,bkcd->bkgsc", qg, k_new.astype(cdt),
                           preferred_element_type=jnp.float32) * scale
        s_new = s_new + (gate[:, None, None, None, None] - 1.0) * 1e9
        s = jnp.concatenate([s, s_new], axis=-1)
    m = jnp.max(s, axis=-1, keepdims=True)
    p = jnp.exp(s - m)
    l = jnp.sum(p, axis=-1, keepdims=True)
    if fresh is not None:
        p, p_new = p[..., :-1], p[..., -1:]
    if v_scale is not None:
        p = p * v_scale[:, :, None, None, :]
    ctx = jnp.einsum("bkgsc,bkcd->bkgsd", p.astype(cdt), v.astype(cdt),
                     preferred_element_type=jnp.float32)
    if fresh is not None:
        ctx = ctx + p_new * fresh[1].astype(jnp.float32)[:, :, None]
    ctx = ctx / l
    return (ctx.reshape(B, H, S, dh), m.reshape(B, H, S),
            l.reshape(B, H, S))


def mha_reference(q, k, v, key_mask, scale, causal=True):
    """Einsum oracle — the exact op sequence of models/decoder.py:_attend
    with the prefill bias, in f32, heads expanded with ``jnp.repeat``."""
    g = q.shape[1] // k.shape[1]
    if g > 1:
        k, v = jnp.repeat(k, g, axis=1), jnp.repeat(v, g, axis=1)
    logits = jnp.einsum("bhqd,bhkd->bhqk", q, k,
                        preferred_element_type=jnp.float32) * scale
    vis = key_mask.astype(jnp.float32)[:, None, None, :]
    if causal:
        S = q.shape[2]
        vis = vis * jnp.tril(jnp.ones((S, S), jnp.float32))[None, None]
    logits = logits + (vis - 1.0) * 1e9
    w = jax.nn.softmax(logits, axis=-1).astype(q.dtype)
    return jnp.einsum("bhqk,bhkd->bhqd", w, v,
                      preferred_element_type=jnp.float32)


def flash_attention(
    q: jax.Array,            # [B, H, S, dh]
    k: jax.Array,            # [B, KH, S, dh] — KH divides H (GQA)
    v: jax.Array,            # [B, KH, S, dh]
    key_mask: jax.Array,     # [B, S], 1.0 = real token
    *,
    scale: float | None = None,
    causal: bool = True,
) -> jax.Array:
    """Masked (causal) attention. Query position ``r`` attends to key
    positions ``c`` with ``key_mask[b, c] == 1`` and (if ``causal``)
    ``c <= r`` — the prefill/apply visibility of models/decoder.py.
    Returns ``[B, H, S, dh]`` in q's dtype. Differentiable."""
    route.impl("attention_prefill")
    if q.shape[1] % k.shape[1]:
        raise ValueError(f"heads {q.shape[1]} % kv_heads {k.shape[1]} != 0")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    S, Sk = q.shape[2], k.shape[2]
    vis = key_mask[:, None, None, :] > 0                       # [B,1,1,Sk]
    if causal:
        vis = vis & (jnp.arange(Sk)[None, :]
                     <= jnp.arange(S)[:, None])[None, None]
    if route.impl("attention_prefill") == "cudnn" and _cudnn_fits(q, k):
        if S == Sk:
            # a row with no visible key (a left-pad query) sees itself:
            # finite garbage like the einsum path's, never NaN; real rows
            # already see their own column
            vis = vis | jnp.eye(S, dtype=bool)[None, None]
        out = jax.nn.dot_product_attention(
            q.transpose(0, 2, 1, 3), k.transpose(0, 2, 1, 3),
            v.transpose(0, 2, 1, 3), mask=vis, scale=float(scale),
            implementation="cudnn")
        return out.transpose(0, 2, 1, 3)
    ctx, _, _ = _grouped_attention(q, k, v, vis[:, :, None], float(scale))
    return ctx.astype(q.dtype)


def _cudnn_fits(q, k) -> bool:
    """Shapes and dtypes cuDNN's fused attention takes."""
    dh = q.shape[-1]
    return (q.dtype in (jnp.bfloat16, jnp.float16) and k.dtype == q.dtype
            and dh % 8 == 0 and dh <= 128)


def _check_cache_scale_ndim(k_scale, v_scale, *, stacked: bool) -> None:
    """int8-cache scales must match the cache's stacking: a stacked
    [L, B, KH, C, dh] cache needs [L, B, KH, C] scales, an unstacked one
    [B, KH, C]."""
    if k_scale is None:
        return
    want = 4 if stacked else 3
    shape_txt = "[L, B, KH, C]" if stacked else "[B, KH, C]"
    if k_scale.ndim != want or v_scale.ndim != want:
        raise ValueError(
            f"{'stacked' if stacked else 'unstacked'} cache needs "
            f"{shape_txt} scales, got k_scale.ndim={k_scale.ndim} "
            f"v_scale.ndim={v_scale.ndim}")


def _check_cache_args(q, k, k_scale, v_scale, layer):
    if (layer is not None) != (k.ndim == 5):
        raise ValueError("stacked [L, B, KH, C, dh] cache iff layer given")
    kh_ax = 2 if layer is not None else 1
    if q.shape[1] % k.shape[kh_ax]:
        raise ValueError(
            f"heads {q.shape[1]} % kv_heads {k.shape[kh_ax]} != 0")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale must be given together")
    _check_cache_scale_ndim(k_scale, v_scale, stacked=layer is not None)


def flash_attention_at(
    q: jax.Array,            # [B, H, S, dh] — a fresh suffix of S tokens
    k: jax.Array,            # [B, KH, C, dh] — the full cache (fresh K/V
    v: jax.Array,            #   already scattered at cols col0..col0+S-1)
    key_mask: jax.Array,     # [B, C] — cache validity incl. fresh columns
    col0: jax.Array,         # [B] i32 — cache column of each lane's query 0
    *,
    scale: float | None = None,
    k_scale: jax.Array | None = None,   # [B, KH, C] — int8 cache scales
    v_scale: jax.Array | None = None,
    layer: jax.Array | None = None,     # i32 — with a STACKED [L, B, KH,
                                        # C, dh] cache, the layer to read
) -> jax.Array:
    """Continuation attention: query ``r`` sees cache columns
    ``c <= col0[b] + r`` that are mask-live — the visibility of
    ``Decoder.prefill_extend``. Serving-only. Returns ``[B, H, S, dh]``
    in q's dtype."""
    route.impl("attention_cached")
    _check_cache_args(q, k, k_scale, v_scale, layer)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    k, v, k_scale, v_scale = _select_layer(layer, k, v, k_scale, v_scale)
    S, C = q.shape[2], k.shape[2]
    rows = col0[:, None] + jnp.arange(S)[None, :]              # [B, S]
    vis = (jnp.arange(C)[None, None, :] <= rows[:, :, None]) \
        & (key_mask[:, None, :] > 0)                           # [B, S, C]
    ctx, _, _ = _grouped_attention(q, k, v, vis[:, None, None],
                                   float(scale), k_scale, v_scale)
    return ctx.astype(q.dtype)


def flash_attention_cached(
    q: jax.Array,            # [B, H, S, dh] — decode-step queries (S small)
    k: jax.Array,            # [B, KH, C, dh] — the full cache
    v: jax.Array,            # [B, KH, C, dh]
    key_mask: jax.Array,     # [B, C] — 1.0 = live cache column
    *,
    scale: float | None = None,
    k_scale: jax.Array | None = None,   # [B, KH, C] — int8 cache scales
    v_scale: jax.Array | None = None,
    layer: jax.Array | None = None,     # i32 — with a STACKED [L, B, KH,
                                        # C, dh] cache, the layer to read
    return_ml: bool = False,            # also return the un-normalized
                                        # softmax state (m, l) [B, H, S] f32
    fresh_k: jax.Array | None = None,   # [B, KH, 1, dh] float — the decode
                                        # step's fresh K column, not yet in
                                        # the cache, folded into the softmax
    fresh_v: jax.Array | None = None,   # [B, KH, 1, dh] float
    fresh_gate: jax.Array | None = None,  # [B] f32, 1 = lane active
) -> jax.Array:
    """Mask-only cache attention — ``Decoder.decode_step``/
    ``decode_step_slots`` visibility (the key mask alone encodes what each
    lane may see; no causal term). Serving-only. Returns ``[B, H, S, dh]``
    in q's dtype (plus (m, l) with ``return_ml``)."""
    route.impl("attention_cached")
    _check_cache_args(q, k, k_scale, v_scale, layer)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if (fresh_k is None) != (fresh_v is None):
        raise ValueError("fresh_k and fresh_v must be given together")
    if fresh_k is not None and return_ml:
        raise ValueError("fresh-column fold replaces the (m, l) path")
    fresh = None
    if fresh_k is not None:
        gate = (jnp.ones((q.shape[0],), jnp.float32) if fresh_gate is None
                else jnp.asarray(fresh_gate, jnp.float32).reshape(-1))
        fresh = (fresh_k, fresh_v, gate)
    k, v, k_scale, v_scale = _select_layer(layer, k, v, k_scale, v_scale)
    vis = key_mask[:, None, None, None, :] > 0
    ctx, m, l = _grouped_attention(q, k, v, vis, float(scale), k_scale,
                                   v_scale, fresh)
    if return_ml:
        return ctx.astype(q.dtype), m, l
    return ctx.astype(q.dtype)
