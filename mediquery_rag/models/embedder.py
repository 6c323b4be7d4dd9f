"""768-d text-embedding encoder — pure-JAX functional transformer.

The architecture class of ``shaw/dmeta-embedding-zh`` (a Chinese 768-d BERT
derivative, reference medical_engine.py:43) re-implemented accelerator-first:

- layers stored stacked ``[L, ...]`` and executed with ``lax.scan`` — one
  compiled block regardless of depth (fast compile, natural PP cut point);
- bf16 activations / f32 params & layernorms; matmuls run with
  f32 accumulation;
- explicit Megatron-style partition specs (``partition_specs``): qkv/wi
  column-sharded, out/wo row-sharded over the ``model`` axis, batch over
  ``data`` — XLA inserts the psums;
- optional per-layer rematerialization (``jax.checkpoint``) to trade FLOPs
  for HBM during training.

No torch, no flax module tree: params are a plain pytree, ``apply`` is a
pure function — the natural shape for pjit/shard_map composition.
"""

from __future__ import annotations

import functools
from typing import Any

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from mediquery_rag.config import EmbedderConfig

EmbedderParams = dict  # nested pytree of jnp arrays


def _init_dense(key, fan_in, shape):
    return jax.random.normal(key, shape, jnp.float32) * (fan_in ** -0.5)


class Embedder:
    """Functional embedding encoder. All methods are static given a config."""

    def __init__(self, cfg: EmbedderConfig = EmbedderConfig()):
        self.cfg = cfg
        if cfg.hidden % cfg.heads:
            raise ValueError("hidden must divide heads")

    # -- params --------------------------------------------------------------

    def init(self, key: jax.Array) -> EmbedderParams:
        c = self.cfg
        keys = jax.random.split(key, 8)
        L, D, F = c.layers, c.hidden, c.mlp_dim

        def stack(k, fan_in, shape):
            ks = jax.random.split(k, L)
            return jnp.stack([_init_dense(ks[i], fan_in, shape) for i in range(L)])

        return {
            "tok_embed": jax.random.normal(keys[0], (c.vocab_size, D), jnp.float32) * 0.02,
            "pos_embed": jax.random.normal(keys[1], (c.max_len, D), jnp.float32) * 0.02,
            "blocks": {
                "ln1_scale": jnp.ones((L, D)),
                "ln1_bias": jnp.zeros((L, D)),
                "qkv": stack(keys[2], D, (D, 3 * D)),
                "attn_out": stack(keys[3], D, (D, D)),
                "ln2_scale": jnp.ones((L, D)),
                "ln2_bias": jnp.zeros((L, D)),
                "wi": stack(keys[4], D, (D, F)),
                "bi": jnp.zeros((L, F)),
                "wo": stack(keys[5], F, (F, D)),
                "bo": jnp.zeros((L, D)),
            },
            "ln_f_scale": jnp.ones((D,)),
            "ln_f_bias": jnp.zeros((D,)),
        }

    def partition_specs(self) -> Any:
        """Megatron TP layout over mesh axes ('data', 'model')."""
        return {
            "tok_embed": P(None, None),
            "pos_embed": P(None, None),
            "blocks": {
                "ln1_scale": P(None, None),
                "ln1_bias": P(None, None),
                "qkv": P(None, None, "model"),      # column parallel
                "attn_out": P(None, "model", None),  # row parallel
                "ln2_scale": P(None, None),
                "ln2_bias": P(None, None),
                "wi": P(None, None, "model"),        # column parallel
                "bi": P(None, "model"),
                "wo": P(None, "model", None),        # row parallel
                "bo": P(None, None),
            },
            "ln_f_scale": P(None),
            "ln_f_bias": P(None),
        }

    # -- forward -------------------------------------------------------------

    def apply(
        self,
        params: EmbedderParams,
        ids: jax.Array,      # [B, S] i32
        mask: jax.Array,     # [B, S] f32
        *,
        remat: bool = False,
        dropout_rng: jax.Array | None = None,
    ) -> jax.Array:
        """Returns L2-normalized embeddings [B, hidden] f32.

        With ``dropout_rng`` and ``cfg.dropout > 0``, residual-branch
        dropout is active (training mode) — two passes over the same text
        with different rngs give the SimCSE positive pair. Inference
        (``dropout_rng=None``) is deterministic."""
        c = self.cfg
        adt = jnp.dtype(c.dtype)
        B, S = ids.shape

        x = params["tok_embed"][ids] + params["pos_embed"][:S][None]
        x = x.astype(adt)
        # additive attention bias from padding mask
        attn_bias = (mask[:, None, None, :] - 1.0) * 1e9   # [B,1,1,S] f32

        drop = c.dropout if dropout_rng is not None else 0.0
        block_fn = functools.partial(
            _block, heads=c.heads, hidden=c.hidden, adt=adt,
            attn_bias=attn_bias, drop=drop
        )
        if remat:
            block_fn = jax.checkpoint(block_fn)

        if drop > 0.0:
            layer_keys = jax.random.split(dropout_rng, c.layers)
            x, _ = jax.lax.scan(
                lambda carry, xs: (block_fn(carry, xs[0], key=xs[1]), None),
                x, (params["blocks"], layer_keys),
            )
        else:
            x, _ = jax.lax.scan(
                lambda carry, lp: (block_fn(carry, lp), None), x,
                params["blocks"]
            )

        x = _layernorm(x, params["ln_f_scale"], params["ln_f_bias"])
        m = mask[:, :, None]
        pooled = (x * m).sum(axis=1) / jnp.maximum(m.sum(axis=1), 1.0)
        pooled = pooled.astype(jnp.float32)
        return pooled / jnp.maximum(jnp.linalg.norm(pooled, axis=-1, keepdims=True), 1e-12)


def _layernorm(x, scale, bias, eps=1e-6):
    xf = x.astype(jnp.float32)
    mu = xf.mean(-1, keepdims=True)
    var = ((xf - mu) ** 2).mean(-1, keepdims=True)
    y = (xf - mu) * jax.lax.rsqrt(var + eps)
    return (y * scale + bias).astype(x.dtype)


def _dropout(x, key, rate):
    keep = 1.0 - rate
    m = jax.random.bernoulli(key, keep, x.shape)
    return jnp.where(m, x / keep, jnp.zeros_like(x))


def _block(x, lp, *, heads, hidden, adt, attn_bias, drop=0.0, key=None):
    B, S, D = x.shape
    dh = hidden // heads
    if drop > 0.0:
        k_attn, k_ff = jax.random.split(key)

    h = _layernorm(x, lp["ln1_scale"], lp["ln1_bias"])
    qkv = jnp.einsum("bsd,de->bse", h, lp["qkv"].astype(adt),
                     preferred_element_type=jnp.float32).astype(adt)
    q, k, v = jnp.split(qkv, 3, axis=-1)

    def split_heads(t):
        return t.reshape(B, S, heads, dh).transpose(0, 2, 1, 3)

    q, k, v = split_heads(q), split_heads(k), split_heads(v)
    logits = jnp.einsum("bhqd,bhkd->bhqk", q, k,
                        preferred_element_type=jnp.float32)
    logits = logits * (dh ** -0.5) + attn_bias
    w = jax.nn.softmax(logits, axis=-1).astype(adt)
    ctx = jnp.einsum("bhqk,bhkd->bhqd", w, v,
                     preferred_element_type=jnp.float32).astype(adt)
    ctx = ctx.transpose(0, 2, 1, 3).reshape(B, S, D)
    attn = jnp.einsum("bsd,de->bse", ctx, lp["attn_out"].astype(adt),
                      preferred_element_type=jnp.float32).astype(adt)
    if drop > 0.0:
        attn = _dropout(attn, k_attn, drop)
    x = x + attn

    h = _layernorm(x, lp["ln2_scale"], lp["ln2_bias"])
    ff = jnp.einsum("bsd,df->bsf", h, lp["wi"].astype(adt),
                    preferred_element_type=jnp.float32)
    ff = jax.nn.gelu(ff + lp["bi"]).astype(adt)
    ff = jnp.einsum("bsf,fd->bsd", ff, lp["wo"].astype(adt),
                    preferred_element_type=jnp.float32) + lp["bo"]
    ff = ff.astype(adt)
    if drop > 0.0:
        ff = _dropout(ff, k_ff, drop)
    return x + ff
