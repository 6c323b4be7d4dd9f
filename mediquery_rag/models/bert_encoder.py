"""Post-LN BERT encoder — bit-faithful host for pretrained zh embeddings.

The reference embeds with ``shaw/dmeta-embedding-zh`` (a Chinese BERT
derivative) served by Ollama's GGML runtime over HTTP (reference
medical_engine.py:43, ingest_medical.py:104). The in-repo from-scratch
``Embedder`` is pre-LN (the stabler thing to train); pretrained BERT
checkpoints are post-LN with biases everywhere, token-type embeddings, and
an embedding LayerNorm — a different numerical graph. This module implements
THAT graph, accelerator-first (scan-stacked ``[L, ...]`` layers, bf16 activations
with f32 accumulation, mask-weighted mean pooling), so HF weights
imported by ``hf_import.load_bert`` reproduce the torch model's embeddings
to float tolerance (tests/test_hf_import.py::TestBertImport).
"""

from __future__ import annotations

import functools
from typing import Any

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from mediquery_rag.config import BertEmbedderConfig

BertParams = dict


def _layernorm(x, scale, bias, eps):
    xf = x.astype(jnp.float32)
    mu = xf.mean(-1, keepdims=True)
    var = ((xf - mu) ** 2).mean(-1, keepdims=True)
    y = (xf - mu) * jax.lax.rsqrt(var + eps)
    return (y * scale + bias).astype(x.dtype)


def _dense(x, w, b, adt):
    y = jnp.einsum("...d,df->...f", x, w.astype(adt),
                   preferred_element_type=jnp.float32)
    return y + b.astype(jnp.float32)


class BertEncoder:
    """Functional post-LN BERT. ``apply`` returns pooled L2-normalized
    sentence embeddings; ``hidden_states`` returns the raw [B, S, D]."""

    def __init__(self, cfg: BertEmbedderConfig = BertEmbedderConfig()):
        self.cfg = cfg
        if cfg.hidden % cfg.heads:
            raise ValueError("hidden must divide heads")

    def init(self, key: jax.Array) -> BertParams:
        c = self.cfg
        ks = jax.random.split(key, 12)
        L, D, F = c.layers, c.hidden, c.mlp_dim

        def stack(k, fan_in, shape):
            kk = jax.random.split(k, L)
            return jnp.stack([
                jax.random.normal(kk[i], shape, jnp.float32) * (fan_in ** -0.5)
                for i in range(L)])

        return {
            "tok_embed": jax.random.normal(ks[0], (c.vocab_size, D)) * 0.02,
            "pos_embed": jax.random.normal(ks[1], (c.max_len, D)) * 0.02,
            "type_embed": jax.random.normal(ks[2], (c.type_vocab, D)) * 0.02,
            "emb_ln_scale": jnp.ones((D,)),
            "emb_ln_bias": jnp.zeros((D,)),
            "blocks": {
                "qkv": stack(ks[3], D, (D, 3 * D)),
                "qkv_b": jnp.zeros((L, 3 * D)),
                "attn_out": stack(ks[4], D, (D, D)),
                "attn_out_b": jnp.zeros((L, D)),
                "ln1_scale": jnp.ones((L, D)),
                "ln1_bias": jnp.zeros((L, D)),
                "wi": stack(ks[5], D, (D, F)),
                "bi": jnp.zeros((L, F)),
                "wo": stack(ks[6], F, (F, D)),
                "bo": jnp.zeros((L, D)),
                "ln2_scale": jnp.ones((L, D)),
                "ln2_bias": jnp.zeros((L, D)),
            },
        }

    def partition_specs(self) -> Any:
        """Megatron TP layout over mesh axes ('data', 'model')."""
        return {
            "tok_embed": P(None, None),
            "pos_embed": P(None, None),
            "type_embed": P(None, None),
            "emb_ln_scale": P(None),
            "emb_ln_bias": P(None),
            "blocks": {
                "qkv": P(None, None, "model"),
                "qkv_b": P(None, "model"),
                "attn_out": P(None, "model", None),
                "attn_out_b": P(None, None),
                "ln1_scale": P(None, None),
                "ln1_bias": P(None, None),
                "wi": P(None, None, "model"),
                "bi": P(None, "model"),
                "wo": P(None, "model", None),
                "bo": P(None, None),
                "ln2_scale": P(None, None),
                "ln2_bias": P(None, None),
            },
        }

    def hidden_states(self, params, ids, mask, type_ids=None):
        """Full encoder stack -> [B, S, D] (dtype = cfg.dtype)."""
        c = self.cfg
        adt = jnp.dtype(c.dtype)
        B, S = ids.shape
        if type_ids is None:
            type_ids = jnp.zeros_like(ids)
        x = (params["tok_embed"][ids] + params["pos_embed"][:S][None]
             + params["type_embed"][type_ids])
        x = _layernorm(x, params["emb_ln_scale"], params["emb_ln_bias"],
                       c.ln_eps).astype(adt)
        attn_bias = (mask[:, None, None, :] - 1.0) * 1e9
        block_fn = functools.partial(
            _block, heads=c.heads, adt=adt, attn_bias=attn_bias, eps=c.ln_eps)
        x, _ = jax.lax.scan(
            lambda carry, lp: (block_fn(carry, lp), None), x,
            params["blocks"])
        return x

    def apply(self, params, ids, mask, type_ids=None) -> jax.Array:
        """Pooled L2-normalized [B, D] f32 sentence embeddings."""
        x = self.hidden_states(params, ids, mask, type_ids)
        if self.cfg.pooling == "cls":
            pooled = x[:, 0].astype(jnp.float32)
        else:
            m = mask[:, :, None]
            pooled = ((x * m).sum(1) / jnp.maximum(m.sum(1), 1.0)
                      ).astype(jnp.float32)
        return pooled / jnp.maximum(
            jnp.linalg.norm(pooled, axis=-1, keepdims=True), 1e-12)


def _block(x, lp, *, heads, adt, attn_bias, eps):
    B, S, D = x.shape
    dh = D // heads

    qkv = _dense(x, lp["qkv"], lp["qkv_b"], adt).astype(adt)
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

    attn = _dense(ctx, lp["attn_out"], lp["attn_out_b"], adt)
    x = _layernorm(x.astype(jnp.float32) + attn, lp["ln1_scale"],
                   lp["ln1_bias"], eps).astype(adt)

    # HF's default "gelu" is the exact erf form, not tanh-approximate
    ff = jax.nn.gelu(_dense(x, lp["wi"], lp["bi"], adt),
                     approximate=False).astype(adt)
    ff = _dense(ff, lp["wo"], lp["bo"], adt)
    return _layernorm(x.astype(jnp.float32) + ff, lp["ln2_scale"],
                      lp["ln2_bias"], eps).astype(adt)
