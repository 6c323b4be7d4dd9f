"""Import HuggingFace qwen2-class checkpoints into the on-device decoder.

Closes SURVEY §2b row 2 for real: the reference's chat capability was
qwen2.5:7b served by Ollama's GGML runtime (reference medical_engine.py:46).
The on-device decoder (models/decoder.py) implements the same architecture class
(RMSNorm/RoPE/SwiGLU/GQA with qkv biases); this module maps a safetensors
checkpoint into its pytree so the SAME pretrained weights serve on the device
— no HTTP daemon.

The safetensors container is read with a minimal in-repo reader (the format
is 8-byte little-endian header length + JSON header + raw tensor buffer):
zero-copy ``np.memmap`` slices, so a 7B checkpoint never doubles in host RAM
— each tensor is materialized once, directly at the target dtype, at the
moment it is stacked into the layer-major ``[L, ...]`` layout the decoder's
``lax.scan`` expects.

Layout mapping (HF stores Linear weights ``[out, in]``; the decoder right-
multiplies ``x @ W`` with ``[in, out]``, hence the transposes):

    model.embed_tokens.weight            -> tok_embed            [V, D]
    layers.i.input_layernorm.weight      -> blocks.rms1[i]       [D]
    layers.i.self_attn.{q,k,v}_proj      -> blocks.qkv[i]        [D, (H+2KV)*dh]
    layers.i.self_attn.{q,k,v}_proj.bias -> blocks.qkv_b[i]      [(H+2KV)*dh]
    layers.i.self_attn.o_proj            -> blocks.attn_out[i]   [D, D]
    layers.i.post_attention_layernorm    -> blocks.rms2[i]       [D]
    layers.i.mlp.{gate,up,down}_proj     -> blocks.w_{gate,up,down}[i]
    model.norm.weight                    -> rms_f                [D]
    lm_head.weight (or tied embed)       -> lm_head              [D, V]
"""

from __future__ import annotations

import glob
import json
import os

import numpy as np

from mediquery_rag.config import DecoderConfig

_DTYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16,
    "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8,
    "U8": np.uint8, "BOOL": np.bool_,
}


def _bf16():
    import ml_dtypes  # ships with jax
    return ml_dtypes.bfloat16


def read_safetensors(path: str) -> dict[str, np.ndarray]:
    """Minimal safetensors reader: {tensor name: zero-copy memmap view}."""
    with open(path, "rb") as f:
        header_len = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(header_len))
    base = 8 + header_len
    buf = np.memmap(path, dtype=np.uint8, mode="r")
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dt = (_bf16() if info["dtype"] == "BF16"
              else _DTYPES[info["dtype"]])
        s, e = info["data_offsets"]
        out[name] = buf[base + s: base + e].view(dt).reshape(info["shape"])
    return out


def _load_all_tensors(model_dir: str) -> dict[str, np.ndarray]:
    files = sorted(glob.glob(os.path.join(model_dir, "*.safetensors")))
    if not files:
        raise FileNotFoundError(f"no .safetensors files in {model_dir}")
    tensors: dict[str, np.ndarray] = {}
    for f in files:
        tensors.update(read_safetensors(f))
    return tensors


def load_qwen2(model_dir: str, *, max_len: int = 4096,
               dtype: str = "bfloat16", param_dtype: str = "bfloat16",
               kv_dtype: str = "", attn_impl: str = "flash"):
    """Read an HF qwen2/qwen2.5 (or any llama-class) checkpoint directory.

    Returns ``(DecoderConfig, params)`` ready for ``Decoder``/``Generator``.
    ``param_dtype`` defaults to bfloat16 — decode is weight-bandwidth bound
    (see Generator.to_serving_dtype), and loading straight at bf16 keeps a
    7B import at ~14 GB host RAM instead of 28.
    """
    with open(os.path.join(model_dir, "config.json"), encoding="utf-8") as f:
        hf = json.load(f)
    if hf.get("model_type") not in ("qwen2", "llama", "mistral"):
        raise ValueError(
            f"model_type {hf.get('model_type')!r} is not a qwen/llama-class "
            "decoder this importer understands")

    D = hf["hidden_size"]
    L = hf["num_hidden_layers"]
    H = hf["num_attention_heads"]
    KV = hf.get("num_key_value_heads", H)
    F = hf["intermediate_size"]
    dh = hf.get("head_dim") or D // H
    if dh != D // H:
        raise ValueError(f"head_dim {dh} != hidden/heads {D // H}: "
                         "unsupported by the fused-qkv decoder layout")

    t = _load_all_tensors(model_dir)
    # strip an optional "model."-less prefix variance defensively
    pdt = _bf16() if param_dtype == "bfloat16" else np.dtype(param_dtype)

    def W(name):  # [out, in] -> [in, out] at target dtype
        return np.asarray(t[name].T, dtype=pdt)

    def vec(name):
        return np.asarray(t[name], dtype=pdt)

    qkv_bias = f"model.layers.0.self_attn.q_proj.bias" in t

    qkv, qkv_b = [], []
    attn_out, w_gate, w_up, w_down, rms1, rms2 = [], [], [], [], [], []
    for i in range(L):
        p = f"model.layers.{i}."
        qkv.append(np.concatenate(
            [W(p + "self_attn.q_proj.weight"),
             W(p + "self_attn.k_proj.weight"),
             W(p + "self_attn.v_proj.weight")], axis=1))
        if qkv_bias:
            qkv_b.append(np.concatenate(
                [vec(p + "self_attn.q_proj.bias"),
                 vec(p + "self_attn.k_proj.bias"),
                 vec(p + "self_attn.v_proj.bias")]))
        attn_out.append(W(p + "self_attn.o_proj.weight"))
        w_gate.append(W(p + "mlp.gate_proj.weight"))
        w_up.append(W(p + "mlp.up_proj.weight"))
        w_down.append(W(p + "mlp.down_proj.weight"))
        rms1.append(vec(p + "input_layernorm.weight"))
        rms2.append(vec(p + "post_attention_layernorm.weight"))

    embed = np.asarray(t["model.embed_tokens.weight"], dtype=pdt)
    V = embed.shape[0]
    if hf.get("tie_word_embeddings") or "lm_head.weight" not in t:
        lm_head = np.asarray(embed.T)  # materialized (decoder keeps them separate)
    else:
        lm_head = W("lm_head.weight")

    blocks = {
        "rms1": np.stack(rms1), "qkv": np.stack(qkv),
        "attn_out": np.stack(attn_out), "rms2": np.stack(rms2),
        "w_gate": np.stack(w_gate), "w_up": np.stack(w_up),
        "w_down": np.stack(w_down),
    }
    if qkv_bias:
        blocks["qkv_b"] = np.stack(qkv_b)

    import jax.numpy as jnp
    params = {
        "tok_embed": jnp.asarray(embed),
        "blocks": {k: jnp.asarray(v) for k, v in blocks.items()},
        "rms_f": jnp.asarray(vec("model.norm.weight")),
        "lm_head": jnp.asarray(lm_head),
    }
    cfg = DecoderConfig(
        vocab_size=V, hidden=D, layers=L, heads=H, kv_heads=KV, mlp_dim=F,
        max_len=min(max_len, hf.get("max_position_embeddings", max_len)),
        rope_theta=float(hf.get("rope_theta", 10000.0)),
        qkv_bias=qkv_bias,
        rms_eps=float(hf.get("rms_norm_eps", 1e-6)),
        dtype=dtype, param_dtype=param_dtype, kv_dtype=kv_dtype,
        # real checkpoints serve long admissions: default to the grouped-
        # query attention ops (ops/attention.py), which read the cache at
        # its KV-head size
        attn_impl=attn_impl,
    )
    return cfg, params


def load_bert(model_dir: str, *, max_len: int | None = None,
              pooling: str = "mean", dtype: str = "bfloat16"):
    """Read an HF BERT-family checkpoint (the reference's embedding model
    shaw/dmeta-embedding-zh is a Chinese BERT derivative — reference
    medical_engine.py:43). Returns ``(BertEmbedderConfig, params)`` for
    ``models.bert_encoder.BertEncoder``.

    Layout mapping (HF Linear ``[out, in]`` -> decoder-style ``[in, out]``):

        embeddings.{word,position,token_type}_embeddings -> *_embed
        embeddings.LayerNorm                 -> emb_ln_{scale,bias}
        encoder.layer.i.attention.self.{query,key,value} -> blocks.qkv[i]
        encoder.layer.i.attention.output.dense           -> blocks.attn_out[i]
        encoder.layer.i.attention.output.LayerNorm       -> blocks.ln1_*[i]
        encoder.layer.i.intermediate.dense               -> blocks.wi/bi[i]
        encoder.layer.i.output.dense                     -> blocks.wo/bo[i]
        encoder.layer.i.output.LayerNorm                 -> blocks.ln2_*[i]
    """
    from mediquery_rag.config import BertEmbedderConfig

    with open(os.path.join(model_dir, "config.json"), encoding="utf-8") as f:
        hf = json.load(f)
    t = _load_all_tensors(model_dir)
    # BertModel saves bare names; BertFor* tasks prefix with "bert."
    prefix = "bert." if any(k.startswith("bert.") for k in t) else ""

    def g(name):
        return t[prefix + name]

    L = hf["num_hidden_layers"]

    def W(name):
        return np.asarray(g(name).T, dtype=np.float32)

    def vec(name):
        return np.asarray(g(name), dtype=np.float32)

    blocks = {k: [] for k in ("qkv", "qkv_b", "attn_out", "attn_out_b",
                              "ln1_scale", "ln1_bias", "wi", "bi", "wo",
                              "bo", "ln2_scale", "ln2_bias")}
    for i in range(L):
        p = f"encoder.layer.{i}."
        blocks["qkv"].append(np.concatenate(
            [W(p + "attention.self.query.weight"),
             W(p + "attention.self.key.weight"),
             W(p + "attention.self.value.weight")], axis=1))
        blocks["qkv_b"].append(np.concatenate(
            [vec(p + "attention.self.query.bias"),
             vec(p + "attention.self.key.bias"),
             vec(p + "attention.self.value.bias")]))
        blocks["attn_out"].append(W(p + "attention.output.dense.weight"))
        blocks["attn_out_b"].append(vec(p + "attention.output.dense.bias"))
        blocks["ln1_scale"].append(vec(p + "attention.output.LayerNorm.weight"))
        blocks["ln1_bias"].append(vec(p + "attention.output.LayerNorm.bias"))
        blocks["wi"].append(W(p + "intermediate.dense.weight"))
        blocks["bi"].append(vec(p + "intermediate.dense.bias"))
        blocks["wo"].append(W(p + "output.dense.weight"))
        blocks["bo"].append(vec(p + "output.dense.bias"))
        blocks["ln2_scale"].append(vec(p + "output.LayerNorm.weight"))
        blocks["ln2_bias"].append(vec(p + "output.LayerNorm.bias"))

    import jax.numpy as jnp
    params = {
        "tok_embed": jnp.asarray(vec("embeddings.word_embeddings.weight")),
        "pos_embed": jnp.asarray(
            vec("embeddings.position_embeddings.weight")),
        "type_embed": jnp.asarray(
            vec("embeddings.token_type_embeddings.weight")),
        "emb_ln_scale": jnp.asarray(vec("embeddings.LayerNorm.weight")),
        "emb_ln_bias": jnp.asarray(vec("embeddings.LayerNorm.bias")),
        "blocks": {k: jnp.asarray(np.stack(v)) for k, v in blocks.items()},
    }
    cfg = BertEmbedderConfig(
        vocab_size=hf["vocab_size"], hidden=hf["hidden_size"],
        layers=L, heads=hf["num_attention_heads"],
        mlp_dim=hf["intermediate_size"],
        max_len=min(max_len or hf["max_position_embeddings"],
                    hf["max_position_embeddings"]),
        type_vocab=hf.get("type_vocab_size", 2),
        ln_eps=float(hf.get("layer_norm_eps", 1e-12)),
        pooling=pooling, dtype=dtype,
    )
    return cfg, params


class BertTextEmbedder:
    """Imported-BERT counterpart of ``TextEmbedder``: tokenizer + encoder +
    params behind one ``embed()`` call, batch shapes bucketed so repeated
    calls hit the jit cache. Drop-in for the ingest pipeline / engine."""

    def __init__(self, cfg, params, tokenizer):
        import jax

        from mediquery_rag.models.bert_encoder import BertEncoder

        self.cfg = cfg
        self.model = BertEncoder(cfg)
        self.params = params
        self.tokenizer = tokenizer
        self._apply = jax.jit(self.model.apply)

    @property
    def dim(self) -> int:
        return self.cfg.hidden

    def embed(self, texts):
        import jax.numpy as jnp
        if not len(texts):
            return np.zeros((0, self.cfg.hidden), np.float32)
        ids, mask = self.tokenizer.batch_encode(list(texts))
        b = ids.shape[0]
        bp = 1
        while bp < b:
            bp *= 2
        if bp != b:
            pad_rows = np.full((bp - b, ids.shape[1]), self.tokenizer.pad_id,
                               ids.dtype)
            ids = np.concatenate([ids, pad_rows])
            mask = np.concatenate(
                [mask, np.zeros((bp - b, mask.shape[1]), mask.dtype)])
        out = self._apply(self.params, jnp.asarray(ids), jnp.asarray(mask))
        return np.asarray(out[:b])

    def __call__(self, texts):
        return self.embed(texts)

    @classmethod
    def from_hf(cls, model_dir: str, *, pooling: str = "mean",
                max_len: int | None = None) -> "BertTextEmbedder":
        from mediquery_rag.models.wordpiece_tokenizer import (
            WordPieceTokenizer)

        cfg, params = load_bert(model_dir, max_len=max_len, pooling=pooling)
        tok = WordPieceTokenizer.from_pretrained(model_dir,
                                                 max_len=cfg.max_len)
        return cls(cfg, params, tok)


def load_qwen2_generator(model_dir: str, *, max_len: int = 4096,
                         dtype: str = "bfloat16",
                         param_dtype: str = "bfloat16",
                         kv_dtype: str = "", attn_impl: str = "flash"):
    """Checkpoint dir -> ready ``Generator`` (weights + the checkpoint's own
    BPE tokenizer). The drop-in replacement for ``ChatOllama(qwen2.5:7b)``
    (reference medical_engine.py:46)."""
    from mediquery_rag.models.bpe_tokenizer import BPETokenizer
    from mediquery_rag.models.generate import Generator

    cfg, params = load_qwen2(model_dir, max_len=max_len, dtype=dtype,
                             param_dtype=param_dtype, kv_dtype=kv_dtype,
                             attn_impl=attn_impl)
    tok = BPETokenizer.from_pretrained(model_dir, max_len=cfg.max_len)
    return Generator(cfg, params=params, tokenizer=tok)
