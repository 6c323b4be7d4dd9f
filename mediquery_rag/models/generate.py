"""Batched KV-cache generation engine for the on-device decoder.

The serving loop the reference outsourced to Ollama's C++ runtime
(medical_engine.py:46), rebuilt XLA-first:

- prefill + the whole token loop live inside ONE jitted function — the loop
  is ``lax.while_loop`` (no per-token host round trips) with early exit
  once every sequence has emitted EOS;
- static shapes throughout: prompts bucket to 128-column multiples, batch
  to powers of two, ``max_new`` to 64-multiples — repeated calls hit the
  jit cache (the same bucketing discipline as engine/flat.py);
- greedy and temperature sampling share one compiled program (temperature
  is a traced scalar; the sample/argmax choice is a ``jnp.where``);
- per-sequence EOS: finished rows keep decoding PAD into dead cache slots
  (masked, position-frozen) so the batch stays rectangular.
"""

from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from mediquery_rag.config import DecoderConfig
from mediquery_rag.models.byte_tokenizer import ByteTokenizer
from mediquery_rag.models.decoder import Decoder, KVCache


def _bucket_pow2(n: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return b


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


class Generator:
    """Owns params + jit cache. ``generate()`` is the one public call."""

    def __init__(self, cfg: DecoderConfig = DecoderConfig(), params=None,
                 key: jax.Array | None = None, tokenizer=None):
        self.cfg = cfg
        self.model = Decoder(cfg)
        if params is None:
            key = jax.random.PRNGKey(0) if key is None else key
            # one traced program instead of ~7*layers eager dispatches
            params = jax.jit(self.model.init)(key)
        # pin host (numpy) leaves to device ONCE: a numpy params tree
        # re-uploads on EVERY jitted call, dwarfing the decode itself.
        # jax.Array
        # leaves pass through untouched so sharded (TP) trees keep their
        # placement.
        self.params = jax.tree_util.tree_map(
            lambda x: x if isinstance(x, jax.Array) else jnp.asarray(x),
            params)
        # any object with batch_encode/decode + pad_id/eos_id works: the
        # in-repo ByteTokenizer (toy training) or BPETokenizer (HF imports)
        self.tokenizer = tokenizer or ByteTokenizer(cfg.max_len)
        self._jit_cache: dict = {}

    def to_serving_dtype(self, dtype=jnp.bfloat16) -> "Generator":
        """Cast weights to ``dtype`` in place (returns self). B=1 decode is
        weight-BANDWIDTH bound — every step re-reads all params from HBM —
        so serving f32 training masters wastes 2x the bytes (and tok/s).
        Cast per leaf so peak HBM is old tree + one leaf, not two trees."""
        def walk(d):
            for k2, v2 in d.items():
                if isinstance(v2, dict):
                    walk(v2)
                elif v2.dtype == jnp.float32:
                    d[k2] = v2.astype(dtype)      # old leaf freed on rebind

        walk(self.params)
        self._jit_cache.clear()
        return self

    def quantize_weights(self, bits: int = 8) -> "Generator":
        """Weight-only quantized serving (returns self): matmul weights
        become per-output-channel int8 (``bits=8``, half bf16's weight
        bytes — 7B-class in ~7 GB) or nibble-packed int4 with an AWQ-style
        activation equalizer (``bits=4``, a quarter — ~3.8 GB, the same
        4-bit tier Ollama's default qwen2.5 GGUF serves the reference at),
        streamed by the weight-only matvecs (ops/matvec.py). Converts
        leaf-by-leaf so the old leaf frees before the next converts; at 7B+
        scale prefer building quantized directly:
        ``jax.jit(lambda k: quantize_decoder_params(model.init(k), bits))``.
        Checkpoints store FLOAT params — ``save()`` before quantizing and
        re-quantize after ``from_checkpoint`` (the tree structures differ;
        ``from_checkpoint`` raises a clear count mismatch otherwise).
        """
        from mediquery_rag.ops.matvec import (quantize_weight,
                                                  quantize_weight_int4)

        if bits == 4:
            q2 = jax.jit(quantize_weight_int4)
            q3 = jax.jit(lambda w: jax.lax.map(quantize_weight_int4, w))
        elif bits == 8:
            def pair(w):
                q, s = quantize_weight(w)
                return {"q": q, "s": s}

            q2 = jax.jit(pair)
            q3 = jax.jit(lambda w: jax.lax.map(pair, w))
        else:
            raise ValueError(f"bits must be 4 or 8, got {bits}")
        blocks = self.params["blocks"]
        for k in ("qkv", "attn_out", "w_down"):
            blocks[k] = q3(blocks[k])                   # old leaf freed here
        if bits == 8:
            # gate‖up fuse into one streamed matrix (one decode dispatch +
            # one activation quantization for both; lossless at int8 —
            # see quantize_decoder_params)
            def pair_fn(p):
                q, s = quantize_weight(jnp.concatenate(p, axis=-1))
                return {"q": q, "s": s}

            blocks["w_gateup"] = jax.jit(
                lambda wg, wu: jax.lax.map(pair_fn, (wg, wu)))(
                blocks["w_gate"], blocks["w_up"])
            del blocks["w_gate"], blocks["w_up"]
        else:
            # int4 keeps the pair separate: fusing would share one
            # per-input-dim equalizer across both (measured quality cost)
            for k in ("w_gate", "w_up"):
                blocks[k] = q3(blocks[k])
        self.params["lm_head"] = q2(self.params["lm_head"])
        self._jit_cache.clear()
        return self

    # -- the compiled program ---------------------------------------------------

    def _compiled(self, B: int, S: int, max_new: int,
                  constraint_fp: str | None = None):
        key_ = (B, S, max_new, constraint_fp)
        fn = self._jit_cache.get(key_)
        if fn is not None:
            return fn
        cache_len = min(_round_up(S + max_new, 128), self.cfg.max_len)
        model = self.model
        pad_id = jnp.int32(self.tokenizer.pad_id)
        eos_id = jnp.int32(self.tokenizer.eos_id)
        constrained = constraint_fp is not None

        @jax.jit
        def run(params, ids, mask, temperature, rng, next_table,
                tok_bytes, tok_len, eos_tok):
            logits, cache = model.prefill(params, ids, mask, cache_len)
            if constrained:
                n_sym = next_table.shape[1]
                next_flat = next_table.reshape(-1)       # [S * N_SYM]

            def walk(state):
                """Advance ALL vocab tokens' byte strings through the DFA
                from each row's state: a fori_loop of [B, V] gathers —
                negligible next to the decode matmuls, and it means an HF
                model generates with its native multi-byte tokens, not
                byte-at-a-time. Returns (allowed [B, V] bool, the landing
                state per token [B, V])."""
                Bv = (state.shape[0], tok_len.shape[0])
                st = jnp.broadcast_to(state[:, None], Bv)
                ok = jnp.broadcast_to(tok_len > 0, Bv)

                def step(j, carry):
                    st, ok = carry
                    active = (j < tok_len)[None, :]              # [1, V]
                    nxt = next_flat[jnp.clip(st, 0, None) * n_sym
                                    + tok_bytes[:, j][None, :]]  # [B, V]
                    st2 = jnp.where(active, nxt, st)
                    return st2, ok & ((st2 >= 0) | ~active)

                st, ok = jax.lax.fori_loop(
                    0, tok_bytes.shape[1], step, (st, ok))
                # EOS is legal exactly where the DFA accepts
                eos_ok = next_flat[state * n_sym + (n_sym - 1)] >= 0  # [B]
                is_eos = (jnp.arange(Bv[1]) == eos_tok)[None, :]
                ok = jnp.where(is_eos, eos_ok[:, None], ok)
                return ok, st

            def pick(logits, rng, done, state):
                land = None
                if constrained:
                    allowed, land = walk(state)
                    logits = jnp.where(allowed, logits, -1e9)
                r, rng = jax.random.split(rng)
                greedy = jnp.argmax(logits, axis=-1).astype(jnp.int32)
                t = jnp.maximum(temperature, 1e-6)
                sampled = jax.random.categorical(r, logits / t).astype(jnp.int32)
                tok = jnp.where(temperature > 0.0, sampled, greedy)
                return jnp.where(done, pad_id, tok), rng, land

            def cond(st):
                done, t = st[3], st[4]
                return (t < max_new) & ~done.all()

            def body(st):
                cache, out, rng, done, t, logits, state = st
                tok, rng, land = pick(logits, rng, done, state)
                out = jax.lax.dynamic_update_slice(out, tok[:, None], (0, t))
                if constrained:
                    ns = jnp.take_along_axis(
                        land, tok[:, None], axis=1)[:, 0]   # [B]
                    state = jnp.where(done | (tok == eos_id), state, ns)
                done = done | (tok == eos_id)
                logits, cache = model.decode_step(params, cache, tok)
                return cache, out, rng, done, t + 1, logits, state

            out0 = jnp.full((B, max_new), pad_id, jnp.int32)
            done0 = jnp.zeros((B,), bool)
            state0 = jnp.zeros((B,), jnp.int32)
            st = jax.lax.while_loop(
                cond, body,
                (cache, out0, rng, done0, jnp.int32(0), logits, state0))
            return st[1]

        self._jit_cache[key_] = run
        return run

    # -- public API ---------------------------------------------------------------

    def generate(
        self,
        prompts: Sequence[str],
        *,
        max_new_tokens: int = 256,
        temperature: float = 0.0,
        seed: int = 0,
        constraint=None,
    ) -> list[str]:
        """Decode continuations for a batch of prompts. Greedy when
        ``temperature == 0`` (the reference ran qwen at temperature=0,
        medical_engine.py:46). ``constraint`` is a compiled
        ``models.constrain.JsonConstraint``: each step's logits are masked
        to the grammar's allowed next bytes, so the continuation is valid
        JSON of the schema by construction (truncation at the token budget
        is the one residual failure; size ``max_new_tokens`` generously)."""
        if not prompts:
            return []
        ids, mask = self.tokenizer.batch_encode(list(prompts))
        B, S = ids.shape
        want = max(max_new_tokens, 1)
        if constraint is not None:
            # the grammar is finite, so its longest accepting path (incl.
            # the EOS step) is exact — budget for it and truncation cannot
            # happen: "valid by construction" holds literally
            want = max(want, constraint.max_len_bytes)
        max_new = min(_round_up(want, 64), self.cfg.max_len - S)
        if max_new <= 0:
            raise ValueError(
                f"prompt ({S} tokens after bucketing) leaves no room for "
                f"generation under max_len={self.cfg.max_len}")
        Bp = _bucket_pow2(B)
        if Bp != B:
            ids = np.pad(ids, ((0, Bp - B), (0, 0)))
            mask = np.pad(mask, ((0, Bp - B), (0, 0)))
        if constraint is not None:
            if constraint.tok_len.shape[0] != self.cfg.vocab_size:
                raise ValueError(
                    f"constraint compiled for vocab "
                    f"{constraint.tok_len.shape[0]}, model has "
                    f"{self.cfg.vocab_size}")
            run = self._compiled(Bp, S, max_new, constraint.fingerprint)
            tables = (jnp.asarray(constraint.next_table),
                      jnp.asarray(constraint.tok_bytes),
                      jnp.asarray(constraint.tok_len),
                      jnp.int32(constraint.eos_id))
        else:
            run = self._compiled(Bp, S, max_new)
            zero = jnp.zeros((1,), jnp.int32)    # unused traced placeholders
            tables = (zero, zero[:, None], zero, jnp.int32(0))
        out = run(self.params, jnp.asarray(ids), jnp.asarray(mask),
                  jnp.float32(temperature), jax.random.PRNGKey(seed),
                  *tables)
        # constrained JSON must not be cut mid-grammar by the user's cap —
        # keep everything up to the bucketed budget (EOS already gates it)
        limit = max_new if constraint is not None else max_new_tokens
        out = np.asarray(out[:B, :limit])
        return [self.tokenizer.decode(row) for row in out]

    def generate_tokens(
        self,
        prompts: Sequence[str],
        *,
        max_new_tokens: int = 256,
        temperature: float = 0.0,
        seed: int = 0,
    ) -> list[list[int]]:
        """Like ``generate`` but returns the RAW token ids per prompt (cut
        at the first EOS, inclusive; trailing pads stripped). Token-level
        output matters when the stream itself is the artifact — draft
        distillation (models/distill.py) must imitate the target's exact
        token sequence, and re-encoding decoded text loses it: byte-level
        decode drops out-of-range ids, and BPE re-tokenization can drift at
        merge boundaries."""
        if not prompts:
            return []
        ids, mask = self.tokenizer.batch_encode(list(prompts))
        B, S = ids.shape
        max_new = min(_round_up(max(max_new_tokens, 1), 64),
                      self.cfg.max_len - S)
        if max_new <= 0:
            raise ValueError(
                f"prompt ({S} tokens after bucketing) leaves no room for "
                f"generation under max_len={self.cfg.max_len}")
        Bp = _bucket_pow2(B)
        if Bp != B:
            ids = np.pad(ids, ((0, Bp - B), (0, 0)))
            mask = np.pad(mask, ((0, Bp - B), (0, 0)))
        run = self._compiled(Bp, S, max_new)
        zero = jnp.zeros((1,), jnp.int32)
        out = run(self.params, jnp.asarray(ids), jnp.asarray(mask),
                  jnp.float32(temperature), jax.random.PRNGKey(seed),
                  zero, zero[:, None], zero, jnp.int32(0))
        out = np.asarray(out[:B, :max_new_tokens])
        eos = int(self.tokenizer.eos_id)
        rows = []
        for row in out:
            toks = []
            for t in row:
                toks.append(int(t))
                if int(t) == eos:
                    break
            rows.append(toks)
        return rows

    # -- checkpointing (np.savez convention, as TextEmbedder/CrossEncoder) --------

    def save(self, path: str) -> None:
        import json
        import os

        os.makedirs(path, exist_ok=True)
        flat, _ = jax.tree_util.tree_flatten(self.params)
        np.savez(os.path.join(path, "params.npz"),
                 **{str(i): np.asarray(x) for i, x in enumerate(flat)})
        with open(os.path.join(path, "config.json"), "w") as f:
            json.dump(self.cfg.__dict__, f)

    @classmethod
    def from_checkpoint(cls, path: str) -> "Generator":
        import json
        import os

        with open(os.path.join(path, "config.json")) as f:
            cfg = DecoderConfig(**json.load(f))
        gen = cls(cfg)
        z = np.load(os.path.join(path, "params.npz"))
        flat, treedef = jax.tree_util.tree_flatten(gen.params)
        if len(z.files) != len(flat):
            raise ValueError(
                f"checkpoint at {path} has {len(z.files)} arrays but this "
                f"architecture has {len(flat)}")
        gen.params = jax.tree_util.tree_unflatten(
            treedef, [jnp.asarray(z[str(i)]) for i in range(len(flat))])
        return gen
