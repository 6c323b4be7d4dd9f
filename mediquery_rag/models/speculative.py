"""Speculative decoding — breaking the B=1 weight-bandwidth wall.

Single-stream decode is bound by re-reading every weight from HBM per
token (benchmarks/decode.py: a 7B-class model's tokens/s at B=1 is its
weight-bandwidth floor). The only way past the wall is to amortize the weight
read over several tokens: a small DRAFT model proposes ``gamma`` tokens
autoregressively, then the TARGET scores all of them in ONE multi-token
pass (``Decoder.prefill_extend(all_logits=True)``) — γ+1 emitted tokens
per target weight read in the best case, with output GUARANTEED identical
to the target's own greedy decode (the acceptance rule keeps exactly the
prefix the target agrees with, then substitutes the target's own next
token).

accelerator-first design decisions:
- The ENTIRE propose→verify→accept loop lives in one jitted
  ``lax.while_loop``: a host round trip per round would cost about as
  much as the verify pass it schedules. On-device it costs two gathers
  and a cumprod per round.
- Cache management is free: ``prefill_extend`` masks everything at/after
  its write column before writing (the rollback that chat sessions use),
  so REJECTED candidate K/V from round N is killed by round N+1's write —
  no explicit eviction, no copies, static shapes throughout.
- The draft runs in the same program over its own row-format cache; its
  proposal steps are S=1 extends (same full-cache attention cost as a
  decode step).

Greedy only (temperature=0) — the reference ran qwen at temperature 0
(medical_engine.py:46); lossless rejection-sampling for temperature>0 is
a straightforward extension of the same verify pass.

Numerics note: "identical to the target's greedy decode" means the greedy
decode AS COMPUTED BY THE VERIFY PASS (a multi-token forward). On CPU f32
this is bit-identical to the one-token-at-a-time decode loop (pinned by
tests). On an accelerator, bf16 products and reductions round differently
per program shape, so a near-tie can resolve differently than the lockstep
loop — the same batched-vs-unbatched divergence every serving stack and
speculative implementation exhibits. Output is invariant to ``gamma`` and
to the draft's weights either way.

Reference seam: this accelerates the same chat completions the reference
rented from Ollama (which had no speculative path).
"""

from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from mediquery_rag.models.generate import Generator, _round_up


class SpeculativeGenerator:
    """Wraps a target + draft ``Generator`` pair. ``generate()`` emits the
    target's exact greedy continuation, faster when the draft agrees.

    The draft must share the target's tokenizer (same vocab); quality only
    affects SPEED (acceptance rate), never output content.
    """

    def __init__(self, target: Generator, draft: Generator, *,
                 gamma: int = 4):
        if target.cfg.vocab_size != draft.cfg.vocab_size:
            raise ValueError("target/draft vocab mismatch")
        if gamma < 1:
            raise ValueError("gamma must be >= 1")
        self.target = target
        self.draft = draft
        self.gamma = gamma
        self.tokenizer = target.tokenizer
        self._jit_cache: dict = {}
        self.last_stats: dict = {}

    # -- the compiled program --------------------------------------------------

    def _compiled(self, S: int, max_new: int):
        key_ = (S, max_new)
        fn = self._jit_cache.get(key_)
        if fn is not None:
            return fn

        tmodel, dmodel = self.target.model, self.draft.model
        gamma = self.gamma
        G = gamma + 1
        # The cache over-allocates up to G columns past cfg.max_len as
        # SCRATCH: a round that starts at n = max_new-1 still writes G
        # candidate columns. Kept outputs never depend on the scratch tail
        # (tokens past the budget are dropped; RoPE is computed from the
        # position scalar, not a max_len-sized table), so the emit budget
        # can match Generator.generate exactly instead of shrinking by G+1
        # near the context limit.
        C = _round_up(S + max_new + G, 128)
        eos_id = jnp.int32(self.tokenizer.eos_id)
        pad_id = jnp.int32(self.tokenizer.pad_id)
        out_len = max_new + G                    # round writes are G wide

        @jax.jit
        def run(tp, dp, ids, mask):
            t_logits, tkv = tmodel.prefill(tp, ids, mask, C)
            _, dkv = dmodel.prefill(dp, ids, mask, C)
            # row format: [L, KH, C, dh] single lane
            tk, tv, tkm = tkv.k[:, 0], tkv.v[:, 0], tkv.key_mask[0]
            dk, dv, dkm = dkv.k[:, 0], dkv.v[:, 0], dkv.key_mask[0]
            # scale ROWS for int8-KV caches (None on the float path) —
            # threaded through the while_loop like the cache rows
            tks = None if tkv.k_scale is None else tkv.k_scale[:, 0]
            tvs = None if tkv.v_scale is None else tkv.v_scale[:, 0]
            dks = None if dkv.k_scale is None else dkv.k_scale[:, 0]
            dvs = None if dkv.v_scale is None else dkv.v_scale[:, 0]
            cur = tkv.cursor                     # scalar: next write column
            pos = tkv.next_pos[0]                # scalar: next RoPE position
            ones1 = jnp.ones((1,), jnp.float32)
            onesG = jnp.ones((G,), jnp.float32)

            def cond(st):
                return (st["n"] < max_new) & ~st["done"]

            def body(st):
                t0 = jnp.argmax(st["t_logits"]).astype(jnp.int32)

                # draft proposes gamma tokens (S=1 extends over its cache;
                # the first extend's rollback also kills last round's
                # rejected draft K/V). The scan runs G=gamma+1 consumes so
                # the draft also ingests the FINAL candidate — otherwise a
                # fully-accepted round leaves a hole (an unconsumed token)
                # in the draft cache that silently degrades every later
                # proposal (losslessness would hold, throughput wouldn't).
                def propose(carry, i):
                    dk, dv, dkm, dks, dvs, tok = carry
                    dl, dk, dv, dkm, dks, dvs = dmodel.prefill_extend(
                        dp, dk, dv, dkm, tok[None], ones1,
                        st["cur"] + i, st["pos"] + i,
                        k_scale_row=dks, v_scale_row=dvs)
                    nxt = jnp.argmax(dl).astype(jnp.int32)
                    return (dk, dv, dkm, dks, dvs, nxt), nxt

                (dk, dv, dkm, dks, dvs, _), outs = jax.lax.scan(
                    propose, (st["dk"], st["dv"], st["dkm"],
                              st["dks"], st["dvs"], t0),
                    jnp.arange(G))
                cand = jnp.concatenate([t0[None], outs[:gamma]])   # [G]

                # target verifies ALL candidates in one pass (one weight
                # read); its rollback kills last round's rejected K/V
                tl, tk, tv, tkm, tks, tvs = tmodel.prefill_extend(
                    tp, st["tk"], st["tv"], st["tkm"], cand, onesG,
                    st["cur"], st["pos"], all_logits=True,
                    k_scale_row=st["tks"],
                    v_scale_row=st["tvs"])                      # [G, V]
                u = jnp.argmax(tl, axis=-1).astype(jnp.int32)   # [G]

                # accept the longest prefix of drafts the target agrees
                # with. EOS can only ever surface as a round's t0 (drafts
                # equal to EOS stop the accepted prefix right before
                # themselves, and the true EOS then arrives as the next
                # round's free token), so termination is just t0 == EOS.
                match = (cand[1:] == u[:-1])
                not_eos = (cand != eos_id)
                keep = jnp.concatenate([not_eos[:1],
                                        match & not_eos[1:]])
                acc = jnp.cumprod(keep.astype(jnp.int32))       # [G]
                n_acc = jnp.sum(acc)       # tokens emitted, 1..G (0 if t0=EOS)
                hit_eos = t0 == eos_id

                emit = jnp.where(jnp.arange(G) < jnp.maximum(n_acc, 1),
                                 cand, pad_id)
                out = jax.lax.dynamic_update_slice(st["out"], emit,
                                                   (st["n"],))
                # the target's own next-token dist AFTER the accepted
                # prefix — next round's free token / correction
                t_logits = tl[jnp.maximum(n_acc - 1, 0)]
                return {
                    "tk": tk, "tv": tv, "tkm": tkm,
                    "dk": dk, "dv": dv, "dkm": dkm,
                    "tks": tks, "tvs": tvs, "dks": dks, "dvs": dvs,
                    "cur": st["cur"] + n_acc, "pos": st["pos"] + n_acc,
                    "t_logits": t_logits, "out": out,
                    "n": st["n"] + jnp.maximum(n_acc, 1).astype(jnp.int32),
                    "done": st["done"] | hit_eos,
                    "rounds": st["rounds"] + 1,
                }

            st0 = {
                "tk": tk, "tv": tv, "tkm": tkm,
                "dk": dk, "dv": dv, "dkm": dkm,
                "tks": tks, "tvs": tvs, "dks": dks, "dvs": dvs,
                "cur": cur, "pos": pos, "t_logits": t_logits[0],
                "out": jnp.full((out_len,), pad_id, jnp.int32),
                "n": jnp.int32(0), "done": jnp.zeros((), bool),
                "rounds": jnp.int32(0),
            }
            st = jax.lax.while_loop(cond, body, st0)
            return st["out"], st["n"], st["rounds"]

        self._jit_cache[key_] = run
        return run

    # -- public API --------------------------------------------------------------

    def generate(self, prompts: Sequence[str], *,
                 max_new_tokens: int = 256) -> list[str]:
        """Greedy continuation per prompt (B=1 programs — speculation is a
        LATENCY tool; batch throughput is serve/llm.py's job)."""
        outs = []
        rounds_total, toks_total = 0, 0
        for prompt in prompts:
            ids, mask = self.tokenizer.batch_encode([prompt])
            S = ids.shape[1]
            # same budget formula as Generator.generate so the exact-match
            # contract holds all the way to the context limit
            max_new = min(_round_up(max(max_new_tokens, 1), 64),
                          self.target.cfg.max_len - S)
            if max_new <= 0:
                raise ValueError(
                    f"prompt ({S} tokens) leaves no room under "
                    f"max_len={self.target.cfg.max_len}")
            run = self._compiled(S, max_new)
            out, n, rounds = jax.device_get(      # ONE host round trip —
                run(self.target.params, self.draft.params,   # separate
                    jnp.asarray(ids), jnp.asarray(mask)))    # int()/asarray
            n = int(n)                                       # fetches cost
            toks = np.asarray(out)[:min(n, max_new_tokens)]  # a round
                                                             # trip each
            outs.append(self.tokenizer.decode(toks))
            rounds_total += int(rounds)
            toks_total += n
        self.last_stats = {
            "rounds": rounds_total, "tokens": toks_total,
            "tokens_per_round": (toks_total / rounds_total
                                 if rounds_total else 0.0),
        }
        return outs
