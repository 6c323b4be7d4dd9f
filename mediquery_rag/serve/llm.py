"""Continuous-batching LLM serving engine.

The reference's chat inference was Ollama (reference medical_engine.py:46)
— a daemon that queues whole requests one at a time per model. Production
LLM serving (vLLM, TGI, Ollama's own batch mode) interleaves many requests
through one decode loop so a new arrival never waits for someone else's
500-token generation to finish. This is that engine, rebuilt with static shapes:

- **Slot model.** The batch dimension is ``slots`` fixed serving lanes.
  Each lane is an independent request at its own cache position —
  ``Decoder.decode_step_slots`` (per-slot cursors) is the step primitive.
  Admission = prefill the prompt, scatter its K/V into the lane's row.
- **Chunked scheduling.** Every host round trip costs a synchronization,
  so per-token host scheduling would cap throughput regardless of model
  size. Instead the jitted program decodes ``chunk``
  steps for all lanes per dispatch (early-exiting if every lane finishes),
  and the host only schedules at chunk boundaries: admit arrivals, harvest
  EOS/overflow completions, resolve futures.
- **Static shapes everywhere.** One compiled chunk program per (slots,
  chunk); one prefill program per bucketed prompt length. Arrivals and
  departures change only the ``active`` mask — a traced VALUE, so no
  recompile, exactly the bucketing discipline of models/generate.py.
- **In-place cache.** The serving state (K/V cache + cursors + carried
  logits) is donated to both programs, so the multi-GB cache of a 7B-class
  model updates in place instead of copying every chunk.

Determinism notes:
- temperature>0 tokens depend on which chunk RNG rows the request happened
  to occupy — not reproducible across interleavings (greedy is). Same
  trade every continuous-batching server makes.
- greedy output is bit-identical to the lockstep ``Generator.generate``
  path at the same batch shape, and independent of WHO shares the batch
  (row-wise matmuls can't mix lanes). On an accelerator it may differ from
  a DIFFERENT program shape's output: bf16 products and reductions round
  differently per shape, which flips near-ties — the standard batched-vs-
  unbatched divergence every serving stack exhibits.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import Future
from dataclasses import dataclass, field
from functools import partial
from typing import NamedTuple, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from mediquery_rag.models.generate import Generator, _round_up


def _set_scale(dst, slot, src, lane=None):
    """Scatter one lane's KV-scale row into an optional [L, B, KH, C]
    scale array. None-propagating: the float path carries no scales (and
    then ``src`` is None too, never touched). ``lane`` slices a batch
    axis out of ``src`` first (prefill outputs are [L, 1, KH, C])."""
    if dst is None:
        return None
    return dst.at[:, slot].set(src if lane is None else src[:, lane])


class ServerSaturated(RuntimeError):
    """Raised by ``submit`` when the request backlog exceeds
    ``max_backlog`` — the signal the HTTP layer maps to 429. Shedding at
    admission beats queueing forever: a caller that sees saturation can
    retry against another replica; a caller stuck in an unbounded queue
    just times out with the work wasted."""


class ServeState(NamedTuple):
    """Device-resident serving state. ``logits`` carries each lane's
    next-token distribution across chunk boundaries (the token after a
    prefill comes from the prefill's own last-position logits). ``dfa``/
    ``schema`` are the per-lane grammar-constraint state: which registered
    JSON schema the lane decodes under (-1 = unconstrained) and its
    current DFA state (models/constrain.py)."""

    k: jax.Array          # [L, B, KH, C, dh] — int8 when kv_dtype="int8"
    v: jax.Array
    key_mask: jax.Array   # [B, C] f32
    cursor: jax.Array     # [B] i32 — per-slot next write column
    next_pos: jax.Array   # [B] i32 — per-slot RoPE position
    logits: jax.Array     # [B, V] f32
    dfa: jax.Array        # [B] i32 — DFA state under the lane's schema
    schema: jax.Array     # [B] i32 — registered schema index, -1 = none
    k_scale: jax.Array | None = None   # [L, B, KH, C] f32 (int8 cache)
    v_scale: jax.Array | None = None


class DraftState(NamedTuple):
    """Device-resident draft-model serving state for speculative quanta.
    No carried logits: each round's first draft consume is the target's
    free token, so the draft never needs its own next-token carry."""

    k: jax.Array          # [L, B, KH, Cd, dh]
    v: jax.Array
    key_mask: jax.Array   # [B, Cd] f32
    cursor: jax.Array     # [B] i32
    next_pos: jax.Array   # [B] i32
    k_scale: jax.Array | None = None
    v_scale: jax.Array | None = None


@dataclass
class _Request:
    prompt: str
    max_new: int
    temperature: float
    future: Future
    session: str | None = None
    schema: dict | None = None
    top_p: float = 1.0
    on_text: object = None       # streaming callback: fn(delta_text: str)
    ignore_eos: bool = False     # benchmark mode: decode past EOS to budget
    tokens: list = field(default_factory=list)
    prompt_ids: list = field(default_factory=list)  # real prefilled tokens
    streamed: int = 0            # tokens already flushed to on_text
    t_submit: float = 0.0
    t_first: float | None = None  # first token emitted (TTFT)


@dataclass
class _PendingPrefill:
    """A long admission being prefilled in pieces (chunked prefill): the
    lane stays inactive while its prompt lands ``prefill_chunk`` tokens
    per scheduler iteration, so co-tenant decode quanta interleave with
    the pieces instead of stalling behind one monolithic prefill."""

    req: _Request
    toks: list
    done: int = 0


@dataclass
class _Session:
    """Host bookkeeping for a lane-pinned chat session (the prefix cache).

    ``tokens`` mirrors a PREFIX of the lane's real cache content: prompt
    tokens + the tokens the user was actually given. The cache may hold
    more (the EOS a generation appended, overshoot past ``max_new`` inside
    a chunk) — the next turn's extension rolls the lane back to the match
    point and masks everything beyond dead, so cache-beyond-tokens is
    never visible. Columns are contiguous from ``first_col`` (left-pad
    puts the first real token at column pad_len; every extension appends
    at the cursor), so token i lives at column ``first_col + i``."""

    lane: int
    first_col: int
    tokens: list
    last_use: float


class LLMServer:
    """Continuous-batching server over a ``Generator``'s model/params.

    >>> srv = LLMServer(generator, slots=4)
    >>> fut = srv.submit("prompt", max_new_tokens=64)
    >>> text = fut.result()
    """

    def __init__(self, generator: Generator, *, slots: int = 4,
                 chunk: int = 32, cache_len: int | None = None,
                 max_wait_ms: float = 2.0, seed: int = 0,
                 draft: Generator | None = None, gamma: int = 4,
                 spec_rounds: int | None = None,
                 prefill_chunk: int = 256, max_backlog: int = 0):
        self.gen = generator
        cfg = generator.cfg
        self.model = generator.model
        self.tok = generator.tokenizer
        self.B = slots
        self.T = chunk
        self.C = cache_len or cfg.max_len
        if self.C > cfg.max_len:
            raise ValueError(f"cache_len {self.C} > model max_len {cfg.max_len}")
        self.max_wait = max_wait_ms / 1e3
        self._rng = jax.random.PRNGKey(seed)
        self._eos = int(self.tok.eos_id)
        self._pad = int(self.tok.pad_id)

        # speculative serving: a draft model turns each greedy lane's
        # scheduling quantum into propose->verify rounds (gamma+1 tokens
        # per target weight read in the best case, output still the
        # target's exact greedy continuation per lane). Lanes that need
        # sampling or grammar constraints fall back to plain quanta.
        self.draft = draft
        self.gamma = gamma
        if draft is not None:
            if draft.cfg.vocab_size != cfg.vocab_size:
                raise ValueError("draft/target vocab mismatch")
            if gamma < 1:
                raise ValueError("gamma must be >= 1")
            self.Cd = min(self.C, draft.cfg.max_len)
            self.Cd -= self.Cd % 128
            # rounds per dispatched quantum. The old default T//(gamma+1)
            # sized the quantum for BEST-case acceptance (gamma+1/round):
            # at a realistic ~2-3 accepted/round each dispatch then yields
            # fewer tokens than a plain T-token chunk, so the spec path
            # pays MORE dispatches than plain and loses end-to-end
            # wherever dispatch latency matters. Default now
            # sizes for an expected ~2/round floor (ceil(T/2) rounds —
            # dispatch-count parity with plain even at low acceptance);
            # worst case a lane advances rounds*(gamma+1) columns in one
            # quantum, so preemption granularity coarsens accordingly.
            def _fits(rounds: int) -> bool:
                return self.Cd >= _round_up(rounds * (gamma + 1) + 1,
                                            128) + 128
            if spec_rounds is not None:
                self._rounds = max(1, spec_rounds)
                if not _fits(self._rounds):
                    raise ValueError(
                        f"draft cache too small ({self.Cd}) for "
                        f"{self._rounds} rounds of gamma={gamma}")
            else:
                # default rounds, clamped to draft-cache capacity: prefer
                # ceil(T/2) (dispatch-count parity with plain chunks at
                # ~2 accepted/round), but a small draft max_len with a
                # large chunk must not make a previously-valid config
                # raise — degrade toward T//(gamma+1) and below instead.
                self._rounds = max(1, -(-self.T // 2))
                while self._rounds > 1 and not _fits(self._rounds):
                    self._rounds -= 1
                if not _fits(self._rounds):
                    raise ValueError(
                        f"draft cache too small ({self.Cd}) for even one "
                        f"round of gamma={gamma}")
        # lanes close enough to the cache end that a spec round could not
        # write its gamma+1 candidates must finish as "length"
        self._margin = (gamma + 1) if draft is not None else 1

        L, D = cfg.layers, cfg.hidden
        kvh = cfg.kv_heads or cfg.heads
        dh = D // cfg.heads
        adt = jnp.dtype(cfg.dtype)
        B, C, V = self.B, self.C, cfg.vocab_size

        kv_quant = cfg.kv_dtype == "int8"
        cdt = jnp.int8 if kv_quant else adt

        def _empty() -> ServeState:
            return ServeState(
                k=jnp.zeros((L, B, kvh, C, dh), cdt),
                v=jnp.zeros((L, B, kvh, C, dh), cdt),
                key_mask=jnp.zeros((B, C), jnp.float32),
                cursor=jnp.zeros((B,), jnp.int32),
                next_pos=jnp.zeros((B,), jnp.int32),
                logits=jnp.zeros((B, V), jnp.float32),
                dfa=jnp.zeros((B,), jnp.int32),
                schema=jnp.full((B,), -1, jnp.int32),
                k_scale=(jnp.zeros((L, B, kvh, C), jnp.float32)
                         if kv_quant else None),
                v_scale=(jnp.zeros((L, B, kvh, C), jnp.float32)
                         if kv_quant else None),
            )

        self._make_empty = jax.jit(_empty)
        self.state = self._make_empty()
        self._make_dempty = None
        self.dstate: DraftState | None = None
        if draft is not None:
            dcfg = draft.cfg
            dkvh = dcfg.kv_heads or dcfg.heads
            ddh = dcfg.hidden // dcfg.heads
            Cd = self.Cd

            dquant = dcfg.kv_dtype == "int8"
            ddt = jnp.int8 if dquant else jnp.dtype(dcfg.dtype)

            def _dempty() -> DraftState:
                return DraftState(
                    k=jnp.zeros((dcfg.layers, B, dkvh, Cd, ddh), ddt),
                    v=jnp.zeros((dcfg.layers, B, dkvh, Cd, ddh), ddt),
                    key_mask=jnp.zeros((B, Cd), jnp.float32),
                    cursor=jnp.zeros((B,), jnp.int32),
                    next_pos=jnp.zeros((B,), jnp.int32),
                    k_scale=(jnp.zeros((dcfg.layers, B, dkvh, Cd),
                                       jnp.float32) if dquant else None),
                    v_scale=(jnp.zeros((dcfg.layers, B, dkvh, Cd),
                                       jnp.float32) if dquant else None),
                )

            self._make_dempty = jax.jit(_dempty)
            self.dstate = self._make_dempty()
        self._draft_dirty = [True] * self.B
        self._dsync_cache: dict = {}
        self._spec_fn = None
        self._admit_cache: dict = {}
        self._chunk_cache: dict = {}
        # grammar constraints: registered schemas stack into one padded
        # [K, S_max, 257] device table; lanes pick theirs by index
        self._schemas: dict[str, int] = {}      # canonical json -> index
        self._constraints: list = []            # JsonConstraint, by index
        self._nt_dev = None                     # stacked next-tables
        self._tok_dev = None                    # (tok_bytes, tok_len)

        # host-side bookkeeping
        self._slots: list[_Request | None] = [None] * self.B
        self._pending: dict[int, _PendingPrefill] = {}
        self.prefill_chunk = prefill_chunk
        self.max_backlog = max_backlog
        self._queue: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self._sessions: dict[str, _Session] = {}
        self._lane_owner: list[str | None] = [None] * self.B
        self._extend_cache: dict = {}
        self._clock = 0.0          # monotone LRU tick (no wall clock needed)
        self.stats = {"requests": 0, "chunks": 0, "prefills": 0,
                      "tokens_out": 0, "extends": 0,
                      "prefix_tokens_reused": 0, "prefill_pieces": 0,
                      "spec_rounds": 0, "spec_tokens": 0, "draft_syncs": 0,
                      "cancelled": 0, "rejected": 0, "errors": 0}
        from collections import deque
        # bounded: a long-lived server must not grow per-request state
        self._lat_total: deque = deque(maxlen=8192)   # submit -> done, s
        self._lat_first: deque = deque(maxlen=8192)   # submit -> TTFT, s
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()

    # -- client API ----------------------------------------------------------

    def submit(self, prompt: str, *, max_new_tokens: int = 256,
               temperature: float = 0.0, top_p: float = 1.0,
               session: str | None = None,
               schema: dict | None = None, on_text=None,
               ignore_eos: bool = False) -> Future:
        """``session``: opaque id pinning this conversation to a lane whose
        KV cache persists between turns — the next turn with the same id
        prefills only the suffix past the longest shared token prefix
        (see ChatSession for the ergonomic wrapper). ``schema``: a
        models/constrain.py restricted JSON schema; the lane decodes under
        its compiled DFA, so the reply is valid JSON of that schema by
        construction — per lane, so constrained and free-text requests
        share one batch. ``on_text``: streaming callback ``fn(delta)``
        invoked from the scheduler thread at every chunk boundary with the
        newly decoded text (UTF-8-safe: a trailing partial byte sequence
        is held back until it completes).

        Cancellation: calling ``.cancel()`` on the returned future drops
        the request — immediately if still queued, at the next chunk
        boundary if its lane is already decoding (the lane frees for the
        backlog). Raises ``ServerSaturated`` when ``max_backlog`` > 0 and
        that many requests are already waiting for a lane.

        ``ignore_eos``: decode exactly ``max_new_tokens`` tokens, EOS or
        not (the load-benchmark contract — output length follows the
        schedule, not the model); such lanes take plain quanta, never the
        speculative program."""
        import time as _time

        if self._stop.is_set():
            raise RuntimeError(
                "LLMServer is stopped (closed or device failure)")
        if self.max_backlog and self._queue.qsize() >= self.max_backlog:
            self.stats["rejected"] += 1
            raise ServerSaturated(
                f"backlog {self._queue.qsize()} >= max_backlog "
                f"{self.max_backlog}")
        fut: Future = Future()
        self._queue.put(_Request(prompt, max_new_tokens, temperature, fut,
                                 session, schema, top_p, on_text,
                                 ignore_eos=ignore_eos,
                                 t_submit=_time.perf_counter()))
        return fut

    def complete(self, prompt: str, *, max_new_tokens: int = 256,
                 temperature: float = 0.0, top_p: float = 1.0,
                 timeout: float = 600.0,
                 session: str | None = None,
                 schema: dict | None = None) -> str:
        return self.submit(prompt, max_new_tokens=max_new_tokens,
                           temperature=temperature, top_p=top_p,
                           session=session,
                           schema=schema).result(timeout=timeout)

    def complete_batch(self, prompts: Sequence[str], **kw) -> list[str]:
        timeout = kw.pop("timeout", 600.0)
        futs = [self.submit(p, **kw) for p in prompts]
        return [f.result(timeout=timeout) for f in futs]

    def close(self) -> None:
        self._stop.set()
        self._worker.join(timeout=30.0)
        # fail whatever is still outstanding — a caller blocked on
        # .result() must see the shutdown, not a timeout
        err = RuntimeError("LLMServer closed")
        for b, req in enumerate(self._slots):
            if req is not None:
                try:
                    req.future.set_exception(err)
                except Exception:
                    pass
                self._slots[b] = None
        for slot, p in list(self._pending.items()):
            try:
                p.req.future.set_exception(err)
            except Exception:
                pass
            del self._pending[slot]
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            try:
                req.future.set_exception(err)
            except Exception:
                pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- scheduler loop ------------------------------------------------------

    def _register_schema(self, schema: dict) -> int:
        """Compile ``schema`` (models/constrain.py restricted JSON schema)
        and add it to the stacked device tables. Called on the worker
        thread only; a new schema re-stacks the tables (new shapes → the
        chunk program recompiles once)."""
        import json as _json

        from mediquery_rag.models.constrain import JsonConstraint

        key = _json.dumps(schema, sort_keys=True)
        idx = self._schemas.get(key)
        if idx is not None:
            return idx
        c = JsonConstraint.compile(schema, self.tok,
                                   vocab_size=self.gen.cfg.vocab_size)
        self._constraints.append(c)
        idx = len(self._constraints) - 1
        self._schemas[key] = idx
        s_max = max(x.next_table.shape[0] for x in self._constraints)
        stacked = np.full((len(self._constraints), s_max, 257), -1,
                          np.int32)
        for i, x in enumerate(self._constraints):
            stacked[i, : x.next_table.shape[0]] = x.next_table
        self._nt_dev = jnp.asarray(stacked)
        # token byte table: shared across schemas; cap the walk length at
        # the longest grammar (longer tokens can never be consumed anyway)
        cap = max(x.max_len_bytes for x in self._constraints)
        tb, tl = self.tok.token_byte_table(
            vocab_size=self.gen.cfg.vocab_size, max_bytes=cap)
        self._tok_dev = (jnp.asarray(tb), jnp.asarray(tl))
        return idx

    def _chunk_program(self, use_topp: bool = False):
        """The T-step decode program. Compiled per (constraint-mode,
        nucleus-mode): the vocab-parallel DFA walk and the top-p vocab
        sort only trace when a lane actually needs them, so greedy
        free-text servers never pay for either."""
        use_dfa = bool(self._constraints)
        fn = self._chunk_cache.get((use_dfa, use_topp))
        if fn is not None:
            return fn

        from mediquery_rag.models.decoder import KVCache

        model, pad_id, eos_id = self.model, self._pad, self._eos
        B, T = self.B, self.T

        def _as_kv(state: ServeState) -> KVCache:
            return KVCache(k=state.k, v=state.v, key_mask=state.key_mask,
                           cursor=state.cursor, next_pos=state.next_pos,
                           k_scale=state.k_scale, v_scale=state.v_scale)

        @partial(jax.jit, donate_argnums=(1,))
        def decode_chunk(params, state, active, keep_eos, temps, top_ps,
                         rng, nt, tok_bytes, tok_len):
            """T decode steps for all lanes; returns (state, tokens [B,T]).
            Early-exits once every active lane has emitted EOS this chunk
            (or none are active) — the remaining columns hold pad."""
            if use_dfa:
                K, s_max, n_sym = nt.shape
                nt_flat = nt.reshape(-1)

            def walk(dfa, schema):
                """models/generate.py's vocab-parallel DFA walk with a
                per-lane table: lane b's gathers index schema[b]'s stacked
                slice. Returns (allowed [B,Vt] bool, landing state [B,Vt])."""
                Vt = tok_len.shape[0]
                sidx = jnp.clip(schema, 0, None)
                base = (sidx * s_max)[:, None]               # [B, 1]
                st = jnp.broadcast_to(dfa[:, None], (B, Vt))
                ok = jnp.broadcast_to(tok_len > 0, (B, Vt))

                def step(j, carry):
                    st, ok = carry
                    act = (j < tok_len)[None, :]
                    nxt = nt_flat[(base + jnp.clip(st, 0, None)) * n_sym
                                  + tok_bytes[:, j][None, :]]
                    st2 = jnp.where(act, nxt, st)
                    return st2, ok & ((st2 >= 0) | ~act)

                st, ok = jax.lax.fori_loop(0, tok_bytes.shape[1], step,
                                           (st, ok))
                eos_ok = nt_flat[(base[:, 0] + dfa) * n_sym
                                 + (n_sym - 1)] >= 0          # [B]
                is_eos = (jnp.arange(Vt) == eos_id)[None, :]
                ok = jnp.where(is_eos, eos_ok[:, None], ok)
                # unconstrained lanes: everything goes
                ok = jnp.where((schema >= 0)[:, None], ok, True)
                return ok, st

            def pick(state, r, temps):
                logits = state.logits
                land = None
                if use_dfa:
                    allowed, land = walk(state.dfa, state.schema)
                    logits = jnp.where(allowed, logits, -1e9)
                greedy = jnp.argmax(logits, axis=-1).astype(jnp.int32)
                t = jnp.maximum(temps, 1e-6)
                warped = logits / t[:, None]
                if use_topp:
                    # nucleus: keep the smallest prefix of the sorted
                    # distribution whose mass reaches top_p (HF order:
                    # temperature first, then the nucleus cut; the top-1
                    # token is always kept)
                    srt = jnp.sort(warped, axis=-1)[:, ::-1]      # desc
                    probs = jax.nn.softmax(srt, axis=-1)
                    cum = jnp.cumsum(probs, axis=-1)
                    keep = (cum - probs) < top_ps[:, None]
                    thr = jnp.min(jnp.where(keep, srt, jnp.inf), axis=-1)
                    thr = jnp.where(top_ps >= 1.0, -jnp.inf, thr)
                    warped = jnp.where(warped >= thr[:, None],
                                       warped, -1e9)
                sampled = jax.random.categorical(r, warped).astype(
                    jnp.int32)
                return jnp.where(temps > 0.0, sampled, greedy), land

            out0 = jnp.full((B, T), pad_id, jnp.int32)
            live0 = active

            def cond(carry):
                _, _, live, t = carry
                return (t < T) & live.any()

            def body(carry):
                state, out, live, t = carry
                r = jax.random.fold_in(rng, t)
                tok, land = pick(state, r, temps)
                tok = jnp.where(live, tok, pad_id)
                out = jax.lax.dynamic_update_slice(out, tok[:, None], (0, t))
                dfa = state.dfa
                if use_dfa:
                    ns = jnp.take_along_axis(
                        land, tok[:, None], axis=1)[:, 0]
                    dfa = jnp.where(
                        live & (state.schema >= 0) & (tok != eos_id),
                        ns, dfa)
                logits, cache = model.decode_step_slots(
                    params, _as_kv(state), tok, live)
                live = live & ((tok != eos_id) | keep_eos)
                state = ServeState(cache.k, cache.v, cache.key_mask,
                                   cache.cursor, cache.next_pos, logits,
                                   dfa, state.schema,
                                   cache.k_scale, cache.v_scale)
                return state, out, live, t + 1

            state, out, _, _ = jax.lax.while_loop(
                cond, body, (state, out0, live0, jnp.int32(0)))
            return state, out

        self._chunk_cache[(use_dfa, use_topp)] = decode_chunk
        return decode_chunk

    def _spec_program(self):
        """The speculative quantum: up to ``_rounds`` propose->verify
        rounds for all lanes in ONE dispatch. Per round, the draft
        proposes gamma tokens per lane (G=1 ``extend_slots`` scan), the
        target verifies all gamma+1 candidates of every lane in one
        batched multi-column ``extend_slots``, and each lane keeps the
        prefix its target agrees with — per-lane variable advance, exactly
        the B=1 acceptance rule of models/speculative.py vectorized over
        lanes. Emitted tokens are written COMPACTLY per lane (pad tail
        only) so harvest/session bookkeeping sees the same row format as
        the plain chunk program. Greedy lanes only — the scheduler falls
        back to the plain program whenever a sampled or grammar-
        constrained lane is active."""
        if self._spec_fn is not None:
            return self._spec_fn

        from mediquery_rag.models.decoder import KVCache

        model, dmodel = self.model, self.draft.model
        pad_id, eos_id = self._pad, self._eos
        B, G, R = self.B, self.gamma + 1, self._rounds
        C, Cd = self.C, self.Cd

        def _as_kv(state: ServeState) -> KVCache:
            return KVCache(k=state.k, v=state.v, key_mask=state.key_mask,
                           cursor=state.cursor, next_pos=state.next_pos,
                           k_scale=state.k_scale, v_scale=state.v_scale)

        def _dkv(d: DraftState) -> KVCache:
            return KVCache(k=d.k, v=d.v, key_mask=d.key_mask,
                           cursor=d.cursor, next_pos=d.next_pos,
                           k_scale=d.k_scale, v_scale=d.v_scale)

        @partial(jax.jit, donate_argnums=(2, 3))
        def spec_chunk(tp, dp, state, dstate, active):
            cols = jnp.arange(C)[None, :]
            dcols = jnp.arange(Cd)[None, :]
            out0 = jnp.full((B, R * G), pad_id, jnp.int32)
            ncol0 = jnp.zeros((B,), jnp.int32)
            # entry guarantee: every active lane has room for one round
            live0 = (active & (state.cursor + G <= C)
                     & (dstate.cursor + G <= Cd))

            def cond(carry):
                _, _, _, _, live, r = carry
                return (r < R) & live.any()

            def body(carry):
                state, dstate, out, ncol, live, r = carry
                t0 = jnp.argmax(state.logits, axis=-1).astype(jnp.int32)

                # draft proposes gamma tokens; the G-th consume ingests the
                # final candidate so a fully-accepted round leaves no hole
                # in the draft cache (same invariant as models/speculative)
                dcur0, dpos0 = dstate.cursor, dstate.next_pos

                def propose(pc, _):
                    dst, tok = pc
                    dl, dkv2 = dmodel.extend_slots(
                        dp, _dkv(dst), tok[:, None], live)
                    nxt = jnp.argmax(dl[:, 0], axis=-1).astype(jnp.int32)
                    return (DraftState(dkv2.k, dkv2.v, dkv2.key_mask,
                                       dkv2.cursor, dkv2.next_pos,
                                       dkv2.k_scale, dkv2.v_scale),
                            nxt), nxt

                (dstate2, _), douts = jax.lax.scan(
                    propose, (dstate, t0), None, length=G)
                cand = jnp.concatenate(
                    [t0[:, None], douts.T[:, : G - 1]], axis=1)   # [B, G]

                # one batched target pass verifies every lane's candidates
                tcur0, tpos0 = state.cursor, state.next_pos
                tl, tkv = model.extend_slots(tp, _as_kv(state), cand, live)
                u = jnp.argmax(tl, axis=-1).astype(jnp.int32)     # [B, G]
                match = cand[:, 1:] == u[:, :-1]
                not_eos = cand != eos_id
                keep = jnp.concatenate(
                    [not_eos[:, :1], match & not_eos[:, 1:]], axis=1)
                acc = jnp.cumprod(keep.astype(jnp.int32), axis=1)
                n_acc = jnp.sum(acc, axis=1)                      # [B]
                hit_eos = (t0 == eos_id) & live

                n_emit = jnp.where(live, jnp.maximum(n_acc, 1), 0)
                emit = jnp.where(
                    jnp.arange(G)[None, :] < n_emit[:, None], cand, pad_id)
                out = jax.vmap(
                    lambda o, e, s: jax.lax.dynamic_update_slice(
                        o, e, (s,)))(out, emit, ncol)
                ncol = ncol + n_emit

                # roll both caches back to the accepted prefix: cursor =
                # old + n_acc, everything at/after it masked dead (the
                # invariant extend_slots assumes on entry)
                adv = n_acc * live.astype(jnp.int32)
                new_cur = tcur0 + adv
                km = jnp.where(cols >= new_cur[:, None],
                               0.0, tkv.key_mask)
                idx = jnp.maximum(n_acc - 1, 0)
                newlog = jnp.take_along_axis(
                    tl, idx[:, None, None], axis=1)[:, 0]         # [B, V]
                logits = jnp.where(live[:, None], newlog, state.logits)
                state = ServeState(tkv.k, tkv.v, km, new_cur,
                                   tpos0 + adv, logits,
                                   state.dfa, state.schema,
                                   tkv.k_scale, tkv.v_scale)
                dcur_new = dcur0 + adv
                dkm = jnp.where(dcols >= dcur_new[:, None],
                                0.0, dstate2.key_mask)
                dstate = DraftState(dstate2.k, dstate2.v, dkm,
                                    dcur_new, dpos0 + adv,
                                    dstate2.k_scale, dstate2.v_scale)

                live = (live & ~hit_eos & (new_cur + G <= C)
                        & (dcur_new + G <= Cd))
                return state, dstate, out, ncol, live, r + 1

            state, dstate, out, ncol, _, r = jax.lax.while_loop(
                cond, body, (state, dstate, out0, ncol0, live0,
                             jnp.int32(0)))
            return state, dstate, out, ncol, r

        self._spec_fn = spec_chunk
        return spec_chunk

    def _dsync_program(self, S: int):
        """Draft-lane (re)build program for bucketed context length S:
        prefill the draft model over the lane's recent tokens and scatter
        into its slot. The draft cache never affects OUTPUT (losslessness
        is the verify pass's property) — only acceptance rate — so lanes
        resync lazily: after plain-quantum fallbacks, admissions, session
        extensions, or when the draft's own (possibly smaller) cache runs
        out of room, in which case the context window simply slides."""
        fn = self._dsync_cache.get(S)
        if fn is not None:
            return fn
        dmodel, Cd = self.draft.model, self.Cd

        @partial(jax.jit, donate_argnums=(1,))
        def dsync(dp, dstate, ids, mask, slot):
            _, kv = dmodel.prefill(dp, ids, mask, Cd)
            return DraftState(
                k=dstate.k.at[:, slot].set(kv.k[:, 0]),
                v=dstate.v.at[:, slot].set(kv.v[:, 0]),
                key_mask=dstate.key_mask.at[slot].set(kv.key_mask[0]),
                cursor=dstate.cursor.at[slot].set(kv.cursor),
                next_pos=dstate.next_pos.at[slot].set(kv.next_pos[0]),
                k_scale=_set_scale(dstate.k_scale, slot, kv.k_scale,
                                   lane=0),
                v_scale=_set_scale(dstate.v_scale, slot, kv.v_scale,
                                   lane=0),
            )

        self._dsync_cache[S] = dsync
        return dsync

    def _sync_draft_lanes(self) -> None:
        """Bring every active lane's draft cache in line with its
        transcript (prompt + tokens so far), bucketed and windowed to the
        draft cache's spare room."""
        room = self._rounds * (self.gamma + 1)
        cap = self.Cd - _round_up(room + 1, 128)
        dcur = np.asarray(self.dstate.cursor)
        for b, req in enumerate(self._slots):
            if req is None:
                continue
            if (not self._draft_dirty[b]
                    and int(dcur[b]) + room <= self.Cd):
                continue             # clean and has room for a full quantum
            toks = (req.prompt_ids + req.tokens)[-cap:]
            W = max(len(toks), 1)
            S = _round_up(W, 128)
            ids = np.full((1, S), self._pad, np.int32)
            mask = np.zeros((1, S), np.float32)
            ids[0, S - W:] = toks if toks else [self._pad]
            mask[0, S - W:] = 1.0
            run = self._dsync_program(S)
            self.dstate = run(self.draft.params, self.dstate,
                              jnp.asarray(ids), jnp.asarray(mask),
                              jnp.int32(b))
            self._draft_dirty[b] = False
            self.stats["draft_syncs"] += 1

    def _admit_program(self, S: int):
        """Prefill-into-slot program for bucketed prompt length S (cached
        per S — arrivals at the same bucket reuse it)."""
        fn = self._admit_cache.get(S)
        if fn is not None:
            return fn
        model, C = self.model, self.C

        @partial(jax.jit, donate_argnums=(1,))
        def admit(params, state, ids, mask, slot, sch):
            logits, kv = model.prefill(params, ids, mask, C)
            return ServeState(
                k=state.k.at[:, slot].set(kv.k[:, 0]),
                v=state.v.at[:, slot].set(kv.v[:, 0]),
                key_mask=state.key_mask.at[slot].set(kv.key_mask[0]),
                cursor=state.cursor.at[slot].set(kv.cursor),
                next_pos=state.next_pos.at[slot].set(kv.next_pos[0]),
                logits=state.logits.at[slot].set(logits[0]),
                dfa=state.dfa.at[slot].set(0),
                schema=state.schema.at[slot].set(sch),
                k_scale=_set_scale(state.k_scale, slot, kv.k_scale,
                                   lane=0),
                v_scale=_set_scale(state.v_scale, slot, kv.v_scale,
                                   lane=0),
            )

        self._admit_cache[S] = admit
        return admit

    def _extend_program(self, S: int):
        """Suffix-prefill program for bucketed extension length S: rolls the
        lane back to the match point and prefills only the new tokens
        against the cached prefix (Decoder.prefill_extend)."""
        fn = self._extend_cache.get(S)
        if fn is not None:
            return fn
        model = self.model

        @partial(jax.jit, donate_argnums=(1,))
        def extend(params, state, ids, mask, slot, col0, pos0, sch):
            logits, k_row, v_row, km, ksr, vsr = model.prefill_extend(
                params, state.k[:, slot], state.v[:, slot],
                state.key_mask[slot], ids, mask, col0, pos0,
                k_scale_row=(None if state.k_scale is None
                             else state.k_scale[:, slot]),
                v_scale_row=(None if state.v_scale is None
                             else state.v_scale[:, slot]))
            n = jnp.sum(mask).astype(jnp.int32)
            return ServeState(
                k=state.k.at[:, slot].set(k_row),
                v=state.v.at[:, slot].set(v_row),
                key_mask=state.key_mask.at[slot].set(km),
                cursor=state.cursor.at[slot].set(col0 + n),
                next_pos=state.next_pos.at[slot].set(pos0 + n),
                logits=state.logits.at[slot].set(logits),
                dfa=state.dfa.at[slot].set(0),
                schema=state.schema.at[slot].set(sch),
                k_scale=_set_scale(state.k_scale, slot, ksr),
                v_scale=_set_scale(state.v_scale, slot, vsr),
            )

        self._extend_cache[S] = extend
        return extend

    def _pick_lane(self, req: _Request) -> int | None:
        """A free lane for ``req``: its own session's parked lane if
        possible, else an unowned free lane, else evict the least-recently-
        used parked session."""
        free = [b for b in range(self.B)
                if self._slots[b] is None and b not in self._pending]
        if not free:
            return None
        if req.session is not None:
            sess = self._sessions.get(req.session)
            if sess is not None and sess.lane in free:
                return sess.lane
        unowned = [b for b in free if self._lane_owner[b] is None]
        if unowned:
            return unowned[0]
        victim = min(free, key=lambda b: self._sessions[
            self._lane_owner[b]].last_use)
        self._evict(victim)
        return victim

    def _evict(self, lane: int) -> None:
        owner = self._lane_owner[lane]
        if owner is not None:
            self._sessions.pop(owner, None)
            self._lane_owner[lane] = None

    def _schema_idx(self, req: _Request) -> int:
        """Resolve (and lazily register) the request's schema; bumps the
        token budget to the grammar's exact longest path so constrained
        output can never truncate mid-JSON."""
        if req.schema is None:
            return -1
        idx = self._register_schema(req.schema)
        req.max_new = max(req.max_new,
                          self._constraints[idx].max_len_bytes)
        return idx

    def _try_admit(self, req: _Request, slot: int) -> None:
        if req.future.cancelled():
            self.stats["cancelled"] += 1   # dropped while queued: no prefill
            return
        sess = (self._sessions.get(req.session)
                if req.session is not None else None)
        if sess is not None and sess.lane == slot:
            if self._try_extend(req, sess):
                return
            self._evict(slot)    # prefix too cold / cache full: start over
        elif self._lane_owner[slot] is not None:
            self._evict(slot)    # lane reassigned to someone else

        # chunked prefill: a long prompt with co-tenants (or other pending
        # admissions) lands piece by piece so decode quanta interleave —
        # one admission must not stall everyone else's generation for its
        # whole prefill. Alone on the server, monolithic is strictly better.
        toks = self.tok.encode(req.prompt)
        busy = any(s is not None for s in self._slots) or bool(self._pending)
        if busy and len(toks) > self.prefill_chunk:
            cap = self.C - 128
            if len(toks) > cap:   # keep the tail — standard chat truncation
                toks = toks[-cap:]
            self._pending[slot] = _PendingPrefill(req, list(toks))
            return

        # left-padded one-row batch straight from ``toks`` (exactly the
        # batch_encode contract — reusing the encode above keeps the
        # tokenizer off this hot path twice more)
        S = min(_round_up(max(len(toks), 1), 128), self.tok.max_len)
        if S >= self.C:          # keep the tail — standard chat truncation
            S = _round_up(self.C - 128, 128)
        kept = toks[-S:]
        ids = np.full((1, S), self._pad, np.int32)
        mask = np.zeros((1, S), np.float32)
        if kept:
            ids[0, S - len(kept):] = kept
            mask[0, S - len(kept):] = 1.0
        run = self._admit_program(S)
        self.state = run(self.gen.params, self.state, jnp.asarray(ids),
                         jnp.asarray(mask), jnp.int32(slot),
                         jnp.int32(self._schema_idx(req)))
        req.prompt_ids = list(kept)
        self._slots[slot] = req
        self._draft_dirty[slot] = True
        self.stats["prefills"] += 1
        if req.session is not None:
            old = self._sessions.pop(req.session, None)
            if old is not None and self._lane_owner[old.lane] == req.session:
                self._lane_owner[old.lane] = None   # moved to a new lane
            self._clock += 1
            self._sessions[req.session] = _Session(
                slot, S - len(kept), list(kept), self._clock)
            self._lane_owner[slot] = req.session

    def _try_extend(self, req: _Request, sess: _Session) -> bool:
        """Admit ``req`` by prefilling only the suffix past the shared
        token prefix. False -> caller falls back to a full prefill."""
        new_toks = self.tok.encode(req.prompt)
        m = 0
        for a, b in zip(sess.tokens, new_toks):
            if a != b:
                break
            m += 1
        # always extend with >=1 token: the lane's carried logits belong to
        # its LAST cache token, not necessarily token m-1
        m = min(m, len(new_toks) - 1)
        if m < 1:
            return False
        ext = new_toks[m:]
        S = _round_up(len(ext), 128)
        col0 = sess.first_col + m
        if col0 + S >= self.C:
            return False         # no room: reset the lane via full prefill
        ids = np.full((S,), self._pad, np.int32)
        mask = np.zeros((S,), np.float32)
        ids[: len(ext)] = ext    # RIGHT-padded (prefill_extend contract)
        mask[: len(ext)] = 1.0
        run = self._extend_program(S)
        self.state = run(self.gen.params, self.state, jnp.asarray(ids),
                         jnp.asarray(mask), jnp.int32(sess.lane),
                         jnp.int32(col0), jnp.int32(m),
                         jnp.int32(self._schema_idx(req)))
        sess.tokens = list(new_toks)
        req.prompt_ids = list(new_toks)
        self._clock += 1
        sess.last_use = self._clock
        self._slots[sess.lane] = req
        self._draft_dirty[sess.lane] = True
        self.stats["extends"] += 1
        self.stats["prefix_tokens_reused"] += m
        return True

    def _advance_pending(self) -> None:
        """Land ONE prefill piece per pending admission (the suffix-prefill
        program at the lane's running column). A finished admission
        installs the request into its lane exactly like a monolithic
        prefill — same carried logits, same session bookkeeping, with the
        first real token at column 0 (right-padded pieces)."""
        for slot, p in list(self._pending.items()):
            if p.req.future.cancelled():
                del self._pending[slot]    # abandon the half-built lane
                self.stats["cancelled"] += 1
                continue
            piece = p.toks[p.done: p.done + self.prefill_chunk]
            S = _round_up(len(piece), 128)
            ids = np.full((S,), self._pad, np.int32)
            mask = np.zeros((S,), np.float32)
            ids[: len(piece)] = piece
            mask[: len(piece)] = 1.0
            run = self._extend_program(S)
            self.state = run(self.gen.params, self.state, jnp.asarray(ids),
                             jnp.asarray(mask), jnp.int32(slot),
                             jnp.int32(p.done), jnp.int32(p.done),
                             jnp.int32(self._schema_idx(p.req)))
            p.done += len(piece)
            self.stats["prefill_pieces"] += 1
            if p.done < len(p.toks):
                continue
            del self._pending[slot]
            req = p.req
            req.prompt_ids = list(p.toks)
            self._slots[slot] = req
            self._draft_dirty[slot] = True
            self.stats["prefills"] += 1
            if req.session is not None:
                old = self._sessions.pop(req.session, None)
                if (old is not None
                        and self._lane_owner[old.lane] == req.session):
                    self._lane_owner[old.lane] = None
                self._clock += 1
                self._sessions[req.session] = _Session(
                    slot, 0, list(p.toks), self._clock)
                self._lane_owner[slot] = req.session

    def _harvest(self, toks: np.ndarray, counts=None) -> None:
        """Fold one chunk's tokens into per-slot transcripts; resolve
        futures for lanes that hit EOS, their token budget, or the cache
        end. ``counts`` (spec quanta only): per-lane emitted-token count —
        spec rows are compact with a pad TAIL that is not output (a lane
        can stall on cache room mid-quantum without emitting EOS), unlike
        plain rows where pad only ever follows EOS."""
        import time as _time

        now = _time.perf_counter()
        cursors = np.asarray(self.state.cursor)
        for b, req in enumerate(self._slots):
            if req is None:
                continue
            if req.future.cancelled():
                # client gone (disconnect/timeout): free the lane for the
                # backlog at this chunk boundary; its session mirror was
                # not extended, so a parked prefix stays consistent
                self._slots[b] = None
                self.stats["cancelled"] += 1
                continue
            row = toks[b] if counts is None else toks[b][: int(counts[b])]
            # finish reason mirrors the OpenAI contract: "stop" = natural
            # EOS, "length" = token budget or cache exhaustion truncated it
            finish = None
            for t in row:
                t = int(t)
                if t == self._eos:
                    if not req.ignore_eos:
                        # a lane only goes inactive mid-chunk via EOS, so
                        # everything before the first EOS is real output
                        # (a sampled pad id is a legal token — decode()
                        # skips it)
                        finish = "stop"
                        break
                    # ignore_eos: the token counts toward the budget but
                    # is stored as PAD — decode() stops at EOS, and the
                    # stream must keep flowing past it
                    t = self._pad
                req.tokens.append(t)
                if len(req.tokens) >= req.max_new:
                    finish = "length"
                    break
            if req.tokens and req.t_first is None:
                req.t_first = now
            if req.on_text is not None:
                # decode() is prefix-stable under append (a trailing
                # partial UTF-8 sequence is dropped until completed), so
                # the char-offset delta never splits a codepoint
                full = self.tok.decode(req.tokens)
                if len(full) > req.streamed:
                    try:
                        req.on_text(full[req.streamed:])
                    except Exception:
                        pass          # a broken consumer must not kill serving
                    req.streamed = len(full)
            if finish is None and int(cursors[b]) >= self.C - self._margin:
                # cache exhausted: finish with what we have. With a draft,
                # the margin is gamma+1 — a spec round needs room for all
                # its candidates, so closer-than-that lanes cannot progress
                finish = "length"
            if finish is not None:
                self.stats["tokens_out"] += len(req.tokens)
                self._lat_total.append(now - req.t_submit)
                self._lat_first.append(
                    (req.t_first or now) - req.t_submit)
                if req.session is not None:
                    sess = self._sessions.get(req.session)
                    if sess is not None and sess.lane == b:
                        # the lane PARKS for the session: cache stays put,
                        # and its token mirror grows by what the user saw
                        # (EOS/overshoot beyond it is rolled back next turn)
                        sess.tokens.extend(req.tokens)
                        self._clock += 1
                        sess.last_use = self._clock
                req.future.finish_reason = finish   # read via getattr
                # first/last-TOKEN timestamps (scheduler clock) — unlike
                # on_text they fire even when the tokens decode to no
                # visible text (pad/noise ids), so latency measurement
                # does not depend on what the model happens to emit
                req.future.t_first_token = req.t_first
                req.future.t_done = now
                # the generated ids themselves: decode() drops ids outside
                # the text vocabulary, so token-level checks read these
                req.future.token_ids = list(req.tokens)
                try:
                    req.future.set_result(self.tok.decode(req.tokens))
                except Exception:
                    # cancelled between the check above and here — the
                    # result is simply dropped, never a dead worker thread
                    self.stats["cancelled"] += 1
                self._slots[b] = None

    def latency(self) -> dict:
        """p50/p99 request latency + time-to-first-token, seconds (over
        the last ``maxlen`` requests; same np.percentile semantics as
        obs.metrics so the two stats are comparable)."""
        def pct(xs, q):
            if not xs:
                return None
            return float(np.percentile(list(xs), q))

        return {
            "p50_s": pct(self._lat_total, 50),
            "p99_s": pct(self._lat_total, 99),
            "ttft_p50_s": pct(self._lat_first, 50),
            "ttft_p99_s": pct(self._lat_first, 99),
            "n": len(self._lat_total),
        }

    def _admit_queued(self) -> bool:
        """Drain the queue into free lanes. Returns True if anything was
        admitted."""
        admitted = False
        while any(self._slots[b] is None and b not in self._pending
                  for b in range(self.B)):
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            self.stats["requests"] += 1
            lane = self._pick_lane(req)
            self._try_admit(req, lane)
            admitted = True
        return admitted

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self._tick()
            except Exception as e:   # noqa: BLE001 — containment boundary
                self._contain_failure(e)

    def _contain_failure(self, e: Exception) -> None:
        """A dispatch failure (device OOM, runtime error, a bug) must not
        silently kill the worker and hang every outstanding future. Fail
        the in-flight requests with the error, rebuild the device state
        from scratch (the donated buffers may be half-consumed and are
        unsafe to touch), drop parked sessions (their lanes mirror that
        state), and keep serving — the next admission prefills clean."""
        self.stats["errors"] += 1
        for b, req in enumerate(self._slots):
            if req is not None:
                try:
                    req.future.set_exception(e)
                except Exception:
                    pass             # already cancelled
                self._slots[b] = None
        for slot, p in list(self._pending.items()):
            try:
                p.req.future.set_exception(e)
            except Exception:
                pass
            del self._pending[slot]
        self._sessions.clear()
        self._lane_owner = [None] * self.B
        self._draft_dirty = [True] * self.B
        try:
            self.state = self._make_empty()
            if self.draft is not None:
                self.dstate = self._make_dempty()
        except Exception:
            # the device itself is gone: stop rather than spin hot — and
            # fail the queued futures too, or their callers (and every
            # later submit) would hang against a worker that no longer runs
            self._stop.set()
            while True:
                try:
                    queued = self._queue.get_nowait()
                except queue.Empty:
                    break
                try:
                    queued.future.set_exception(e)
                except Exception:
                    pass
            raise

    def _tick(self) -> None:
        """One scheduler iteration: admissions, prefill pieces, one decode
        quantum (speculative when eligible)."""
        admitted = self._admit_queued()
        self._advance_pending()
        active_h = [r is not None for r in self._slots]
        if not any(active_h):
            if self._pending:
                return            # keep landing prefill pieces
            if not admitted:
                try:
                    req = self._queue.get(timeout=0.05)
                except queue.Empty:
                    return
                self.stats["requests"] += 1
                self._try_admit(req, self._pick_lane(req))
            return

        if self.draft is not None and all(
                r is None or (r.temperature == 0.0 and r.schema is None
                              and not r.ignore_eos)
                for r in self._slots):
            # speculative quantum: every active lane is greedy and
            # unconstrained, so the propose->verify program applies
            self._sync_draft_lanes()
            self.state, self.dstate, toks, ncol, rounds = (
                self._spec_program()(
                    self.gen.params, self.draft.params, self.state,
                    self.dstate, jnp.asarray(active_h)))
            ncol = np.asarray(ncol)
            self.stats["chunks"] += 1
            self.stats["spec_rounds"] += int(rounds)
            self.stats["spec_tokens"] += int(ncol.sum())
            self._harvest(np.asarray(toks), counts=ncol)
            return

        self._rng, sub = jax.random.split(self._rng)
        keep_eos = jnp.asarray(
            [bool(r is not None and r.ignore_eos) for r in self._slots])
        temps = jnp.asarray(
            [r.temperature if r else 0.0 for r in self._slots],
            jnp.float32)
        top_ps = jnp.asarray(
            [r.top_p if r else 1.0 for r in self._slots], jnp.float32)
        use_topp = any(r is not None and r.top_p < 1.0 and
                       r.temperature > 0.0 for r in self._slots)
        if self._nt_dev is not None:
            tables = (self._nt_dev, *self._tok_dev)
        else:
            zero = jnp.zeros((1,), jnp.int32)     # untraced placeholders
            tables = (zero[:, None, None], zero[:, None], zero)
        self.state, toks = self._chunk_program(use_topp)(
            self.gen.params, self.state,
            jnp.asarray(active_h), keep_eos, temps, top_ps, sub, *tables)
        self.stats["chunks"] += 1
        if self.draft is not None:
            # plain quanta advance target lanes past their draft
            # mirrors; resync before the next spec quantum
            for b, a in enumerate(active_h):
                if a:
                    self._draft_dirty[b] = True
        self._harvest(np.asarray(toks))


class ChatSession:
    """Multi-turn chat with transparent prefix reuse.

    Each ``ask()`` renders the FULL transcript (the stateless contract every
    ``LLMClient`` honors) but the server prefills only the suffix past the
    lane's cached token prefix — turn latency stays O(new turn), not
    O(conversation). The reference re-sent the whole history to Ollama
    every turn (structured_consultation.py follow-up replay) and paid full
    prefill each time.
    """

    def __init__(self, server: LLMServer, *, template: str = "plain",
                 system_prompt: str | None = None,
                 max_new_tokens: int = 256, temperature: float = 0.0):
        import uuid

        from mediquery_rag.llm.messages import system

        self.server = server
        self.id = uuid.uuid4().hex
        self.template = template
        self.max_new_tokens = max_new_tokens
        self.temperature = temperature
        self.messages = [system(system_prompt)] if system_prompt else []

    def ask(self, text: str, **kw) -> str:
        from mediquery_rag.llm.messages import ai, user
        from mediquery_rag.llm.device_client import _cut_turn, render_chat

        self.messages.append(user(text))
        prompt = render_chat(self.messages, template=self.template)
        out = self.server.complete(
            prompt, session=self.id,
            max_new_tokens=kw.get("max_new_tokens", self.max_new_tokens),
            temperature=kw.get("temperature", self.temperature))
        reply = _cut_turn(out, self.template)
        self.messages.append(ai(reply))
        return reply


class ServedLLMClient:
    """``LLMClient`` adapter over a shared ``LLMServer`` — many sessions,
    one device decode loop. Chat templating mirrors llm/device_client.py."""

    def __init__(self, server: LLMServer, *, max_new_tokens: int = 256,
                 temperature: float = 0.0, template: str = "plain"):
        self.server = server
        self.max_new_tokens = max_new_tokens
        self.temperature = temperature
        self.template = template

    def complete(self, messages, **kw) -> str:
        from mediquery_rag.llm.device_client import render_chat, _cut_turn

        prompt = render_chat(messages, template=self.template)
        schema = kw.get("schema")
        out = self.server.complete(
            prompt,
            max_new_tokens=kw.get("max_new_tokens", self.max_new_tokens),
            temperature=kw.get("temperature", self.temperature),
            top_p=kw.get("top_p", 1.0),
            schema=schema)
        if schema is not None:
            # grammar + EOS already terminate valid JSON; marker-cutting
            # would corrupt strings that happen to contain a marker
            return out.strip()
        return _cut_turn(out, self.template)
