#!/usr/bin/env python3
"""Drive the RAG serving path once on a CUDA GPU, at full width, and check it.

    python chip_smoke.py                 # one GPU: phases A, B, C
    python chip_smoke.py --four-cards    # four GPUs: the sharded index only

Phase A — retrieval engine at deployment size: a 10M x 768 corpus of unit
vectors generated on the card from ``--seed``; bf16 flat (the default),
int8 flat + rerank, int4 flat + rerank and int8 IVF, each built through the
public index API, searched with 64 queries (k=10) and compared with an
exact float32 top-k that regenerates the rows chunk by chunk.
Phase B — the 768-wide BERT encoder (``BertEmbedderConfig``) on 64 x 128
tokens, against the same forward pass in float32 at precision "highest".
Phase C — a Qwen2.5-7B-shaped decoder (seeded bf16 weights, then int8
weight-only) behind the HTTP server wiring of ``python -m
mediquery_rag.serve``: chat completions, /qa and /search over HTTP; greedy
completions checked against lockstep ``Generator.generate``.
Phase D (``--four-cards``) — ``ShardedFlatIndex`` (bf16) and
``ShardedIVFIndex`` (int8) over 40M x 768 rows on a 4-device mesh.

Each phase prints one JSON line (compile seconds, peak device memory, the
route every op took, each check with its tolerance). The last line is
``{"ok": true, "device": {...}}`` and is printed only when every check
passed. Without a GPU the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

QWEN25_7B = dict(                 # Qwen/Qwen2.5-7B config.json
    hidden=3584, layers=28, heads=28, kv_heads=4, mlp_dim=18944,
    vocab_size=152064, rope_theta=1e6, rms_eps=1e-6, qkv_bias=True,
    max_position_embeddings=131072, tie_word_embeddings=False,
    hidden_act="silu", sliding_window=None)
MAX_LEN = 4096                    # cut: cache length (published 131072)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


# -- measurement helpers ------------------------------------------------------

class CompileMeter:
    """Backend compile seconds and persistent-cache hits, from JAX's own
    monitoring events (one listener for the whole process)."""

    def __init__(self):
        import jax
        from jax._src import dispatch
        self.seconds = 0.0
        self.count = 0
        self.cache_hits = 0
        self.cache_misses = 0
        event = dispatch.BACKEND_COMPILE_EVENT

        def on_duration(name, secs, **_):
            if name == event:
                self.seconds += secs
                self.count += 1

        def on_event(name, **_):
            if name == "/jax/compilation_cache/cache_hits":
                self.cache_hits += 1
            elif name == "/jax/compilation_cache/cache_misses":
                self.cache_misses += 1

        jax.monitoring.register_event_duration_secs_listener(on_duration)
        jax.monitoring.register_event_listener(on_event)

    def snapshot(self):
        return (self.seconds, self.count, self.cache_hits, self.cache_misses)

    def since(self, snap) -> dict:
        s, c, h, m = snap
        return {"compile_s": round(self.seconds - s, 3),
                "compiles": self.count - c,
                "cache_hits": self.cache_hits - h,
                "cache_misses": self.cache_misses - m}


def memory(devices=None) -> dict:
    import jax
    out = {}
    for d in devices or jax.local_devices()[:1]:
        st = d.memory_stats() or {}
        out[str(d.id)] = {"peak_bytes_in_use": st.get("peak_bytes_in_use"),
                          "bytes_in_use": st.get("bytes_in_use")}
    return out


def free_device_memory() -> None:
    gc.collect()


def recall_at_k(got_ids, ref_ids) -> float:
    import numpy as np
    got_ids, ref_ids = np.asarray(got_ids), np.asarray(ref_ids)
    hits = [len(set(g.tolist()) & set(r.tolist())) / len(r)
            for g, r in zip(got_ids, ref_ids)]
    return float(np.mean(hits))


def check(name: str, value: float, bound: float, op: str) -> dict:
    ok = value >= bound if op == ">=" else value <= bound
    return {"name": name, "value": value, "bound": bound, "op": op,
            "ok": bool(ok)}


def median_seconds(fn, *args, reps: int = 5) -> float:
    """Median wall time of ``fn(*args)`` ending in block_until_ready,
    after one warm-up call."""
    import jax
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return sorted(ts)[len(ts) // 2]


def compare_block_topk(queries, corpus, n_valid: int, k: int,
                       tile: int) -> tuple[dict, list]:
    """The top-k selection of a flat search as the route runs it
    (``masked_topk``: the Triton block top-k kernel on the GPU) against
    the plain two-stage ``lax.top_k``, on ONE score array, so both see the
    same bits: ids and scores must be identical. Also times the whole
    search (matmul + selection) each way."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from mediquery_rag.ops.scoring import scores_xt
    from mediquery_rag.ops.topk import masked_topk, two_stage_topk

    def plain_topk(s, nv):
        col = jax.lax.broadcasted_iota(jnp.int32, s.shape, 1)
        return two_stage_topk(jnp.where(col < nv, s, -jnp.inf), k, tile)

    routed = jax.jit(lambda s, nv: masked_topk(s, nv, k, tile))
    plain = jax.jit(plain_topk)
    nv = jnp.int32(n_valid)
    scores = jax.jit(scores_xt)(queries, corpus)
    (v1, i1), (v2, i2) = jax.device_get((routed(scores, nv),
                                         plain(scores, nv)))
    times = {
        "search_routed_s": median_seconds(jax.jit(
            lambda q, c, nv: masked_topk(scores_xt(q, c), nv, k, tile)),
            queries, corpus, nv),
        "search_plain_xla_s": median_seconds(jax.jit(
            lambda q, c, nv: plain_topk(scores_xt(q, c), nv)),
            queries, corpus, nv),
    }
    del scores
    checks = [check("block_topk_ids_equal_plain",
                    float(np.array_equal(i1, i2)), 1.0, ">="),
              check("block_topk_scores_equal_plain",
                    float(np.array_equal(v1, v2)), 1.0, ">=")]
    return times, checks


def compare_quant_matvec(params, *, rows=(1, 4, 16, 32, 256), seed=0):
    """The int8 weight-only matvec as the route runs it (the Triton
    kernel on the GPU up to 32 rows, XLA above) and XLA's
    dequantize-into-dot, each against the exact product computed in
    float32 at precision "highest", on the model's own quantized matrices
    (first and last layer, and the LM head).

    The products bf16 x int8 are exact in f32 (8 + 8 significand bits),
    so a route may differ from the exact sum only by the order of its f32
    sums. Any order of a D-term f32 sum is within (D-1) 2^-24 sum|terms|
    of the exact sum, so the bound is |route - exact| <= 2 D 2^-24
    max(sum_d |x_d w_fd| s_f).
    """
    import jax
    import jax.numpy as jnp
    import numpy as np

    from mediquery_rag.ops.matvec import quant_matvec

    key = jax.random.PRNGKey(seed)
    blocks = params["blocks"]
    mats = [(n, blocks[n]["q"], blocks[n]["s"], l)
            for n in ("qkv", "attn_out", "w_gateup", "w_down")
            if n in blocks
            for l in (0, blocks[n]["q"].shape[0] - 1)]
    mats.append(("lm_head", params["lm_head"]["q"],
                 params["lm_head"]["s"], None))
    worst, checks = {}, []
    for name, q, s, layer in mats:
        d = q.shape[-1]
        for r in rows:
            x = jax.random.normal(jax.random.fold_in(key, r), (r, d),
                                  jnp.bfloat16)
            ql = q if layer is None else q[layer]
            sl = s if layer is None else s[layer]
            with jax.default_matmul_precision("highest"):
                exact = (x.astype(jnp.float32) @ ql.astype(jnp.float32).T
                         ) * sl[None, :]
                mag = (jnp.abs(x).astype(jnp.float32)
                       @ jnp.abs(ql).astype(jnp.float32).T) * sl[None, :]
            tag = f"{name}" + ("" if layer is None else f"[{layer}]")
            for impl in (None, "xla"):
                got = quant_matvec(x, q, s, layer=layer, impl=impl)
                err = float(jnp.max(jnp.abs(got - exact)) / jnp.max(mag))
                how = impl or "routed"
                worst[f"{tag}x{r}_{how}"] = err
                checks.append(check(f"matvec_rel_err_{tag}_rows{r}_{how}",
                                    err, 2 * d * 2.0 ** -24, "<="))
    del mats
    return worst, checks


# -- synthetic corpus ---------------------------------------------------------

class Corpus:
    """Clustered unit vectors, regenerable chunk by chunk from a seed.

    Two levels, as an embedding corpus has: ``rows // 10000`` topic
    directions; ``rows // per_center`` document clusters, each centered at
    normalize(topic + tau * noise); row r = normalize(center[a_r] +
    sigma * noise_r) stored in bf16, with ``a_r`` uniform over clusters.
    Queries are normalized noisy copies of random cluster centers, so each
    query's true top-k sits in its cluster, inside its topic. The corpus IS
    the bf16 rows; the exact reference scores their float32 upcast.
    """

    def __init__(self, rows: int, dim: int, seed: int, *, chunk: int,
                 per_center: int = 20, sigma: float = 1.0,
                 tau: float = 1.0):
        import jax
        import jax.numpy as jnp
        self.rows, self.dim, self.chunk = rows, dim, chunk
        self.sigma = sigma
        self.n_centers = max(1, rows // per_center)
        n_topics = max(1, rows // 10_000)
        key = jax.random.PRNGKey(seed)
        self.key_rows, k_t, k_a, k_c, self.key_q = jax.random.split(key, 5)
        t = jax.random.normal(k_t, (n_topics, dim), jnp.float32)
        t = t / jnp.linalg.norm(t, axis=-1, keepdims=True)
        a = jax.random.randint(k_a, (self.n_centers,), 0, n_topics)
        c = t[a] + tau * jax.random.normal(
            k_c, (self.n_centers, dim), jnp.float32) * (dim ** -0.5)
        self.centers = c / jnp.linalg.norm(c, axis=-1, keepdims=True)
        self.n_chunks = -(-rows // chunk)
        self._gen = jax.jit(self._gen_chunk)

    def _gen_chunk(self, centers, idx):
        import jax
        import jax.numpy as jnp
        k = jax.random.fold_in(self.key_rows, idx)
        ka, kn = jax.random.split(k)
        a = jax.random.randint(ka, (self.chunk,), 0, self.n_centers)
        noise = jax.random.normal(kn, (self.chunk, self.dim), jnp.float32)
        x = centers[a] + self.sigma * noise * (self.dim ** -0.5)
        x = x / jnp.linalg.norm(x, axis=-1, keepdims=True)
        return x.astype(jnp.bfloat16)

    def chunk_rows(self, c: int) -> int:
        return min(self.chunk, self.rows - c * self.chunk)

    def gen(self, c: int, device=None):
        """Chunk ``c`` ([chunk, D] bf16; the tail chunk's extra rows are
        beyond ``rows`` and ignored by callers)."""
        import jax
        centers = self.centers
        if device is not None:
            centers = jax.device_put(centers, device)
        return self._gen(centers, c)

    def chunks(self):
        for c in range(self.n_chunks):
            x = self.gen(c)
            m = self.chunk_rows(c)
            yield x if m == self.chunk else x[:m]

    def queries(self, b: int):
        import jax
        import jax.numpy as jnp
        ka, kn = jax.random.split(self.key_q)
        a = jax.random.randint(ka, (b,), 0, self.n_centers)
        x = self.centers[a] + self.sigma * jax.random.normal(
            kn, (b, self.dim)) * (self.dim ** -0.5)
        return x / jnp.linalg.norm(x, axis=-1, keepdims=True)

    def materialize(self, device=None, row0: int = 0, rows: int | None = None):
        """Rows ``[row0, row0+rows)`` as one bf16 array, filled chunk by
        chunk in place (``row0`` and ``rows`` are chunk multiples)."""
        import functools

        import jax
        import jax.numpy as jnp
        rows = self.rows - row0 if rows is None else rows
        n_c = -(-rows // self.chunk)
        buf = jnp.zeros((n_c * self.chunk, self.dim), jnp.bfloat16,
                        device=device)

        @functools.partial(jax.jit, donate_argnums=(0,))
        def put(buf, x, i):
            return jax.lax.dynamic_update_slice(buf, x, (i * self.chunk, 0))

        for i in range(n_c):
            buf = put(buf, self.gen(row0 // self.chunk + i, device), i)
        if buf.shape[0] != rows:
            buf = buf[:rows]
        return buf

    def exact_topk(self, q, k: int, device=None):
        """float32 top-k over all rows at precision "highest", keeping a
        running top-k — no f32 copy of the corpus is ever held."""
        import jax
        import jax.numpy as jnp

        @jax.jit
        def step(centers, q, run_s, run_i, c):
            x = self._gen_chunk(centers, c).astype(jnp.float32)
            x = x / jnp.linalg.norm(x, axis=-1, keepdims=True)
            with jax.default_matmul_precision("highest"):
                s = q @ x.T
            col = c * self.chunk + jnp.arange(self.chunk)
            s = jnp.where(col[None, :] < self.rows, s, -jnp.inf)
            s2 = jnp.concatenate([run_s, s], axis=1)
            i2 = jnp.concatenate(
                [run_i, jnp.broadcast_to(col, s.shape).astype(jnp.int32)],
                axis=1)
            v, p = jax.lax.top_k(s2, k)
            return v, jnp.take_along_axis(i2, p, axis=1)

        centers = self.centers if device is None else jax.device_put(
            self.centers, device)
        q = q.astype(jnp.float32)
        if device is not None:
            q = jax.device_put(q, device)
        b = q.shape[0]
        run_s = jnp.full((b, k), -jnp.inf, jnp.float32)
        run_i = jnp.zeros((b, k), jnp.int32)
        if device is not None:
            run_s, run_i = jax.device_put((run_s, run_i), device)
        for c in range(self.n_chunks):
            run_s, run_i = step(centers, q, run_s, run_i, c)
        return jax.device_get((run_s, run_i))


# -- phase A: retrieval engine ------------------------------------------------

def phase_a(meter, *, rows=10_000_000, dim=768, batch=64, k=10, seed=0,
            chunk=62_500, nlist=4096, nprobe=32, corpus_tile=2048,
            kinds=("bf16_flat", "int8_flat", "int4_flat", "int8_ivf")):
    """Build and search each index kind; yields one result dict per kind."""
    import jax
    import numpy as np

    from mediquery_rag.config import EngineConfig
    from mediquery_rag.engine import FlatIndex, IVFIndex
    from mediquery_rag.ops import route

    corpus = Corpus(rows, dim, seed, chunk=chunk)
    q = corpus.queries(batch)
    t0 = time.perf_counter()
    ref_s, ref_i = corpus.exact_topk(q, k)
    ref_seconds = time.perf_counter() - t0
    qn = np.asarray(q)
    bounds = {"bf16_flat": 0.99, "int8_flat": 0.99, "int4_flat": 0.98,
              "int8_ivf": 0.95}
    for kind in kinds:
        snap = meter.snapshot()
        t0 = time.perf_counter()
        if kind == "int8_ivf":
            cfg = EngineConfig(dim=dim, dtype="int8", index_kind="ivf",
                               ivf_nlist=nlist, ivf_nprobe=nprobe,
                               top_k=k)
            index = IVFIndex.build_streaming(
                corpus.chunks, rows, cfg, key=jax.random.PRNGKey(seed),
                chunk_rows=chunk)
            ops = ["ivf_probe_search"]
        else:
            dtype = {"bf16_flat": "bfloat16", "int8_flat": "int8",
                     "int4_flat": "int4"}[kind]
            cfg = EngineConfig(dim=dim, dtype=dtype, top_k=k,
                               corpus_tile=corpus_tile,
                               rerank_factor=0 if dtype == "bfloat16" else 4)
            vectors = corpus.materialize()
            index = FlatIndex.build(vectors, cfg)
            del vectors
            ops = [{"bfloat16": "flat_search", "int8": "int8_flat_search",
                    "int4": "int4_flat_search"}[dtype], "block_topk"]
        jax.block_until_ready(index.buckets if kind == "int8_ivf"
                              else index.corpus)
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        s, i = index.search(qn, k=k)
        s, i = jax.device_get((s, i))
        first_search_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        jax.block_until_ready(index.search(qn, k=k))
        search_s = time.perf_counter() - t0
        checks = [check("recall@10", recall_at_k(i, ref_i), bounds[kind],
                        ">=")]
        kernel_times = None
        if kind == "bf16_flat":
            kernel_times, kchecks = compare_block_topk(
                jax.numpy.asarray(qn), index.corpus, index.n, k,
                corpus_tile)
            checks += kchecks
            # bf16 rounding of 768-d unit vectors (rel. 2^-9 per element,
            # f32 accumulation): score error ~1e-4; bound with margin
            ref_map = [dict(zip(r_i.tolist(), r_s.tolist()))
                       for r_i, r_s in zip(ref_i, ref_s)]
            err = max(abs(float(sv) - ref_map[r][int(iv)])
                      for r in range(len(ref_map))
                      for sv, iv in zip(s[r], i[r]) if int(iv) in ref_map[r])
            checks.append(check("max_abs_score_error", err, 2e-2, "<="))
        result = {
            "phase": f"A.{kind}", "rows": rows, "dim": dim, "batch": batch,
            "k": k, "routes": {op: route.impl(op) for op in ops},
            "index_bytes": index.nbytes, "build_s": round(build_s, 3),
            "first_search_s": round(first_search_s, 3),
            "search_s": round(search_s, 6),
            "reference_s": round(ref_seconds, 3),
            **meter.since(snap), "memory": memory(), "checks": checks,
        }
        if kernel_times:
            result["block_topk_vs_plain"] = kernel_times
        if kind == "int8_ivf":
            result.update(nlist=int(index.centroids.shape[0]),
                          nprobe=nprobe, cap=index.cap)
        del index
        free_device_memory()
        yield result


# -- phase B: the 768-wide encoder ---------------------------------------------

def _wordpiece_vocab(size: int) -> dict:
    """A BERT-Chinese-shaped vocab of ``size`` entries: the five specials
    then single CJK characters (WordPiece splits CJK per character)."""
    specials = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    vocab = {t: i for i, t in enumerate(specials)}
    cp = 0x4E00
    while len(vocab) < size:
        vocab[chr(cp)] = len(vocab)
        cp += 1
    return vocab


def phase_b(meter, *, batch=64, seq=128, seed=0, cfg_kw=None):
    import dataclasses

    import jax
    import numpy as np

    from mediquery_rag.config import BertEmbedderConfig
    from mediquery_rag.models.bert_encoder import BertEncoder
    from mediquery_rag.models.hf_import import BertTextEmbedder
    from mediquery_rag.models.wordpiece_tokenizer import WordPieceTokenizer
    from mediquery_rag.ops import route

    cfg = BertEmbedderConfig(**(cfg_kw or {}))
    vocab = _wordpiece_vocab(cfg.vocab_size)
    tok = WordPieceTokenizer(vocab, max_len=seq)
    snap = meter.snapshot()
    params = jax.jit(BertEncoder(cfg).init)(jax.random.PRNGKey(seed))
    emb = BertTextEmbedder(cfg, params, tok)
    rng = np.random.default_rng(seed)
    chars = list(vocab)[5:]
    texts = ["".join(rng.choice(chars, seq - 2)) for _ in range(batch)]
    ids, _ = tok.batch_encode(texts)
    t0 = time.perf_counter()
    got = emb.embed(texts)
    embed_s = time.perf_counter() - t0
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = jax.tree_util.tree_map(lambda a: a.astype("float32"), params)
    with jax.default_matmul_precision("highest"):
        ref = BertTextEmbedder(cfg32, p32, tok).embed(texts)
    cos = np.sum(got * ref, axis=1) / (
        np.linalg.norm(got, axis=1) * np.linalg.norm(ref, axis=1))
    shape_ok = got.shape == (batch, cfg.hidden) and bool(
        np.isfinite(got).all())
    result = {
        "phase": "B.bert_encoder", "layers": cfg.layers,
        "hidden": cfg.hidden, "vocab": cfg.vocab_size, "batch": batch,
        "tokens_per_query": int(ids.shape[1]),
        "routes": {"matmuls": "xla"}, "platform": route.platform(),
        "embed_s": round(embed_s, 3), **meter.since(snap),
        "memory": memory(),
        "checks": [check("min_row_cosine_vs_f32_highest",
                         float(cos.min()), 0.999, ">="),
                   check("finite_and_shape", float(shape_ok), 1.0, ">=")],
    }
    del params, p32, emb
    free_device_memory()
    return result


# -- phase C: the LM behind the HTTP server -----------------------------------

def _post(port: int, path: str, body: dict, timeout: float = 900.0) -> dict:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return json.loads(r.read().decode())
    except urllib.error.HTTPError as e:     # keep the server's message
        raise RuntimeError(f"{path}: HTTP {e.code}: "
                           f"{e.read().decode(errors='replace')}") from e


def _prompt_of_len(n_bytes: int, i: int) -> str:
    """ASCII text of exactly ``n_bytes`` bytes (one byte token each)."""
    base = (f"Question {i}: patient notes on blood pressure, diet and "
            "sleep. ")
    return (base * (n_bytes // len(base) + 1))[:n_bytes]


def _parallel(fn, items):
    out = [None] * len(items)
    errs = []

    def run(j, it):
        try:
            out[j] = fn(it)
        except Exception as e:          # re-raised in the caller below
            errs.append(e)

    threads = [threading.Thread(target=run, args=(j, it))
               for j, it in enumerate(items)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errs:
        raise errs[0]
    return out


def _first_divergence(a, b):
    for t, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return t
    return None if len(a) == len(b) else min(len(a), len(b))


def _tie_margin(gen, prompt: str, prefix) -> float:
    """Top-1 minus top-2 logit of the next token after ``prompt + prefix``
    from a full causal forward (no cache), over the logit std — the
    rounding-order noise a different program shape can flip at."""
    import jax.numpy as jnp
    import numpy as np
    ids = gen.tokenizer.encode(prompt) + list(prefix)
    n = len(ids)
    s = -(-n // 256) * 256
    arr = np.full((1, s), gen.tokenizer.pad_id, np.int32)
    mask = np.zeros((1, s), np.float32)
    arr[0, s - n:], mask[0, s - n:] = ids, 1.0
    logits = np.asarray(gen.model.apply(gen.params, jnp.asarray(arr),
                                        jnp.asarray(mask))[0, -1])
    top2 = np.sort(logits)[-2:]
    return float((top2[1] - top2[0]) / (logits.std() + 1e-9))


def phase_c(meter, *, seed=0, cfg_kw=None, max_len=MAX_LEN,
            prompt_bytes=(200, 600, 1000, 1450, 300, 700, 1100, 1500),
            max_new=32, slots=4, n_qa=4, n_search=4, tie_tol=0.05,
            modes=("bf16", "int8"), root="."):
    """Yields one result dict per weight mode."""
    import jax
    import numpy as np

    from mediquery_rag.cli.context import AppContext
    from mediquery_rag.config import DecoderConfig
    from mediquery_rag.llm.device_client import DeviceLLMClient
    from mediquery_rag.models.generate import Generator
    from mediquery_rag.ops import route
    from mediquery_rag.serve.server import build_server

    published = dict(QWEN25_7B, **(cfg_kw or {}))
    fields = {f for f in DecoderConfig.__dataclass_fields__}
    expressible = {k: v for k, v in published.items() if k in fields}
    cuts = {"max_len": {"published": published["max_position_embeddings"],
                        "used": max_len}}
    for k in ("tie_word_embeddings", "hidden_act", "sliding_window"):
        cuts[k] = {"published": published[k],
                   "used": "not a DecoderConfig field: untied lm_head, "
                           "SwiGLU (silu), full attention"}
    # attention as an imported HF checkpoint serves it (hf_import.py:
    # attn_impl="flash"): cuDNN prefill, grouped-query cache attention
    dcfg = DecoderConfig(**expressible, max_len=max_len, dtype="bfloat16",
                         param_dtype="bfloat16", attn_impl="flash")
    snap = meter.snapshot()
    gen = Generator(dcfg, key=jax.random.PRNGKey(seed))
    init = meter.since(snap)
    for mode in modes:
        snap = meter.snapshot()
        t_mode = time.perf_counter()
        matvec_err, matvec_checks = None, []
        if mode == "int8":
            gen.quantize_weights(bits=8)
            free_device_memory()
            matvec_err, matvec_checks = compare_quant_matvec(gen.params,
                                                             seed=seed)
        weight_bytes = sum(x.nbytes for x in jax.tree_util.tree_leaves(
            gen.params))
        ctx = AppContext.build(root, llm=DeviceLLMClient(gen))
        server = build_server(ctx, slots=slots)
        port = server.start("127.0.0.1", 0)
        try:
            prompts = [_prompt_of_len(n, j)
                       for j, n in enumerate(prompt_bytes)]
            bodies = [{"messages": [{"role": "user", "content": p}],
                       "max_tokens": max_new, "temperature": 0.0}
                      for p in prompts]
            t0 = time.perf_counter()
            chat = _parallel(lambda b: _post(port, "/v1/chat/completions",
                                             b), bodies)
            chat_s = time.perf_counter() - t0
            rendered = [server._chat_prompt(b)[0] for b in bodies]
            # the same requests, token ids read back from the server
            futs = [server.llm_server.submit(p, max_new_tokens=max_new)
                    for p in rendered]
            served = [f.result(timeout=900) for f in futs]
            served_ids = [f.token_ids for f in futs]
            qs = ["高血压患者饮食应注意什么？", "糖尿病的早期症状有哪些？",
                  "感冒发烧该如何处理？", "如何预防骨质疏松？"]
            t0 = time.perf_counter()
            qa = _parallel(lambda q: _post(port, "/qa", {"question": q}),
                           qs[:n_qa])
            qa_s = time.perf_counter() - t0
            search = _parallel(
                lambda q: _post(port, "/search", {"query": q, "k": 5}),
                qs[:n_search])
        finally:
            server.shutdown()
            server.llm_server.close()
        # lockstep reference: Generator.generate at the server's batch
        # shape (slots prompts per batch)
        lock_ids, lock_txt = [], []
        for j in range(0, len(rendered), slots):
            group = rendered[j:j + slots]
            lock_ids += gen.generate_tokens(group, max_new_tokens=max_new)
            lock_txt += gen.generate(group, max_new_tokens=max_new)
        eos = gen.tokenizer.eos_id

        def upto_eos(x):
            x = list(x)
            return (x[:x.index(eos) + 1] if eos in x else x)[:max_new]

        exact, ties, diverged = 0, [], []
        for j, (a, b) in enumerate(zip(served_ids, lock_ids)):
            a, b = upto_eos(a), upto_eos(b)
            t = _first_divergence(a, b)
            if t is None:
                exact += 1
                continue
            margin = _tie_margin(gen, rendered[j], b[:t])
            (ties if margin < tie_tol else diverged).append(
                {"request": j, "position": t, "margin_over_std": margin})
        from mediquery_rag.llm.device_client import _cut_turn
        http_same = sum(int(c["choices"][0]["message"]["content"]
                            == _cut_turn(s_, "plain"))
                        for c, s_ in zip(chat, served))
        http_ok = (len(chat) == len(prompts)
                   and all("answer" in r and "error" not in r for r in qa)
                   and all(len(r["results"][0]) > 0 for r in search))
        result = {
            "phase": f"C.lm_{mode}", "published": "Qwen/Qwen2.5-7B",
            "config": {k: expressible[k] for k in sorted(expressible)},
            "cuts": cuts, "tokenizer": "ByteTokenizer",
            "weight_bytes": weight_bytes, "slots": slots,
            "attn_impl": dcfg.attn_impl,
            "routes": {"quant_matvec": route.impl("quant_matvec")
                       if mode == "int8" else "not used (bf16 weights)",
                       "attention_prefill": route.impl("attention_prefill"),
                       "attention_cached": route.impl("attention_cached"),
                       "block_topk": route.impl("block_topk"),
                       "matmuls": "xla"},
            "chat_requests": len(chat), "qa_requests": len(qa),
            "search_requests": len(search),
            "prompt_bytes": list(prompt_bytes), "max_new_tokens": max_new,
            "chat_s": round(chat_s, 3), "qa_s": round(qa_s, 3),
            "mode_s": round(time.perf_counter() - t_mode, 3),
            "greedy_exact": exact, "greedy_near_tie": ties,
            "greedy_diverged": diverged, "lockstep_text": lock_txt[:1],
            "matvec_rel_err_vs_plain": matvec_err,
            "init": init if mode == modes[0] else None,
            **meter.since(snap), "memory": memory(),
            "checks": [
                check("http_requests_ok", float(http_ok), 1.0, ">="),
                check("greedy_divergences_above_tie_tol",
                      float(len(diverged)), 0.0, "<="),
                check("http_text_equals_served_text", float(http_same),
                      float(len(chat)), ">="),
            ] + matvec_checks,
        }
        del ctx, server
        free_device_memory()
        yield result
    del gen
    free_device_memory()


# -- phase D: the sharded index on four cards ----------------------------------

def unsharded_topk(index, queries, k: int):
    """The sharded flat index's answer computed without the mesh: the
    single-device ``flat_search`` on each card's shard, with the query
    prepared as the sharded search prepares it, then a host merge by
    score. Sharding must not change the result of one unsharded index
    (the float32 truth differs from both by bf16 storage, which phase A
    bounds)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from mediquery_rag.engine.flat import l2_normalize
    from mediquery_rag.ops.scoring import flat_search

    q = jnp.asarray(queries, jnp.float32)
    if index.cfg.metric == "cosine":
        q = l2_normalize(q)
    q = q.astype(index.corpus.dtype)
    ss, ii = [], []
    for sh in index.corpus.addressable_shards:
        off = sh.index[0].start or 0
        per = sh.data.shape[0]
        s, i = flat_search(jax.device_put(q, sh.device), sh.data, k,
                           n_valid=int(np.clip(index.n - off, 0, per)),
                           corpus_tile=index.cfg.corpus_tile)
        ss.append(np.asarray(s))
        ii.append(np.asarray(i) + off)
    s, i = np.concatenate(ss, axis=1), np.concatenate(ii, axis=1)
    top = np.argsort(-s, axis=1, kind="stable")[:, :k]
    return (np.take_along_axis(s, top, axis=1),
            np.take_along_axis(i, top, axis=1))


FOUR_CARD_ROWS = 4 * 2048 * 4882      # 39,993,344: 40M rounded down to
                                      # whole 2048-row blocks per card


def phase_d(meter, *, rows=FOUR_CARD_ROWS, dim=768, batch=64, k=10,
            seed=0, chunk=78_112, nlist=4096, nprobe=32, corpus_tile=2048,
            n_devices=4):
    """ShardedFlatIndex (bf16) and ShardedIVFIndex (int8) over a
    ``n_devices`` mesh; the exact reference regenerates rows on device 0.
    Each card's rows are generated on that card, chunk by chunk."""
    import jax
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from mediquery_rag.config import EngineConfig
    from mediquery_rag.engine import ShardedFlatIndex, ShardedIVFIndex
    from mediquery_rag.ops import route
    from mediquery_rag.parallel import corpus_mesh

    devices = jax.devices()[:n_devices]
    if len(devices) < n_devices:
        raise RuntimeError(f"need {n_devices} devices, have {len(devices)}")
    mesh = corpus_mesh(n_devices)
    per = rows // n_devices
    if rows % n_devices or per % chunk:
        raise ValueError("rows must split into whole chunks per device")
    corpus = Corpus(rows, dim, seed, chunk=chunk)
    q = corpus.queries(batch)
    ref_s, ref_i = corpus.exact_topk(q, k, device=devices[0])
    qn = np.asarray(q)

    snap = meter.snapshot()
    t0 = time.perf_counter()
    shards = [corpus.materialize(device=d, row0=j * per, rows=per)
              for j, d in enumerate(mesh.devices.reshape(-1))]
    vectors = jax.make_array_from_single_device_arrays(
        (rows, dim), NamedSharding(mesh, P("shard", None)), shards)
    del shards
    cfg = EngineConfig(dim=dim, dtype="bfloat16", top_k=k,
                       corpus_tile=corpus_tile)
    flat = ShardedFlatIndex.build(vectors, mesh, cfg)
    del vectors
    jax.block_until_ready(flat.corpus)
    build_s = time.perf_counter() - t0
    s, i = jax.device_get(flat.search(qn, k=k))
    placement = {str(sh.device.id): list(sh.data.shape)
                 for sh in flat.corpus.addressable_shards}
    st_s, st_i = unsharded_topk(flat, qn, k)
    st_map = [dict(zip(r_i.tolist(), r_s.tolist()))
              for r_i, r_s in zip(st_i, st_s)]
    err = max(abs(float(sv) - st_map[r][int(iv)])
              for r in range(len(st_map))
              for sv, iv in zip(s[r], i[r]) if int(iv) in st_map[r])
    yield {
        "phase": "D.sharded_bf16_flat", "rows": rows, "devices": n_devices,
        "corpus_tile": corpus_tile,
        "routes": {"flat_search": route.impl("flat_search"),
                   "block_topk": route.impl("block_topk")},
        "shard_rows": placement, "build_s": round(build_s, 3),
        **meter.since(snap), "memory": memory(devices),
        "checks": [check("recall@10_vs_unsharded",
                         recall_at_k(i, st_i), 0.999, ">="),
                   check("max_abs_score_error_vs_unsharded",
                         err, 1e-3, "<="),
                   check("recall@10_vs_f32", recall_at_k(i, ref_i), 0.99,
                         ">="),
                   check("one_shard_per_device", float(len(placement)),
                         float(n_devices), ">=")],
    }
    del flat
    free_device_memory()

    snap = meter.snapshot()
    t0 = time.perf_counter()
    cfg = EngineConfig(dim=dim, dtype="int8", index_kind="ivf", top_k=k,
                       ivf_nlist=nlist, ivf_nprobe=nprobe)
    ivf = ShardedIVFIndex.build_streaming(
        corpus.chunks, rows, mesh, cfg, key=jax.random.PRNGKey(seed),
        chunk_rows=chunk)
    jax.block_until_ready(ivf.buckets)
    build_s = time.perf_counter() - t0
    s, i = jax.device_get(ivf.search(qn, k=k))
    placement = {str(sh.device.id): list(sh.data.shape)
                 for sh in ivf.buckets.addressable_shards}
    yield {
        "phase": "D.sharded_int8_ivf", "rows": rows, "devices": n_devices,
        "nlist": ivf.nlist, "nprobe": nprobe, "cap": ivf.cap,
        "routes": {"ivf_probe_search": route.impl("ivf_probe_search")},
        "shard_rows": placement, "build_s": round(build_s, 3),
        **meter.since(snap), "memory": memory(devices),
        "checks": [check("recall@10", recall_at_k(i, ref_i), 0.95, ">="),
                   check("one_shard_per_device", float(len(placement)),
                         float(n_devices), ">=")],
    }
    del ivf
    free_device_memory()


# -- entry point ----------------------------------------------------------------

def card_line() -> str:
    """``nvidia-smi`` name and power limit, from a child that never
    touches JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded-index phase on 4 GPUs")
    ap.add_argument("--phases", default="ABC",
                    help="one-GPU phases to run (default ABC)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rows", type=int, default=None,
                    help="corpus rows (default 10M; 39,993,344 with "
                         "--four-cards)")
    args = ap.parse_args(argv)

    import jax
    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: needs a CUDA GPU, JAX found "
              f"{devices[0].platform!r}", file=sys.stderr)
        return 2
    print(f"card: {card_line()}", flush=True)

    from mediquery_rag import compile_cache
    from mediquery_rag.ops import route

    cache = compile_cache.enable()
    meter = CompileMeter()
    emit({"phase": "setup", "platform": devices[0].platform,
          "kind": devices[0].device_kind, "devices": len(devices),
          "jax": jax.__version__, "compile_cache": cache,
          "routes": route.table()})
    results = []
    if args.four_cards:
        for r in phase_d(meter, rows=args.rows or FOUR_CARD_ROWS,
                         seed=args.seed):
            emit(r)
            results.append(r)
    else:
        if "A" in args.phases:
            for r in phase_a(meter, rows=args.rows or 10_000_000,
                             seed=args.seed):
                emit(r)
                results.append(r)
        if "B" in args.phases:
            r = phase_b(meter, seed=args.seed)
            emit(r)
            results.append(r)
        if "C" in args.phases:
            for r in phase_c(meter, seed=args.seed):
                emit(r)
                results.append(r)
    failed = [(r["phase"], c["name"]) for r in results
              for c in r["checks"] if not c["ok"]]
    emit({"phase": "summary", "failed_checks": failed,
          "cache_hits": meter.cache_hits,
          "cache_misses": meter.cache_misses,
          "compile_s": round(meter.seconds, 3)})
    if failed or not results:
        return 1
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
