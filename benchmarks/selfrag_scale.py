"""End-to-end Self-RAG loop throughput at scale (SURVEY §7 step 6).

N concurrent sessions drive the full graph (router → retrieve → grade →
summarize, scripted LLM so the measurement isolates the framework, not an
external chat model). Every retrieve node goes through the micro-batcher
into a 1M x 768 device index — the BASELINE north star wiring ("the Self-RAG
loop issues batched queries straight into this engine instead of
collection.query"). Prints one JSON line per configuration.

The embedder here is a planted-vector lookup (query "qNNN" -> a noisy copy
of corpus vector NNN): embedding throughput is measured separately in
benchmarks/embed.py; this isolates loop + batcher + engine dispatch.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import threading
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class PlantedEmbedder:
    def __init__(self, corpus_vecs: np.ndarray, noise: float = 0.05,
                 seed: int = 987654321):
        # NB: the seed must differ from the corpus generator's — reusing it
        # makes the noise vector reproduce the corpus's first rows (the same
        # gaussian stream), planting a spurious near-duplicate of x[0]
        self.v = corpus_vecs
        self.noise = noise
        self.rng = np.random.default_rng(seed)

    def __call__(self, texts):
        out = []
        for t in texts:
            m = re.search(r"(\d+)", t)
            i = int(m.group(1)) % len(self.v) if m else 0
            q = self.v[i] + self.noise * self.rng.standard_normal(self.v.shape[1])
            out.append((q / np.linalg.norm(q)).astype(np.float32))
        return np.stack(out)


class VectorStore:
    """DocumentStore-shaped shim over a raw index (no 1M chunk objects)."""

    def __init__(self, index, embedder):
        self.index = index
        self.embedder = embedder

    def batch_search(self, queries, k=5):
        from mediquery_rag.ingest.pipeline import RetrievedDoc
        q = np.asarray(self.embedder(list(queries)))
        scores, idx = self.index.search(q, k=k)
        scores, idx = np.asarray(scores), np.asarray(idx)
        return [
            [RetrievedDoc(f"文档{int(idx[r, j])}：相关资料",
                          {"doc_id": int(idx[r, j])}, float(scores[r, j]))
             for j in range(idx.shape[1]) if scores[r, j] > -np.inf]
            for r in range(len(queries))
        ]

    def similarity_search(self, query, k=5):
        return self.batch_search([query], k)[0]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--d", type=int, default=768)
    ap.add_argument("--sessions", type=int, default=64)
    ap.add_argument("--queries-per-session", type=int, default=4)
    ap.add_argument("--dtype", default="int8")
    args = ap.parse_args()

    import jax.numpy as jnp

    from mediquery_rag.config import EngineConfig
    from mediquery_rag.engine import FlatIndex
    from mediquery_rag.graph import build_medical_graph, create_nodes
    from mediquery_rag.llm import RuleLLM, user
    from mediquery_rag.serve import BatchingSearchService

    rng = np.random.default_rng(0)
    x = rng.standard_normal((args.n, args.d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    t0 = time.perf_counter()
    index = FlatIndex.build(jnp.asarray(x),
                            EngineConfig(dim=args.d, dtype=args.dtype))
    build_s = time.perf_counter() - t0
    store = VectorStore(index, PlantedEmbedder(x))

    # warm the kernel for every padded batch shape the batcher can produce
    # (B pads to 16-multiples; a first compile would otherwise land inside
    # the measured window)
    for b in (1, 17, 33, 49, 64):
        store.batch_search([f"q{i}" for i in range(b)], k=5)

    svc = BatchingSearchService(store.batch_search, max_batch=64,
                                max_wait_ms=3.0)
    hits = []
    lock = threading.Lock()

    def session(sid):
        llm = RuleLLM([
            (r"yes 或 no", "yes"),
            (r"【用户问题】", f"答复{sid}"),
        ])
        app = build_medical_graph(create_nodes(llm, svc))
        ok = 0
        for qi in range(args.queries_per_session):
            target = (sid * 7919 + qi * 104729) % args.n
            events = list(app.stream(
                {"messages": [user(f"咨询 {target} 号文档")],
                 "user_id": "anonymous"},
                thread_id=f"s{sid}_{qi}"))
            final = events[-1][1]
            docs = final.get("documents") or []
            if docs and docs[0]["metadata"].get("doc_id") == target:
                ok += 1
        with lock:
            hits.append(ok)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=session, args=(i,))
               for i in range(args.sessions)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    svc.shutdown()

    total_q = args.sessions * args.queries_per_session
    print(json.dumps({
        "metric": "selfrag_e2e_qps",
        "n": args.n, "dtype": args.dtype,
        "sessions": args.sessions,
        "queries": total_q,
        "wall_s": round(wall, 3),
        "e2e_qps": round(total_q / wall, 1),
        "planted_hit_rate": round(sum(hits) / total_q, 4),
        "index_build_s": round(build_s, 2),
        "batcher": dict(svc.stats),
    }))


if __name__ == "__main__":
    main()
