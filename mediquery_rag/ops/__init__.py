"""Device compute primitives, routed per platform (ops/route.py).

These replace the C++ compute the reference delegated to dependencies
(hnswlib HNSW search inside ChromaDB — reference medical_engine.py:52,
nodes.py:93 — and GGML inference inside Ollama).
"""

from mediquery_rag.ops.topk import exact_topk, merge_topk  # noqa: F401
from mediquery_rag.ops.scoring import flat_search, flat_search_xla  # noqa: F401
