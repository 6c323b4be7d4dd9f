"""MediQuery — an accelerator-native medical RAG framework.

A ground-up re-design of the capabilities of lnkloveating/MediQuery-RAG
for a GPU-hosted JAX runtime:

- ``ops``      Device ops routed per platform (ops/route.py): exact scan +
               two-stage top-k, IVF probe, int8/int4 quantization, the
               int8 weight-only matvec (a Triton-route Pallas kernel on the
               GPU), grouped-query attention, on-device k-means.
- ``engine``   The retrieval core: flat and IVF indexes, device-resident
               sharded embedding matrices, index checkpointing.
- ``parallel`` Device-mesh sharding and collectives: per-shard partial
               top-k with all-gather merge.
- ``models``   Flax text-embedding encoder (768-d, zh) + contrastive trainer.
- ``graph``    Minimal typed state-machine workflow engine (replaces LangGraph).
- ``app``      Consultation state machine, two-tier memory, risk triage,
               calculators (replaces src/consultation + src/memory).
- ``ingest``   Corpus parsing + index build pipeline (replaces ingest_medical.py).
- ``llm``      Pluggable LLM client protocol + fakes for tests.
- ``cli``      Terminal UI (replaces src/ui/interface.py).
- ``obs``      Metrics (QPS, recall, latency) and jax.profiler tracing hooks.

The reference is a pure-Python LangGraph+ChromaDB+Ollama app whose heavy
compute lives in dependency C++ (hnswlib HNSW, GGML inference). Here that
compute is first-class and accelerator-native: JAX/XLA, one Pallas kernel.
"""

__version__ = "0.1.0"
