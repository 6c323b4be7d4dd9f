"""Corpus ingest: parse + embed + index build.

Replaces the reference's offline ingest script (src/ingest_medical.py):
same corpus format, but embedding runs as one batched device forward pass and
"index build" is the engine's one-HBM-pass construction instead of per-doc
HTTP embedding calls feeding incremental HNSW inserts.
"""

from mediquery_rag.ingest.parser import Chunk, parse_corpus, parse_corpus_file  # noqa: F401
from mediquery_rag.ingest.pipeline import DocumentStore, build_document_store  # noqa: F401
