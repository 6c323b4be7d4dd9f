"""Serving layer: request micro-batching into the device engine."""

from mediquery_rag.serve.batcher import BatchingSearchService  # noqa: F401
from mediquery_rag.serve.server import SearchServer  # noqa: F401
