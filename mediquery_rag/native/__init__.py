"""Native (C++) components, loaded via ctypes — no pybind11 dependency."""

from mediquery_rag.native.hnsw import HNSWIndex, hnsw_available  # noqa: F401
