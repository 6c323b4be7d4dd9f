"""The retrieval core: accelerator-native vector indexes.

Replaces ChromaDB + hnswlib (reference: src/medical_engine.py:52,
src/ingest_medical.py:106-110, src/agents/nodes.py:93) with HBM-resident
indexes searched by the device ops in ``ops/``:

- ``FlatIndex``        exact brute-force search (the recall oracle + small-N path)
- ``ShardedFlatIndex`` corpus sharded over a device mesh, partial top-k
                       merged via all-gather over ICI (multi-slice: DCN
                       hierarchical merge via ``EngineConfig.dcn_axis``)
- ``IVFIndex``         coarse-quantized inverted file for large N
- ``StreamingFlatIndex`` beyond-HBM capacity tier: host-RAM/memmap corpus
                       streamed chunk-wise through the same kernels
"""

from mediquery_rag.engine.flat import FlatIndex  # noqa: F401
from mediquery_rag.engine.sharded import ShardedFlatIndex  # noqa: F401
from mediquery_rag.engine.ivf import IVFIndex  # noqa: F401
from mediquery_rag.engine.sharded_ivf import ShardedIVFIndex  # noqa: F401
from mediquery_rag.engine.streaming import StreamingFlatIndex  # noqa: F401
