"""Device-mesh sharding and ICI collectives.

The reference had no distributed backend at all (SURVEY §2c: single-process,
the only IPC was HTTP to Ollama). This package is the net-new first-class
component: mesh construction, corpus sharding, and the all-gather partial
top-k merge that rides ICI.
"""

from mediquery_rag.parallel.mesh import (  # noqa: F401
    corpus_mesh, make_mesh, slice_mesh,
)
from mediquery_rag.parallel.collectives import (  # noqa: F401
    grouped_topk_merge, hierarchical_topk_merge, sharded_topk_merge,
)
