"""TextEmbedder: tokenizer + encoder + params behind one embed() call.

The in-process replacement for the reference's HTTP round trip to Ollama per
embedding call (medical_engine.py:43). Batches are padded to shape buckets
(powers of two) so repeated calls hit the jit cache instead of recompiling —
query batch sizes 1/8/64 are the BASELINE config-2 measurement points.

STATUS — experimental below real data scale: the from-scratch trained
encoder memorizes at the 160-chunk corpus (held-out r@1 0.50 vs the
lexical channel's 0.871, benchmarks/retrieval_eval.py), so the zero-
egress default retrieval stack is ``IDFHashingEmbedder`` and the hybrid
fusion stays behind ``MEDIQUERY_HYBRID=1``. This class is the throughput
path (6.9K texts/s at B=64, 79%% MFU) for corpora big enough to train
on, or for serving imported pretrained checkpoints (hf_import).
"""

from __future__ import annotations

import os
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from mediquery_rag.config import EmbedderConfig
from mediquery_rag.models.embedder import Embedder
from mediquery_rag.models.tokenizer import HashCharTokenizer


def _bucket(n: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return b


class TextEmbedder:
    def __init__(
        self,
        cfg: EmbedderConfig = EmbedderConfig(),
        params=None,
        key: jax.Array | None = None,
        mesh=None,
    ):
        """``mesh``: optional ``jax.sharding.Mesh`` with a ``data`` axis —
        ingest-scale embedding runs data-parallel over the slice (batch rows
        sharded, params replicated; XLA inserts nothing but the input
        scatter/output gather)."""
        self.cfg = cfg
        self.model = Embedder(cfg)
        self.tokenizer = HashCharTokenizer(cfg.vocab_size, cfg.max_len)
        if params is None:
            key = jax.random.PRNGKey(0) if key is None else key
            params = self.model.init(key)
        self.params = params
        self.mesh = mesh
        self._apply = jax.jit(lambda p, ids, mask: self.model.apply(p, ids, mask))
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            self._data_sharding = NamedSharding(mesh, P("data", None))
            self._repl = NamedSharding(mesh, P())
            self.params = jax.device_put(self.params, self._repl)

    @property
    def dim(self) -> int:
        return self.cfg.hidden

    def embed(self, texts: Sequence[str]) -> np.ndarray:
        """Returns [len(texts), hidden] L2-normalized f32 embeddings."""
        if not texts:
            return np.zeros((0, self.cfg.hidden), np.float32)
        ids, mask = self.tokenizer.batch_encode(list(texts))
        b = ids.shape[0]
        bp = _bucket(b)
        if self.mesh is not None:
            # data-parallel: batch rows must divide the data axis
            dp = self.mesh.shape["data"]
            bp = max(bp, dp) if bp % dp == 0 else -(-bp // dp) * dp
        if bp != b:
            ids = np.pad(ids, ((0, bp - b), (0, 0)))
            mask = np.pad(mask, ((0, bp - b), (0, 0)))
        ids_j, mask_j = jnp.asarray(ids), jnp.asarray(mask)
        if self.mesh is not None:
            ids_j = jax.device_put(ids_j, self._data_sharding)
            mask_j = jax.device_put(mask_j, self._data_sharding)
        out = self._apply(self.params, ids_j, mask_j)
        return np.asarray(out[:b])

    def __call__(self, texts: Sequence[str]) -> np.ndarray:
        return self.embed(texts)

    # -- checkpointing -------------------------------------------------------

    def save(self, path: str) -> None:
        import json

        os.makedirs(path, exist_ok=True)
        flat, treedef = jax.tree_util.tree_flatten(self.params)
        np.savez(
            os.path.join(path, "params.npz"),
            **{str(i): np.asarray(x) for i, x in enumerate(flat)},
        )
        with open(os.path.join(path, "config.json"), "w") as f:
            json.dump(self.cfg.__dict__, f)

    def load_params(self, path: str) -> None:
        z = np.load(os.path.join(path, "params.npz"))
        flat, treedef = jax.tree_util.tree_flatten(self.params)
        if len(z.files) != len(flat):
            raise ValueError(
                f"checkpoint at {path} has {len(z.files)} arrays but this "
                f"architecture has {len(flat)} — construct the TextEmbedder "
                "with from_checkpoint() or the matching EmbedderConfig")
        new_flat = [jnp.asarray(z[str(i)]) for i in range(len(flat))]
        self.params = jax.tree_util.tree_unflatten(treedef, new_flat)

    @classmethod
    def from_checkpoint(cls, path: str) -> "TextEmbedder":
        """Rebuild with the architecture recorded at save time."""
        import json

        with open(os.path.join(path, "config.json")) as f:
            cfg = EmbedderConfig(**json.load(f))
        te = cls(cfg)
        te.load_params(path)
        return te
