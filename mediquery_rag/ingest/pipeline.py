"""DocumentStore: the vectorstore equivalent (chunks + device index + embedder).

Replaces ``Chroma.from_documents`` / ``vectorstore.similarity_search``
(reference ingest_medical.py:104-110, nodes.py:93). Build embeds the whole
corpus as batched device forward passes and constructs the index in one HBM
pass; search embeds the query batch and calls the engine.
"""

from __future__ import annotations

import hashlib
import json
import os
from dataclasses import dataclass
from typing import Callable, Sequence

import numpy as np

_SENTINEL = "指纹校验：高血压与糖尿病"


def embedder_fingerprint(embedder: Callable) -> str:
    """Hash of the embedder's output on a fixed sentinel — detects loading an
    index built with a *different* embedder (dims can match while the vector
    spaces are unrelated, which would silently return garbage neighbors)."""
    v = np.asarray(embedder([_SENTINEL])[0], dtype=np.float32)
    return hashlib.sha1(np.round(v, 4).tobytes()).hexdigest()[:16]

from mediquery_rag.config import EngineConfig
from mediquery_rag.engine import FlatIndex, IVFIndex
from mediquery_rag.ingest.parser import Chunk, parse_corpus_file


@dataclass
class RetrievedDoc:
    text: str
    metadata: dict
    score: float


class DocumentStore:
    def __init__(self, chunks: list[Chunk | None], index, embedder: Callable):
        # position in ``chunks`` == stable engine doc id; None = deleted
        self.chunks = chunks
        self.index = index
        self.embedder = embedder
        # cached: an O(len(chunks)) scan per search call would dominate the
        # serving hot path at 10M docs; mutations keep it current
        self._live = sum(c is not None for c in chunks)

    @property
    def live_count(self) -> int:
        return self._live

    def similarity_search(self, query: str, k: int = 5,
                          where: dict | None = None) -> list[RetrievedDoc]:
        return self.batch_search([query], k, where=where)[0]

    @staticmethod
    def _matches(meta: dict, where: dict) -> bool:
        """Chroma-style metadata filter: every key must match. A list value
        (or a comma/、-delimited string, how ``Chunk.metadata`` renders
        tags) matches if it CONTAINS the wanted value."""
        import re
        for key, want in where.items():
            have = meta.get(key)
            if isinstance(have, (list, tuple)):
                if want not in have:
                    return False
            elif isinstance(have, str) and isinstance(want, str):
                if want != have and want not in re.split(r"[，,、;；]\s*", have):
                    return False
            elif have != want:
                return False
        return True

    def batch_search(
        self, queries: Sequence[str], k: int = 5, where: dict | None = None
    ) -> list[list[RetrievedDoc]]:
        """Batched retrieval — the Self-RAG loop issues batched queries
        straight into the engine (BASELINE north star).

        ``where`` filters results by metadata (Chroma ``where`` parity,
        e.g. ``{"tags": "高血压"}``). Implemented as overfetch-then-filter:
        the engine returns 4x k candidates and matches fill up to k; if the
        overfetch runs dry the scan widens to the whole corpus (exact, rare).
        """
        k = min(k, self.live_count)
        q = np.asarray(self.embedder(list(queries)))
        # the fused kernel caps at k=128; the widened fallback below covers
        # rows whose matches are rarer than the overfetch
        fetch = k if where is None else min(4 * k, self.live_count, 128)
        scores, idx = self.index.search(q, k=fetch)
        scores = np.asarray(scores)
        idx = np.asarray(idx)
        out = []
        widen_rows = []
        for r in range(len(queries)):
            row = []
            for j in range(fetch):
                i = int(idx[r, j])
                if i < 0 or scores[r, j] == -np.inf:
                    continue
                c = self.chunks[i]
                if c is None:            # engine already masks deleted docs;
                    continue             # belt-and-braces for stale indexes
                if where is not None and not self._matches(c.metadata, where):
                    continue
                row.append(RetrievedDoc(c.text, c.metadata, float(scores[r, j])))
                if len(row) == k:
                    break
            if where is not None and len(row) < k and fetch < self.live_count:
                widen_rows.append(r)
            out.append(row)
        if widen_rows:
            # widened fallback for starved rows: deepest fetch the fused
            # kernel supports (k <= 128); rows whose matches are rarer than
            # that return what was found
            match_ids = [i for i, c in enumerate(self.chunks)
                         if c is not None and self._matches(c.metadata, where)]
            if match_ids:
                full_s, full_i = self.index.search(
                    q[widen_rows], k=min(128, self.live_count))
                full_s, full_i = np.asarray(full_s), np.asarray(full_i)
                ok = set(match_ids)
                for rr, r in enumerate(widen_rows):
                    row = []
                    for j in range(full_i.shape[1]):
                        i = int(full_i[rr, j])
                        if i in ok and full_s[rr, j] > -np.inf:
                            c = self.chunks[i]
                            row.append(RetrievedDoc(c.text, c.metadata,
                                                    float(full_s[rr, j])))
                            if len(row) == k:
                                break
                    out[r] = row
        return out

    # -- incremental mutation (Chroma add/delete capability parity) ----------

    def add_documents(self, new_chunks: list[Chunk], batch_size: int = 64
                      ) -> list[int]:
        """Embed and insert chunks; returns their stable doc ids."""
        if not new_chunks:
            return []
        vecs = _embed_chunks(self.embedder, new_chunks, batch_size)
        start = self.index.next_id
        # keep position == doc id (holes between next_id and len are
        # impossible: ids are handed out consecutively)
        assert start == len(self.chunks), "doc-id/chunk alignment broken"
        new_index = self.index.add(vecs)
        # publication order matters for lock-free concurrent readers
        # (serve/server.py runs searches in parallel with mutations):
        # grow ``chunks`` BEFORE swapping the index ref, so a reader that
        # sees the new index can never look up a doc id past len(chunks)
        self.chunks.extend(new_chunks)
        self.index = new_index
        self._live += len(new_chunks)
        return list(range(start, start + len(new_chunks)))

    def delete_documents(self, chunk_ids: Sequence[str]) -> int:
        """Delete by chunk_id (the corpus-format key); returns #deleted."""
        want = set(chunk_ids)
        doc_ids = [i for i, c in enumerate(self.chunks)
                   if c is not None and c.chunk_id in want]
        if not doc_ids:
            return 0
        self.index = self.index.delete(np.asarray(doc_ids, np.int32))
        for i in doc_ids:
            self.chunks[i] = None
        self._live -= len(doc_ids)
        return len(doc_ids)

    # -- persistence ---------------------------------------------------------

    def save(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "chunks.jsonl"), "w", encoding="utf-8") as f:
            for doc_id, c in enumerate(self.chunks):
                if c is None:
                    continue
                f.write(json.dumps({
                    "doc_id": doc_id,
                    "chunk_id": c.chunk_id, "title": c.title,
                    "content": c.content, "source": c.source, "tags": c.tags,
                }, ensure_ascii=False) + "\n")
        with open(os.path.join(path, "store.json"), "w") as f:
            json.dump({"embedder_fingerprint": embedder_fingerprint(self.embedder)}, f)
        self.index.save(os.path.join(path, "index"))

    @classmethod
    def load(cls, path: str, embedder: Callable) -> "DocumentStore":
        rows = []
        with open(os.path.join(path, "chunks.jsonl"), encoding="utf-8") as f:
            for line in f:
                d = json.loads(line)
                rows.append((d.pop("doc_id", len(rows)), Chunk(**d)))
        chunks: list[Chunk | None] = [None] * (max(i for i, _ in rows) + 1)
        for i, c in rows:
            chunks[i] = c
        meta_path = os.path.join(path, "store.json")
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                want = json.load(f).get("embedder_fingerprint")
            got = embedder_fingerprint(embedder)
            if want and got != want:
                raise ValueError(
                    f"index at {path} was built with a different embedder "
                    f"(fingerprint {want} != {got}); rebuild the index or "
                    "pass the matching embedder")
        ix_path = os.path.join(path, "index")
        with open(os.path.join(ix_path, "meta.json")) as f:
            kind = json.load(f)["kind"]
        index = (IVFIndex if kind == "ivf" else FlatIndex).load(ix_path)
        # trailing deletes can leave next_id past the last live chunk;
        # re-pad so position == doc id stays true for future adds
        nid = getattr(index, "next_id", len(chunks))
        chunks.extend([None] * (nid - len(chunks)))
        return cls(chunks, index, embedder)


def _embed_chunks(embedder: Callable, chunks: Sequence[Chunk],
                  batch_size: int) -> np.ndarray:
    """Batched document embedding. Embedders exposing ``embed_docs``
    (field-weighted lexical channels, models/lexical.py) get the
    structured chunks — title/tags/content weighting needs more than the
    rendered text; everything else gets ``chunk.text`` as before."""
    fn = getattr(embedder, "embed_docs", None)
    embs = []
    for i in range(0, len(chunks), batch_size):
        part = chunks[i:i + batch_size]
        embs.append(np.asarray(fn(part) if fn is not None
                               else embedder([c.text for c in part])))
    return np.concatenate(embs, axis=0)


def build_document_store(
    source: str | list[Chunk],
    embedder: Callable,
    cfg: EngineConfig | None = None,
    *,
    kind: str = "flat",
    batch_size: int = 64,
    mesh=None,
) -> DocumentStore:
    """Parse (if a path), embed in batches, build the index."""
    chunks = parse_corpus_file(source) if isinstance(source, str) else source
    if not chunks:
        raise ValueError("empty corpus")
    vecs = _embed_chunks(embedder, chunks, batch_size)
    if cfg is None:
        cfg = EngineConfig(dim=vecs.shape[1])
    if cfg.dim != vecs.shape[1]:
        cfg = EngineConfig(**{**cfg.__dict__, "dim": vecs.shape[1]})
    if kind == "ivf":
        index = IVFIndex.build(vecs, cfg)
    elif kind == "sharded":
        from mediquery_rag.engine import ShardedFlatIndex
        index = ShardedFlatIndex.build(vecs, mesh, cfg)
    elif kind == "streaming":
        # beyond-HBM capacity tier: searchable store, but immutable —
        # add/delete need an HBM-resident index (engine/streaming.py)
        from mediquery_rag.engine import StreamingFlatIndex
        index = StreamingFlatIndex.build(vecs, cfg)
    else:
        index = FlatIndex.build(vecs, cfg)
    return DocumentStore(chunks, index, embedder)
