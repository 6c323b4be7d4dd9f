"""Ingest parser + DocumentStore tests (reference format parity)."""

import numpy as np
import pytest

from mediquery_rag.config import EngineConfig
from mediquery_rag.ingest import build_document_store, parse_corpus, parse_corpus_file
from mediquery_rag.ingest.pipeline import DocumentStore
from mediquery_rag.models import HashingEmbedder

CORPUS = "data/medical_data.txt"
CFG = EngineConfig(dim=256, dtype="float32", corpus_tile=256)


class TestParser:
    def test_parse_sample_corpus(self):
        chunks = parse_corpus_file(CORPUS)
        assert len(chunks) == 160          # reference ships 154; we ship 160
        assert chunks[0].chunk_id == "001"
        assert "高血压" in chunks[0].title
        assert chunks[0].source.startswith("MediQuery")
        assert "血压" in chunks[0].tags

    def test_text_rendering(self):
        chunks = parse_corpus_file(CORPUS)
        assert chunks[0].text.startswith("问题：")
        assert "\n答案：" in chunks[0].text

    def test_tolerates_messy_fields(self):
        raw = (
            "chunk_id: 9\n"
            "title:\t\t多行内容测试\n"
            "content:  第一行\n  续行内容\n"
            "tags: a、b, c，d\n"
        )
        (c,) = parse_corpus(raw)
        assert c.content == "第一行\n续行内容"
        assert c.tags == ["a", "b", "c", "d"]

    def test_skips_empty_records(self):
        assert parse_corpus("chunk_id: 1\n\nchunk_id: 2\ntitle: t\ncontent: c\n") != []
        assert len(parse_corpus("chunk_id: 1\n\n")) == 0


class TestDocumentStore:
    @pytest.fixture(scope="class")
    def store(self):
        return build_document_store(CORPUS, HashingEmbedder(dim=256), CFG)

    def test_retrieves_relevant_chunk(self, store):
        docs = store.similarity_search("高血压患者吃饭要注意什么 饮食 限盐", k=3)
        assert len(docs) == 3
        assert any("高血压" in d.text for d in docs)

    def test_batch_search(self, store):
        res = store.batch_search(["睡眠不好怎么办", "糖尿病 运动"], k=2)
        assert len(res) == 2 and all(len(r) == 2 for r in res)
        assert any("睡眠" in d.text for d in res[0])
        assert any("运动" in d.text or "糖尿病" in d.text for d in res[1])

    def test_k_clamped_to_corpus(self, store):
        docs = store.similarity_search("血压", k=100)
        assert len(docs) <= 100

    def test_save_load_roundtrip(self, store, tmp_path):
        store.save(str(tmp_path / "store"))
        loaded = DocumentStore.load(str(tmp_path / "store"), HashingEmbedder(dim=256))
        assert len(loaded.chunks) == 160
        d1 = store.similarity_search("骨质疏松 预防", k=2)
        d2 = loaded.similarity_search("骨质疏松 预防", k=2)
        assert [x.metadata["chunk_id"] for x in d1] == [
            x.metadata["chunk_id"] for x in d2
        ]


class TestEmbedderFingerprint:
    def test_mismatched_embedder_rejected(self, tmp_path):
        store = build_document_store(CORPUS, HashingEmbedder(dim=256), CFG)
        store.save(str(tmp_path / "s"))

        class OtherEmbedder:
            def __call__(self, texts):
                import numpy as np
                base = HashingEmbedder(dim=256)(texts)
                return -base          # same dim, different space

        with pytest.raises(ValueError, match="different embedder"):
            DocumentStore.load(str(tmp_path / "s"), OtherEmbedder())

    def test_matching_embedder_loads(self, tmp_path):
        store = build_document_store(CORPUS, HashingEmbedder(dim=256), CFG)
        store.save(str(tmp_path / "s"))
        loaded = DocumentStore.load(str(tmp_path / "s"), HashingEmbedder(dim=256))
        assert len(loaded.chunks) == 160


class TestDocumentStoreMutation:
    """Incremental add/delete through the store (Chroma capability parity)."""

    def _store(self):
        return build_document_store(CORPUS, HashingEmbedder(dim=256), CFG)

    def test_add_documents(self):
        from mediquery_rag.ingest.parser import Chunk
        store = self._store()
        n0 = store.live_count
        new = [Chunk(chunk_id="900", title="新增测试问题",
                     content="这是一个新增的测试答案，关于罕见病毒X的防护。",
                     source="unit", tags=["测试"])]
        ids = store.add_documents(new)
        assert ids == [n0]
        assert store.live_count == n0 + 1
        docs = store.similarity_search("罕见病毒X 防护", k=1)
        assert docs[0].metadata.get("title") == "新增测试问题" or \
            "病毒X" in docs[0].text

    def test_delete_documents(self):
        store = self._store()
        n0 = store.live_count
        target = store.chunks[0]
        deleted = store.delete_documents([target.chunk_id])
        assert deleted == 1 and store.live_count == n0 - 1
        for row in store.batch_search([target.text], k=min(n0 - 1, 128)):
            assert all(d.metadata.get("chunk_id") != target.chunk_id
                       for d in row)

    def test_mutation_save_load_roundtrip(self, tmp_path):
        from mediquery_rag.ingest.parser import Chunk
        emb = HashingEmbedder(dim=256)
        store = self._store()
        gone = store.chunks[2].chunk_id
        store.delete_documents([gone])
        store.add_documents([Chunk(chunk_id="901", title="回环测试",
                                   content="保存后重新加载仍可检索的内容。",
                                   source="unit", tags=[])])
        store.save(str(tmp_path / "ds"))
        store2 = DocumentStore.load(str(tmp_path / "ds"), emb)
        assert store2.live_count == store.live_count
        q = "保存后重新加载 回环测试"
        r1 = store.similarity_search(q, k=3)
        r2 = store2.similarity_search(q, k=3)
        assert [d.text for d in r1] == [d.text for d in r2]
        # adds continue from the same stable id after reload
        ids = store2.add_documents([Chunk(chunk_id="902", title="再加一条",
                                          content="继续递增的文档编号。",
                                          source="unit", tags=[])])
        assert ids[0] == store2.index.next_id - 1


class TestMetadataFilter:
    """Chroma-style `where` filtering (overfetch + widened fallback)."""

    def _store(self):
        return build_document_store(CORPUS, HashingEmbedder(dim=256), CFG)

    def test_where_filters_by_tag(self):
        store = self._store()
        docs = store.similarity_search("饮食建议", k=3, where={"tags": "血压"})
        assert docs, "expected at least one tagged match"
        for d in docs:
            assert "血压" in d.metadata.get("tags", "")

    def test_where_no_match_returns_empty(self):
        store = self._store()
        docs = store.similarity_search("任何问题", k=3,
                                       where={"tags": "不存在的标签"})
        assert docs == []

    def test_where_rare_tag_found_via_widening(self):
        """A tag so rare it never lands in the 4k overfetch must still be
        found by the widened pass."""
        store = self._store()
        # tag exactly one chunk with a unique marker
        target = store.chunks[-1]
        target.tags.append("稀有标记")
        # query crafted to be dissimilar to the target so it ranks last
        docs = store.similarity_search("高血压 饮食 限盐", k=2,
                                       where={"tags": "稀有标记"})
        assert len(docs) == 1
        assert "稀有标记" in docs[0].metadata["tags"]  # delimited string

    def test_where_exact_key_match(self):
        store = self._store()
        src = store.chunks[0].metadata.get("source")
        docs = store.similarity_search("健康", k=2, where={"source": src})
        for d in docs:
            assert d.metadata["source"] == src


class TestParserFuzz:
    def test_random_garbage_never_crashes(self):
        """The parser must degrade to 'no chunks', never raise, on garbage
        (fail-open ingest; the reference would regex-crash on some of these)."""
        import random
        random.seed(11)
        fragments = ["chunk_id:", "title:", "content:", "tags:", "：", "\n",
                     "中文内容", "123", "   ", "\t", "source:", "reviewed_at:",
                     "🩺", "chunk_id: 7\n"]
        for _ in range(200):
            blob = "".join(random.choice(fragments)
                           for _ in range(random.randint(0, 40)))
            chunks = parse_corpus(blob)          # must not raise
            for c in chunks:
                assert c.content or c.title


def test_where_filter_large_k_and_corpus():
    """where-filter with 4*k past the kernel cap must not crash (fetch is
    clamped to 128; the widened fallback covers rare matches)."""
    from mediquery_rag.ingest.parser import Chunk
    chunks = [Chunk(chunk_id=str(i), title=f"问题{i}",
                    content=f"与主题{i % 7}有关的内容描述。",
                    source="unit", tags=[f"主题{i % 7}"])
              for i in range(300)]
    store = build_document_store(chunks, HashingEmbedder(dim=256), CFG)
    rows = store.batch_search(["主题3 的内容", "主题5"], k=40,
                              where={"tags": "主题3"})
    assert len(rows) == 2
    for d in rows[0]:
        assert "主题3" in d.metadata["tags"]


class TestInt4Store:
    """End-to-end: parse -> embed -> int4 index -> retrieve (the full RAG
    document path on the quarter-byte storage)."""

    def test_int4_flat_store_retrieves(self):
        cfg = EngineConfig(dim=256, dtype="int4", corpus_tile=256,
                           rerank_factor=4)
        store = build_document_store(CORPUS, HashingEmbedder(dim=256), cfg)
        docs = store.similarity_search("高血压患者吃饭要注意什么 饮食 限盐", k=3)
        assert len(docs) == 3
        assert any("高血压" in d.text for d in docs)

    def test_int4_ivf_store_retrieves(self):
        cfg = EngineConfig(dim=256, dtype="int4", ivf_nlist=4,
                           ivf_kmeans_iters=2)
        store = build_document_store(CORPUS, HashingEmbedder(dim=256), cfg,
                                     kind="ivf")
        docs = store.similarity_search("睡眠不好怎么办", k=2)
        assert len(docs) == 2

    def test_streaming_store_retrieves(self):
        """kind='streaming' builds the beyond-HBM tier behind the same
        DocumentStore search surface (engine/streaming.py)."""
        cfg = EngineConfig(dim=256, dtype="int8", corpus_tile=256,
                           )
        store = build_document_store(CORPUS, HashingEmbedder(dim=256), cfg,
                                     kind="streaming")
        from mediquery_rag.engine import StreamingFlatIndex
        assert isinstance(store.index, StreamingFlatIndex)
        docs = store.similarity_search("高血压患者吃饭要注意什么 饮食 限盐", k=3)
        assert len(docs) == 3
        assert any("高血压" in d.text for d in docs)


class TestAppContextIndexKind:
    """The app-level index-type knob (EngineConfig.index_kind / --index):
    the context must build the requested engine and rebuild a saved index
    whose type no longer matches."""

    def _mini_root(self, tmp_path):
        import shutil
        (tmp_path / "data").mkdir()
        blocks = open("data/medical_data.txt", encoding="utf-8").read(
            ).split("\n\n")
        (tmp_path / "data" / "medical_data.txt").write_text(
            "\n\n".join(blocks[:16]), encoding="utf-8")
        return str(tmp_path)

    def test_ivf_kind_builds_then_switch_rebuilds(self, tmp_path):
        from mediquery_rag.cli.context import AppContext
        from mediquery_rag.engine import FlatIndex, IVFIndex

        root = self._mini_root(tmp_path)
        ctx = AppContext.build(root, fake_llm=True, use_trained_encoder=False,
                               index_kind="ivf")
        assert isinstance(ctx.store.index, IVFIndex)
        hits = ctx.store.similarity_search("高血压 饮食 限盐", k=3)
        assert any("高血压" in d.text for d in hits)

        # same root, flat requested: the saved ivf index must be rebuilt
        ctx2 = AppContext.build(root, fake_llm=True, use_trained_encoder=False,
                                index_kind="flat")
        assert isinstance(ctx2.store.index, FlatIndex)

    def test_unknown_kind_rejected(self, tmp_path):
        from mediquery_rag.cli.context import AppContext
        with pytest.raises(ValueError, match="index_kind"):
            AppContext.build(self._mini_root(tmp_path), fake_llm=True,
                             use_trained_encoder=False, index_kind="hnsw")
