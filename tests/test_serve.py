"""Micro-batching serving layer tests."""

import threading
import time

import pytest

from mediquery_rag.config import EngineConfig
from mediquery_rag.ingest import build_document_store
from mediquery_rag.models import HashingEmbedder
from mediquery_rag.serve import BatchingSearchService

CFG = EngineConfig(dim=256, dtype="float32", corpus_tile=256)


@pytest.fixture()
def service():
    store = build_document_store("data/medical_data.txt", HashingEmbedder(256), CFG)
    svc = BatchingSearchService(store.batch_search, max_batch=8, max_wait_ms=20)
    yield svc
    svc.shutdown()


def test_single_request(service):
    docs = service.search("高血压 饮食 限盐", k=3)
    assert len(docs) == 3
    assert any("高血压" in d.text for d in docs)


def test_concurrent_requests_coalesce(service):
    results = {}

    def worker(i, q):
        results[i] = service.search(q, k=2)

    threads = [threading.Thread(target=worker, args=(i, q)) for i, q in
               enumerate(["睡眠不好", "糖尿病 运动", "血脂 高", "骨质疏松",
                          "高血压 饮食", "心肺功能", "力量训练", "情绪压力"])]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert len(results) == 8
    assert all(len(v) == 2 for v in results.values())
    # at least one multi-request batch formed
    assert service.stats["max_batch_seen"] >= 2
    assert service.stats["batches"] < service.stats["requests"]


def test_mixed_k_in_one_batch(service):
    f1 = service.submit("睡眠", k=1)
    f2 = service.submit("血压", k=4)
    assert len(f1.result(10)) == 1
    assert len(f2.result(10)) == 4


def test_engine_error_propagates():
    def broken(queries, k):
        raise RuntimeError("engine down")

    svc = BatchingSearchService(broken, max_wait_ms=1)
    try:
        with pytest.raises(RuntimeError, match="engine down"):
            svc.search("q", k=1, timeout=5)
    finally:
        svc.shutdown()


def test_shutdown_idempotent(service):
    service.shutdown()
    service.shutdown()


class TestMicroBatcher:
    """Generic item-level coalescer (serve/batcher.py:MicroBatcher)."""

    def test_coalesces_and_fans_out(self):
        from mediquery_rag.serve.batcher import MicroBatcher
        calls = []

        def fn(items):
            calls.append(list(items))
            return [x * 2 for x in items]

        mb = MicroBatcher(fn, max_batch=8, max_wait_ms=30)
        try:
            results = {}

            def worker(i):
                results[i] = mb.submit(i).result(timeout=10)

            threads = [threading.Thread(target=worker, args=(i,))
                       for i in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=10)
            assert results == {i: i * 2 for i in range(8)}
            assert mb.stats["requests"] == 8
            assert mb.stats["max_batch_seen"] >= 2   # coalescing happened
            assert sum(len(c) for c in calls) == 8   # nothing duplicated
        finally:
            mb.shutdown()

    def test_submit_many_preserves_order(self):
        from mediquery_rag.serve.batcher import MicroBatcher
        mb = MicroBatcher(lambda xs: [x + 1 for x in xs],
                          max_batch=4, max_wait_ms=1)
        try:
            assert mb.submit_many(list(range(10))) == list(range(1, 11))
        finally:
            mb.shutdown()

    def test_exception_fans_out(self):
        from mediquery_rag.serve.batcher import MicroBatcher

        def broken(items):
            raise RuntimeError("embedder down")

        mb = MicroBatcher(broken, max_wait_ms=1)
        try:
            with pytest.raises(RuntimeError, match="embedder down"):
                mb.submit("x").result(timeout=5)
        finally:
            mb.shutdown()

    def test_shutdown_idempotent(self):
        from mediquery_rag.serve.batcher import MicroBatcher
        mb = MicroBatcher(lambda xs: xs)
        mb.shutdown()
        mb.shutdown()


def test_selfrag_sessions_coalesce_through_batcher():
    """N concurrent Self-RAG sessions with the batcher as the graph's store:
    their retrieve nodes coalesce into shared device batches (the BASELINE
    north star — the loop issues batched queries straight into the engine)."""
    from mediquery_rag.graph import build_medical_graph, create_nodes
    from mediquery_rag.llm import RuleLLM, user

    store = build_document_store("data/medical_data.txt", HashingEmbedder(256), CFG)
    svc = BatchingSearchService(store.batch_search, max_batch=8, max_wait_ms=30)
    try:
        answers = {}

        def session(i):
            llm = RuleLLM([
                (r"yes 或 no", "yes"),
                (r"【用户问题】", f"回答{i}：参考资料已检索。"),
            ])
            app = build_medical_graph(create_nodes(llm, svc))
            events = list(app.stream(
                {"messages": [user(f"高血压 饮食 建议 {i}")],
                 "user_id": "anonymous"},
                thread_id=f"s{i}"))
            answers[i] = events[-1][1]["final_answer"]

        threads = [threading.Thread(target=session, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert len(answers) == 8
        for i, a in answers.items():
            assert f"回答{i}" in a
        assert svc.stats["max_batch_seen"] >= 2     # real coalescing happened
    finally:
        svc.shutdown()


class TestHTTPServer:
    """Stdlib HTTP front over the batcher (net-new serving component)."""

    @pytest.fixture()
    def server(self):
        from mediquery_rag.graph import build_medical_graph, create_nodes
        from mediquery_rag.llm import RuleLLM
        from mediquery_rag.serve import SearchServer

        store = build_document_store("data/medical_data.txt",
                                     HashingEmbedder(256), CFG)

        def make_app():
            llm = RuleLLM([
                (r"yes 或 no", "yes"),
                (r"【用户问题】", "基于资料的回答：注意限盐。"),
            ])
            return build_medical_graph(create_nodes(llm, srv.service))

        srv = SearchServer(store, make_graph_app=make_app, max_wait_ms=10)
        port = srv.start(port=0)
        yield srv, port
        srv.shutdown()

    def _post(self, port, path, payload):
        import json as js
        import urllib.request
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}{path}",
            data=js.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        # the where-filter path compiles widened-k fallback shapes on first
        # use (~30s cold on a busy CPU) — give the HTTP round trip headroom
        with urllib.request.urlopen(req, timeout=120) as r:
            return js.loads(r.read())

    def test_search_endpoint(self, server):
        srv, port = server
        out = self._post(port, "/search", {"query": "高血压 饮食 限盐", "k": 3})
        assert len(out["results"][0]) == 3
        assert any("高血压" in d["text"] for d in out["results"][0])

    def test_search_where_filter(self, server):
        srv, port = server
        out = self._post(port, "/search",
                         {"query": "饮食", "k": 3, "where": {"tags": "血压"}})
        for d in out["results"][0]:
            assert "血压" in d["metadata"]["tags"]

    def test_concurrent_searches_coalesce(self, server):
        srv, port = server
        results = {}

        def worker(i):
            results[i] = self._post(port, "/search",
                                    {"query": f"睡眠 问题 {i}", "k": 2})

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert len(results) == 8
        assert srv.service.stats["max_batch_seen"] >= 2

    def test_qa_endpoint(self, server):
        srv, port = server
        out = self._post(port, "/qa", {"question": "高血压饮食要注意什么 限盐"})
        assert "限盐" in out["answer"]
        assert out["docs"]

    def _sse_events(self, port, path, payload, timeout=120):
        import json as js
        import urllib.request
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}{path}",
            data=js.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        events, done = [], False
        with urllib.request.urlopen(req, timeout=timeout) as r:
            assert r.headers["Content-Type"].startswith("text/event-stream")
            for line in r:
                line = line.decode().strip()
                if not line.startswith("data: "):
                    continue
                data = line[len("data: "):]
                if data == "[DONE]":
                    done = True
                    break
                events.append(js.loads(data))
        return events, done

    def test_qa_stream_sse(self, server):
        """/qa with stream:true yields one node event per Self-RAG
        super-step, then the final answer — the app.stream surface over
        HTTP, and the answer matches the non-streaming /qa contract."""
        srv, port = server
        events, done = self._sse_events(
            port, "/qa", {"question": "高血压饮食要注意什么 限盐",
                          "stream": True})
        assert done
        nodes = [e["node"] for e in events if e.get("event") == "node"]
        assert nodes[0] == "router" and "retrieve" in nodes
        assert nodes[-1] == "summarizer"
        retrieve_ev = events[nodes.index("retrieve")]
        assert retrieve_ev["n_docs"] >= 1 and retrieve_ev["loop_step"] == 1
        final = events[-1]
        assert final["event"] == "answer" and "限盐" in final["answer"]
        assert final["docs"] and final["thread_id"]

    def test_qa_stream_bad_request_is_http_400(self, server):
        import json as js
        import urllib.error
        import urllib.request
        srv, port = server
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/qa",
            data=js.dumps({"stream": True}).encode(),   # no question
            headers={"Content-Type": "application/json"})
        try:
            urllib.request.urlopen(req, timeout=30)
            assert False, "expected HTTP 400"
        except urllib.error.HTTPError as e:
            assert e.code == 400

    def test_healthz(self, server):
        import json as js
        import urllib.request
        srv, port = server
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/healthz", timeout=10) as r:
            out = js.loads(r.read())
        assert out["ok"] is True

    def test_bad_request_is_json_error(self, server):
        import urllib.error
        srv, port = server
        try:
            self._post(port, "/search", {"k": 3})     # no query
            assert False, "expected HTTP 400"
        except urllib.error.HTTPError as e:
            assert e.code == 400

    def test_embeddings_endpoint(self, server):
        srv, port = server
        out = self._post(port, "/v1/embeddings",
                         {"input": ["高血压", "头痛"]})
        assert out["object"] == "list" and len(out["data"]) == 2
        v0 = out["data"][0]["embedding"]
        assert len(v0) == 256 and isinstance(v0[0], float)
        # single-string input: OpenAI contract returns a 1-row list
        one = self._post(port, "/v1/embeddings", {"input": "失眠"})
        assert len(one["data"]) == 1
        assert one["data"][0]["index"] == 0
        assert one["usage"]["prompt_tokens"] > 0

    def test_concurrent_embeddings_coalesce(self, server):
        """N concurrent /v1/embeddings callers become few device embed calls
        (server-side MicroBatcher), with each caller getting its own rows."""
        srv, port = server
        results = {}

        def worker(i):
            results[i] = self._post(port, "/v1/embeddings",
                                    {"input": [f"查询{i}", f"问题{i}"]})

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert len(results) == 6
        for out in results.values():
            assert len(out["data"]) == 2
            assert len(out["data"][0]["embedding"]) == 256
        mb = srv._embed_batcher
        assert mb is not None and mb.stats["max_batch_seen"] >= 2
        # determinism: same text through the coalescer == direct embed
        direct = self._post(port, "/v1/embeddings", {"input": "查询0"})
        assert direct["data"][0]["embedding"] == \
            results[0]["data"][0]["embedding"]

    def test_document_add_then_searchable(self, server):
        srv, port = server
        before = srv.store.live_count
        out = self._post(port, "/documents", {"documents": [{
            "chunk_id": "http_add_1",
            "title": "深海鱼油与血脂",
            "content": "适量摄入深海鱼油可能有助于调节血脂水平。",
            "tags": ["血脂", "营养"]}]})
        assert out["added"] == 1
        assert srv.store.live_count == before + 1
        hits = self._post(port, "/search",
                          {"query": "深海鱼油 血脂", "k": 3})
        assert any(d["metadata"]["chunk_id"] == "http_add_1"
                   for d in hits["results"][0])

    def test_document_delete_masks_from_search(self, server):
        srv, port = server
        self._post(port, "/documents", {"documents": [{
            "chunk_id": "http_del_1", "title": "临时条目",
            "content": "马上会被删除的临时健康条目。", "tags": []}]})
        out = self._post(port, "/documents/delete",
                         {"chunk_ids": ["http_del_1", "not_there"]})
        assert out["deleted"] == 1
        hits = self._post(port, "/search", {"query": "临时健康条目", "k": 5})
        assert all(d["metadata"]["chunk_id"] != "http_del_1"
                   for d in hits["results"][0])

    def test_metrics_without_llm(self, server):
        import urllib.request
        srv, port = server
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/metrics", timeout=30) as r:
            text = r.read().decode()
        assert "mediquery_search_" in text
        assert "mediquery_llm_" not in text       # no LLM server configured


def test_engine_failure_propagates_to_callers():
    """A failing engine must reject every future in the batch, not hang."""
    calls = {"n": 0}

    def broken(queries, k):
        calls["n"] += 1
        raise RuntimeError("engine down")

    svc = BatchingSearchService(broken, max_batch=4, max_wait_ms=5)
    try:
        futs = [svc.submit(f"q{i}", 2) for i in range(3)]
        for f in futs:
            with pytest.raises(RuntimeError, match="engine down"):
                f.result(timeout=10)
        assert calls["n"] >= 1
        # the service survives and serves the next healthy call
        svc._fn = lambda queries, k: [[] for _ in queries]
        assert svc.search("ok", 2) == []
    finally:
        svc.shutdown()


def test_mutation_while_serving_is_safe():
    """Adds/deletes while the batcher serves concurrent searches: the index
    swap is atomic (functional indexes, single mutator), so searches must
    never crash and must eventually see the new docs."""
    from mediquery_rag.ingest.parser import Chunk

    store = build_document_store("data/medical_data.txt",
                                 HashingEmbedder(256), CFG)
    svc = BatchingSearchService(store.batch_search, max_batch=8,
                                max_wait_ms=2)
    errors = []
    stop = threading.Event()

    def searcher():
        while not stop.is_set():
            try:
                svc.search("高血压 饮食", k=3, timeout=30)
            except Exception as e:          # pragma: no cover
                errors.append(e)
                return

    threads = [threading.Thread(target=searcher) for _ in range(4)]
    for t in threads:
        t.start()
    try:
        for i in range(10):
            store.add_documents([Chunk(
                chunk_id=f"mut{i}", title=f"并发写入测试{i}",
                content=f"独特标记语料{i}：罕见病症Z的处理方式。",
                source="unit", tags=["并发"])])
            if i % 3 == 2:
                store.delete_documents([f"mut{i - 1}"])
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=10)
        svc.shutdown()
    assert not errors, errors
    # post-mutation: new docs are retrievable, deleted ones are not
    docs = store.similarity_search("罕见病症Z 处理", k=3)
    ids = [d.metadata.get("chunk_id") for d in docs]
    assert any(str(x).startswith("mut") for x in ids)
    live_ids = {c.chunk_id for c in store.chunks if c is not None}
    assert "mut7" not in live_ids and "mut9" in live_ids
