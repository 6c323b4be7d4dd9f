"""Graph engine + Self-RAG integration tests with scripted LLMs.

SURVEY §4 class (5): graph-level tests with a fake LLM replacing Ollama —
possible because every touchpoint is constructor-injected.
"""

import pytest

from mediquery_rag.config import EngineConfig, GraphConfig
from mediquery_rag.graph import (
    END,
    SqliteCheckpointer,
    StateGraph,
    build_medical_graph,
    create_nodes,
)
from mediquery_rag.graph.engine import append_reducer
from mediquery_rag.graph.state import detect_mode
from mediquery_rag.ingest import build_document_store
from mediquery_rag.llm import FakeLLM, RuleLLM, user
from mediquery_rag.llm.client import extract_json
from mediquery_rag.models import HashingEmbedder

CFG = EngineConfig(dim=256, dtype="float32", corpus_tile=256)


@pytest.fixture(scope="module")
def store():
    return build_document_store("data/medical_data.txt", HashingEmbedder(256), CFG)


def _run(app, question, thread_id="t1", user_id="anonymous"):
    events = list(app.stream({"messages": [user(question)], "user_id": user_id},
                             thread_id=thread_id))
    return events, events[-1][1]


class TestStateGraphEngine:
    def test_linear_flow_and_reducer(self):
        g = StateGraph(reducers={"log": append_reducer})
        g.add_node("a", lambda s: {"log": "a"})
        g.add_node("b", lambda s: {"log": "b"})
        g.set_entry("a").add_edge("a", "b").add_edge("b", END)
        out = g.compile().invoke({})
        assert out["log"] == ["a", "b"]

    def test_conditional_edges(self):
        g = StateGraph()
        g.add_node("r", lambda s: {})
        g.add_node("x", lambda s: {"hit": "x"})
        g.add_node("y", lambda s: {"hit": "y"})
        g.set_entry("r")
        g.add_conditional_edges("r", lambda s: s["go"], {"1": "x", "2": "y"})
        g.add_edge("x", END).add_edge("y", END)
        assert g.compile().invoke({"go": "2"})["hit"] == "y"

    def test_unknown_edge_rejected(self):
        g = StateGraph()
        g.add_node("a", lambda s: {})
        g.set_entry("a").add_edge("a", "ghost")
        with pytest.raises(ValueError, match="ghost"):
            g.compile()

    def test_max_steps_guard(self):
        g = StateGraph()
        g.add_node("a", lambda s: {})
        g.set_entry("a").add_edge("a", "a")
        with pytest.raises(RuntimeError, match="max_steps"):
            g.compile(max_steps=5).invoke({})

    def test_checkpoint_resume(self):
        ck = SqliteCheckpointer()
        g = StateGraph(reducers={"messages": append_reducer})
        g.add_node("echo", lambda s: {"messages": [f"seen:{len(s['messages'])}"]})
        g.set_entry("echo").add_edge("echo", END)
        app = g.compile(checkpointer=ck)
        app.invoke({"messages": ["m1"]}, thread_id="th")
        out = app.invoke({"messages": ["m2"]}, thread_id="th")
        # resumed thread accumulated messages across invocations
        assert out["messages"][0] == "m1" and "m2" in out["messages"]


class TestModeDetection:
    def test_structured_marker_bypass(self):
        assert detect_mode("【咨询需求】请给出睡眠建议 170cm") == "science"

    def test_assessment(self):
        assert detect_mode("我身高175cm体重80kg，帮我计算BMI") == "assessment"

    def test_science_default(self):
        assert detect_mode("高血压能吃咸菜吗") == "science"


class TestSelfRAGFlow:
    def test_happy_path_grade_yes(self, store):
        llm = RuleLLM([
            (r"yes 或 no", "yes"),
            (r"【用户问题】", "这是基于资料的回答：注意限盐。"),
        ])
        nodes = create_nodes(llm, store)
        app = build_medical_graph(nodes)
        events, final = _run(app, "高血压患者饮食要注意什么 限盐")
        names = [n for n, _ in events]
        assert names == ["router", "retrieve", "grade_loop", "summarizer"]
        assert "限盐" in final["final_answer"]
        assert final["messages"][-1].role == "assistant"

    def test_rewrite_then_best_effort(self, store):
        """All grades "no", no web tool: rewrite twice, then best-effort."""
        llm = RuleLLM([
            (r"yes 或 no", "no"),
            (r"改写后的问题", "改写：血压 饮食"),
            (r"信息有限", "尽力回答"),
        ])
        nodes = create_nodes(llm, store, cfg=GraphConfig(max_retrieval_loops=3))
        app = build_medical_graph(nodes)
        events, final = _run(app, "火星上如何养生")
        names = [n for n, _ in events]
        assert names.count("retrieve") == 3
        assert names[-1] == "summarizer"
        assert "尽力回答" in final["final_answer"]
        # the rewrite was appended, not replacing the original question
        user_msgs = [m for m in final["messages"] if m.role == "user"]
        assert len(user_msgs) == 3

    def test_web_search_path(self, store):
        calls = []

        def fake_web(q):
            calls.append(q)
            return [{"title": "最新指南", "content": "web内容", "url": "http://x"}]

        llm = RuleLLM([
            # grade no until web was used (web内容 in docs), then yes
            (r"yes 或 no(?s:.*)web内容", "yes"),
            (r"yes 或 no", "no"),
            (r"改写后的问题", "改写查询"),
            (r"【用户问题】", "基于网络资料的回答"),
        ])
        nodes = create_nodes(llm, store, web_search=fake_web,
                             cfg=GraphConfig(max_retrieval_loops=2))
        app = build_medical_graph(nodes)
        events, final = _run(app, "冷门问题xyzw")
        names = [n for n, _ in events]
        assert "web_search" in names
        assert calls, "web tool was never invoked"
        assert final["used_web_search"] is True
        assert "基于网络资料的回答" in final["final_answer"]

    def test_web_failure_fails_open(self, store):
        def broken_web(q):
            raise ConnectionError("no egress")

        llm = RuleLLM([
            (r"yes 或 no", "no"),
            (r"改写后的问题", "改写"),
            (r"信息有限", "兜底回答"),
        ])
        nodes = create_nodes(llm, store, web_search=broken_web,
                             cfg=GraphConfig(max_retrieval_loops=2))
        app = build_medical_graph(nodes)
        _, final = _run(app, "冷门问题")
        assert "兜底回答" in final["final_answer"]

    def test_assessment_mode_runs_calculators(self, store):
        llm = RuleLLM([
            (r"yes 或 no", "yes"),
            (r"【用户问题】", "建议保持运动。"),
        ])
        nodes = create_nodes(llm, store)
        app = build_medical_graph(nodes)
        events, final = _run(app, "我身高175cm，体重80kg，45岁男，帮我计算BMI")
        names = [n for n, _ in events]
        assert "assessment_tool" in names
        assert "BMI：26.1" in final["final_answer"]
        assert "基础代谢率" in final["final_answer"]

    def test_profile_injection_for_logged_in_user(self, store):
        extracted = []
        llm = RuleLLM([
            (r"yes 或 no", "yes"),
            (r"用户健康档案", "结合档案的回答（过敏注意）"),
            (r"【用户问题】", "普通回答"),
        ])
        nodes = create_nodes(
            llm, store,
            extract_health=lambda q, uid: extracted.append((q, uid)),
            load_profile=lambda uid: "对青霉素过敏",
        )
        app = build_medical_graph(nodes)
        _, final = _run(app, "感冒了怎么办 高血压", user_id="u42")
        assert extracted and extracted[0][1] == "u42"
        assert "结合档案的回答" in final["final_answer"]


class TestExtractJson:
    def test_plain(self):
        assert extract_json('{"a": 1}') == {"a": 1}

    def test_fenced(self):
        assert extract_json('```json\n[1, 2]\n```') == [1, 2]

    def test_embedded_prose(self):
        assert extract_json('结果如下：{"risk": "low", "n": 3} 供参考') == {
            "risk": "low", "n": 3}

    def test_garbage_returns_none(self):
        assert extract_json("完全不是JSON") is None


class TestWebClients:
    def test_fake_web_search_records(self):
        from mediquery_rag.llm.web import FakeWebSearch
        ws = FakeWebSearch([{"title": "t", "content": "c", "url": "u"}])
        assert ws("查询")[0]["title"] == "t"
        assert ws.queries == ["查询"]

    def test_tavily_without_key_is_safe(self, monkeypatch):
        from mediquery_rag.llm.web import TavilyClient
        monkeypatch.delenv("TAVILY_API_KEY", raising=False)
        t = TavilyClient()
        assert not t.available
        assert t("任何查询") == []     # no key -> no network, empty results


def test_checkpoint_steps_monotonic_across_invocations():
    """A shorter second run must not leave an earlier run's stale tail as
    the thread's latest() state."""
    ck = SqliteCheckpointer()
    g = StateGraph(reducers={"messages": append_reducer})
    g.add_node("a", lambda s: {"messages": ["a"], "tag": s.get("want")})
    g.add_node("b", lambda s: {"messages": ["b"]})
    g.set_entry("a")
    g.add_conditional_edges("a", lambda s: "long" if s.get("want") == 1 else "end",
                            {"long": "b", "end": END})
    g.add_edge("b", END)
    app = g.compile(checkpointer=ck)
    app.invoke({"want": 1}, thread_id="t")      # 2 steps
    app.invoke({"want": 2}, thread_id="t")      # 1 step (shorter)
    latest = ck.latest("t")
    assert latest["tag"] == 2                   # the SECOND run's state
    assert latest["messages"] == ["a", "b", "a"]
