"""Memory subsystem tests: profile store, extractor, summary, HITL, markdown."""

import os

from mediquery_rag.app.memory import (
    HITLManager,
    ProfileStore,
    UserProfileMarkdown,
    extract_health_info,
    load_health_profile,
    should_summarize,
    summarize_messages,
)
from mediquery_rag.config import MemoryConfig
from mediquery_rag.llm import FakeLLM, ai, user


class TestProfileStore:
    def test_add_and_dedup(self):
        s = ProfileStore()
        assert s.add_health_record("u1", "allergy", "青霉素过敏", True)
        assert not s.add_health_record("u1", "allergy", "青霉素过敏", True)
        assert len(s.get_health_records("u1")) == 1

    def test_important_first_ordering(self):
        s = ProfileStore()
        s.add_health_record("u1", "lifestyle", "每天跑步", False)
        s.add_health_record("u1", "medication", "二甲双胍", True)
        recs = s.get_health_records("u1")
        assert recs[0].category == "medication"

    def test_category_query_and_delete(self):
        s = ProfileStore()
        s.add_health_record("u1", "disease", "高血压", True)
        s.add_health_record("u1", "lifestyle", "久坐", False)
        ds = s.get_records_by_category("u1", "disease")
        assert len(ds) == 1
        assert s.delete_record(ds[0].record_id)
        assert s.get_records_by_category("u1", "disease") == []

    def test_clear_user(self):
        s = ProfileStore()
        s.add_health_record("u1", "basic", "170cm", False)
        s.add_health_record("u2", "basic", "160cm", False)
        assert s.clear_user_records("u1") == 1
        assert len(s.get_health_records("u2")) == 1

    def test_markdown_sync_live(self, tmp_path):
        md = UserProfileMarkdown(str(tmp_path))
        s = ProfileStore(markdown_sync=md)
        s.add_health_record("u9", "allergy", "海鲜过敏", True)
        content = open(tmp_path / "u9.md", encoding="utf-8").read()
        assert "海鲜过敏" in content and "[重要]" in content
        assert "u9" in open(tmp_path / "INDEX.md", encoding="utf-8").read()


class TestExtractor:
    def test_extracts_and_stores(self):
        llm = FakeLLM(['[{"category": "allergy", "content": "花生过敏", "important": true}]'])
        s = ProfileStore()
        n = extract_health_info("我对花生过敏", "u1", llm, s)
        assert n == 1
        recs = s.get_health_records("u1")
        assert recs[0].content == "花生过敏" and recs[0].important

    def test_anonymous_skipped(self):
        llm = FakeLLM()
        assert extract_health_info("我对花生过敏", "anonymous", llm, ProfileStore()) == 0
        assert llm.calls == []

    def test_fenced_json_and_unknown_category(self):
        llm = FakeLLM(['```json\n[{"category": "weird", "content": "喜欢跑步"}]\n```'])
        s = ProfileStore()
        assert extract_health_info("x", "u1", llm, s) == 1
        assert s.get_health_records("u1")[0].category == "basic"

    def test_garbage_fails_open(self):
        llm = FakeLLM(["不是JSON"])
        assert extract_health_info("x", "u1", llm, ProfileStore()) == 0

    def test_profile_rendering(self):
        s = ProfileStore()
        s.add_health_record("u1", "allergy", "青霉素过敏", True)
        s.add_health_record("u1", "lifestyle", "每周健身3次", False)
        text = load_health_profile("u1", s)
        assert text.index("重要提醒") < text.index("生活习惯")
        assert "青霉素过敏" in text
        assert load_health_profile("nobody", s) == ""


class TestSummary:
    def test_threshold(self):
        cfg = MemoryConfig()
        msgs = [user(f"m{i}") for i in range(16)]
        assert not should_summarize(msgs, cfg)
        assert should_summarize(msgs + [user("one more")], cfg)

    def test_compression_keeps_tail(self):
        cfg = MemoryConfig()
        msgs = [user(f"消息{i}") for i in range(20)]
        llm = FakeLLM(["摘要内容：血压140"])
        out = summarize_messages(msgs, llm, cfg)
        assert len(out) == 1 + cfg.keep_recent_messages
        assert out[0].role == "system" and "血压140" in out[0].content
        assert out[-1].content == "消息19"

    def test_truncation_of_old_messages(self):
        cfg = MemoryConfig()
        msgs = [user("x" * 2000)] * 18
        llm = FakeLLM(["ok"])
        summarize_messages(msgs, llm, cfg)
        assert "x" * 501 not in llm.calls[0]


class TestHITL:
    def test_low_risk_auto_approved(self, tmp_path):
        s = ProfileStore()
        h = HITLManager(str(tmp_path), s)
        req = h.submit("u1", "我平时喜欢夜跑",
                       [{"category": "lifestyle", "content": "夜跑", "important": False}])
        assert req.status == "approved"
        assert s.get_health_records("u1")[0].content == "夜跑"
        assert h.stats()["approved"] == 1 and h.stats()["pending"] == 0

    def test_high_risk_queued_then_human_approved(self, tmp_path):
        s = ProfileStore()
        h = HITLManager(str(tmp_path), s)
        req = h.submit("u1", "我在吃华法林",
                       [{"category": "medication", "content": "华法林", "important": True}])
        assert req.risk == "HIGH" and req.status == "pending"
        assert s.get_health_records("u1") == []
        # human edits status in the pending markdown
        path = os.path.join(str(tmp_path), "pending", f"{req.request_id}.md")
        text = open(path, encoding="utf-8").read().replace(
            "status: pending", "status: approved")
        open(path, "w", encoding="utf-8").write(text)
        result = h.process_reviews()
        assert result["applied"] == 1
        assert s.get_health_records("u1")[0].content == "华法林"
        assert not os.path.exists(path)

    def test_rejected_archived_without_apply(self, tmp_path):
        s = ProfileStore()
        h = HITLManager(str(tmp_path), s)
        req = h.submit("u1", "确诊糖尿病",
                       [{"category": "disease", "content": "糖尿病", "important": True}])
        path = os.path.join(str(tmp_path), "pending", f"{req.request_id}.md")
        text = open(path, encoding="utf-8").read().replace(
            "status: pending", "status: rejected")
        open(path, "w", encoding="utf-8").write(text)
        out = h.process_reviews()
        assert out["rejected"] == 1
        assert s.get_health_records("u1") == []
        assert h.stats()["rejected"] == 1


class TestExtractionThroughHITL:
    def test_high_risk_extraction_queued_not_stored(self, tmp_path):
        """Allergy extractions must wait for human review when a HITL
        manager is wired (LLM hallucinations of safety-critical facts
        previously flowed straight into every future prompt)."""
        from mediquery_rag.app.memory.hitl import HITLManager
        store = ProfileStore(":memory:")
        hitl = HITLManager(str(tmp_path / "review"), store)
        llm = FakeLLM(['[{"category": "allergy", "content": "青霉素过敏", '
                       '"important": true}]'])
        n = extract_health_info("我对青霉素过敏", "u1", llm, store, hitl=hitl)
        assert n == 1
        assert store.get_health_records("u1") == []     # not yet applied
        assert hitl.stats()["pending"] == 1

    def test_low_risk_extraction_auto_applied(self, tmp_path):
        from mediquery_rag.app.memory.hitl import HITLManager
        store = ProfileStore(":memory:")
        hitl = HITLManager(str(tmp_path / "review"), store)
        llm = FakeLLM(['[{"category": "lifestyle", "content": "每周跑步三次", '
                       '"important": false}]'])
        n = extract_health_info("我每周跑步三次", "u2", llm, store, hitl=hitl)
        assert n == 1
        recs = store.get_health_records("u2")
        assert recs and "跑步" in recs[0].content
        assert hitl.stats()["pending"] == 0
