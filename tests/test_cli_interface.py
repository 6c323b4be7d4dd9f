"""Script-driven CLI integration tests (VERDICT r2 item 8).

Drives ``cli/interface.py``'s interactive loops end-to-end with scripted
stdin and a FakeLLM — all four menu entries, including the health-advisor
CRITICAL abort path — against a real AppContext built in a tmp root
(reference flows: /root/reference/src/ui/interface.py:40-60).
"""

import os
import shutil

import pytest

from mediquery_rag.cli.context import AppContext
from mediquery_rag.cli import interface


@pytest.fixture(scope="module")
def ctx(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_root")
    os.makedirs(root / "data", exist_ok=True)
    shutil.copy("data/medical_data.txt", root / "data" / "medical_data.txt")
    return AppContext.build(str(root), fake_llm=True)


def _drive(monkeypatch, answers):
    """Feed ``answers`` to input(); exhaustion raises EOFError (the
    interface treats it as end-of-input and exits cleanly)."""
    it = iter(answers)

    def fake_input(prompt=""):
        try:
            return next(it)
        except StopIteration:
            raise EOFError

    monkeypatch.setattr("builtins.input", fake_input)


class TestMainMenu:
    def test_quit(self, ctx, monkeypatch, capsys):
        _drive(monkeypatch, ["q"])
        interface.main_menu(ctx)
        out = capsys.readouterr().out
        assert "MediQuery" in out and "再见" in out

    def test_eof_quits(self, ctx, monkeypatch, capsys):
        _drive(monkeypatch, [])
        interface.main_menu(ctx)
        assert "再见" in capsys.readouterr().out


class TestScienceQA:
    def test_question_retrieves_and_answers(self, ctx, monkeypatch, capsys):
        _drive(monkeypatch, ["2", "高血压患者平时吃饭要注意什么", "q", "q"])
        interface.main_menu(ctx)
        out = capsys.readouterr().out
        assert "检索到" in out            # retrieve event surfaced
        assert "健康科普问答" in out

    def test_blank_line_skipped(self, ctx, monkeypatch, capsys):
        _drive(monkeypatch, ["2", "   ", "q", "q"])
        interface.main_menu(ctx)
        assert "检索到" not in capsys.readouterr().out


class TestHealthAdvisor:
    ANSWERS_BASIC = ["李四", "35", "男", "175", "70",
                     "无", "无", "无", "无"]

    def test_critical_abort(self, ctx, monkeypatch, capsys):
        # chief complaint hits the emergency-keyword hard rule -> abort
        _drive(monkeypatch, ["1", "13800001111", *self.ANSWERS_BASIC,
                             "症状咨询", "最近总觉得不想活了", "q"])
        interface.main_menu(ctx)
        out = capsys.readouterr().out
        assert "问诊终止" in out and "立即就医" in out
        # the RAG hand-off must NOT have run ("个性化建议" alone also
        # appears in the menu banner — match the hand-off line)
        assert "正在为您生成个性化建议" not in out

    def test_anonymous_interrupt_preserves_graceful_exit(
            self, ctx, monkeypatch, capsys):
        # anonymous login, stop answering mid-intake: clean abort message
        _drive(monkeypatch, ["1", "", "王五", "40"])
        interface.main_menu(ctx)
        out = capsys.readouterr().out
        assert "问诊中止" in out

    def test_full_flow_reaches_rag(self, ctx, monkeypatch, capsys):
        answers = ["1", "13800002222", *self.ANSWERS_BASIC,
                   "健康管理", "减重", "每周快走三次", "7", "q"]
        _drive(monkeypatch, answers)
        interface.main_menu(ctx)
        out = capsys.readouterr().out
        assert "正在为您生成个性化建议" in out   # reached the RAG hand-off
        assert "问诊记录已保存" in out     # markdown history written


class TestHITLAndProfile:
    def test_hitl_review_entry(self, ctx, monkeypatch, capsys):
        _drive(monkeypatch, ["3", "q"])
        interface.main_menu(ctx)
        out = capsys.readouterr().out
        assert "审核队列" in out and "本次处理" in out

    def test_profile_view_unknown_phone(self, ctx, monkeypatch, capsys):
        _drive(monkeypatch, ["4", "19999990000", "q"])
        interface.main_menu(ctx)
        assert "没有问诊档案" in capsys.readouterr().out

    def test_profile_view_after_consultation(self, ctx, monkeypatch,
                                              capsys):
        # the advisor run above persisted 13800002222's profile;
        # profile view must find it read-only
        _drive(monkeypatch, ["4", "13800002222", "q"])
        interface.main_menu(ctx)
        out = capsys.readouterr().out
        assert "基本档案" in out
        assert "李四" in out
