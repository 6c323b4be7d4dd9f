"""Risk triage + structured consultation state machine tests."""

import json
import os

import pytest

from mediquery_rag.app.consultation import Stage, StructuredConsultation
from mediquery_rag.app.risk import (
    CRITICAL, HIGH, LOW, MEDIUM,
    assess_answer_risk, final_assessment, keyword_emergency,
)
from mediquery_rag.app.tools import calculate_bmi, parse_body_params, run_assessment
from mediquery_rag.config import ConsultationConfig
from mediquery_rag.llm import FakeLLM, RuleLLM


class TestTools:
    def test_bmi(self):
        r = calculate_bmi(80, 175)
        assert r["bmi"] == 26.1 and r["category"] == "超重"

    def test_parse_params(self):
        p = parse_body_params("我身高175cm，体重80kg，45岁男")
        assert p == {"height_cm": 175.0, "weight_kg": 80.0, "age": 45, "gender": "男"}

    def test_run_assessment_partial(self):
        assert run_assessment("就是问问") is None
        out = run_assessment("身高160 体重50kg 女 30岁")
        assert "BMI" in out and "基础代谢率" in out


class TestRisk:
    def test_emergency_keyword_overrides_llm(self):
        llm = FakeLLM(['{"risk": "LOW"}'])
        r = assess_answer_risk("最近感觉如何", "我不想活了", llm)
        assert r.level == CRITICAL and r.source == "rule"
        assert "120" in r.message or "12356" in r.message
        assert llm.calls == []   # LLM never consulted on hard rule

    def test_llm_triage_high(self):
        llm = FakeLLM(['{"risk": "HIGH", "severity": 8, "reason": "持续胸痛"}'])
        r = assess_answer_risk("有什么症状", "胸口一直疼", llm)
        assert r.level == HIGH and r.severity == 8 and "就医" in r.message

    def test_parse_failure_fails_open_low(self):
        r = assess_answer_risk("q", "头有点晕", FakeLLM(["乱七八糟"]))
        assert r.level == LOW and r.source == "fallback"

    def test_parse_failure_fail_mode_medium(self):
        cfg = ConsultationConfig(risk_fail_mode="medium")
        r = assess_answer_risk("q", "头有点晕", FakeLLM(["乱"]), cfg)
        assert r.level == MEDIUM

    def test_final_assessment_floor(self):
        assert final_assessment("偶尔胸闷", 0, LOW) == MEDIUM
        assert final_assessment("没什么", 7, LOW) == MEDIUM
        assert final_assessment("没什么", 2, LOW) == LOW
        assert final_assessment("胸闷", 9, HIGH) == HIGH  # never downgrades


NO_FOLLOWUP = '{"need_followup": false}'


def make_sc(tmp_path, llm=None):
    llm = llm or RuleLLM([
        (r"need_followup", NO_FOLLOWUP),
        (r"risk", '{"risk": "LOW", "severity": 1, "reason": "轻微"}'),
        (r"评价", "身体指标总体正常。"),
    ])
    return StructuredConsultation(llm, data_dir=str(tmp_path))


def drive(sc, answers):
    """Feed scripted answers keyed by question key (callable or str)."""
    seen = []
    for _ in range(50):
        q = sc.get_current_question()
        if q is None:
            break
        seen.append(q["key"])
        a = answers.get(q["key"])
        if a is None:
            a = answers.get("__default__", "无")
        r = sc.process_answer(a() if callable(a) else a)
        assert r["ok"], r
    return seen


BASIC = {
    "name": "张三", "age": "45", "gender": "男",
    "height_cm": "175", "weight_kg": "80",
    "chronic": "无", "allergy": "无", "medication": "无",
}


class TestConsultation:
    def test_identity_stable_and_persisted(self, tmp_path):
        sc = make_sc(tmp_path)
        p1 = sc.identify_user("13800138000")
        p2 = StructuredConsultation(FakeLLM(), str(tmp_path)).identify_user(
            "13800138000")
        assert p1.user_id == p2.user_id
        assert os.path.exists(tmp_path / p1.user_id / "profile.json")

    def test_full_symptom_flow(self, tmp_path):
        sc = make_sc(tmp_path)
        sc.identify_user("100")
        assert sc.start_session() == Stage.BASIC_INFO
        answers = dict(BASIC)
        answers.update({
            "consult_type": "症状咨询",
            "chief_complaint": "最近经常头晕",
            "duration": "两周",
            "severity": "4",
        })
        seen = drive(sc, answers)
        assert sc.is_complete
        assert "chief_complaint" in seen
        sm = sc.get_consultation_summary()
        assert sm["age"] == 45 and sm["consult_type"] == "症状咨询"
        assert sm["health_metrics"], "calculators should have run"
        q = sc.build_rag_query()
        assert "【咨询需求】" in q and "头晕" in q

    def test_complete_profile_skips_basics(self, tmp_path):
        sc = make_sc(tmp_path)
        sc.identify_user("101")
        sc.start_session()
        drive(sc, {**BASIC, "consult_type": "健康管理",
                   "health_goal": "减重", "exercise": "很少", "sleep": "6"})
        # second session: profile already complete
        sc2 = make_sc(tmp_path)
        sc2.identify_user("101")
        stage = sc2.start_session()
        assert stage == Stage.CONSULTATION_TYPE
        assert sc2.session.health_metrics        # analysis ran at start
        q = sc2.get_current_question()
        assert q["key"] == "consult_type"

    def test_followup_rounds_capped(self, tmp_path):
        always_follow = RuleLLM([
            (r"need_followup",
             '{"need_followup": true, "question": "再追问一下？", "options": [], "reason": "r"}'),
            (r"risk", '{"risk": "LOW", "severity": 0, "reason": ""}'),
            (r"评价", "ok"),
        ])
        sc = make_sc(tmp_path, always_follow)
        sc.identify_user("102")
        sc.start_session()
        answers = {**BASIC, "consult_type": "症状咨询",
                   "chief_complaint": "咳嗽", "duration": "三天", "severity": "3",
                   "__followup__": "好的"}
        seen = drive(sc, answers)
        assert sc.is_complete
        assert seen.count("__followup__") == 3   # hard cap

    def test_critical_stops_followups_and_flags(self, tmp_path):
        llm = RuleLLM([
            (r"need_followup", NO_FOLLOWUP),
            (r"评价", "ok"),
        ])
        sc = make_sc(tmp_path, llm)
        sc.identify_user("103")
        sc.start_session()
        answers = {**BASIC, "consult_type": "症状咨询",
                   "chief_complaint": "胸口剧痛到不想活了",
                   "duration": "一小时", "severity": "9"}
        drive(sc, answers)
        assert sc.session.risk_level == CRITICAL
        assert any("120" in m for m in sc.session.risk_messages)

    def test_validation_rejects_bad_input(self, tmp_path):
        sc = make_sc(tmp_path)
        sc.identify_user("104")
        sc.start_session()
        sc.process_answer("张三")                  # name ok
        r = sc.process_answer("四十五")            # age must be numeric
        assert not r["ok"] and "数字" in r["error"]
        r = sc.process_answer("45")
        assert r["ok"]
        r = sc.process_answer("外星人")            # gender choice invalid
        assert not r["ok"]
        r = sc.process_answer("1")                 # numeric choice pick
        assert r["ok"] and sc.profile.gender == "男"

    def test_history_and_similarity(self, tmp_path):
        sc = make_sc(tmp_path)
        sc.identify_user("105")
        sc.start_session()
        drive(sc, {**BASIC, "consult_type": "症状咨询",
                   "chief_complaint": "反复头晕目眩", "duration": "一周",
                   "severity": "5"})
        sc2 = make_sc(tmp_path)
        sc2.identify_user("105")
        sc2.start_session()
        hist = sc2.get_history_summary()
        assert len(hist) == 1 and "头晕" in hist[0]["chief_complaint"]
        sim = sc2.find_similar_history("又开始头晕目眩了")
        assert sim is not None
        assert sc2.find_similar_history("脚踝扭伤") is None
        md_path = sc2.generate_history_markdown()
        assert "头晕" in open(md_path, encoding="utf-8").read()

    def test_resume_interrupted_intake(self, tmp_path):
        """Profile JSON written after every answer → interrupt loses nothing."""
        sc = make_sc(tmp_path)
        sc.identify_user("106")
        sc.start_session()
        sc.process_answer("李四")
        sc.process_answer("30")
        # crash; new process
        sc2 = make_sc(tmp_path)
        p = sc2.identify_user("106")
        assert p.name == "李四" and p.age == 30
        sc2.start_session()
        q = sc2.get_current_question()
        assert q["key"] == "gender"               # resumes where it left off


class TestReviewRegressions:
    def test_severity_parse_failure_keeps_critical(self):
        """A malformed optional severity must not downgrade a valid
        CRITICAL verdict to LOW (clinical fail-open direction)."""
        from mediquery_rag.app.risk import CRITICAL, assess_answer_risk
        llm = FakeLLM(['{"risk": "CRITICAL", "severity": null, '
                       '"reason": "急性症状"}'])
        r = assess_answer_risk("症状", "持续剧烈胸痛并放射到左臂", llm)
        assert r.level == CRITICAL
        assert r.message            # hotline shown

    def test_partial_history_not_complete(self):
        """chronic answered but allergy/medication never asked => the
        profile must NOT be complete (or-chain once skipped them forever)."""
        from mediquery_rag.app.consultation import UserProfile
        p = UserProfile(user_id="u", name="张三", age=40, gender="男",
                        height_cm=175.0, weight_kg=70.0, chronic="高血压")
        assert not p.is_complete()
        p.allergy = "无"
        p.medication = "无"
        assert p.is_complete()

    def test_number_validation_rejects_inf_nan(self, tmp_path):
        from mediquery_rag.app.consultation import StructuredConsultation
        sc = StructuredConsultation(FakeLLM(), data_dir=str(tmp_path))
        sc.identify_user("13800000000")
        sc.start_session()
        # walk to the age question
        while True:
            q = sc.get_current_question()
            assert q is not None
            if q["key"] == "age":
                break
            sc.process_answer("测试")
        for bad in ("inf", "nan", "-inf"):
            r = sc.process_answer(bad)
            assert not r["ok"]

    def test_numeric_range_validation(self, tmp_path):
        """Reference parity (structured_consultation.py:195-212): age 0-120,
        height 50-250, weight 20-300, severity 0-10 — 'age 999' rejected."""
        sc = make_sc(tmp_path)
        sc.identify_user("106")
        sc.start_session()
        sc.process_answer("张三")                 # name
        r = sc.process_answer("999")              # age out of range
        assert not r["ok"] and "0-120" in r["error"]
        assert sc.process_answer("45")["ok"]
        sc.process_answer("男")                   # gender
        r = sc.process_answer("500")              # height out of range
        assert not r["ok"] and "50-250" in r["error"]
        assert sc.process_answer("175")["ok"]
        r = sc.process_answer("5")                # weight out of range
        assert not r["ok"] and "20-300" in r["error"]
        assert sc.process_answer("80")["ok"]
        # walk to severity and bound-check it
        answers = {"chronic": "无", "family_history": "无", "allergy": "无",
                   "medication": "无", "consult_type": "症状咨询",
                   "chief_complaint": "头晕", "duration": "一周"}
        while True:
            q = sc.get_current_question()
            if q is None or q["key"] == "severity":
                break
            a = answers.get(q["key"], "无")
            assert sc.process_answer(a)["ok"]
        r = sc.process_answer("15")
        assert not r["ok"] and "0-10" in r["error"]
        assert sc.process_answer("4")["ok"]

    def test_family_history_multi_choice(self, tmp_path):
        sc = make_sc(tmp_path)
        sc.identify_user("107")
        sc.start_session()
        answers = {**BASIC, "family_history": "高血压，糖尿病",
                   "consult_type": "症状咨询", "chief_complaint": "最近头晕",
                   "duration": "两周", "severity": "4"}
        seen = drive(sc, answers)
        assert "family_history" in seen
        assert sc.profile.family_history == ["高血压", "糖尿病"]
        q = sc.build_rag_query()
        assert "家族史：高血压、糖尿病" in q
        # invalid option rejected
        sc2 = make_sc(tmp_path)
        sc2.identify_user("108")
        sc2.start_session()
        while True:
            q = sc2.get_current_question()
            if q["key"] == "family_history":
                break
            sc2.process_answer(BASIC.get(q["key"], "无"))
        r = sc2.process_answer("外星病")
        assert not r["ok"] and "无效选项" in r["error"]
        assert sc2.process_answer("无")["ok"]
        assert sc2.profile.family_history == ["无"]

    def test_corrupt_session_file_skipped(self, tmp_path):
        from mediquery_rag.app.consultation import StructuredConsultation
        sc = StructuredConsultation(FakeLLM(), data_dir=str(tmp_path))
        p = sc.identify_user("13811112222")
        sc.start_session()
        d = os.path.join(str(tmp_path), p.user_id, "sessions")
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "zzz_corrupt.json"), "w") as f:
            f.write('{"session_id": "trunc')
        assert sc.get_history_summary() == []   # must not raise
