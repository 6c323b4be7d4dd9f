"""Grammar-constrained JSON decoding (models/constrain.py + generate.py).

The reference's three JSON seams (structured_consultation.py:589-652 and
:835-919, health_extractor.py:72) all parse LLM output and fail open on
garbage; constrained decoding makes valid JSON a decoder property instead.
These tests pin (a) the DFA compiler's accept/reject semantics, (b) the
valid-by-construction guarantee through the jitted decode loop with a
random-weight model (the adversarial case: an untrained model emits
arbitrary bytes, so any structure in the output comes from the mask alone),
and (c) the exact-budget property that rules out mid-grammar truncation.
"""

import json

import numpy as np
import pytest

from mediquery_rag.config import DecoderConfig
from mediquery_rag.models.byte_tokenizer import ByteTokenizer
from mediquery_rag.models.constrain import (
    EXTRACT_SCHEMA, FOLLOWUP_SCHEMA, RISK_SCHEMA, JsonConstraint)
from mediquery_rag.models.generate import Generator

TINY = DecoderConfig(vocab_size=384, hidden=64, layers=2, heads=4,
                     mlp_dim=128, max_len=2048, dtype="float32")

SCHEMAS = {"risk": RISK_SCHEMA, "followup": FOLLOWUP_SCHEMA,
           "extract": EXTRACT_SCHEMA}


def _compile(schema):
    return JsonConstraint.compile(schema, ByteTokenizer(),
                                  vocab_size=TINY.vocab_size)


class TestCompiler:
    @pytest.mark.parametrize("name", sorted(SCHEMAS))
    def test_tables_and_budget(self, name):
        c = _compile(SCHEMAS[name])
        assert c.next_table.shape[1] == 257
        assert c.tok2sym.shape == (TINY.vocab_size,)
        # 256 byte tokens + EOS are mapped, everything else is forbidden
        assert int((c.tok2sym >= 0).sum()) == 257
        assert c.max_len_bytes > 2

    def test_risk_accepts_exact_contract(self):
        c = _compile(RISK_SCHEMA)
        assert c.accepts('{"risk":"LOW","severity":2,"reason":"观察即可"}')
        assert c.accepts('{"risk":"CRITICAL","severity":10,"reason":"x"}')
        # wrong enum, out-of-range int, missing key, whitespace, reorder
        assert not c.accepts('{"risk":"NONE","severity":2,"reason":"x"}')
        assert not c.accepts('{"risk":"LOW","severity":11,"reason":"x"}')
        assert not c.accepts('{"risk":"LOW","severity":2}')
        assert not c.accepts('{"risk": "LOW","severity":2,"reason":"x"}')
        assert not c.accepts('{"severity":2,"risk":"LOW","reason":"x"}')
        # prefix without EOS is not accepting
        assert not c.accepts('{"risk":"LOW","severity":2,"reason":"x"')

    def test_string_budget_and_escapes(self):
        c = JsonConstraint.compile(
            {"type": "string", "max_bytes": 4}, ByteTokenizer(),
            vocab_size=TINY.vocab_size)
        assert c.accepts('"ab"') and c.accepts('""') and c.accepts('"abcd"')
        assert c.accepts('"a\\n"')          # escape costs its 2 raw bytes
        assert not c.accepts('"abcde"')     # over budget
        assert not c.accepts('"a"b"')       # unescaped quote
        assert not c.accepts('"a\\xb"')     # bad escape char

    def test_array_bounds(self):
        c = JsonConstraint.compile(
            {"type": "array", "min_items": 1, "max_items": 2,
             "items": {"type": "boolean"}},
            ByteTokenizer(), vocab_size=TINY.vocab_size)
        assert c.accepts("[true]") and c.accepts("[true,false]")
        assert not c.accepts("[]")
        assert not c.accepts("[true,false,true]")
        # extract schema allows [] (min_items 0)
        assert _compile(EXTRACT_SCHEMA).accepts("[]")

    def test_integer_range_is_exact(self):
        c = JsonConstraint.compile(
            {"type": "integer", "min": 0, "max": 12}, ByteTokenizer(),
            vocab_size=TINY.vocab_size)
        for i in range(13):
            assert c.accepts(str(i))
        for bad in ["13", "-1", "007", "1.5", ""]:
            assert not c.accepts(bad)

    def test_max_len_bytes_is_tight(self):
        # enum-only schema: longest literal + EOS step, computable by hand
        c = JsonConstraint.compile(
            {"type": "enum", "values": ["LOW", "CRITICAL"]},
            ByteTokenizer(), vocab_size=TINY.vocab_size)
        assert c.max_len_bytes == len('"CRITICAL"') + 1


class TestConstrainedGeneration:
    @pytest.fixture(scope="class")
    def gen(self):
        return Generator(TINY)

    @pytest.mark.parametrize("name", sorted(SCHEMAS))
    def test_valid_json_from_random_weights(self, gen, name):
        c = JsonConstraint.compile(SCHEMAS[name], gen.tokenizer,
                                   vocab_size=TINY.vocab_size)
        outs = gen.generate(["患者主诉：胸闷两天。", "头痛发热。"],
                            constraint=c, temperature=0.9, seed=7)
        assert len(outs) == 2
        for s in outs:
            obj = json.loads(s)          # parses
            assert c.accepts(s)          # and the DFA agrees
            if name == "risk":
                assert obj["risk"] in {"CRITICAL", "HIGH", "MEDIUM", "LOW"}
                assert 0 <= obj["severity"] <= 10
            elif name == "followup":
                assert set(obj) == {"need_followup", "question", "options",
                                    "reason"}
                assert isinstance(obj["need_followup"], bool)
            else:
                for item in obj:
                    assert item["category"] in {"allergy", "medication",
                                                "disease", "lifestyle",
                                                "basic"}

    def test_budget_beats_small_cap(self, gen):
        # the exact-longest-path budget overrides a too-small user cap, so
        # truncated JSON is impossible by construction
        c = JsonConstraint.compile(RISK_SCHEMA, gen.tokenizer,
                                   vocab_size=TINY.vocab_size)
        s = gen.generate(["x"], constraint=c, max_new_tokens=1,
                         temperature=0.9, seed=1)[0]
        json.loads(s)
        assert c.accepts(s)

    def test_greedy_is_deterministic_and_valid(self, gen):
        c = JsonConstraint.compile(RISK_SCHEMA, gen.tokenizer,
                                   vocab_size=TINY.vocab_size)
        a = gen.generate(["血压 180/120"], constraint=c)[0]
        b = gen.generate(["血压 180/120"], constraint=c)[0]
        assert a == b
        json.loads(a)

    def test_vocab_mismatch_raises(self, gen):
        c = JsonConstraint.compile(RISK_SCHEMA, gen.tokenizer,
                                   vocab_size=TINY.vocab_size)
        c.tok_len = np.resize(c.tok_len, (17,))
        with pytest.raises(ValueError, match="vocab"):
            gen.generate(["x"], constraint=c)

    def test_unconstrained_path_unchanged(self, gen):
        out = gen.generate(["你好"], max_new_tokens=8, temperature=0.5,
                           seed=0)
        assert len(out) == 1 and isinstance(out[0], str)


class TestAppSeams:
    """The reference's failure mode — unparseable LLM JSON → fail-open
    fallback — cannot happen through a on-device client: even a RANDOM-weight
    model yields schema-valid triage/extraction through the real app code."""

    @pytest.fixture(scope="class")
    def llm(self):
        from mediquery_rag.llm.device_client import DeviceLLMClient
        return DeviceLLMClient(Generator(TINY), temperature=0.9)

    def test_triage_never_falls_back(self, llm):
        from mediquery_rag.app.risk import assess_answer_risk
        r = assess_answer_risk("疼痛程度如何？", "大概5分吧", llm)
        assert r.source == "llm"     # parsed, not the fail-open fallback
        assert r.level in {"CRITICAL", "HIGH", "MEDIUM", "LOW"}
        assert 0 <= r.severity <= 10

    def test_extractor_output_parses(self, llm):
        from mediquery_rag.app.memory.health_extractor import (
            extract_health_info)
        from mediquery_rag.app.memory.profile_store import ProfileStore
        store = ProfileStore()
        # random weights may emit 0..8 records; the invariant is that
        # the pipeline runs without the fail-open early return firing
        # on a parse error — count is whatever the model said
        n = extract_health_info("我对青霉素过敏", "u1", llm, store)
        assert n >= 0

    def test_schema_kwarg_ignored_by_fakes(self):
        from mediquery_rag.llm.client import FakeLLM
        from mediquery_rag.models.constrain import RISK_SCHEMA
        fake = FakeLLM(['{"risk":"LOW","severity":1,"reason":"x"}'])
        out = fake.complete("q", schema=RISK_SCHEMA)
        assert json.loads(out)["risk"] == "LOW"


class TestTokenizerProjection:
    def test_byte_tokenizer_ids(self):
        ids = ByteTokenizer().byte_token_ids()
        assert ids.shape == (256,) and len(set(ids.tolist())) == 256

    def test_bpe_tokenizer_ids(self, tmp_path):
        pytest.importorskip("tokenizers")
        from tests.test_hf_import import _write_tiny_tokenizer
        from mediquery_rag.models.bpe_tokenizer import BPETokenizer
        _write_tiny_tokenizer(str(tmp_path))
        tok = BPETokenizer.from_pretrained(str(tmp_path), max_len=512)
        ids = tok.byte_token_ids()
        assert ids.shape == (256,) and len(set(ids.tolist())) == 256
        # projection really maps ids back to their bytes
        c = JsonConstraint.compile(RISK_SCHEMA, tok,
                                   vocab_size=len(tok.vocab))
        assert int((c.tok2sym >= 0).sum()) == 257

    def test_token_byte_table_matches_vocab(self, tmp_path):
        pytest.importorskip("tokenizers")
        from tests.test_hf_import import _write_tiny_tokenizer
        from mediquery_rag.models.bpe_tokenizer import BPETokenizer
        _write_tiny_tokenizer(str(tmp_path))
        tok = BPETokenizer.from_pretrained(str(tmp_path), max_len=512)
        tb, tl = tok.token_byte_table()
        assert tl.max() > 1              # real multi-byte tokens exist
        # every mapped row decodes back to its vocab token's bytes
        inv = {v: k for k, v in tok.vocab.items()}
        for i in np.flatnonzero(tl)[:50]:
            raw = bytes(tb[i, : tl[i]].tolist())
            expect = bytes(tok._byte_dec[ch] for ch in inv[int(i)])
            assert raw == expect
        # specials are excluded (decode() drops them)
        for sid in tok.specials.values():
            assert tl[sid] == 0


class TestTokenLevelBPE:
    """Token-level constrained decoding with a real byte-level-BPE vocab:
    the model generates with its native multi-byte tokens (not projected to
    single bytes) and the output is still schema-valid by construction."""

    @pytest.fixture(scope="class")
    def gen(self, tmp_path_factory):
        pytest.importorskip("tokenizers")
        from tests.test_hf_import import _write_tiny_tokenizer
        from mediquery_rag.models.bpe_tokenizer import BPETokenizer
        d = str(tmp_path_factory.mktemp("bpe"))
        _write_tiny_tokenizer(d)
        tok = BPETokenizer.from_pretrained(d, max_len=512)
        cfg = DecoderConfig(vocab_size=len(tok.vocab), hidden=64, layers=2,
                            heads=4, mlp_dim=128, max_len=2048,
                            dtype="float32")
        return Generator(cfg, tokenizer=tok)

    @pytest.mark.parametrize("name", ["risk", "followup"])
    def test_valid_json_with_bpe_vocab(self, gen, name):
        c = JsonConstraint.compile(SCHEMAS[name], gen.tokenizer,
                                   vocab_size=gen.cfg.vocab_size)
        s = gen.generate(["血压 150/95，头晕"], constraint=c,
                         temperature=0.9, seed=11)[0]
        json.loads(s)
        assert c.accepts(s)
