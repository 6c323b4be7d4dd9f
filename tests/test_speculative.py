"""Speculative decoding (models/speculative.py).

The contract: output is the TARGET's exact greedy continuation no matter
what the draft proposes — draft quality moves only the speed (accepted
tokens per verify round). Tests pin the lossless property with an
adversarial (random, disagreeing) draft, and the acceptance mechanics
with a perfectly-agreeing draft (the target itself).
"""

import pytest

from mediquery_rag.config import DecoderConfig
from mediquery_rag.models.generate import Generator
from mediquery_rag.models.speculative import SpeculativeGenerator

TARGET = DecoderConfig(vocab_size=384, hidden=64, layers=2, heads=4,
                       mlp_dim=128, max_len=1024, dtype="float32")
DRAFT = DecoderConfig(vocab_size=384, hidden=32, layers=1, heads=2,
                      mlp_dim=64, max_len=1024, dtype="float32")

PROMPTS = ["高血压的饮食建议", "头痛", "BMI 如何计算？"]


@pytest.fixture(scope="module")
def target():
    return Generator(TARGET)


@pytest.fixture(scope="module")
def draft():
    import jax
    return Generator(DRAFT, key=jax.random.PRNGKey(7))


class TestLossless:
    @pytest.mark.parametrize("gamma", [1, 4])
    def test_random_draft_output_identical(self, target, draft, gamma):
        spec = SpeculativeGenerator(target, draft, gamma=gamma)
        got = spec.generate(PROMPTS, max_new_tokens=40)
        for p, o in zip(PROMPTS, got):
            assert o == target.generate([p], max_new_tokens=40)[0]

    def test_exact_match_at_context_limit(self, draft):
        """Near max_len the spec path must emit EXACTLY what the target's
        own greedy decode emits — the cache over-allocates a scratch tail
        for candidate writes instead of shrinking the token budget."""
        import jax
        cfg = DecoderConfig(vocab_size=384, hidden=64, layers=2, heads=4,
                            mlp_dim=128, max_len=192, dtype="float32")
        tgt = Generator(cfg, key=jax.random.PRNGKey(3))
        # prompt buckets to S=128; budget = max_len - S = 64 exactly
        prompt = "高血压患者日常饮食应当注意哪些方面？" * 2
        spec = SpeculativeGenerator(tgt, draft, gamma=4)
        got = spec.generate([prompt], max_new_tokens=512)[0]
        want = tgt.generate([prompt], max_new_tokens=512)[0]
        assert got == want

    def test_int4_target_stays_lossless(self, draft):
        """Weight quantization must not break the exact-match contract:
        the spec output equals the int4 target's OWN greedy continuation
        (verify and decode run the same q4 matvec path)."""
        import jax
        tgt4 = Generator(TARGET, key=jax.random.PRNGKey(9))
        tgt4.quantize_weights(bits=4)
        spec = SpeculativeGenerator(tgt4, draft, gamma=3)
        got = spec.generate(PROMPTS[:2], max_new_tokens=32)
        for p, o in zip(PROMPTS[:2], got):
            assert o == tgt4.generate([p], max_new_tokens=32)[0]

    def test_eos_terminates_identically(self, target, draft):
        # long budget: EOS (if the random model hits one) must cut both
        # paths at the same place
        spec = SpeculativeGenerator(target, draft, gamma=3)
        got = spec.generate([PROMPTS[0]], max_new_tokens=96)[0]
        want = target.generate([PROMPTS[0]], max_new_tokens=96)[0]
        assert got == want


class TestAcceptance:
    def test_perfect_draft_accepts_gamma_plus_one(self, target):
        # the target drafting for itself agrees on every proposal:
        # every round must emit gamma+1 tokens (modulo the final round)
        spec = SpeculativeGenerator(target, target, gamma=4)
        out = spec.generate([PROMPTS[0]], max_new_tokens=40)[0]
        assert out == target.generate([PROMPTS[0]], max_new_tokens=40)[0]
        stats = spec.last_stats
        assert stats["tokens_per_round"] > 4.0   # ~5 with gamma=4

    def test_adversarial_draft_still_progresses(self, target, draft):
        # worst case: ~1 token per round (the free token), never fewer
        spec = SpeculativeGenerator(target, draft, gamma=4)
        spec.generate([PROMPTS[1]], max_new_tokens=24)
        assert spec.last_stats["tokens_per_round"] >= 1.0

    def test_generate_tokens_matches_decode(self, target):
        rows = target.generate_tokens(PROMPTS[:2], max_new_tokens=24)
        texts = target.generate(PROMPTS[:2], max_new_tokens=24)
        for row, text in zip(rows, texts):
            assert target.tokenizer.decode(row) == text
            # cut at first EOS inclusive
            eos = target.tokenizer.eos_id
            assert all(t != eos for t in row[:-1])

    def test_vocab_mismatch_raises(self, target):
        bad = Generator(DecoderConfig(vocab_size=512, hidden=32, layers=1,
                                      heads=2, mlp_dim=64, max_len=512,
                                      dtype="float32"))
        with pytest.raises(ValueError, match="vocab"):
            SpeculativeGenerator(target, bad)


class TestDistill:
    """Token-level draft distillation (models/distill.py): acceptance on
    the training prompt distribution must rise from the random floor (1.0
    token/round) toward gamma+1 — the knob that turns speculation's
    projected speedup into a real one."""

    def test_distilled_draft_lifts_acceptance(self, target):
        from mediquery_rag.models.distill import distill_draft
        prompts = ["高血压饮食", "糖尿病运动", "头痛", "咳嗽", "失眠", "发烧"]
        draft = distill_draft(target, DRAFT, prompts, max_new_tokens=64,
                              epochs=120)
        assert draft.last_loss < 0.2
        spec = SpeculativeGenerator(target, draft, gamma=4)
        outs = spec.generate(prompts[:3], max_new_tokens=64)
        # lossless regardless of the draft
        for p, o in zip(prompts, outs):
            assert o == target.generate([p], max_new_tokens=64)[0]
        assert spec.last_stats["tokens_per_round"] > 3.0

    def test_distill_vocab_mismatch_raises(self, target):
        from mediquery_rag.models.distill import distill_draft
        bad = DecoderConfig(vocab_size=512, hidden=32, layers=1, heads=2,
                            mlp_dim=64, max_len=512, dtype="float32")
        with pytest.raises(ValueError, match="vocab"):
            distill_draft(target, bad, ["x"])


class TestDistillCLI:
    def test_cli_roundtrip_serves_lossless(self, target, tmp_path):
        """python -m mediquery_rag.models.distill --target <ckpt> must
        produce a checkpoint that Generator.from_checkpoint restores and
        LLMServer(draft=...) serves — output still the target's exact
        greedy continuation."""
        import sys

        from mediquery_rag.models import distill as dmod
        from mediquery_rag.serve.llm import LLMServer

        tdir, odir = tmp_path / "target", tmp_path / "draft"
        target.save(str(tdir))
        pfile = tmp_path / "p.txt"
        pfile.write_text("\n".join(PROMPTS), encoding="utf-8")
        argv = sys.argv
        sys.argv = ["distill", "--target", str(tdir), "--out", str(odir),
                    "--preset", "tiny", "--prompts-file", str(pfile),
                    "--max-new", "16", "--epochs", "3"]
        try:
            dmod.main()
        finally:
            sys.argv = argv

        draft = Generator.from_checkpoint(str(odir))
        want = target.generate([PROMPTS[0]], max_new_tokens=16)[0]
        with LLMServer(target, slots=1, chunk=6, draft=draft, gamma=2) as srv:
            got = srv.complete(PROMPTS[0], max_new_tokens=16)
            assert srv.stats["spec_rounds"] > 0
        assert got == want
