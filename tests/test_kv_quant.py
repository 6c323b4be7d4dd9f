"""int8 KV-cache quantization (DecoderConfig.kv_dtype="int8").

What the feature guarantees and what these tests pin:
- The cache stores int8 codes + per-column-per-head scales (half the
  HBM of bf16 at f32-test-config it's 1/4) — shape/dtype asserted.
- The float path is UNTOUCHED: kv_dtype="" still produces bit-identical
  logits to the pre-feature code (covered by the whole existing suite;
  spot-checked here against prefill+decode).
- Quantized logits stay CLOSE to the float path's (absmax int8 on K/V is
  a ~0.4% perturbation) — tolerance-checked, plus argmax agreement on a
  real decode step.
- The serving equivalences that survive quantization hold EXACTLY:
  server greedy output == lockstep greedy output (both int8), and
  extend_slots == sequential decode_step_slots (the speculative-serving
  losslessness foundation) — both paths read the SAME quantized values.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mediquery_rag.config import DecoderConfig
from mediquery_rag.models.generate import Generator
from mediquery_rag.serve.llm import LLMServer

KW = dict(vocab_size=384, hidden=64, layers=2, heads=4, mlp_dim=128,
          max_len=1024, dtype="float32")
F32 = DecoderConfig(**KW)
Q8 = DecoderConfig(**KW, kv_dtype="int8")

PROMPTS = ["高血压的饮食建议", "头痛", "BMI 如何计算？"]


@pytest.fixture(scope="module")
def gen_f32():
    return Generator(F32)


@pytest.fixture(scope="module")
def gen_q8(gen_f32):
    g = Generator(Q8)
    g.params = gen_f32.params          # same weights, only the cache differs
    return g


class TestCacheLayout:
    def test_prefill_produces_int8_cache_with_scales(self, gen_q8):
        tok = gen_q8.tokenizer
        ids, mask = tok.batch_encode(PROMPTS[:2])
        _, cache = jax.jit(
            lambda p, i, m: gen_q8.model.prefill(p, i, m, 256))(
            gen_q8.params, jnp.asarray(ids), jnp.asarray(mask))
        assert cache.k.dtype == jnp.int8 and cache.v.dtype == jnp.int8
        L, B, KH, C, dh = cache.k.shape
        assert cache.k_scale.shape == (L, B, KH, C)
        assert cache.k_scale.dtype == jnp.float32
        # real columns carry real scales; padding columns are garbage but
        # masked — check a live column's roundtrip error bound
        col = ids.shape[1] - 1
        approx = (cache.k[:, :, :, col, :].astype(jnp.float32)
                  * cache.k_scale[:, :, :, col, None])
        assert np.all(np.abs(np.asarray(cache.k[:, :, :, col, :])) <= 127)
        assert np.isfinite(np.asarray(approx)).all()

    def test_float_path_unaffected(self, gen_f32):
        tok = gen_f32.tokenizer
        ids, mask = tok.batch_encode(PROMPTS[:1])
        _, cache = jax.jit(
            lambda p, i, m: gen_f32.model.prefill(p, i, m, 256))(
            gen_f32.params, jnp.asarray(ids), jnp.asarray(mask))
        assert cache.k.dtype == jnp.float32
        assert cache.k_scale is None and cache.v_scale is None


class TestAccuracy:
    def test_decode_logits_close_and_argmax_agrees(self, gen_f32, gen_q8):
        tok = gen_f32.tokenizer
        ids, mask = tok.batch_encode(PROMPTS)
        ids, mask = jnp.asarray(ids), jnp.asarray(mask)

        l32, c32 = jax.jit(
            lambda p, i, m: gen_f32.model.prefill(p, i, m, 256))(
            gen_f32.params, ids, mask)
        l8, c8 = jax.jit(
            lambda p, i, m: gen_q8.model.prefill(p, i, m, 256))(
            gen_q8.params, ids, mask)
        # prefill logits: within-prompt attention is full precision in
        # both modes — identical
        np.testing.assert_allclose(np.asarray(l32), np.asarray(l8),
                                   rtol=1e-5, atol=1e-5)

        # decode step reads the (quantized) cache: close, same argmax
        t0 = jnp.argmax(l32, axis=-1).astype(jnp.int32)
        d32, _ = jax.jit(gen_f32.model.decode_step)(gen_f32.params, c32, t0)
        d8, _ = jax.jit(gen_q8.model.decode_step)(gen_q8.params, c8, t0)
        d32n, d8n = np.asarray(d32), np.asarray(d8)
        spread = float(d32n.max() - d32n.min())
        assert np.max(np.abs(d32n - d8n)) < 0.05 * spread
        assert np.array_equal(d32n.argmax(-1), d8n.argmax(-1))

    def test_generation_sane(self, gen_q8):
        outs = gen_q8.generate(PROMPTS[:2], max_new_tokens=24)
        assert all(isinstance(o, str) for o in outs)


class TestServingEquivalences:
    def test_server_greedy_matches_lockstep_int8(self, gen_q8):
        want = [gen_q8.generate([p], max_new_tokens=32)[0] for p in PROMPTS]
        with LLMServer(gen_q8, slots=4, chunk=8) as srv:
            futs = [srv.submit(p, max_new_tokens=32) for p in PROMPTS]
            outs = [f.result(timeout=300) for f in futs]
        assert outs == want

    def test_extend_slots_matches_sequential_int8(self, gen_q8):
        """The speculative-serving foundation under quantization: a
        G-token extend and G sequential slot steps quantize each fresh
        column once with the same per-column scale, so they must agree
        EXACTLY."""
        from mediquery_rag.models.decoder import KVCache

        tok = gen_q8.tokenizer
        ids, mask = tok.batch_encode(["高血压", "糖尿病运动"])
        _, cache = jax.jit(
            lambda p, i, m: gen_q8.model.prefill(p, i, m, 256))(
            gen_q8.params, jnp.asarray(ids), jnp.asarray(mask))
        B = ids.shape[0]
        base = KVCache(
            k=cache.k, v=cache.v, key_mask=cache.key_mask,
            cursor=jnp.full((B,), cache.cursor, jnp.int32),
            next_pos=cache.next_pos,
            k_scale=cache.k_scale, v_scale=cache.v_scale)
        toks = jnp.asarray([[5, 9, 200], [77, 3, 150]], jnp.int32)
        act = jnp.ones((B,), bool)

        seq_logits, c_seq = [], base
        for i in range(3):
            l, c_seq = jax.jit(gen_q8.model.decode_step_slots)(
                gen_q8.params, c_seq, toks[:, i], act)
            seq_logits.append(np.asarray(l))
        l_ext, c_ext = jax.jit(gen_q8.model.extend_slots)(
            gen_q8.params, base, toks, act)

        np.testing.assert_allclose(
            np.asarray(l_ext), np.stack(seq_logits, axis=1),
            rtol=2e-4, atol=2e-4)
        assert np.array_equal(np.asarray(c_ext.k), np.asarray(c_seq.k))
        np.testing.assert_allclose(np.asarray(c_ext.k_scale),
                                   np.asarray(c_seq.k_scale),
                                   rtol=1e-6, atol=1e-7)

    def test_spec_serving_lossless_int8(self, gen_q8):
        draft = Generator(DecoderConfig(
            vocab_size=384, hidden=32, layers=1, heads=2, mlp_dim=64,
            max_len=1024, dtype="float32", kv_dtype="int8"),
            key=jax.random.PRNGKey(7))
        want = gen_q8.generate([PROMPTS[0]], max_new_tokens=32)[0]
        with LLMServer(gen_q8, slots=2, chunk=8, draft=draft,
                       gamma=3) as srv:
            got = srv.complete(PROMPTS[0], max_new_tokens=32)
            assert srv.stats["spec_rounds"] > 0
        assert got == want

    def test_session_extension_sane_int8(self, gen_q8):
        # exact cold-vs-extended equality does NOT survive quantization
        # (a cold prefill attends fresh bf16 K within the prompt, an
        # extension attends the stored int8 prefix) — pin that the flow
        # works and reuses the prefix, not bit-equality
        from mediquery_rag.serve.llm import ChatSession
        with LLMServer(gen_q8, slots=2, chunk=8) as srv:
            s = ChatSession(srv, max_new_tokens=16)
            r1 = s.ask("高血压饮食")
            r2 = s.ask("运动呢？")
            assert srv.stats["extends"] == 1
            assert srv.stats["prefix_tokens_reused"] > 0
        assert isinstance(r1, str) and isinstance(r2, str)


class TestGQAQuant:
    """GQA (kv_heads < heads) exercises the scale head-expansion
    (_rep_s): a repeat/tile or transpose slip would corrupt attention
    only on real qwen2.5-shaped checkpoints — pin it on a tiny GQA
    config."""

    GKW = dict(vocab_size=384, hidden=64, layers=2, heads=4, kv_heads=2,
               mlp_dim=128, max_len=512, dtype="float32")

    @pytest.fixture(scope="class")
    def pair(self):
        g32 = Generator(DecoderConfig(**self.GKW))
        q8 = Generator(DecoderConfig(**self.GKW, kv_dtype="int8"))
        q8.params = g32.params
        return g32, q8

    def test_decode_argmax_agrees(self, pair):
        g32, q8 = pair
        tok = g32.tokenizer
        ids, mask = tok.batch_encode(PROMPTS)
        ids, mask = jnp.asarray(ids), jnp.asarray(mask)
        l32, c32 = jax.jit(
            lambda p, i, m: g32.model.prefill(p, i, m, 256))(
            g32.params, ids, mask)
        _, c8 = jax.jit(
            lambda p, i, m: q8.model.prefill(p, i, m, 256))(
            q8.params, ids, mask)
        t0 = jnp.argmax(l32, axis=-1).astype(jnp.int32)
        d32, _ = jax.jit(g32.model.decode_step)(g32.params, c32, t0)
        d8, _ = jax.jit(q8.model.decode_step)(q8.params, c8, t0)
        assert np.array_equal(np.asarray(d32).argmax(-1),
                              np.asarray(d8).argmax(-1))

    def test_extend_slots_matches_sequential_gqa(self, pair):
        from mediquery_rag.models.decoder import KVCache
        _, q8 = pair
        tok = q8.tokenizer
        ids, mask = tok.batch_encode(["高血压", "糖尿病"])
        _, cache = jax.jit(
            lambda p, i, m: q8.model.prefill(p, i, m, 256))(
            q8.params, jnp.asarray(ids), jnp.asarray(mask))
        B = ids.shape[0]
        base = KVCache(
            k=cache.k, v=cache.v, key_mask=cache.key_mask,
            cursor=jnp.full((B,), cache.cursor, jnp.int32),
            next_pos=cache.next_pos,
            k_scale=cache.k_scale, v_scale=cache.v_scale)
        toks = jnp.asarray([[5, 9], [77, 3]], jnp.int32)
        act = jnp.ones((B,), bool)
        seq, c_seq = [], base
        for i in range(2):
            l, c_seq = jax.jit(q8.model.decode_step_slots)(
                q8.params, c_seq, toks[:, i], act)
            seq.append(np.asarray(l))
        l_ext, c_ext = jax.jit(q8.model.extend_slots)(
            q8.params, base, toks, act)
        np.testing.assert_allclose(np.asarray(l_ext),
                                   np.stack(seq, axis=1),
                                   rtol=2e-4, atol=2e-4)
        assert np.array_equal(np.asarray(c_ext.k), np.asarray(c_seq.k))

    def test_server_greedy_matches_lockstep_gqa(self, pair):
        _, q8 = pair
        want = q8.generate([PROMPTS[0]], max_new_tokens=24)[0]
        with LLMServer(q8, slots=2, chunk=8) as srv:
            got = srv.complete(PROMPTS[0], max_new_tokens=24)
        assert got == want


class TestLockstepSpeculativeQuant:
    def test_speculative_generator_runs_int8(self, gen_q8):
        """The lockstep SpeculativeGenerator must thread the scale rows
        (it crashed with dtype mismatch before) and stay lossless."""
        from mediquery_rag.models.speculative import SpeculativeGenerator
        draft = Generator(DecoderConfig(
            vocab_size=384, hidden=32, layers=1, heads=2, mlp_dim=64,
            max_len=1024, dtype="float32", kv_dtype="int8"),
            key=jax.random.PRNGKey(7))
        spec = SpeculativeGenerator(gen_q8, draft, gamma=3)
        got = spec.generate([PROMPTS[0]], max_new_tokens=24)[0]
        want = gen_q8.generate([PROMPTS[0]], max_new_tokens=24)[0]
        assert got == want


class TestValidation:
    def test_bad_kv_dtype_rejected(self):
        with pytest.raises(ValueError, match="kv_dtype"):
            Generator(DecoderConfig(**KW, kv_dtype="int4"))
