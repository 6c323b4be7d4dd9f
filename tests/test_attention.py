"""Grouped-query attention ops (ops/attention.py) vs the einsum oracle, and
the decoder's attn_impl="flash" mode vs "einsum", on the CPU route."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mediquery_rag.config import DecoderConfig
from mediquery_rag.models.decoder import Decoder
from mediquery_rag.ops.attention import (flash_attention,
                                             flash_attention_at,
                                             mha_reference)


@pytest.fixture(autouse=True)
def _force_stacked_layout(monkeypatch):
    """These parity tests exist to pin the flash paths against the einsum
    oracle; the stacked zero-copy layout only engages for >=128 MB caches
    (decoder._use_stacked), so force it here — the xs layout keeps its
    coverage from the decoder/serve/speculative suites' tiny caches."""
    from mediquery_rag.models import decoder
    monkeypatch.setattr(decoder, "_STACKED_MIN_CACHE_BYTES", 0)


def _mk(rng, shape):
    return jnp.asarray(rng.standard_normal(shape, dtype=np.float32))


def _left_pad_masks(rng, b, s):
    m = np.ones((b, s), np.float32)
    pads = []
    for i in range(b):
        p = int(rng.integers(0, s // 2))
        m[i, :p] = 0.0
        pads.append(p)
    return jnp.asarray(m), pads


class TestFlashKernel:
    @pytest.mark.parametrize(
        "b,h,kh,s,dh",
        [(2, 4, 2, 100, 64),    # GQA, ragged S, dh below a lane
         (1, 8, 8, 257, 128),   # MHA, prime S
         (2, 6, 2, 33, 32),     # tiny everything
         (1, 28, 4, 300, 128)]) # qwen2.5-7b's head geometry
    def test_matches_einsum_on_valid_rows(self, b, h, kh, s, dh):
        rng = np.random.default_rng(42)
        q, k, v = _mk(rng, (b, h, s, dh)), _mk(rng, (b, kh, s, dh)), \
            _mk(rng, (b, kh, s, dh))
        mask, pads = _left_pad_masks(rng, b, s)
        out = np.asarray(flash_attention(q, k, v, mask))
        ref = np.asarray(mha_reference(q, k, v, mask, dh ** -0.5, True))
        for i in range(b):
            # rows < pad see zero visible keys: garbage under both impls
            # (different garbage — the kernel's key padding participates);
            # every consumer masks or slices those rows away
            np.testing.assert_allclose(out[i, :, pads[i]:],
                                       ref[i, :, pads[i]:],
                                       rtol=1e-4, atol=1e-5)

    def test_non_causal(self):
        rng = np.random.default_rng(7)
        q, k, v = _mk(rng, (2, 4, 50, 64)), _mk(rng, (2, 4, 50, 64)), \
            _mk(rng, (2, 4, 50, 64))
        mask = jnp.ones((2, 50))
        out = flash_attention(q, k, v, mask, causal=False)
        ref = mha_reference(q, k, v, mask, 64 ** -0.5, False)
        np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                                   rtol=1e-4, atol=1e-5)

    def test_grad_matches_reference(self):
        rng = np.random.default_rng(3)
        q, k, v = _mk(rng, (1, 4, 64, 32)), _mk(rng, (1, 2, 64, 32)), \
            _mk(rng, (1, 2, 64, 32))
        mask = jnp.ones((1, 64))

        def f(q_, k_, v_):
            return flash_attention(q_, k_, v_, mask).sum()

        def r(q_, k_, v_):
            return mha_reference(q_, k_, v_, mask, 32 ** -0.5, True).sum()

        g_f = jax.grad(f, argnums=(0, 1, 2))(q, k, v)
        g_r = jax.grad(r, argnums=(0, 1, 2))(q, k, v)
        for a, b_ in zip(g_f, g_r):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b_),
                                       rtol=1e-4, atol=1e-5)

    @pytest.mark.parametrize(
        "b,h,kh,s,dh,causal",
        [(2, 4, 2, 70, 64, True),     # GQA, ragged S (padding rows), causal
         (1, 6, 6, 33, 32, True),     # MHA, tiny prime S
         (2, 4, 2, 48, 64, False)])   # non-causal GQA
    def test_grad_padded_masked(self, b, h, kh, s, dh, causal):
        """The grouped attention's backward == the einsum VJP with
        left-padded masks, pad rows, and a NON-uniform cotangent — pad and
        fully-masked rows get zero upstream (loss-masked), which is where
        the two implementations are defined to agree."""
        rng = np.random.default_rng(21)
        q, k, v = _mk(rng, (b, h, s, dh)), _mk(rng, (b, kh, s, dh)), \
            _mk(rng, (b, kh, s, dh))
        mask, pads = _left_pad_masks(rng, b, s)
        w = _mk(rng, (b, h, s, dh)) * np.asarray(mask)[:, None, :, None]

        def f(q_, k_, v_):
            return (flash_attention(q_, k_, v_, mask, causal=causal) * w).sum()

        def r(q_, k_, v_):
            return (mha_reference(q_, k_, v_, mask, dh ** -0.5, causal)
                    .astype(q_.dtype) * w).sum()

        g_f = jax.grad(f, argnums=(0, 1, 2))(q, k, v)
        g_r = jax.grad(r, argnums=(0, 1, 2))(q, k, v)
        for a, b_ in zip(g_f, g_r):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b_),
                                       rtol=2e-4, atol=2e-4)

    def test_offset_variant_matches_cache_reference(self):
        """flash_attention_at: a fresh suffix at col0 over a [C] cache —
        the prefill_extend visibility (cols <= col0 + r, mask-live)."""
        rng = np.random.default_rng(11)
        B, H, KH, S, C, dh = 2, 4, 2, 24, 96, 64
        q = _mk(rng, (B, H, S, dh))
        k = _mk(rng, (B, KH, C, dh))
        v = _mk(rng, (B, KH, C, dh))
        col0 = np.array([40, 17], np.int32)
        mask = np.zeros((B, C), np.float32)
        for b in range(B):
            mask[b, :col0[b] + S] = 1.0       # live prefix + fresh suffix
        out = np.asarray(flash_attention_at(
            q, k, v, jnp.asarray(mask), jnp.asarray(col0)))
        # oracle: einsum with the explicit [S, C] visibility
        g = H // KH
        kr, vr = np.repeat(np.asarray(k), g, 1), np.repeat(np.asarray(v), g, 1)
        for b in range(B):
            logits = np.einsum("hqd,hkd->hqk", np.asarray(q)[b], kr[b]) \
                * dh ** -0.5
            vis = (np.arange(C)[None, :] <= col0[b] + np.arange(S)[:, None]) \
                & (mask[b] > 0)[None, :]
            logits += (vis.astype(np.float32) - 1.0) * 1e9
            w = np.exp(logits - logits.max(-1, keepdims=True))
            w /= w.sum(-1, keepdims=True)
            ref = np.einsum("hqk,hkd->hqd", w, vr[b])
            np.testing.assert_allclose(out[b], ref, rtol=1e-4, atol=1e-5)

    def test_stacked_cache_layer_select(self):
        """flash_attention_cached/_at over a STACKED [L, B, KH, C, dh]
        cache + scalar-prefetch layer index == the same call on the
        unstacked per-layer slice, for EVERY layer (incl. layer > 0,
        which the index maps must offset into) and with int8 per-column
        scales riding along."""
        from mediquery_rag.ops.attention import flash_attention_cached
        rng = np.random.default_rng(17)
        L, B, H, KH, S, C, dh = 3, 2, 4, 2, 8, 96, 64
        q = _mk(rng, (B, H, S, dh))
        ks = _mk(rng, (L, B, KH, C, dh))
        vs = _mk(rng, (L, B, KH, C, dh))
        mask = np.zeros((B, C), np.float32)
        mask[0, :50] = 1.0
        mask[1, :30] = 1.0
        mask = jnp.asarray(mask)
        col0 = jnp.asarray([40, 17], jnp.int32)

        # int8 codes + per-column scales (the kv_dtype="int8" layout)
        k8 = jnp.asarray(rng.integers(-127, 128, (L, B, KH, C, dh)), jnp.int8)
        v8 = jnp.asarray(rng.integers(-127, 128, (L, B, KH, C, dh)), jnp.int8)
        ksc = jnp.abs(_mk(rng, (L, B, KH, C))) * 0.02 + 1e-3
        vsc = jnp.abs(_mk(rng, (L, B, KH, C))) * 0.02 + 1e-3

        for l in range(L):
            li = jnp.asarray([l], jnp.int32)
            got = flash_attention_cached(q, ks, vs, mask, layer=li)
            ref = flash_attention_cached(q, ks[l], vs[l], mask)
            np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                                       rtol=1e-5, atol=1e-6)
            got = flash_attention_at(q, ks, vs, mask, col0, layer=li)
            ref = flash_attention_at(q, ks[l], vs[l], mask, col0)
            np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                                       rtol=1e-5, atol=1e-6)
            got = flash_attention_cached(q, k8, v8, mask, layer=li,
                                         k_scale=ksc, v_scale=vsc)
            ref = flash_attention_cached(q, k8[l], v8[l], mask,
                                         k_scale=ksc[l], v_scale=vsc[l])
            np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                                       rtol=1e-5, atol=1e-6)
            # stacked int8 + col0 offsets: the chunked-prefill-over-
            # quantized-stacked-cache combination (Decoder.prefill_extend
            # with kv_dtype="int8" stacked caches)
            got = flash_attention_at(q, k8, v8, mask, col0, layer=li,
                                     k_scale=ksc, v_scale=vsc)
            ref = flash_attention_at(q, k8[l], v8[l], mask, col0,
                                     k_scale=ksc[l], v_scale=vsc[l])
            np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                                       rtol=1e-5, atol=1e-6)

    def test_stacked_cache_requires_layer_consistency(self):
        from mediquery_rag.ops.attention import flash_attention_cached
        rng = np.random.default_rng(0)
        q = _mk(rng, (1, 4, 4, 32))
        k5 = _mk(rng, (2, 1, 2, 32, 32))
        with pytest.raises(ValueError, match="stacked"):
            flash_attention_cached(q, k5, k5, jnp.ones((1, 32)))
        k4 = _mk(rng, (1, 2, 32, 32))
        with pytest.raises(ValueError, match="stacked"):
            flash_attention_cached(q, k4, k4, jnp.ones((1, 32)),
                                   layer=jnp.asarray([0], jnp.int32))

    def test_cache_scale_ndim_mismatch_raises(self):
        """A stacked 5-D cache with unstacked [B,KH,C] scales (and the
        reverse) must fail fast with a clear error, not an opaque
        shape failure deep in the product."""
        from mediquery_rag.ops.attention import flash_attention_cached
        rng = np.random.default_rng(3)
        q = _mk(rng, (1, 4, 4, 32))
        k5 = jnp.asarray(rng.integers(-127, 128, (2, 1, 2, 32, 32)), jnp.int8)
        sc3 = jnp.ones((1, 2, 32), jnp.float32)        # unstacked scales
        li = jnp.asarray([0], jnp.int32)
        with pytest.raises(ValueError, match="scales"):
            flash_attention_cached(q, k5, k5, jnp.ones((1, 32)), layer=li,
                                   k_scale=sc3, v_scale=sc3)
        with pytest.raises(ValueError, match="scales"):
            flash_attention_at(q, k5, k5, jnp.ones((1, 32)),
                               jnp.zeros((1,), jnp.int32), layer=li,
                               k_scale=sc3, v_scale=sc3)
        k4 = jnp.asarray(rng.integers(-127, 128, (1, 2, 32, 32)), jnp.int8)
        sc4 = jnp.ones((2, 1, 2, 32), jnp.float32)     # stacked scales
        with pytest.raises(ValueError, match="scales"):
            flash_attention_cached(q, k4, k4, jnp.ones((1, 32)),
                                   k_scale=sc4, v_scale=sc4)

    def test_bad_gqa_ratio_raises(self):
        rng = np.random.default_rng(0)
        q = _mk(rng, (1, 5, 16, 32))
        k = _mk(rng, (1, 2, 16, 32))
        with pytest.raises(ValueError, match="kv_heads"):
            flash_attention(q, k, k, jnp.ones((1, 16)))


CFG = DecoderConfig(vocab_size=384, hidden=128, layers=2, heads=4,
                    kv_heads=2, mlp_dim=256, max_len=256, dtype="float32",
                    qkv_bias=True)


class TestDecoderFlash:
    def _models(self):
        base = Decoder(CFG)
        flash = Decoder(dataclasses.replace(CFG, attn_impl="flash"))
        params = base.init(jax.random.PRNGKey(0))
        return base, flash, params

    def test_apply_parity(self):
        base, flash, params = self._models()
        rng = np.random.default_rng(0)
        ids = jnp.asarray(rng.integers(3, 259, (2, 40)), jnp.int32)
        mask = jnp.concatenate(
            [jnp.zeros((2, 5)), jnp.ones((2, 35))], axis=1)  # left pad
        lo_e = np.asarray(base.apply(params, ids, mask))
        lo_f = np.asarray(flash.apply(params, ids, mask))
        # only positions with >=1 visible key are meaningful
        np.testing.assert_allclose(lo_f[:, 5:], lo_e[:, 5:],
                                   rtol=2e-3, atol=2e-3)

    def test_prefill_parity_and_decode_handoff(self):
        base, flash, params = self._models()
        rng = np.random.default_rng(1)
        ids = jnp.asarray(rng.integers(3, 259, (2, 24)), jnp.int32)
        mask = jnp.concatenate(
            [jnp.zeros((2, 4)), jnp.ones((2, 20))], axis=1)
        lo_e, cache_e = base.prefill(params, ids, mask, cache_len=64)
        lo_f, cache_f = flash.prefill(params, ids, mask, cache_len=64)
        np.testing.assert_allclose(np.asarray(lo_f), np.asarray(lo_e),
                                   rtol=2e-3, atol=2e-3)
        # the cache a flash prefill builds must feed the (einsum) decode path
        np.testing.assert_allclose(np.asarray(cache_f.k[:, :, :, 4:24]),
                                   np.asarray(cache_e.k[:, :, :, 4:24]),
                                   rtol=2e-3, atol=2e-3)
        tok = jnp.argmax(lo_f, axis=-1).astype(jnp.int32)
        lo2_f, _ = flash.decode_step(params, cache_f, tok)
        lo2_e, _ = base.decode_step(params, cache_e, tok)
        np.testing.assert_allclose(np.asarray(lo2_f), np.asarray(lo2_e),
                                   rtol=2e-3, atol=2e-3)

    def test_prefill_extend_parity(self):
        """Flash chunked-prefill continuation == einsum continuation, on a
        cache built by a (flash) batch prefill then extended per lane."""
        base, flash, params = self._models()
        rng = np.random.default_rng(5)
        ids = jnp.asarray(rng.integers(3, 259, (1, 16)), jnp.int32)
        mask = jnp.ones((1, 16))
        _, cache = flash.prefill(params, ids, mask, cache_len=96)
        ext = jnp.asarray(rng.integers(3, 259, (12,)), jnp.int32)
        ext_mask = jnp.concatenate([jnp.ones((9,)), jnp.zeros((3,))])
        args = (cache.k[:, 0], cache.v[:, 0], cache.key_mask[0],
                ext, ext_mask, jnp.int32(16), jnp.int32(16))
        lo_f = flash.prefill_extend(params, *args, all_logits=True)[0]
        lo_e = base.prefill_extend(params, *args, all_logits=True)[0]
        np.testing.assert_allclose(np.asarray(lo_f)[:9], np.asarray(lo_e)[:9],
                                   rtol=2e-3, atol=2e-3)

    def test_slots_paths_parity(self):
        """decode_step_slots + extend_slots under attn_impl="flash" (the
        GQA-folded cached-attention kernel, mask-only / per-lane offset
        visibility) == the einsum path, on a cache with DIVERGED per-lane
        cursors."""
        from mediquery_rag.models.decoder import KVCache
        base, flash, params = self._models()
        rng = np.random.default_rng(9)
        ids = jnp.asarray(rng.integers(3, 259, (2, 20)), jnp.int32)
        mask = jnp.concatenate(
            [jnp.zeros((2, 3)), jnp.ones((2, 17))], axis=1)
        _, cache = base.prefill(params, ids, mask, cache_len=64)
        slot = KVCache(k=cache.k, v=cache.v, key_mask=cache.key_mask,
                       cursor=jnp.full((2,), cache.cursor, jnp.int32),
                       next_pos=cache.next_pos)
        # advance lane 0 only -> cursors [21, 20]
        _, slot = base.decode_step_slots(
            params, slot, jnp.asarray([7, 9], jnp.int32),
            jnp.asarray([True, False]))

        act = jnp.ones((2,), bool)
        tok = jnp.asarray([11, 42], jnp.int32)
        l_e, c_e = base.decode_step_slots(params, slot, tok, act)
        l_f, c_f = flash.decode_step_slots(params, slot, tok, act)
        np.testing.assert_allclose(np.asarray(l_f), np.asarray(l_e),
                                   rtol=2e-3, atol=2e-3)
        assert np.array_equal(np.asarray(c_f.key_mask),
                              np.asarray(c_e.key_mask))

        toks = jnp.asarray([[5, 9, 200], [77, 3, 150]], jnp.int32)
        le, ce = base.extend_slots(params, slot, toks, act)
        lf, cf = flash.extend_slots(params, slot, toks, act)
        np.testing.assert_allclose(np.asarray(lf), np.asarray(le),
                                   rtol=2e-3, atol=2e-3)
        np.testing.assert_allclose(np.asarray(cf.k), np.asarray(ce.k),
                                   rtol=2e-3, atol=2e-3)
        assert np.array_equal(np.asarray(cf.cursor), np.asarray(ce.cursor))

    def test_int8_cache_flash_parity(self):
        """The quant kernel (int8 codes + per-column scales folded in-kernel)
        == the einsum int8 branch, across every cached path: decode_step,
        decode_step_slots, extend_slots (per-lane offset window), and the
        chunked-prefill continuation prefill_extend."""
        from mediquery_rag.models.decoder import KVCache
        base = Decoder(dataclasses.replace(CFG, kv_dtype="int8"))
        flash = Decoder(dataclasses.replace(CFG, kv_dtype="int8",
                                            attn_impl="flash"))
        params = base.init(jax.random.PRNGKey(0))
        rng = np.random.default_rng(11)
        ids = jnp.asarray(rng.integers(3, 259, (2, 20)), jnp.int32)
        mask = jnp.concatenate(
            [jnp.zeros((2, 3)), jnp.ones((2, 17))], axis=1)
        _, cache = base.prefill(params, ids, mask, cache_len=64)
        assert cache.k_scale is not None

        tok = jnp.asarray([11, 42], jnp.int32)
        l_e, c_e = base.decode_step(params, cache, tok)
        l_f, c_f = flash.decode_step(params, cache, tok)
        np.testing.assert_allclose(np.asarray(l_f), np.asarray(l_e),
                                   rtol=2e-3, atol=2e-3)
        assert np.array_equal(np.asarray(c_f.k), np.asarray(c_e.k))

        slot = KVCache(k=cache.k, v=cache.v, key_mask=cache.key_mask,
                       cursor=jnp.full((2,), cache.cursor, jnp.int32),
                       next_pos=cache.next_pos,
                       k_scale=cache.k_scale, v_scale=cache.v_scale)
        # diverge lane cursors: [21, 20]
        _, slot = base.decode_step_slots(
            params, slot, jnp.asarray([7, 9], jnp.int32),
            jnp.asarray([True, False]))
        act = jnp.ones((2,), bool)
        l_e, _ = base.decode_step_slots(params, slot, tok, act)
        l_f, _ = flash.decode_step_slots(params, slot, tok, act)
        np.testing.assert_allclose(np.asarray(l_f), np.asarray(l_e),
                                   rtol=2e-3, atol=2e-3)

        toks = jnp.asarray([[5, 9, 200], [77, 3, 150]], jnp.int32)
        le, ce = base.extend_slots(params, slot, toks, act)
        lf, cf = flash.extend_slots(params, slot, toks, act)
        np.testing.assert_allclose(np.asarray(lf), np.asarray(le),
                                   rtol=2e-3, atol=2e-3)
        assert np.array_equal(np.asarray(cf.k), np.asarray(ce.k))
        assert np.array_equal(np.asarray(cf.cursor), np.asarray(ce.cursor))

        ext = jnp.asarray(rng.integers(3, 259, (8,)), jnp.int32)
        ext_mask = jnp.concatenate([jnp.ones((6,)), jnp.zeros((2,))])
        args = (cache.k[:, 0], cache.v[:, 0], cache.key_mask[0],
                ext, ext_mask, jnp.int32(20), jnp.int32(17))
        kw = dict(all_logits=True, k_scale_row=cache.k_scale[:, 0],
                  v_scale_row=cache.v_scale[:, 0])
        lo_f = flash.prefill_extend(params, *args, **kw)[0]
        lo_e = base.prefill_extend(params, *args, **kw)[0]
        np.testing.assert_allclose(np.asarray(lo_f)[:6], np.asarray(lo_e)[:6],
                                   rtol=2e-3, atol=2e-3)

    def test_bad_attn_impl_raises(self):
        with pytest.raises(ValueError, match="attn_impl"):
            Decoder(dataclasses.replace(CFG, attn_impl="paged"))
