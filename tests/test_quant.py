"""Int8/int4 quantized scoring tests (BASELINE config 4: recall parity vs f32)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mediquery_rag.config import EngineConfig
from mediquery_rag.engine import FlatIndex
from mediquery_rag.obs import recall_at_k
from mediquery_rag.ops import flat_search_xla
from mediquery_rag.ops.quant import (
    dequantize_int4, int4_flat_search, int8_flat_search, quantize_rows,
    quantize_rows_int4, unpack_int4,
)


def _vecs(n, d, seed=0):
    x = jax.random.normal(jax.random.PRNGKey(seed), (n, d))
    return x / jnp.linalg.norm(x, axis=-1, keepdims=True)


class TestQuantizeRows:
    def test_roundtrip_error_small(self):
        x = _vecs(100, 64)
        q, s = quantize_rows(x)
        back = q.astype(jnp.float32) * s[:, None]
        err = float(jnp.max(jnp.abs(back - x)))
        assert err <= float(jnp.max(s)) * 0.51    # half-ulp of the scale

    def test_range(self):
        q, _ = quantize_rows(_vecs(50, 32) * 100)
        assert int(q.max()) <= 127 and int(q.min()) >= -127

    def test_zero_row_safe(self):
        q, s = quantize_rows(jnp.zeros((4, 32)))
        assert np.isfinite(np.asarray(s)).all()
        assert (np.asarray(q) == 0).all()


class TestInt8Search:
    def test_recall_parity_vs_f32(self):
        n, d, b, k = 4096, 128, 16, 10
        c = _vecs(n, d, seed=1)
        q = _vecs(b, d, seed=2)
        c8, cs = quantize_rows(c)
        tile = 512
        n_pad = -(-n // tile) * tile
        c8 = jnp.pad(c8, ((0, n_pad - n), (0, 0)))
        cs = jnp.pad(cs, ((0, n_pad - n),))
        s, i = int8_flat_search(q, c8, cs, k, n_valid=n, corpus_tile=tile)
        _, i_ref = flat_search_xla(q, c, k)
        rec = recall_at_k(i, i_ref)
        assert rec >= 0.95, f"int8 recall@10 too low: {rec}"

    def test_scores_close_to_f32(self):
        n, d, b = 512, 64, 4
        c = _vecs(n, d, seed=3)
        q = _vecs(b, d, seed=4)
        c8, cs = quantize_rows(c)
        s, _ = int8_flat_search(q, c8, cs, 5, n_valid=n, corpus_tile=128)
        s_ref, _ = flat_search_xla(q, c, 5)
        np.testing.assert_allclose(np.asarray(s), np.asarray(s_ref),
                                   atol=0.02)   # ~1% of unit-norm dot range


class TestFlatIndexInt8:
    def test_build_search(self):
        cfg = EngineConfig(dim=64, dtype="int8", corpus_tile=256)
        c = _vecs(2000, 64, seed=5)
        idx = FlatIndex.build(c, cfg)
        assert idx.corpus.dtype == jnp.int8
        q = _vecs(8, 64, seed=6)
        _, i = idx.search(q, k=10)
        _, i_ref = flat_search_xla(q, c, 10)
        assert recall_at_k(i, i_ref) >= 0.95

    def test_memory_halved_vs_bf16(self):
        c = _vecs(2048, 64, seed=7)
        i8 = FlatIndex.build(c, EngineConfig(dim=64, dtype="int8", corpus_tile=256))
        bf = FlatIndex.build(c, EngineConfig(dim=64, dtype="bfloat16", corpus_tile=256))
        assert i8.nbytes < bf.nbytes * 0.6

    def test_save_load_add(self, tmp_path):
        cfg = EngineConfig(dim=64, dtype="int8", corpus_tile=256)
        c = _vecs(500, 64, seed=8)
        idx = FlatIndex.build(c, cfg)
        idx.save(str(tmp_path / "ix"))
        idx2 = FlatIndex.load(str(tmp_path / "ix"))
        assert idx2.corpus_scale is not None and idx2.n == 500
        extra = _vecs(10, 64, seed=9)
        idx3 = idx2.add(extra)
        assert idx3.n == 510
        _, i = idx3.search(extra[0], k=1)
        assert int(i[0]) == 500


class TestInt4Pack:
    def test_pack_unpack_exact(self):
        x = _vecs(64, 96, seed=20)
        packed, s2 = quantize_rows_int4(x)
        assert packed.shape == (32, 96) and packed.dtype == jnp.int8
        assert s2.shape == (2, 32)
        codes = np.asarray(unpack_int4(packed))
        s_log = np.asarray(s2).T.reshape(-1)          # per-logical-row order
        want = np.clip(np.round(np.asarray(x, np.float32)
                                / s_log[:, None]), -7, 7)
        np.testing.assert_array_equal(codes, want.astype(np.int32))

    def test_dequant_error_half_step(self):
        x = _vecs(100, 64, seed=21)
        packed, s = quantize_rows_int4(x)
        back = np.asarray(dequantize_int4(packed, s))
        err = np.max(np.abs(back - np.asarray(x, np.float32)))
        assert err <= float(jnp.max(s)) * 0.51

    def test_odd_n_phantom_row(self):
        x = _vecs(5, 64, seed=19)
        packed, s2 = quantize_rows_int4(x)
        assert packed.shape == (3, 64) and s2.shape == (2, 3)
        back = np.asarray(dequantize_int4(packed, s2, 5))
        assert back.shape == (5, 64)
        # the phantom 6th row decodes to exact zeros
        np.testing.assert_array_equal(np.asarray(unpack_int4(packed))[5], 0)

    def test_requantize_stable(self):
        # quantize(dequantize(q)) reproduces the same codes — save/load via
        # the dequantized corpus is lossless for int4 indexes
        x = _vecs(32, 64, seed=22)
        p1, s1 = quantize_rows_int4(x)
        p2, s2 = quantize_rows_int4(dequantize_int4(p1, s1))
        np.testing.assert_array_equal(np.asarray(p1), np.asarray(p2))
        np.testing.assert_allclose(np.asarray(s1), np.asarray(s2), rtol=1e-6)


class TestInt4Search:
    def test_kernel_matches_integer_oracle(self):
        # the kernel's integer math must match a numpy int32 oracle exactly
        # (same codes, same accumulation); scores then differ only by f32
        # scaling order
        n, d, b, k = 768, 64, 8, 10
        c = _vecs(n, d, seed=23)
        q = _vecs(b, d, seed=24)
        c4, cs = quantize_rows_int4(c)
        tile = 256
        n_pad = -(-n // tile) * tile
        c4p = jnp.pad(c4, ((0, n_pad // 2 - c4.shape[0]), (0, 0)))
        csp = jnp.pad(cs, ((0, 0), (0, n_pad // 2 - cs.shape[1])))
        s, i = int4_flat_search(q, c4p, csp, k, n_valid=n, corpus_tile=tile)

        q8, qs = quantize_rows(q)
        raw = np.asarray(q8, np.int32) @ np.asarray(
            unpack_int4(c4), np.int32).T
        cs_log = np.asarray(cs).T.reshape(-1)[:n]
        oracle = (raw.astype(np.float32) * np.asarray(qs)[:, None]
                  * cs_log[None, :])
        top = np.argsort(-oracle, axis=1, kind="stable")[:, :k]
        np.testing.assert_allclose(
            np.asarray(s),
            np.take_along_axis(oracle, np.asarray(i), axis=1), rtol=1e-6)
        assert recall_at_k(np.asarray(i), top) == 1.0

    def test_recall_reasonable_plain(self):
        n, d, b, k = 3000, 768, 16, 10
        c = _vecs(n, d, seed=25)
        q = _vecs(b, d, seed=26)
        c4, cs = quantize_rows_int4(c)
        tile = 512
        n_pad = -(-n // tile) * tile
        c4p = jnp.pad(c4, ((0, n_pad // 2 - c4.shape[0]), (0, 0)))
        csp = jnp.pad(cs, ((0, 0), (0, n_pad // 2 - cs.shape[1])))
        _, i = int4_flat_search(q, c4p, csp, k, n_valid=n, corpus_tile=tile)
        _, i_ref = flat_search_xla(q, c, k)
        rec = recall_at_k(np.asarray(i), np.asarray(i_ref))
        assert rec >= 0.5, f"int4 plain recall@10 collapsed: {rec}"


class TestFlatIndexInt4:
    def test_rerank_recovers_recall(self):
        n, d = 3000, 768
        c = _vecs(n, d, seed=27)
        q = _vecs(32, d, seed=28)
        _, i_ref = flat_search_xla(q, c, 10)
        idx = FlatIndex.build(c, EngineConfig(dim=d, dtype="int4",
                                              corpus_tile=512,
                                              rerank_factor=8))
        assert idx.corpus.shape == (1536, d)    # row-pair packed: N_pad/2
        _, i = idx.search(q, k=10)
        rec = recall_at_k(np.asarray(i), np.asarray(i_ref))
        assert rec >= 0.95, f"int4+rerank recall@10: {rec}"

    def test_memory_quarter_vs_bf16(self):
        c = _vecs(2048, 128, seed=29)
        i4 = FlatIndex.build(c, EngineConfig(dim=128, dtype="int4",
                                             corpus_tile=256))
        bf = FlatIndex.build(c, EngineConfig(dim=128, dtype="bfloat16",
                                             corpus_tile=256))
        assert i4.nbytes < bf.nbytes * 0.35

    def test_save_load_add_delete(self, tmp_path):
        cfg = EngineConfig(dim=64, dtype="int4", corpus_tile=256,
                           rerank_factor=4)
        c = _vecs(500, 64, seed=30)
        idx = FlatIndex.build(c, cfg)
        idx.save(str(tmp_path / "i4"))
        idx2 = FlatIndex.load(str(tmp_path / "i4"))
        assert idx2.n == 500 and idx2.corpus.shape == (256, 64)
        _, ia = idx.search(np.asarray(c[7]), k=5)
        _, ib = idx2.search(np.asarray(c[7]), k=5)
        np.testing.assert_array_equal(np.asarray(ia), np.asarray(ib))
        extra = _vecs(10, 64, seed=31)
        idx3 = idx2.add(extra).delete([2, 4])
        assert idx3.n == 508
        _, i = idx3.search(np.asarray(extra[3]), k=1)
        assert int(i[0]) == 503      # stable id survives the deletes

    def test_sharded_int4(self):
        from mediquery_rag.engine import ShardedFlatIndex
        from mediquery_rag.parallel import corpus_mesh
        mesh = corpus_mesh(8)
        cfg = EngineConfig(dim=64, dtype="int4", corpus_tile=256,
                           )
        c = _vecs(3000, 64, seed=33)
        q = _vecs(8, 64, seed=34)
        idx = ShardedFlatIndex.build(c, mesh, cfg)
        # 3000 -> n_pad 4096 logical over 8 shards -> 2048 packed byte-rows
        assert idx.corpus.shape == (2048, 64)
        s, i = idx.search(q, k=10)
        _, i_ref = flat_search_xla(q, c, 10)
        # global merge must route shard-local hits back to global ids
        rec = recall_at_k(np.asarray(i), np.asarray(i_ref))
        assert rec >= 0.5
        # and the scores must be the int4 scores of those exact rows
        c4, cs = quantize_rows_int4(c)
        q8, qs = quantize_rows(q)
        cs_log = np.asarray(cs).T.reshape(-1)[: c.shape[0]]
        oracle = (np.asarray(q8, np.int32)
                  @ np.asarray(unpack_int4(c4), np.int32).T
                  ).astype(np.float32) * np.asarray(qs)[:, None] \
            * cs_log[None, :]
        got = np.take_along_axis(oracle, np.asarray(i), axis=1)
        np.testing.assert_allclose(np.asarray(s), got, rtol=1e-5)


class TestIVFInt4:
    """Int4 split-half packed buckets: half int8's probe bytes and HBM."""

    def test_full_probe_recall_and_scores(self):
        from mediquery_rag.engine import IVFIndex
        cfg = EngineConfig(dim=64, dtype="int4", ivf_nlist=16,
                           ivf_kmeans_iters=4)
        c = _vecs(2000, 64, seed=40)
        idx = IVFIndex.build(c, cfg)
        assert idx.buckets.shape == (16 * idx.cap // 2, 64)
        assert idx.bucket_scales.shape == (16, idx.cap)
        q = _vecs(6, 64, seed=41)
        s, i = idx.search(q, k=5, nprobe=16)       # full probe = exact-ish
        _, i_ref = flat_search_xla(q, c, 5)
        assert recall_at_k(np.asarray(i), np.asarray(i_ref)) >= 0.85
        # rescaled scores approximate true cosine (int4 is coarser than int8)
        s_ref, _ = flat_search_xla(q, c, 5)
        np.testing.assert_allclose(np.asarray(s), np.asarray(s_ref), atol=0.1)

    def test_memory_half_of_int8(self):
        from mediquery_rag.engine import IVFIndex
        c = _vecs(2000, 128, seed=44)
        kw = dict(ivf_nlist=16, ivf_kmeans_iters=2)
        i4 = IVFIndex.build(c, EngineConfig(dim=128, dtype="int4", **kw),
                            key=jax.random.PRNGKey(1))
        i8 = IVFIndex.build(c, EngineConfig(dim=128, dtype="int8", **kw),
                            key=jax.random.PRNGKey(1))
        vec4 = i4.buckets.size
        vec8 = i8.buckets.size
        assert vec4 * 2 == vec8

    def test_add_delete_stable_ids(self):
        from mediquery_rag.engine import IVFIndex
        cfg = EngineConfig(dim=64, dtype="int4", ivf_nlist=4,
                           ivf_kmeans_iters=2)
        c = _vecs(300, 64, seed=45)
        idx = IVFIndex.build(c, cfg)
        extra = _vecs(10, 64, seed=46)
        idx2 = idx.add(extra).delete([5, 7])
        assert idx2.n == 310 and idx2.live == 308
        _, i = idx2.search(np.asarray(extra[3]), k=1, nprobe=4)
        assert int(i[0]) == 303
        # deleted ids never come back
        s, ii = idx2.search(np.asarray(c[5]), k=5, nprobe=4)
        assert 5 not in np.asarray(ii)

    def test_save_load(self, tmp_path):
        from mediquery_rag.engine import IVFIndex
        cfg = EngineConfig(dim=64, dtype="int4", ivf_nlist=8,
                           ivf_kmeans_iters=3)
        c = _vecs(500, 64, seed=47)
        idx = IVFIndex.build(c, cfg)
        idx.save(str(tmp_path / "i4"))
        idx2 = IVFIndex.load(str(tmp_path / "i4"))
        assert idx2.buckets.dtype.name == "int8"
        q = _vecs(3, 64, seed=48)
        _, i1 = idx.search(q, k=4)
        _, i2 = idx2.search(q, k=4)
        np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))

    def test_streaming_matches_in_memory(self):
        from mediquery_rag.engine import IVFIndex
        cfg = EngineConfig(dim=64, dtype="int4", ivf_nlist=8,
                           ivf_kmeans_iters=3, ivf_sample=512)
        rng = np.random.default_rng(49)
        c = rng.standard_normal((1000, 64), dtype=np.float32)

        def chunks():
            for i in range(0, 1000, 256):
                yield c[i:i + 256]

        mem = IVFIndex.build(c, cfg, key=jax.random.PRNGKey(2))
        st = IVFIndex.build_streaming(chunks, 1000, cfg, chunk_rows=256,
                                      key=jax.random.PRNGKey(2))
        q = rng.standard_normal((5, 64), dtype=np.float32)
        _, i1 = mem.search(q, k=5, nprobe=8)
        _, i2 = st.search(q, k=5, nprobe=8)
        np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))

    def test_streaming_build_then_add(self):
        """Regression: int4 add() on a streaming-built index must slice the
        dummy tail bucket before unpacking (ADVICE r1: reshape TypeError)."""
        from mediquery_rag.engine import IVFIndex
        cfg = EngineConfig(dim=64, dtype="int4", ivf_nlist=8,
                           ivf_kmeans_iters=3, ivf_sample=512)
        rng = np.random.default_rng(53)
        c = rng.standard_normal((1000, 64), dtype=np.float32)

        def chunks():
            for i in range(0, 1000, 256):
                yield c[i:i + 256]

        st = IVFIndex.build_streaming(chunks, 1000, cfg, chunk_rows=256,
                                      key=jax.random.PRNGKey(4))
        extra = rng.standard_normal((7, 64), dtype=np.float32)
        st2 = st.add(extra)
        assert st2.live == 1007
        # the new rows must be findable under their stable ids
        _, ii = st2.search(extra, k=1, nprobe=8)
        hits = (np.asarray(ii).ravel() >= 1000).mean()
        assert hits >= 5 / 7  # int4 quantization may cost a couple
        # and pre-existing rows still match the pre-add index
        q = rng.standard_normal((5, 64), dtype=np.float32)
        _, i1 = st.search(q, k=5, nprobe=8)
        _, i2 = st2.search(q, k=5, nprobe=8)
        old = np.asarray(i2)
        assert (np.sort(np.asarray(i1), 1) == np.sort(
            np.where(old >= 1000, np.asarray(i1), old), 1)).mean() > 0.9

    def test_sharded_matches_single_chip(self):
        from mediquery_rag.engine.sharded_ivf import ShardedIVFIndex
        from mediquery_rag.engine import IVFIndex
        from mediquery_rag.parallel import corpus_mesh
        mesh = corpus_mesh(8)
        cfg = EngineConfig(dim=64, dtype="int4", ivf_nlist=16,
                           ivf_kmeans_iters=3)
        c = _vecs(2000, 64, seed=50)
        base = IVFIndex.build(c, cfg, key=jax.random.PRNGKey(3))
        sh = ShardedIVFIndex.from_single(base, mesh)
        q = _vecs(8, 64, seed=51)
        s1, i1 = base.search(q, k=5, nprobe=6)
        s2, i2 = sh.search(q, k=5, nprobe=6)
        np.testing.assert_array_equal(np.sort(np.asarray(i1), axis=1),
                                      np.sort(np.asarray(i2), axis=1))

    def test_rerank_recovers_recall(self):
        from mediquery_rag.engine import IVFIndex
        cfg = EngineConfig(dim=768, dtype="int4", ivf_nlist=16,
                           ivf_kmeans_iters=3, rerank_factor=8)
        c = _vecs(2000, 768, seed=52)
        idx = IVFIndex.build(c, cfg)
        assert idx.refine is not None
        q = _vecs(8, 768, seed=53)
        _, i = idx.search(q, k=10, nprobe=16)
        _, i_ref = flat_search_xla(q, c, 10)
        rec = recall_at_k(np.asarray(i), np.asarray(i_ref))
        assert rec >= 0.9, f"int4 IVF + rerank recall@10: {rec}"


class TestRerankRefinement:
    """Two-stage int8 + f16 host rerank: int8 scan speed, near-f32 recall."""

    def _data(self, n=3000, d=768, seed=140):
        import jax
        x = jax.random.normal(jax.random.PRNGKey(seed), (n, d))
        return x / jnp.linalg.norm(x, axis=-1, keepdims=True)

    def test_flat_rerank_recovers_recall(self):
        from mediquery_rag.engine import FlatIndex
        from mediquery_rag.obs import recall_at_k
        from mediquery_rag.ops import flat_search_xla
        c = self._data()
        q = self._data(n=32, seed=141)
        _, i_ref = flat_search_xla(q, c, 10)
        plain = FlatIndex.build(c, EngineConfig(dim=768, dtype="int8",
                                                corpus_tile=512))
        rr = FlatIndex.build(c, EngineConfig(dim=768, dtype="int8",
                                             corpus_tile=512,
                                             rerank_factor=4))
        assert rr.refine is not None and rr.refine.dtype == np.float16
        _, i_p = plain.search(q, k=10)
        _, i_r = rr.search(q, k=10)
        r_plain = recall_at_k(np.asarray(i_p), np.asarray(i_ref))
        r_rr = recall_at_k(np.asarray(i_r), np.asarray(i_ref))
        assert r_rr >= r_plain
        assert r_rr >= 0.99, (r_plain, r_rr)

    def test_ivf_rerank(self):
        from mediquery_rag.engine import IVFIndex
        from mediquery_rag.obs import recall_at_k
        from mediquery_rag.ops import flat_search_xla
        c = self._data()
        q = self._data(n=16, seed=142)
        _, i_ref = flat_search_xla(q, c, 10)
        idx = IVFIndex.build(c, EngineConfig(dim=768, dtype="int8",
                                             ivf_nlist=8, ivf_kmeans_iters=3,
                                             rerank_factor=4))
        assert idx.refine is not None
        _, i_r = idx.search(q, k=10, nprobe=8)   # full probe: isolates quant
        assert recall_at_k(np.asarray(i_r), np.asarray(i_ref)) >= 0.99

    def test_rerank_survives_mutation_and_saveload(self, tmp_path):
        from mediquery_rag.engine import FlatIndex
        c = self._data(n=500)
        extra = self._data(n=5, seed=143)
        idx = FlatIndex.build(c, EngineConfig(dim=768, dtype="int8",
                                              corpus_tile=512,
                                              rerank_factor=4))
        idx = idx.add(extra).delete([3])
        assert len(idx.refine) == idx.n
        _, i = idx.search(np.asarray(extra[2]), k=1)
        assert int(i[0]) == 502
        idx.save(str(tmp_path / "rr"))
        idx2 = FlatIndex.load(str(tmp_path / "rr"))
        assert idx2.refine is not None and len(idx2.refine) == idx2.n
        _, i1 = idx.search(np.asarray(c[10]), k=5)
        _, i2 = idx2.search(np.asarray(c[10]), k=5)
        np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))

    def test_ivf_rerank_saveload(self, tmp_path):
        from mediquery_rag.engine import IVFIndex
        c = self._data(n=800)
        idx = IVFIndex.build(c, EngineConfig(dim=768, dtype="int8",
                                             ivf_nlist=8, ivf_kmeans_iters=3,
                                             rerank_factor=4))
        idx.save(str(tmp_path / "ivr"))
        idx2 = IVFIndex.load(str(tmp_path / "ivr"))
        assert idx2.refine is not None
        q = np.asarray(c[7])
        _, i1 = idx.search(q, k=5, nprobe=8)
        _, i2 = idx2.search(q, k=5, nprobe=8)
        np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))


def test_int4_save_after_delete_keeps_stable_ids(tmp_path):
    """Regression: FlatIndex.load padded the stable-id map to the PHYSICAL
    (packed) row count — negative pad once deletes had materialized ids."""
    cfg = EngineConfig(dim=64, dtype="int4", corpus_tile=256)
    c = _vecs(500, 64, seed=60)
    idx = FlatIndex.build(c, cfg).delete([3, 7])
    idx.save(str(tmp_path / "i4d"))
    idx2 = FlatIndex.load(str(tmp_path / "i4d"))
    assert idx2.n == 498 and idx2.next_id == 500
    _, i = idx2.search(np.asarray(c[10]), k=1)
    assert int(i[0]) == 10            # stable id survives delete+save+load
