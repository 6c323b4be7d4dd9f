"""Native C++ HNSW tests (build via make, load via ctypes)."""

import numpy as np
import pytest

from mediquery_rag.native import hnsw_available

pytestmark = pytest.mark.skipif(
    not hnsw_available(), reason="native toolchain unavailable")


def _clustered(n, d, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((32, d))
    asg = rng.integers(0, 32, n)
    x = centers[asg] + 0.3 * rng.standard_normal((n, d))
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


class TestHNSW:
    def test_recall_on_clustered(self):
        from mediquery_rag.native import HNSWIndex
        x = _clustered(5000, 64)
        rng = np.random.default_rng(1)
        q = x[rng.integers(0, 5000, 20)] + 0.05 * rng.standard_normal((20, 64)).astype(np.float32)
        q = (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)
        ix = HNSWIndex(64, M=16, ef_construction=100)
        ix.add(x)
        assert ix.size == 5000
        _, i = ix.search(q, 10, ef=64)
        ref = np.argsort(-(q @ x.T), axis=1)[:, :10]
        rec = np.mean([len(set(i[r]) & set(ref[r])) / 10 for r in range(20)])
        assert rec >= 0.9, rec

    def test_exact_self_lookup(self):
        from mediquery_rag.native import HNSWIndex
        x = _clustered(1000, 32)
        ix = HNSWIndex(32, M=16, ef_construction=100)
        ix.add(x)
        _, i = ix.search(x[:10], 1, ef=32)
        assert (i[:, 0] == np.arange(10)).mean() >= 0.9

    def test_custom_labels_and_memory(self):
        from mediquery_rag.native import HNSWIndex
        x = _clustered(100, 32)
        ix = HNSWIndex(32)
        ix.add(x, labels=np.arange(1000, 1100))
        _, i = ix.search(x[0], 1)
        assert int(i[0, 0]) == 1000
        assert ix.nbytes > 100 * 32 * 4

    def test_empty_search(self):
        from mediquery_rag.native import HNSWIndex
        ix = HNSWIndex(16)
        s, i = ix.search(np.zeros(16, np.float32), 5)
        assert (s == -np.inf).all()

    def test_parallel_batch_matches_serial(self):
        """OpenMP query-parallel search (per-thread visited tables over the
        read-only graph) must be bit-identical to the serial path."""
        from mediquery_rag.native import HNSWIndex
        x = _clustered(3000, 48, seed=3)
        rng = np.random.default_rng(4)
        q = x[rng.integers(0, 3000, 64)]
        ix = HNSWIndex(48, M=16, ef_construction=100)
        ix.add(x)
        s1, i1 = ix.search(q, 10, ef=64, threads=1)
        s4, i4 = ix.search(q, 10, ef=64, threads=4)
        np.testing.assert_array_equal(i1, i4)
        np.testing.assert_array_equal(s1, s4)


class TestNativeTokenizer:
    """C++ batch tokenizer must be BIT-IDENTICAL to the Python loop: the
    embedder fingerprint (and every persisted index) depends on it."""

    def test_exactness_vs_python(self):
        import random
        from mediquery_rag.models.tokenizer import HashCharTokenizer
        from mediquery_rag.native.tokenizer import (
            native_available, tok_batch)
        if not native_available():
            import pytest
            pytest.skip("no C++ toolchain")
        tok = HashCharTokenizer(16384, 256)
        random.seed(7)
        rand = "".join(chr(random.randint(1, 0x10FFFF - 2048))
                       for _ in range(800))
        rand = "".join(c for c in rand if not 0xD800 <= ord(c) <= 0xDFFF)
        cases = [
            "", " ", "\t\n\x1c\x1d\x1e\x1f\x85\xa0        　",
            "高血压患者的饮食建议", "a b  c", "🩺💊🧬 emoji 测试",
            "x" * 1000, "混合 English 和 中文 with spaces   and\ttabs",
            rand,
        ]
        py = [tok.encode(t)[:256] for t in cases]
        ids, lens = tok_batch(cases, 16384, 255, 256)
        for r, e in enumerate(py):
            assert int(lens[r]) == len(e)
            assert ids[r, : len(e)].tolist() == e
            assert (ids[r, len(e):] == 0).all()

    def test_batch_encode_native_matches_fallback(self):
        from mediquery_rag.models.tokenizer import HashCharTokenizer
        from mediquery_rag.native import tokenizer as nt
        if not nt.native_available():
            import pytest
            pytest.skip("no C++ toolchain")
        tok = HashCharTokenizer(2048, 128)
        texts = ["高血压 饮食", "糖尿病如何运动才安全", "", "short"]
        ids_n, mask_n = tok.batch_encode(texts)
        # force the Python fallback
        saved = nt._lib, nt._failed
        nt._lib, nt._failed = None, True
        try:
            ids_p, mask_p = tok.batch_encode(texts)
        finally:
            nt._lib, nt._failed = saved
        import numpy as np
        np.testing.assert_array_equal(ids_n, ids_p)
        np.testing.assert_array_equal(mask_n, mask_p)


class TestNativeRerank:
    def _numpy_oracle(self, refine, q32, s, cand, k):
        safe = np.clip(cand, 0, len(refine) - 1)
        rows = refine[safe].astype(np.float32)
        exact = np.einsum("bd,bkd->bk", q32, rows, optimize=True)
        exact = np.where(s > -np.inf, exact, -np.inf)
        top = np.argsort(-exact, axis=1, kind="stable")[:, :k]
        return (np.take_along_axis(exact, top, axis=1),
                np.take_along_axis(cand, top, axis=1))

    def test_matches_numpy_oracle(self):
        from mediquery_rag.native.rerank import (
            native_rerank, rerank_available)
        if not rerank_available():
            pytest.skip("no C++ toolchain")
        rng = np.random.default_rng(0)
        n, d, b, kk, k = 5000, 768, 16, 40, 10
        refine = rng.standard_normal((n, d)).astype(np.float16)
        q = rng.standard_normal((b, d)).astype(np.float32)
        cand = rng.integers(0, n, (b, kk)).astype(np.int32)
        s = rng.standard_normal((b, kk)).astype(np.float32)
        s[:, -3:] = -np.inf            # padded candidate slots
        s_n, i_n = native_rerank(refine, q, s, cand, k)
        s_o, i_o = self._numpy_oracle(refine, q, s, cand, k)
        np.testing.assert_array_equal(i_n, i_o)
        np.testing.assert_allclose(s_n, s_o, rtol=2e-3, atol=2e-3)

    def test_duplicate_candidates_stable_ties(self):
        from mediquery_rag.native.rerank import (
            native_rerank, rerank_available)
        if not rerank_available():
            pytest.skip("no C++ toolchain")
        n, d, k = 64, 32, 4
        refine = np.ones((n, d), np.float16)
        q = np.ones((1, d), np.float32)
        cand = np.array([[5, 5, 7, 9, 5, 11]], np.int32)   # equal scores
        s = np.zeros((1, 6), np.float32)
        s_n, i_n = native_rerank(refine, q, s, cand, k)
        s_o, i_o = self._numpy_oracle(refine, q, s, cand, k)
        np.testing.assert_array_equal(i_n, i_o)

    def test_host_rerank_dispatches_native(self):
        """engine.flat.host_rerank must produce identical ids through both
        paths on f16 refine input."""
        from mediquery_rag.engine import flat as flat_mod
        from mediquery_rag.native import rerank as nr
        if not nr.rerank_available():
            pytest.skip("no C++ toolchain")
        rng = np.random.default_rng(3)
        refine = rng.standard_normal((2000, 64)).astype(np.float16)
        q = rng.standard_normal((4, 64)).astype(np.float32)
        cand = rng.integers(0, 2000, (4, 20)).astype(np.int32)
        s = rng.standard_normal((4, 20)).astype(np.float32)
        s_a, i_a = flat_mod.host_rerank(refine, q, s, cand, 5, cosine=True)
        q32 = q / np.linalg.norm(q, axis=1, keepdims=True)
        s_o, i_o = self._numpy_oracle(refine, q32, s, cand, 5)
        np.testing.assert_array_equal(np.asarray(i_a), i_o)
        np.testing.assert_allclose(np.asarray(s_a), s_o, rtol=2e-3, atol=2e-3)


class TestNativeLexical:
    """C++ IDF n-gram embedder (native/lexical.cpp) must be bit-identical
    to the Python loop — the embedder fingerprint (and every persisted
    index) depends on it."""

    def _embedder(self):
        from mediquery_rag.ingest import parse_corpus_file
        from mediquery_rag.models.lexical import IDFHashingEmbedder
        chunks = parse_corpus_file("data/medical_data.txt")
        return IDFHashingEmbedder.fit_chunks(chunks), chunks

    def test_exactness_vs_python(self):
        from mediquery_rag.native import lexical as nl
        if not nl.native_available():
            pytest.skip("no C++ toolchain")
        lex, chunks = self._embedder()
        assert lex._native_keys is not None
        texts = [
            "高血压患者平时吃饭要注意什么",
            "糖尿病 人 的 主食",                # spaces between CJK
            "",                                  # empty
            "a",                                 # single ASCII char
            "血压",                              # two chars, one bigram
            "  \t\n ",                           # whitespace only
            "BMI 30 算胖吗？emoji🙂测试",        # mixed ASCII/CJK/emoji
            chunks[0].text,                      # a full rendered chunk
            "qqqqzzzz@@@@",                      # no corpus grams at all
        ]
        native = nl.lex_vec_batch(texts, lex._native_keys,
                                  lex._native_weights, lex.base_dim)
        python = np.stack([lex._vec(t) for t in texts])
        np.testing.assert_array_equal(native, python)

    def test_embed_paths_agree_with_python_loop(self):
        """embed()/embed_docs() (which auto-pick the native path) must
        equal a forced-Python embedder bit-for-bit, so the fingerprint is
        path-independent."""
        from mediquery_rag.native import lexical as nl
        if not nl.native_available():
            pytest.skip("no C++ toolchain")
        lex, chunks = self._embedder()
        forced = type(lex)(dim=lex.base_dim)
        forced._idf = lex._idf
        forced._native_keys = None              # Python loop only
        if lex._uni is not None:                # r5 unigram-fusion channel
            forced._uni._idf = lex._uni._idf
            forced._uni._native_keys = None
        qs = ["嗓子疼自己买头孢吃对吗", "熬夜的危害", chunks[3].text]
        np.testing.assert_array_equal(lex.embed(qs), forced.embed(qs))
        np.testing.assert_array_equal(lex.embed_docs(chunks[:8]),
                                      forced.embed_docs(chunks[:8]))

    def test_throughput_sanity(self):
        """The native path must actually be faster on a real batch (the
        reason it exists); generous 2x bar to stay robust on a loaded
        host."""
        import time
        from mediquery_rag.native import lexical as nl
        if not nl.native_available():
            pytest.skip("no C++ toolchain")
        lex, chunks = self._embedder()
        texts = [c.text for c in chunks] * 4
        t0 = time.perf_counter()
        nl.lex_vec_batch(texts, lex._native_keys, lex._native_weights,
                         lex.base_dim)
        t_native = time.perf_counter() - t0
        t0 = time.perf_counter()
        for t in texts:
            lex._vec(t)
        t_python = time.perf_counter() - t0
        assert t_native * 2 < t_python, (t_native, t_python)
