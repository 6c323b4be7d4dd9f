"""IDF lexical channel + lexicon + self-supervised training data.

Covers VERDICT r2 item 1 (zero-egress retrieval quality): the corpus-
fitted IDF n-gram embedder (models/lexical.py), query-expansion lexicon
(models/lexicon.py), the ssl example builder / hard-negative miner
(models/data.py), and the end-to-end held-out quality gate the round was
asked to hit (recall@10 >= 0.95, recall@1 >= 0.70).
"""

import numpy as np
import pytest

from mediquery_rag.ingest import parse_corpus_file
from mediquery_rag.models.lexical import IDFHashingEmbedder, char_ngrams
from mediquery_rag.models.lexicon import expand_query

CORPUS = "data/medical_data.txt"


@pytest.fixture(scope="module")
def chunks():
    return parse_corpus_file(CORPUS)


@pytest.fixture(scope="module")
def lex(chunks):
    return IDFHashingEmbedder.fit_chunks(chunks)


class TestCharNgrams:
    def test_orders_and_space_stripping(self):
        assert char_ngrams("高 血压", (1,)) == ["高", "血", "压"]
        assert char_ngrams("高血压", (2,)) == ["高血", "血压"]
        assert char_ngrams("ab", (1, 2)) == ["a", "b", "ab"]
        assert char_ngrams("a", (2,)) == []


class TestLexicon:
    def test_expansion_is_additive(self):
        q = "五十多岁的人去健身房举铁有没有必要"
        out = expand_query(q)
        assert out.startswith(q)          # original text always preserved
        assert "力量训练" in out           # 举铁 trigger fired
        assert "中老年" in out             # 五十多岁 trigger fired

    def test_no_trigger_is_identity(self):
        q = "量子计算的指令集"
        assert expand_query(q) == q

    def test_no_duplicate_terms(self):
        out = expand_query("熬夜又晚睡")    # both expand to 睡眠不足
        assert out.count("睡眠不足") == 1


class TestIDFHashingEmbedder:
    def test_unit_norm_and_shape(self, lex, chunks):
        v = lex.embed(["血压偏高怎么办", "糖尿病饮食"])
        assert v.shape == (2, lex.dim)
        np.testing.assert_allclose(np.linalg.norm(v, axis=1), 1.0, rtol=1e-5)
        d = lex.embed_docs(chunks[:5])
        assert d.shape == (5, lex.dim)
        np.testing.assert_allclose(np.linalg.norm(d, axis=1), 1.0, rtol=1e-5)

    def test_deterministic(self, chunks):
        a = IDFHashingEmbedder.fit_chunks(chunks).embed(["高血压饮食"])
        b = IDFHashingEmbedder.fit_chunks(chunks).embed(["高血压饮食"])
        np.testing.assert_array_equal(a, b)

    def test_unseen_grams_embed_to_zero(self, lex):
        # a query sharing nothing with the corpus (and with collision-free
        # luck, no grams) must not produce spurious similarity
        v = lex.embed(["qqqqzzzz@@@@"])
        assert float(np.linalg.norm(v)) == pytest.approx(0.0, abs=1e-6)

    def test_use_before_fit_raises(self):
        e = IDFHashingEmbedder()
        with pytest.raises(RuntimeError, match="fit"):
            e.embed(["x"])
        with pytest.raises(RuntimeError, match="fit"):
            e.embed_docs([])

    def test_rendered_text_is_field_weighted(self, lex, chunks):
        """embed() on the corpus render (问题：…\\n答案：…) must apply the
        same head/body weighting as embed_docs (minus tags)."""
        c = chunks[0]
        via_text = lex.embed([c.text])[0]
        manual = lex._doc_vec(c.title, c.content)
        np.testing.assert_allclose(via_text, manual, rtol=1e-5)

    def test_save_load_roundtrip(self, lex, tmp_path):
        p = str(tmp_path / "idf.json")
        lex.save(p)
        back = IDFHashingEmbedder.load(p)
        q = ["血脂高吃什么", "失眠怎么办"]
        np.testing.assert_allclose(lex.embed(q), back.embed(q), rtol=1e-6)
        assert back.dim == lex.dim and back.orders == lex.orders

    def test_head_weight_validated(self):
        with pytest.raises(ValueError, match="head_weight"):
            IDFHashingEmbedder(head_weight=1.5)

    def test_fit_empty_corpus_raises(self):
        with pytest.raises(ValueError, match="empty"):
            IDFHashingEmbedder().fit([])


class TestHeldoutQualityGate:
    """The r2 VERDICT acceptance bar: held-out recall@10 >= 0.95 and
    recall@1 >= 0.70 on data/heldout_queries.tsv — enforced in-tree so a
    lexical-channel regression fails CI, not just a benchmark table."""

    def test_shipping_lexical_channel_meets_bar(self, lex, chunks):
        from mediquery_rag.models.eval import load_heldout, \
            retrieval_recall
        heldout = load_heldout()
        r = retrieval_recall(
            lex.embed, chunks, [c.chunk_id for c in chunks],
            [q for _, q in heldout], [cid for cid, _ in heldout],
            doc_embed=lex.embed_docs)
        assert r["recall@10"] >= 0.95, r
        # r5 note: the unigram-fusion channel trades one tier-1 query
        # (.886 -> .871) for +2 tier-2 (.70 -> .75); gate has headroom
        assert r["recall@1"] >= 0.80, r


def _bigrams(s):
    cs = [c for c in s if not c.isspace() and c not in ",，。？?、！!："]
    return set("".join(cs[i:i + 2]) for i in range(len(cs) - 1))


class TestTier2BlindSpot:
    """The r3 VERDICT item-6 stress tier: zero/near-zero character-overlap
    paraphrases (data/heldout_tier2.tsv) attack the lexical channel's known
    blind spot — queries sharing (almost) no characters with their target
    document. Closed by the r4 lexicon idiom pass + inverse document-side
    expansion (lexicon.expand_doc, measured +.025 r@1 / +.05 r@10 on this
    tier). Thresholds are the honest measured floor, not aspirational."""

    @pytest.fixture(scope="class")
    def tier2(self):
        from mediquery_rag.models.eval import load_heldout
        return load_heldout("data/heldout_tier2.tsv")

    def test_construction_near_zero_overlap(self, tier2, chunks):
        """The tier IS what it claims: mean content-bigram overlap with the
        gold doc far below tier-1's (0.055 vs 0.206 at authoring time)."""
        from mediquery_rag.models.eval import load_heldout
        by_id = {c.chunk_id: c for c in chunks}

        def mean_overlap(pairs):
            vals = []
            for cid, q in pairs:
                c = by_id[cid]
                doc = c.title + c.content + " ".join(c.tags or [])
                qb = _bigrams(q)
                vals.append(len(qb & _bigrams(doc)) / max(len(qb), 1))
            return float(np.mean(vals)), float(np.max(vals))

        assert len(tier2) >= 30
        m2, mx2 = mean_overlap(tier2)
        m1, _ = mean_overlap(load_heldout())
        assert m2 <= 0.10, f"tier2 mean overlap {m2:.3f} not near-zero"
        assert mx2 <= 0.30, f"tier2 worst-case overlap {mx2:.3f}"
        assert m2 < m1 / 2, (m2, m1)

    def test_queries_absent_from_corpus(self, tier2):
        raw = open(CORPUS, encoding="utf-8").read()
        for _, q in tier2:
            assert q not in raw

    def test_shipping_channel_meets_tier2_bar(self, lex, chunks, tier2):
        from mediquery_rag.models.eval import retrieval_recall
        r = retrieval_recall(
            lex.embed, chunks, [c.chunk_id for c in chunks],
            [q for _, q in tier2], [cid for cid, _ in tier2],
            doc_embed=lex.embed_docs)
        # measured r5 (unigram-fusion channel): r@1 .75 / r@5 .925 /
        # r@10 .975 (deterministic); was r4 .70/.90/.975
        assert r["recall@1"] >= 0.72, r
        assert r["recall@5"] >= 0.90, r
        assert r["recall@10"] >= 0.95, r

    def test_doc_expansion_is_the_measured_win(self, chunks, tier2):
        """Without expand_doc the tier regresses (r@10 .925 vs .975) —
        guards the doc_expand wiring against silent loss."""
        from mediquery_rag.models.eval import retrieval_recall
        off = IDFHashingEmbedder.fit_chunks(chunks, doc_expand=False)
        on = IDFHashingEmbedder.fit_chunks(chunks, doc_expand=True)
        args = (chunks, [c.chunk_id for c in chunks],
                [q for _, q in tier2], [cid for cid, _ in tier2])
        r_off = retrieval_recall(off.embed, *args, doc_embed=off.embed_docs)
        r_on = retrieval_recall(on.embed, *args, doc_embed=on.embed_docs)
        assert r_on["recall@10"] >= r_off["recall@10"]
        assert r_on["mrr"] >= r_off["mrr"]


class TestExpandDoc:
    def test_inverse_triggers(self):
        from mediquery_rag.models.lexicon import expand_doc
        out = expand_doc("力量训练对中老年人有什么好处？")
        assert "撸铁" in out and "举铁" in out

    def test_empty_when_no_canonical_terms(self):
        from mediquery_rag.models.lexicon import expand_doc
        assert expand_doc("量子计算的指令集") == ""

    def test_doc_expand_roundtrips(self, chunks, tmp_path):
        e = IDFHashingEmbedder.fit_chunks(chunks, doc_expand=False)
        p = str(tmp_path / "idf.json")
        e.save(p)
        back = IDFHashingEmbedder.load(p)
        assert back.doc_expand is False
        np.testing.assert_allclose(e.embed_docs(chunks[:3]),
                                   back.embed_docs(chunks[:3]), rtol=1e-6)


class TestPipelineIntegration:
    def test_store_uses_embed_docs_and_roundtrips(self, lex, chunks,
                                                  tmp_path):
        from mediquery_rag.ingest import (
            DocumentStore, build_document_store)
        store = build_document_store(chunks[:32], lex)
        # vectors in the index must be the field-weighted doc vectors,
        # not embed(text) vectors
        got = np.asarray(store.index.search(
            lex.embed_docs(chunks[:1]), k=1)[1])[0, 0]
        assert int(got) == 0
        docs = store.similarity_search(chunks[3].title, k=3)
        assert any(chunks[3].content in d.text for d in docs)
        store.save(str(tmp_path / "idx"))
        back = DocumentStore.load(str(tmp_path / "idx"), lex)
        assert [d.text for d in back.similarity_search(chunks[3].title, k=3)
                ] == [d.text for d in docs]

    def test_add_documents_uses_embed_docs(self, lex, chunks):
        from mediquery_rag.ingest import build_document_store
        store = build_document_store(chunks[:16], lex)
        ids = store.add_documents(list(chunks[16:20]))
        assert ids == [16, 17, 18, 19]
        docs = store.similarity_search(chunks[17].title, k=2)
        assert any(chunks[17].content in d.text for d in docs)

    def test_hybrid_embed_docs_path(self, lex, chunks):
        from mediquery_rag.models import HybridEmbedder

        def sem(texts):
            return np.stack([np.cos(np.arange(16) * (1 + len(t)))
                             for t in texts]).astype(np.float32)

        hy = HybridEmbedder(lex, sem, w_lex=0.8)
        out = hy.embed_docs(chunks[:4])
        assert out.shape == (4, lex.dim + 16)
        np.testing.assert_allclose(np.linalg.norm(out, axis=1), 1.0,
                                   rtol=1e-5)
        # lexical half must equal the field-weighted doc vectors
        want = np.sqrt(0.8) * lex.embed_docs(chunks[:4])
        np.testing.assert_allclose(out[:, :lex.dim], want, rtol=1e-5)


class TestSSLData:
    def test_example_views_and_rows(self, chunks):
        from mediquery_rag.models.data import ssl_examples_from_chunks
        ex = ssl_examples_from_chunks(chunks[:10], seed=0)
        rows = {r for _, _, r in ex}
        assert rows == set(range(10))
        # every chunk contributes the title view and the span view
        titles = {q for q, _, r in ex if r == 0}
        assert chunks[0].title in titles
        assert len(ex) > 2 * 10

    def test_colloquialize_swaps_terms(self):
        from mediquery_rag.models.data import colloquialize
        rng = np.random.default_rng(0)
        outs = {colloquialize("力量训练对中老年人有什么好处", rng, p=1.0)
                for _ in range(8)}
        assert all("力量训练" not in o for o in outs)   # always swapped at p=1
        assert any(("举铁" in o) or ("撸铁" in o) or ("练肌肉" in o)
                   for o in outs)

    def test_hard_negatives_exclude_gold(self, lex, chunks):
        from mediquery_rag.models.data import (
            mine_hard_negatives, ssl_examples_from_chunks)
        ex = ssl_examples_from_chunks(chunks[:20], seed=0)
        negs = mine_hard_negatives(ex, chunks[:20], lex)
        assert len(negs) == len(ex)
        for (q, d, row), n in zip(ex, negs):
            assert n != chunks[row].content

    def test_triplet_loader_shapes(self, chunks):
        from mediquery_rag.models import HashCharTokenizer
        from mediquery_rag.models.data import (
            TripletLoader, ssl_examples_from_chunks)
        ex = ssl_examples_from_chunks(chunks[:12], seed=0)
        tok = HashCharTokenizer(512, 64)
        loader = TripletLoader(ex, [c for _, c, _ in ex], tok,
                               batch_size=4, max_len=64)
        b = next(iter(loader.batches()))
        assert b.q_ids.shape == (4, 64) and b.n_ids.shape == (4, 64)
        assert b.n_mask is not None


class TestTrainerWithNegativesAndDropout:
    def test_loss_decreases(self, chunks):
        import jax
        from mediquery_rag.config import EmbedderConfig, TrainConfig
        from mediquery_rag.models import HashCharTokenizer
        from mediquery_rag.models.data import (
            TripletLoader, ssl_examples_from_chunks)
        from mediquery_rag.models.trainer import ContrastiveTrainer
        mcfg = EmbedderConfig(vocab_size=512, hidden=64, layers=2, heads=4,
                              mlp_dim=128, max_len=64, dtype="float32",
                              dropout=0.1)
        tcfg = TrainConfig(batch_size=8, lr=3e-4, warmup_steps=2,
                           remat=False)
        ex = ssl_examples_from_chunks(chunks[:24], seed=0)
        tok = HashCharTokenizer(512, 64)
        loader = TripletLoader(ex, [c for _, c, _ in ex], tok, 8,
                               max_len=64)
        tr = ContrastiveTrainer(mcfg, tcfg)
        state = tr.init_state(jax.random.PRNGKey(0))
        losses = []
        for epoch in range(6):
            for batch in loader.batches():
                state, m = tr.train_step(state, batch)
                losses.append(float(m["loss"]))
        assert np.mean(losses[-4:]) < np.mean(losses[:4])

    def test_dropout_views_differ_and_inference_deterministic(self):
        import jax
        from mediquery_rag.config import EmbedderConfig
        from mediquery_rag.models import Embedder
        cfg = EmbedderConfig(vocab_size=128, hidden=32, layers=2, heads=2,
                             mlp_dim=64, max_len=16, dtype="float32",
                             dropout=0.3)
        m = Embedder(cfg)
        params = m.init(jax.random.PRNGKey(0))
        import jax.numpy as jnp
        ids = jnp.ones((2, 16), jnp.int32)
        mask = jnp.ones((2, 16), jnp.float32)
        a = m.apply(params, ids, mask, dropout_rng=jax.random.PRNGKey(1))
        b = m.apply(params, ids, mask, dropout_rng=jax.random.PRNGKey(2))
        assert not np.allclose(np.asarray(a), np.asarray(b))
        c = m.apply(params, ids, mask)
        d = m.apply(params, ids, mask)
        np.testing.assert_array_equal(np.asarray(c), np.asarray(d))


class TestMinedChannelProvenance:
    """r4 VERDICT item 5's anti-overfit guard: the unigram-fusion channel
    is mined from CORPUS STATISTICS ONLY — refitting on the corpus alone
    reproduces the shipping tables exactly, and no eval-query text can
    have leaked in (queries are asserted absent from the corpus, and every
    fitted gram is by construction a substring of corpus/lexicon text)."""

    def test_unigram_channel_refits_identically_from_corpus(self, chunks):
        a = IDFHashingEmbedder.fit_chunks(chunks)
        b = IDFHashingEmbedder.fit_chunks(chunks)
        assert a._uni is not None and b._uni is not None
        assert a._uni._idf == b._uni._idf
        assert a._idf == b._idf

    def test_channel_fit_inputs_are_corpus_only(self, chunks):
        """The fit corpus = chunk text + tags + the doc-side lexicon
        expansion of title/tags — a pure function of the corpus and the
        static lexicon, never of any query set."""
        from mediquery_rag.models.lexicon import expand_doc
        lex = IDFHashingEmbedder.fit_chunks(chunks)
        fit_texts = "".join(
            c.text + "\n" + "，".join(c.tags or [])
            + ("\n" + expand_doc(lex._doc_head(c)))
            for c in chunks)
        import random
        rng = random.Random(0)
        grams = rng.sample(sorted(lex._uni._idf), 200)
        joined = "".join(ch for ch in fit_texts if not ch.isspace())
        for g in grams:
            assert g in joined
