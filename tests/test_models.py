"""Embedder/tokenizer/trainer tests, including the DP x TP sharded train
step on the virtual 8-device mesh (SURVEY §4 class 4)."""

import jax
import jax.numpy as jnp
import numpy as np

from mediquery_rag.config import EmbedderConfig, TrainConfig
from mediquery_rag.models import (
    Embedder,
    HashingEmbedder,
    HashCharTokenizer,
    TextEmbedder,
)
from mediquery_rag.models.trainer import Batch, ContrastiveTrainer
from mediquery_rag.parallel import make_mesh

TINY = EmbedderConfig(
    vocab_size=512, hidden=64, layers=2, heads=4, mlp_dim=128, max_len=128,
    dtype="float32",
)


class TestTokenizer:
    def test_deterministic_across_instances(self):
        t1 = HashCharTokenizer(512)
        t2 = HashCharTokenizer(512)
        assert t1.encode("高血压怎么办") == t2.encode("高血压怎么办")

    def test_batch_shapes_and_mask(self):
        t = HashCharTokenizer(512, max_len=128)
        ids, mask = t.batch_encode(["血压", "高血压患者的饮食建议"])
        assert ids.shape == mask.shape
        assert ids.shape[1] % 128 == 0
        assert mask[0].sum() == 3  # CLS + 2 chars
        assert (ids[0][int(mask[0].sum()):] == 0).all()


class TestEmbedder:
    def test_forward_shape_and_norm(self):
        m = Embedder(TINY)
        params = m.init(jax.random.PRNGKey(0))
        tok = HashCharTokenizer(TINY.vocab_size, TINY.max_len)
        ids, mask = tok.batch_encode(["高血压", "糖尿病饮食", "short"])
        out = m.apply(params, jnp.asarray(ids), jnp.asarray(mask))
        assert out.shape == (3, 64)
        np.testing.assert_allclose(
            np.linalg.norm(np.asarray(out), axis=-1), 1.0, rtol=1e-5
        )

    def test_padding_invariance(self):
        """Same text with different padding lengths must embed identically —
        proves the mask actually gates attention and pooling."""
        m = Embedder(TINY)
        params = m.init(jax.random.PRNGKey(0))
        tok = HashCharTokenizer(TINY.vocab_size, TINY.max_len)
        ids1, mask1 = tok.batch_encode(["高血压患者"])
        e1 = m.apply(params, jnp.asarray(ids1), jnp.asarray(mask1))
        # batch with a long sibling forces more padding on the first row
        ids2, mask2 = tok.batch_encode(["高血压患者", "x" * 120])
        e2 = m.apply(params, jnp.asarray(ids2), jnp.asarray(mask2))
        np.testing.assert_allclose(np.asarray(e1[0]), np.asarray(e2[0]), atol=1e-5)

    def test_text_embedder_end_to_end(self):
        te = TextEmbedder(TINY)
        out = te.embed(["高血压", "高血压", "别的"])
        assert out.shape == (3, 64)
        np.testing.assert_allclose(out[0], out[1], atol=1e-6)
        assert not np.allclose(out[0], out[2], atol=1e-3)

    def test_save_load(self, tmp_path):
        te = TextEmbedder(TINY)
        e1 = te.embed(["高血压"])
        te.save(str(tmp_path / "ckpt"))
        te2 = TextEmbedder(TINY, key=jax.random.PRNGKey(7))
        te2.load_params(str(tmp_path / "ckpt"))
        e2 = te2.embed(["高血压"])
        np.testing.assert_allclose(e1, e2, atol=1e-6)


class TestHashingEmbedder:
    def test_similar_text_scores_higher(self):
        he = HashingEmbedder(dim=256)
        v = he.embed(["高血压患者的饮食", "高血压患者的运动", "完全无关的句子啊"])
        sim_related = float(v[0] @ v[1])
        sim_unrelated = float(v[0] @ v[2])
        assert sim_related > sim_unrelated

    def test_deterministic(self):
        a = HashingEmbedder().embed(["糖尿病"])
        b = HashingEmbedder().embed(["糖尿病"])
        np.testing.assert_array_equal(a, b)


class TestTrainer:
    def _batch(self, tok, n=8):
        qs = [f"问题{i}血压高" for i in range(n)]
        ds = [f"答案{i}注意饮食" for i in range(n)]
        q_ids, q_mask = tok.batch_encode(qs)
        d_ids, d_mask = tok.batch_encode(ds)
        return Batch(
            jnp.asarray(q_ids), jnp.asarray(q_mask),
            jnp.asarray(d_ids), jnp.asarray(d_mask),
        )

    def test_loss_decreases_single_device(self):
        tr = ContrastiveTrainer(TINY, TrainConfig(remat=False, warmup_steps=1))
        state = tr.init_state(jax.random.PRNGKey(0))
        batch = self._batch(HashCharTokenizer(TINY.vocab_size, TINY.max_len))
        losses = []
        for _ in range(5):
            state, m = tr.train_step(state, batch)
            losses.append(float(m["loss"]))
        assert losses[-1] < losses[0], losses

    def test_sharded_train_step_dp_tp(self):
        """Full train step jitted over a 4x2 (data x model) mesh — the same
        sharding code the driver dry-runs for multi-chip."""
        mesh = make_mesh({"data": 4, "model": 2})
        tr = ContrastiveTrainer(TINY, TrainConfig(remat=True, warmup_steps=1),
                                mesh=mesh)
        state = tr.init_state(jax.random.PRNGKey(0))
        batch = self._batch(HashCharTokenizer(TINY.vocab_size, TINY.max_len))
        state2, m = tr.train_step(state, batch)
        assert np.isfinite(float(m["loss"]))
        assert int(state2.step) == 1
        # params actually sharded over 'model'
        qkv = state2.params["blocks"]["qkv"]
        assert len(qkv.sharding.device_set) == 8


class TestCrossEncoder:
    """Second model family: joint (query, doc) relevance scorer."""

    def _cfg(self):
        from mediquery_rag.config import EmbedderConfig
        return EmbedderConfig(vocab_size=1024, hidden=128, layers=2, heads=4,
                              mlp_dim=256, max_len=128, dtype="float32")

    def test_forward_shapes(self):
        import jax
        import jax.numpy as jnp
        from mediquery_rag.models import CrossEncoder, HashCharTokenizer
        from mediquery_rag.models.cross_encoder import encode_pairs
        cfg = self._cfg()
        ce = CrossEncoder(cfg)
        params = ce.init(jax.random.PRNGKey(0))
        tok = HashCharTokenizer(cfg.vocab_size, cfg.max_len)
        ids, mask, seg = encode_pairs(
            tok, ["高血压饮食", "糖尿病运动"], ["答案甲", "答案乙"])
        logits = ce.apply(params, jnp.asarray(ids), jnp.asarray(mask),
                          jnp.asarray(seg))
        assert logits.shape == (2,)
        assert bool(jnp.isfinite(logits).all())

    def test_training_separates_pairs(self):
        """After a few epochs on toy pairs, true pairs must outscore
        mismatches — the signal the grader thresholds on."""
        import numpy as np
        from mediquery_rag.models import train_cross_encoder
        from mediquery_rag.models.cross_encoder import (
            CrossEncoder, encode_pairs)
        import jax.numpy as jnp
        cfg = self._cfg()
        pairs = [
            ("高血压患者的饮食", "核心是限盐，每天五克以内，多吃蔬菜水果。"),
            ("糖尿病患者如何运动", "餐后快走三十分钟，每周三次力量训练。"),
            ("睡眠不好怎么办", "固定作息时间，睡前远离屏幕，卧室保持黑暗。"),
            ("骨质疏松如何预防", "补充钙和维生素D，进行负重运动。"),
        ]
        params, tok, loss = train_cross_encoder(pairs, cfg, epochs=60,
                                                batch_size=4, lr=3e-4)
        assert loss < 0.4, loss
        ce = CrossEncoder(cfg)
        qs = [p[0] for p in pairs]
        ds = [p[1] for p in pairs]
        ids, m, sg = encode_pairs(tok, qs, ds)
        pos = np.asarray(ce.apply(params, jnp.asarray(ids), jnp.asarray(m),
                                  jnp.asarray(sg)))
        neg_ds = ds[1:] + ds[:1]
        ids, m, sg = encode_pairs(tok, qs, neg_ds)
        neg = np.asarray(ce.apply(params, jnp.asarray(ids), jnp.asarray(m),
                                  jnp.asarray(sg)))
        assert pos.mean() > neg.mean() + 0.5

    def test_grader_plugs_into_graph(self):
        """grade_fn replaces the LLM grade: a grader that always says yes
        short-circuits the rewrite loop."""
        from mediquery_rag.config import EngineConfig
        from mediquery_rag.graph import build_medical_graph, create_nodes
        from mediquery_rag.ingest import build_document_store
        from mediquery_rag.llm import RuleLLM, user
        from mediquery_rag.models import HashingEmbedder
        store = build_document_store(
            "data/medical_data.txt", HashingEmbedder(256),
            EngineConfig(dim=256, dtype="float32", corpus_tile=256,
                         ))
        seen = []

        def grader(q, texts):
            seen.append((q, len(texts)))
            return True

        llm = RuleLLM([(r"【用户问题】", "交叉编码器判定后的回答")])
        app = build_medical_graph(create_nodes(llm, store, grade_fn=grader))
        events = list(app.stream(
            {"messages": [user("高血压饮食 建议")], "user_id": "anonymous"},
            thread_id="ce"))
        names = [n for n, _ in events]
        assert names == ["router", "retrieve", "grade_loop", "summarizer"]
        assert seen and seen[0][1] == 2       # graded first-2 docs contract
        assert "交叉编码器" in events[-1][1]["final_answer"]

    def test_trained_grader_roundtrip(self, tmp_path):
        import jax
        from mediquery_rag.models.cross_encoder import (
            CrossEncoder, TrainedGrader)
        cfg = self._cfg()
        params = CrossEncoder(cfg).init(jax.random.PRNGKey(3))
        g = TrainedGrader(params, cfg, threshold=0.25)
        g.save(str(tmp_path / "gr"))
        g2 = TrainedGrader.from_checkpoint(str(tmp_path / "gr"))
        assert g2.threshold == 0.25
        q, docs = "高血压饮食", ["限盐建议内容", "运动建议内容"]
        assert g(q, docs) == g2(q, docs)
        assert g2(q, []) is False

    def test_similarity_grader(self):
        """Bi-encoder grader: max cosine over docs vs threshold; empty doc
        list grades False; a doc identical to the query grades True."""
        import numpy as np
        from mediquery_rag.models.cross_encoder import SimilarityGrader

        def unit_hash_embed(texts):
            rows = []
            for t in texts:
                v = np.zeros(8, np.float32)
                v[hash(t[0]) % 8] = 1.0
                rows.append(v)
            return np.stack(rows)

        g = SimilarityGrader(unit_hash_embed, threshold=0.5)
        assert g("高血压", []) is False
        assert g("高血压", ["高血压相关内容"]) is True  # same first char
        # orthogonal one-hots: pick a doc whose first char hashes elsewhere
        other = next(c for c in "abcdefgh" if hash(c) % 8 != hash("高") % 8)
        assert g("高血压", [other + "文档"]) is False


class TestHybridEmbedder:
    """Weighted lexical+semantic concat: dot(out_a, out_b) must equal
    w*cos_lex + (1-w)*cos_sem exactly, rows unit-norm, engine-compatible."""

    def _embedders(self):
        import numpy as np
        from mediquery_rag.models import HashingEmbedder

        def sem(texts):  # deterministic fake semantic embedder, NOT normed
            rng = [np.cos(np.arange(16) * (1 + len(t))) for t in texts]
            return np.stack(rng).astype(np.float32)

        return HashingEmbedder(32), sem

    def test_fused_score_equals_weighted_cosines(self):
        import numpy as np
        from mediquery_rag.models import HybridEmbedder
        lex, sem = self._embedders()
        hy = HybridEmbedder(lex, sem, w_lex=0.8)
        texts = ["高血压饮食建议", "糖尿病运动指导", "高血压用药提醒"]
        out = hy(texts)
        assert out.shape == (3, 32 + 16)
        np.testing.assert_allclose(np.linalg.norm(out, axis=1), 1.0,
                                   rtol=1e-5)

        def ncos(e, a, b):
            va, vb = np.asarray(e([a]))[0], np.asarray(e([b]))[0]
            va = va / np.linalg.norm(va)
            vb = vb / np.linalg.norm(vb)
            return float(va @ vb)

        want = 0.8 * ncos(lex, texts[0], texts[2]) + \
            0.2 * ncos(sem, texts[0], texts[2])
        np.testing.assert_allclose(float(out[0] @ out[2]), want, rtol=1e-5)

    def test_invalid_weight_rejected(self):
        import pytest
        from mediquery_rag.models import HybridEmbedder
        lex, sem = self._embedders()
        for w in (0.0, 1.0, -0.2, 1.5):
            with pytest.raises(ValueError):
                HybridEmbedder(lex, sem, w_lex=w)

    def test_document_store_roundtrip(self, tmp_path):
        """The hybrid embedder works through build/save/load of the store —
        fingerprint check included (the concat dim flows into EngineConfig)."""
        from mediquery_rag.ingest import (
            DocumentStore, build_document_store)
        from mediquery_rag.models import HybridEmbedder
        lex, sem = self._embedders()
        hy = HybridEmbedder(lex, sem, w_lex=0.7)
        store = build_document_store("data/medical_data.txt", hy)
        docs = store.similarity_search("高血压饮食", k=3)
        assert len(docs) == 3
        store.save(str(tmp_path / "idx"))
        store2 = DocumentStore.load(str(tmp_path / "idx"), hy)
        docs2 = store2.similarity_search("高血压饮食", k=3)
        assert [d.text for d in docs] == [d.text for d in docs2]


class TestDataParallelEmbed:
    def test_mesh_embed_matches_single_device(self):
        """DP ingest embedding over the 8-device mesh must match the
        single-device outputs (params replicated, batch rows sharded)."""
        import numpy as np
        from mediquery_rag.config import EmbedderConfig
        from mediquery_rag.models import TextEmbedder
        from mediquery_rag.parallel import make_mesh
        cfg = EmbedderConfig(vocab_size=512, hidden=64, layers=2, heads=4,
                             mlp_dim=128, max_len=128, dtype="float32")
        single = TextEmbedder(cfg)
        mesh = make_mesh({"data": 8})
        dp = TextEmbedder(cfg, params=single.params, mesh=mesh)
        texts = [f"问题{i}：血压与饮食" for i in range(13)]   # odd batch
        a = single.embed(texts)
        b = dp.embed(texts)
        np.testing.assert_allclose(a, b, rtol=2e-5, atol=2e-5)
        assert b.shape == (13, 64)
