"""Training-data pipeline + end-to-end tiny training run on the corpus."""

import jax
import numpy as np

from mediquery_rag.config import EmbedderConfig, TrainConfig
from mediquery_rag.ingest import parse_corpus_file
from mediquery_rag.models import HashCharTokenizer
from mediquery_rag.models.data import PairLoader, pairs_from_chunks
from mediquery_rag.models.trainer import ContrastiveTrainer

TINY = EmbedderConfig(vocab_size=512, hidden=64, layers=2, heads=4,
                      mlp_dim=128, max_len=128, dtype="float32")


def test_pairs_from_corpus():
    chunks = parse_corpus_file("data/medical_data.txt")
    pairs = pairs_from_chunks(chunks)
    assert len(pairs) >= 150  # corpus is 160 chunks (data/medical_data.txt)
    assert all(q and d for q, d in pairs)


def test_loader_shapes_and_shuffle():
    pairs = [(f"问{i}", f"答{i}" * 20) for i in range(16)]
    tok = HashCharTokenizer(512, 128)
    loader = PairLoader(pairs, tok, batch_size=4, seed=0)
    batches = list(loader.batches(epochs=2))
    assert len(batches) == 8
    b = batches[0]
    assert b.q_ids.shape[0] == 4 and b.q_ids.shape == b.q_mask.shape


def test_training_on_corpus_improves_retrieval():
    """A few InfoNCE steps on the sample corpus must raise query->own-doc
    retrieval accuracy above the random-init baseline."""
    chunks = parse_corpus_file("data/medical_data.txt")
    pairs = pairs_from_chunks(chunks)
    tok = HashCharTokenizer(TINY.vocab_size, TINY.max_len)
    trainer = ContrastiveTrainer(TINY, TrainConfig(
        batch_size=12, lr=3e-4, warmup_steps=2, remat=False))
    state = trainer.init_state(jax.random.PRNGKey(0))

    def accuracy(params):
        import jax.numpy as jnp
        q_ids, q_mask = tok.batch_encode([q for q, _ in pairs])
        d_ids, d_mask = tok.batch_encode([d for _, d in pairs])
        qe = trainer.model.apply(params, jnp.asarray(q_ids), jnp.asarray(q_mask))
        de = trainer.model.apply(params, jnp.asarray(d_ids), jnp.asarray(d_mask))
        pred = np.argmax(np.asarray(qe @ de.T), axis=1)
        return float((pred == np.arange(len(pairs))).mean())

    acc0 = accuracy(state.params)
    loader = PairLoader(pairs, tok, batch_size=12, seed=0)
    losses = []
    for batch in loader.batches(epochs=30):
        state, m = trainer.train_step(state, batch)
        losses.append(float(m["loss"]))
    acc1 = accuracy(state.params)
    assert losses[-1] < losses[0]
    assert acc1 >= max(acc0, 0.5), (acc0, acc1)


class TestHeldoutEval:
    def test_heldout_ids_resolve_and_queries_unseen(self):
        """Every held-out gold id exists in the corpus, and no held-out
        query string appears verbatim anywhere in the corpus (else the
        'unseen phrasing' claim of benchmarks/retrieval_eval.py is void)."""
        from mediquery_rag.ingest import parse_corpus_file
        from mediquery_rag.models.eval import load_heldout
        chunks = parse_corpus_file("data/medical_data.txt")
        ids = {c.chunk_id for c in chunks}
        corpus_text = open("data/medical_data.txt", encoding="utf-8").read()
        held = load_heldout()
        assert len(held) >= 60
        for cid, query in held:
            assert cid in ids, f"unknown chunk_id {cid}"
            assert query not in corpus_text, f"leaked query: {query}"

    def test_retrieval_recall_oracle(self):
        """retrieval_recall with a perfect embedder scores 1.0, with an
        adversarial one 0 at k=1."""
        import numpy as np
        from mediquery_rag.models.eval import retrieval_recall
        docs = ["a", "b", "c", "d"]
        ids = ["1", "2", "3", "4"]
        basis = np.eye(4, 8, dtype=np.float32)
        table = {t: basis[i] for i, t in enumerate(docs)}

        def perfect(texts):
            return np.stack([table[t[0]] for t in texts])

        r = retrieval_recall(perfect, docs, ids,
                             ["a!", "c!", "d!"], ["1", "3", "4"], ks=(1,))
        assert r["recall@1"] == 1.0 and r["mrr"] == 1.0

        def shifted(texts):
            # queries (marked "!") embed to the NEXT doc's vector: every
            # query retrieves the wrong chunk at k=1, the right one at k=2
            rolled = {"a": "b", "b": "c", "c": "d", "d": "a"}
            return np.stack([
                table[rolled[t[0]]] + 0.1 * table[t[0]] if t.endswith("!")
                else table[t[0]]
                for t in texts])

        r2 = retrieval_recall(shifted, docs, ids,
                              ["a!", "b!"], ["1", "2"], ks=(1, 2))
        assert r2["recall@1"] == 0.0 and r2["recall@2"] == 1.0
