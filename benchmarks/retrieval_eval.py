"""Held-out retrieval quality: train on the corpus, eval on unseen phrasings.

VERDICT r1 ("model evals are self-referential") / r2 item 1 (close the
zero-egress retrieval-quality gap). Measures every retrieval channel the
framework can ship, on data/heldout_queries.tsv — 70 original colloquial
paraphrases that appear nowhere in the corpus:

- **IDF lexical** (models/lexical.py): corpus-fitted IDF char 1/2-gram
  hashing, field-weighted docs, lexicon query expansion — the zero-config
  shipping default (cli/context.py).
- **trained encoder**: the from-scratch device encoder trained with the
  corpus-scale self-supervised recipe (ssl_examples_from_chunks:
  title/colloquialized-title/tags/span views; lexical-mined hard
  negatives; SimCSE dropout towers).
- **hybrid** fusion sweep (HybridEmbedder w_lex grid).
- flat-hashing baseline (the r1 lexical channel) for the record.

    python benchmarks/retrieval_eval.py                 # real chip
    python benchmarks/retrieval_eval.py --layers 2 --epochs 8   # quick

Reference capability being measured: /root/reference/src/medical_engine.py:43
(pretrained dmeta-embedding-zh answering unseen user questions).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--corpus", default="data/medical_data.txt")
    ap.add_argument("--heldout", default="data/heldout_queries.tsv")
    ap.add_argument("--heldout-tier2", default="data/heldout_tier2.tsv",
                    help="zero-overlap stress tier (r3 VERDICT item 6); "
                         "'' disables")
    ap.add_argument("--lexical-only", action="store_true",
                    help="skip encoder training; report the lexical "
                         "channel (+ doc-expansion A/B) on both tiers")
    ap.add_argument("--epochs", type=int, default=40)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--layers", type=int, default=4,
                    help="encoder depth (160 chunks do not need 12 layers)")
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--dropout", type=float, default=0.1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--save", default="",
                    help="optional checkpoint dir for the trained embedder")
    args = ap.parse_args()

    import jax

    from mediquery_rag.config import EmbedderConfig, TrainConfig
    from mediquery_rag.ingest import parse_corpus_file
    from mediquery_rag.models import (
        HashingEmbedder, HybridEmbedder, IDFHashingEmbedder,
        HashCharTokenizer, TextEmbedder,
    )
    from mediquery_rag.models.data import (
        TripletLoader, mine_hard_negatives, ssl_examples_from_chunks,
    )
    from mediquery_rag.models.eval import load_heldout, retrieval_recall
    from mediquery_rag.models.trainer import ContrastiveTrainer

    chunks = parse_corpus_file(args.corpus)
    heldout = load_heldout(args.heldout)
    print(f"corpus: {len(chunks)} chunks; heldout: {len(heldout)} queries")

    # -- the shipping lexical channel (fitted, field-weighted, expanded) -----
    lex = IDFHashingEmbedder.fit_chunks(chunks)

    def lex_run(embedder, pairs):
        return retrieval_recall(
            embedder.embed, chunks, [c.chunk_id for c in chunks],
            [q for _, q in pairs], [cid for cid, _ in pairs],
            doc_embed=embedder.embed_docs)

    if args.heldout_tier2:
        tier2 = load_heldout(args.heldout_tier2)
        lex_off = IDFHashingEmbedder.fit_chunks(chunks, doc_expand=False)
        report2 = {
            "tier1_lexical": lex_run(lex, heldout),
            "tier1_lexical_no_doc_expand": lex_run(lex_off, heldout),
            "tier2_lexical": lex_run(lex, tier2),
            "tier2_lexical_no_doc_expand": lex_run(lex_off, tier2),
            "n_tier2": len(tier2),
        }
        print(json.dumps({"blind_spot_tiers": report2}, indent=2))
    if args.lexical_only:
        return

    # -- corpus-scale self-supervised encoder training ------------------------
    examples = ssl_examples_from_chunks(chunks, seed=args.seed)
    negatives = mine_hard_negatives(examples, chunks, lex, seed=args.seed)
    print(f"ssl examples: {len(examples)} (hard negatives mined from "
          "lexical top-k)")
    mcfg = EmbedderConfig(layers=args.layers, max_len=args.max_len,
                          dropout=args.dropout)
    tcfg = TrainConfig(batch_size=args.batch_size, lr=args.lr,
                       warmup_steps=20)
    tok = HashCharTokenizer(mcfg.vocab_size, mcfg.max_len)
    loader = TripletLoader(examples, negatives, tok, args.batch_size,
                           seed=args.seed, max_len=args.max_len)
    trainer = ContrastiveTrainer(mcfg, tcfg)
    state = trainer.init_state(jax.random.PRNGKey(args.seed))

    t0 = time.time()
    step = 0
    for batch in loader.batches(epochs=args.epochs):
        state, metrics = trainer.train_step(state, batch)
        step += 1
        if step % 100 == 0 or step == 1:
            print(f"step {step:5d}  loss {float(metrics['loss']):.4f}  "
                  f"{time.time() - t0:.1f}s")
    print(f"trained {step} steps in {time.time() - t0:.1f}s")

    te = TextEmbedder(mcfg, params=jax.device_get(state.params))
    if args.save:
        te.save(args.save)
        print(f"saved -> {args.save}")

    docs = [c.text for c in chunks]
    doc_ids = [c.chunk_id for c in chunks]
    h_q = [q for _, q in heldout]
    h_gold = [cid for cid, _ in heldout]

    def run(embed, doc_embed=None, structured=False):
        return retrieval_recall(
            embed, chunks if structured else docs, doc_ids, h_q, h_gold,
            doc_embed=doc_embed)

    # every channel, shipping paths first
    held_lex = run(lex.embed, doc_embed=lex.embed_docs, structured=True)
    held_sem = run(te.embed)
    held_flat = run(HashingEmbedder(768))
    hybrid_sweep = {}
    for w in (0.5, 0.6, 0.7, 0.8, 0.9):
        hy = HybridEmbedder(lex, te.embed, w_lex=w)
        hybrid_sweep[f"w_lex={w}"] = run(
            hy, doc_embed=hy.embed_docs, structured=True)
    train = retrieval_recall(te.embed, docs, doc_ids,
                             [c.title for c in chunks], doc_ids)

    print(json.dumps({
        "heldout_idf_lexical": held_lex,
        "heldout_trained": held_sem,
        "heldout_hybrid": hybrid_sweep,
        "heldout_flat_hashing_r1_baseline": held_flat,
        "train_titles": train,
        "n_docs": len(docs), "n_heldout": len(heldout),
        "layers": args.layers, "epochs": args.epochs,
        "dropout": args.dropout, "n_examples": len(examples),
    }, indent=2))


if __name__ == "__main__":
    main()
