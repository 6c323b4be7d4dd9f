"""Held-out task metric for the document-grading contract.

VERDICT r1 ("no task metric for the grader ... contracts"): the reference
grades retrieved docs with a yes/no LLM call (core/utils.py:64-72); our
accelerator-native grader is the cross-encoder (models/cross_encoder.py). This
benchmark trains it on the corpus and measures the *binary decision
quality* on data/heldout_queries.tsv — phrasings the grader never saw:

- positive: (held-out query, its gold chunk content)  -> must grade True
- negative: (held-out query, a far-away chunk content) -> must grade False

Reports accuracy / true-positive rate / true-negative rate at the shipping
threshold, plus the threshold-free AUC, so the CLI's grade_fn wiring
(cli/context.py) has a measured quality bar instead of a toy-pair check.

    python benchmarks/grader_eval.py                # defaults of train_grader
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
    ap.add_argument("--epochs", type=int, default=40)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--hidden", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--save", default="",
                    help="optional TrainedGrader checkpoint dir")
    ap.add_argument("--embedder", default="",
                    help="trained TextEmbedder checkpoint dir: also eval the "
                         "bi-encoder SimilarityGrader (the CLI default)")
    args = ap.parse_args()

    import numpy as np

    from mediquery_rag.config import EmbedderConfig
    from mediquery_rag.ingest import parse_corpus_file
    from mediquery_rag.models.cross_encoder import (
        TrainedGrader, train_cross_encoder)
    from mediquery_rag.models.eval import load_heldout

    cfg = EmbedderConfig(vocab_size=2048, hidden=args.hidden,
                         layers=args.layers, heads=4,
                         mlp_dim=2 * args.hidden, max_len=192,
                         dtype="bfloat16")
    chunks = parse_corpus_file(args.corpus)
    by_id = {c.chunk_id: c for c in chunks}
    heldout = load_heldout(args.heldout)
    pairs = [(c.title, c.content) for c in chunks]

    t0 = time.time()
    params, _, loss = train_cross_encoder(
        pairs, cfg, epochs=args.epochs, batch_size=args.batch_size,
        lr=args.lr, seed=args.seed)
    print(f"trained: final loss {loss:.4f} in {time.time() - t0:.1f}s")
    grader = TrainedGrader(params, cfg)
    if args.save:
        grader.save(args.save)
        print(f"saved -> {args.save}")

    # negatives: the gold chunk id + 80 (mod n) — a topically distant chunk
    # (the corpus is grouped by topic), deterministic and disjoint from gold
    ids_sorted = [c.chunk_id for c in chunks]
    from mediquery_rag.models.cross_encoder import score_pairs
    queries = [q for _, q in heldout]
    golds = [by_id[cid].content for cid, _ in heldout]
    negs = [by_id[ids_sorted[(ids_sorted.index(cid) + len(chunks) // 2)
                             % len(chunks)]].content
            for cid, _ in heldout]
    pos_logits = score_pairs(grader.params, cfg, queries, golds)
    neg_logits = score_pairs(grader.params, cfg, queries, negs)

    thr = grader.threshold
    tpr = float((pos_logits > thr).mean())
    tnr = float((neg_logits <= thr).mean())
    acc = 0.5 * (tpr + tnr)
    # threshold-free AUC (probability a random positive outscores a random
    # negative)
    auc = float((pos_logits[:, None] > neg_logits[None, :]).mean())
    report = {
        "heldout_grading_cross_encoder": {
            "accuracy": acc, "tpr": tpr, "tnr": tnr,
            "auc": auc, "threshold": thr},
        "n_heldout": len(heldout), "epochs": args.epochs,
        "layers": args.layers, "hidden": args.hidden,
    }

    if args.embedder:
        # the CLI-default bi-encoder grade (SimilarityGrader): max cosine of
        # doc vs query through a trained embedder, threshold 0.3
        from mediquery_rag.models import TextEmbedder
        from mediquery_rag.models.cross_encoder import SimilarityGrader
        te = TextEmbedder.from_checkpoint(args.embedder)
        sg = SimilarityGrader(te.embed)

        def sims(ds):
            embs = np.asarray(te.embed(queries + ds))
            q, d = embs[: len(queries)], embs[len(queries):]
            return (q * d).sum(axis=1)

        pos_s, neg_s = sims(golds), sims(negs)
        report["heldout_grading_bi_encoder"] = {
            "accuracy": 0.5 * (float((pos_s > sg.threshold).mean())
                               + float((neg_s <= sg.threshold).mean())),
            "tpr": float((pos_s > sg.threshold).mean()),
            "tnr": float((neg_s <= sg.threshold).mean()),
            "auc": float((pos_s[:, None] > neg_s[None, :]).mean()),
            "threshold": sg.threshold,
        }

        # the SHIPPING config: hybrid lexical+trained embedder at thr=0.2
        # (cli/context.py wires exactly this when a checkpoint exists)
        from mediquery_rag.models import HybridEmbedder
        hy = HybridEmbedder.from_checkpoint(args.embedder)

        def hsims(ds):
            embs = np.asarray(hy(queries + ds))
            q, d = embs[: len(queries)], embs[len(queries):]
            return (q * d).sum(axis=1)

        hp, hn = hsims(golds), hsims(negs)
        thr_h = 0.2
        report["heldout_grading_hybrid"] = {
            "accuracy": 0.5 * (float((hp > thr_h).mean())
                               + float((hn <= thr_h).mean())),
            "tpr": float((hp > thr_h).mean()),
            "tnr": float((hn <= thr_h).mean()),
            "auc": float((hp[:, None] > hn[None, :]).mean()),
            "threshold": thr_h,
        }
    print(json.dumps(report, indent=2))


if __name__ == "__main__":
    main()
