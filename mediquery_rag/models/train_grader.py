"""Train the cross-encoder grader: ``python -m mediquery_rag.models.train_grader``.

Fine-tunes the joint (query, doc) relevance scorer on the corpus's
(title, content) pairs and saves a TrainedGrader checkpoint that the CLI
auto-loads (checkpoints/grader) to replace the per-loop LLM document
grading with one device forward pass.
"""

from __future__ import annotations

import argparse


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--corpus", default="data/medical_data.txt")
    ap.add_argument("--out", default="checkpoints/grader")
    ap.add_argument("--epochs", type=int, default=40)
    ap.add_argument("--batch-size", type=int, default=6)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--hidden", type=int, default=128)
    args = ap.parse_args()

    from mediquery_rag.config import EmbedderConfig
    from mediquery_rag.ingest import parse_corpus_file
    from mediquery_rag.models.cross_encoder import (
        TrainedGrader, train_cross_encoder)

    cfg = EmbedderConfig(vocab_size=2048, hidden=args.hidden,
                         layers=args.layers, heads=4,
                         mlp_dim=2 * args.hidden, max_len=192,
                         dtype="bfloat16")
    chunks = parse_corpus_file(args.corpus)
    pairs = [(c.title, c.content) for c in chunks]
    print(f"training grader on {len(pairs)} pairs...")
    params, _, loss = train_cross_encoder(
        pairs, cfg, epochs=args.epochs, batch_size=args.batch_size,
        lr=args.lr)
    print(f"final loss {loss:.4f}")
    TrainedGrader(params, cfg).save(args.out)
    print(f"saved grader -> {args.out}")


if __name__ == "__main__":
    main()
