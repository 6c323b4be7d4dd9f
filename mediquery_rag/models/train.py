"""Train the embedder on a corpus: ``python -m mediquery_rag.models.train``.

End-to-end: parse corpus -> (title, content) pairs -> sharded InfoNCE
fine-tuning -> checkpoint params -> (optionally) rebuild the index with the
trained embedder. Runs single-chip by default; pass --dp/--tp to shard over
a mesh (virtual CPU devices work via XLA_FLAGS for testing).
"""

from __future__ import annotations

import argparse
import time


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--corpus", default="data/medical_data.txt")
    ap.add_argument("--out", default="checkpoints/embedder")
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--layers", type=int, default=None,
                    help="override encoder depth (small corpora train faster shallow)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import jax

    from mediquery_rag.config import EmbedderConfig, TrainConfig
    from mediquery_rag.ingest import parse_corpus_file
    from mediquery_rag.models import HashCharTokenizer, TextEmbedder
    from mediquery_rag.models.data import PairLoader, pairs_from_chunks
    from mediquery_rag.models.trainer import ContrastiveTrainer, TrainState
    from mediquery_rag.parallel import make_mesh

    mcfg = EmbedderConfig() if args.layers is None else EmbedderConfig(
        layers=args.layers)
    tcfg = TrainConfig(batch_size=args.batch_size, lr=args.lr,
                       warmup_steps=20)
    mesh = None
    if args.dp * args.tp > 1:
        mesh = make_mesh({"data": args.dp, "model": args.tp})

    chunks = parse_corpus_file(args.corpus)
    pairs = pairs_from_chunks(chunks)
    print(f"corpus: {len(chunks)} chunks -> {len(pairs)} training pairs")

    tok = HashCharTokenizer(mcfg.vocab_size, mcfg.max_len)
    loader = PairLoader(pairs, tok, args.batch_size, seed=args.seed)
    trainer = ContrastiveTrainer(mcfg, tcfg, mesh=mesh)
    state = trainer.init_state(jax.random.PRNGKey(args.seed))

    step = 0
    t0 = time.time()
    for batch in loader.batches(epochs=args.epochs):
        state, metrics = trainer.train_step(state, batch)
        step += 1
        if step % 10 == 0 or step == 1:
            print(f"step {step:5d}  loss {float(metrics['loss']):.4f}  "
                  f"gnorm {float(metrics['grad_norm']):.3f}  "
                  f"{time.time() - t0:.1f}s")

    te = TextEmbedder(mcfg, params=jax.device_get(state.params))
    te.save(args.out)
    print(f"saved params -> {args.out}")


if __name__ == "__main__":
    main()
