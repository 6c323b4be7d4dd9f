"""Draft distillation for speculative decoding.

Speculative decoding's speedup is set by the ACCEPTANCE RATE — how often
the draft's greedy proposals match the target's (models/speculative.py).
A randomly-initialized draft accepts ~1/vocab; the fix is sequence-level
knowledge distillation: the target greedy-generates continuations for a
prompt distribution, and the draft trains next-token cross-entropy on
exactly those sequences. Greedy agreement is the literal training
objective's argmax — the tightest proxy for acceptance.

Distillation happens at the TOKEN level (Generator.generate_tokens), not
on decoded text: acceptance compares raw token ids, and re-encoding
decoded strings loses the stream — BPE re-tokenization drifts at merge
boundaries, and byte-level decode drops ids outside the byte range — so
a text-distilled draft can reproduce the STRING perfectly yet still be
rejected token-by-token.

This is the standard draft-training recipe (used for real 7B+0.5B pairs);
with in-repo toy targets it demonstrably lifts acceptance well above the
random floor (tests/test_speculative.py::TestDistill), and the same
function distills a draft for an HF-imported target unchanged.

Reference seam: accelerates the chat completions the reference rented
from Ollama (medical_engine.py:46), which had no speculative/draft path.
"""

from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from mediquery_rag.config import DecoderConfig, TrainConfig
from mediquery_rag.models.generate import Generator, _round_up
from mediquery_rag.models.train_lm import (LMBatch, LMTrainer,
                                               LMTrainState)


def distill_draft(
    target: Generator,
    draft_cfg: DecoderConfig,
    prompts: Sequence[str],
    *,
    max_new_tokens: int = 64,
    epochs: int = 30,
    train_cfg: TrainConfig | None = None,
    seed: int = 0,
    mesh=None,
    init_params=None,
    extra_texts: Sequence[str] | None = None,
) -> Generator:
    """Train a ``draft_cfg`` model to imitate ``target``'s greedy
    continuations of ``prompts``. Returns a ready ``Generator`` sharing
    the target's tokenizer (same vocab — required by
    SpeculativeGenerator).

    ``init_params`` warm-starts the draft (e.g. from a corpus LM
    pretrain): a target that regurgitates memorized corpus text is only
    predictable to a draft that has ALSO seen that text — the production
    recipe (both models pretrained on the same distribution, then the
    draft distilled on the target's traffic). ``extra_texts`` are
    rehearsal sequences mixed into the distillation batch (e.g. the
    pretraining corpus): distilling on continuations alone catastrophically
    overwrites the warm-start's memory of text absent from the batch."""
    if draft_cfg.vocab_size != target.cfg.vocab_size:
        raise ValueError("draft vocab must match the target's")

    tok = target.tokenizer
    # chunk the teacher generation: one batch over ALL prompts buckets to
    # a 512-lane KV cache (~17 GB at 1B-class dims) and OOMs the chip
    prompts = list(prompts)
    gen_rows = []
    for i0 in range(0, len(prompts), 64):
        gen_rows += target.generate_tokens(prompts[i0:i0 + 64],
                                           max_new_tokens=max_new_tokens)
    seqs = [tok.encode(p) + row for p, row in zip(prompts, gen_rows)]
    for t in extra_texts or ():
        seqs.append(tok.encode(t))

    # right-padded token batch (the LMLoader text path would re-tokenize
    # and lose the raw stream — see module docstring)
    S = _round_up(max(len(s) for s in seqs), 128)
    ids = np.full((len(seqs), S), int(tok.pad_id), np.int32)
    mask = np.zeros((len(seqs), S), np.float32)
    for r, s in enumerate(seqs):
        s = s[:S]
        ids[r, : len(s)] = s
        mask[r, : len(s)] = 1.0

    tcfg = train_cfg or TrainConfig(lr=3e-3, warmup_steps=20, remat=False)
    trainer = LMTrainer(draft_cfg, tcfg, mesh=mesh)
    state = trainer.init_state(jax.random.PRNGKey(seed))
    if init_params is not None:
        state = LMTrainState(init_params, trainer.tx.init(init_params),
                             state.step)
    metrics = {"loss": jnp.inf}
    # minibatched epochs: one batch of everything OOMs once rehearsal texts
    # grow the set (596 seqs x S=768 materialized a 22 GB attention block);
    # short-batch tails are padded with wrap-around rows so every step
    # reuses ONE compiled shape
    bs = min(max(tcfg.batch_size, 1), len(seqs), 64)
    shuf = np.random.default_rng(seed)
    for _ in range(epochs):
        order = shuf.permutation(len(seqs))
        for i0 in range(0, len(order), bs):
            sel = order[i0:i0 + bs]
            if len(sel) < bs:
                sel = np.concatenate([sel, order[: bs - len(sel)]])
            batch = LMBatch(jnp.asarray(ids[sel]), jnp.asarray(mask[sel]))
            state, metrics = trainer.train_step(state, batch)
    draft = Generator(draft_cfg, params=state.params, tokenizer=tok)
    draft.last_loss = float(metrics["loss"])
    return draft


# draft shape presets (dims as benchmarks/decode.py model zoo)
PRESETS = {
    "tiny": (64, 2, 4, None, 128),          # CPU smoke / tests
    "draft-20M": (256, 4, 4, None, 768),
    "draft-60M": (512, 8, 8, None, 1536),   # the classic 7B-pair draft size
}


def main() -> None:
    """``python -m mediquery_rag.models.distill`` — produce the draft
    checkpoint that ``LLMServer(draft=...)`` / ``serve --draft`` consumes.

    The saved draft restores via ``Generator.from_checkpoint`` with its
    DEFAULT tokenizer — harmless for serving, where only token ids flow
    and the draft's vocab (not its tokenizer) must match the target's.
    Prompt distribution defaults to the corpus question titles: the
    queries the app's chat traffic actually resembles."""
    import argparse
    import json
    import os

    ap = argparse.ArgumentParser()
    ap.add_argument("--target", required=True,
                    help="HF qwen2-class dir OR a Generator checkpoint dir")
    ap.add_argument("--out", default="checkpoints/draft")
    ap.add_argument("--preset", choices=sorted(PRESETS), default="draft-60M")
    ap.add_argument("--prompts-file", default=None,
                    help="one prompt per line (default: corpus titles)")
    ap.add_argument("--corpus", default="data/medical_data.txt")
    ap.add_argument("--max-new", type=int, default=64)
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend")
    args = ap.parse_args()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    with open(os.path.join(args.target, "config.json"),
              encoding="utf-8") as f:
        tcfg_raw = json.load(f)
    if "model_type" in tcfg_raw:        # HF checkpoint, not a Generator save
        from mediquery_rag.models.hf_import import load_qwen2_generator
        target = load_qwen2_generator(args.target)
    else:
        target = Generator.from_checkpoint(args.target)

    if args.prompts_file:
        with open(args.prompts_file, encoding="utf-8") as f:
            prompts = [ln.strip() for ln in f if ln.strip()]
    else:
        from mediquery_rag.ingest.parser import parse_corpus_file
        prompts = [c.title for c in parse_corpus_file(args.corpus)]
    if not prompts:
        raise SystemExit("no prompts to distill on")

    h, l_, heads, kvh, mlp = PRESETS[args.preset]
    dcfg = DecoderConfig(
        vocab_size=target.cfg.vocab_size, hidden=h, layers=l_, heads=heads,
        kv_heads=kvh, mlp_dim=mlp, max_len=target.cfg.max_len,
        dtype=target.cfg.dtype)
    draft = distill_draft(target, dcfg, prompts,
                          max_new_tokens=args.max_new, epochs=args.epochs)
    draft.save(args.out)
    print(json.dumps({"out": args.out, "preset": args.preset,
                      "last_loss": round(draft.last_loss, 4),
                      "prompts": len(prompts)}))


if __name__ == "__main__":
    main()
