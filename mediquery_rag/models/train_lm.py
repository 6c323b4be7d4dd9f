"""Causal-LM trainer + ``python -m mediquery_rag.models.train_lm``.

The reference consumed a frozen third-party chat model (qwen2.5:7b via
Ollama, medical_engine.py:46); a standalone framework must be able to train
its own. Next-token cross-entropy over chat-templated corpus text, sharded
DP (batch over ``data``) x TP (Megatron specs from ``Decoder
.partition_specs`` over ``model``), remat per block — the same parallelism
recipe as the embedder's ContrastiveTrainer (SURVEY §2c).
"""

from __future__ import annotations

import argparse
from typing import Iterator, NamedTuple, Sequence

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from mediquery_rag.config import DecoderConfig, TrainConfig
from mediquery_rag.models.byte_tokenizer import PAD_ID, ByteTokenizer
from mediquery_rag.models.decoder import Decoder


class LMBatch(NamedTuple):
    ids: jax.Array      # [B, S] i32, right-padded, BOS...EOS
    mask: jax.Array     # [B, S] f32


class LMTrainState(NamedTuple):
    params: dict
    opt_state: optax.OptState
    step: jax.Array


def lm_loss(logits, ids, mask):
    """Mean next-token CE. Only positions where both the input token and the
    target token are real contribute (boundary columns drop out)."""
    targets = ids[:, 1:]
    lmask = mask[:, :-1] * mask[:, 1:]
    ce = optax.softmax_cross_entropy_with_integer_labels(
        logits[:, :-1], targets)
    return (ce * lmask).sum() / jnp.maximum(lmask.sum(), 1.0)


class LMLoader:
    """Right-padded LM batches from raw texts (BOS + bytes + EOS), padded to
    128-column multiples so shapes bucket."""

    def __init__(self, texts: Sequence[str], tokenizer: ByteTokenizer,
                 batch_size: int, seed: int = 0):
        if not texts:
            raise ValueError("no training texts")
        self.tok = tokenizer
        self.texts = list(texts)
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)
        longest = max(len(tokenizer.encode(t, eos=True)) for t in self.texts)
        self.seq_len = min(-(-longest // 128) * 128, tokenizer.max_len)

    def _encode(self, batch_texts):
        ids = np.full((len(batch_texts), self.seq_len), PAD_ID, np.int32)
        mask = np.zeros((len(batch_texts), self.seq_len), np.float32)
        for r, t in enumerate(batch_texts):
            e = self.tok.encode(t, eos=True)[: self.seq_len]
            ids[r, : len(e)] = e
            mask[r, : len(e)] = 1.0
        return LMBatch(jnp.asarray(ids), jnp.asarray(mask))

    def batches(self, epochs: int) -> Iterator[LMBatch]:
        n, b = len(self.texts), self.batch_size
        for _ in range(epochs):
            order = self.rng.permutation(n)
            for i in range(0, n - b + 1, b):
                yield self._encode([self.texts[j] for j in order[i : i + b]])
            rem = n % b
            if rem:  # wrap the tail so every batch keeps the jitted shape
                tail = list(order[n - rem :]) + list(order[: b - rem])
                yield self._encode([self.texts[j] for j in tail])


def _scheduled_decay(schedule, rate: float) -> optax.GradientTransformation:
    """Decoupled weight decay, scaled by the lr schedule (AdamW semantics:
    ``p -= lr_t * rate * p``), applied AFTER the optimizer's update — so
    decay anneals with the schedule and is independent of the adaptive
    per-param scaling. No-op when ``rate == 0``."""
    if not rate:
        return optax.identity()

    def init(params):
        del params
        return optax.ScaleByScheduleState(count=jnp.zeros([], jnp.int32))

    def update(updates, state, params=None):
        if params is None:
            raise ValueError("scheduled decay requires params")
        lr = schedule(state.count)
        updates = jax.tree_util.tree_map(
            lambda u, p: u - lr * rate * p, updates, params)
        return updates, optax.ScaleByScheduleState(count=state.count + 1)

    return optax.GradientTransformation(init, update)


class LMTrainer:
    def __init__(self, model_cfg: DecoderConfig = DecoderConfig(),
                 train_cfg: TrainConfig = TrainConfig(),
                 mesh: Mesh | None = None):
        self.model = Decoder(model_cfg)
        self.cfg = train_cfg
        self.mesh = mesh
        sched = optax.warmup_cosine_decay_schedule(
            0.0, train_cfg.lr, train_cfg.warmup_steps,
            train_cfg.decay_steps)
        if train_cfg.optimizer == "adafactor":
            # factored second moment (row+col vectors instead of a full
            # per-param tensor) and no first moment: optimizer state drops
            # from 2x params (Adam m+v, ~8 GB at 1B f32) to ~per-row
            # factors — the difference between a 1B-class corpus train
            # OOMing on one 16 GB chip and fitting with room for serving
            # caches. Weight decay is NOT passed to adafactor: optax
            # applies weight_decay_rate per step un-scaled by the lr
            # schedule (~1/lr stronger than the adamw branch, and never
            # annealing). Instead chain a decoupled AdamW-style decay
            # scaled by the same schedule, so cfg.weight_decay means the
            # same thing for both optimizers.
            inner = optax.chain(
                optax.adafactor(learning_rate=sched,
                                min_dim_size_to_factor=32),
                _scheduled_decay(sched, train_cfg.weight_decay),
            )
        else:
            inner = optax.adamw(sched, weight_decay=train_cfg.weight_decay)
        self.tx = optax.chain(optax.clip_by_global_norm(1.0), inner)
        self._jit_step = None

    def init_state(self, key: jax.Array) -> LMTrainState:
        params = self.model.init(key)
        if self.mesh is not None:
            pspecs = self.model.partition_specs()
            params = jax.tree_util.tree_map(
                lambda x, s: jax.device_put(x, NamedSharding(self.mesh, s)),
                params, pspecs)
        return LMTrainState(params, self.tx.init(params), jnp.int32(0))

    def train_step(self, state: LMTrainState, batch: LMBatch):
        if self._jit_step is None:
            def loss_fn(params, batch):
                logits = self.model.apply(params, batch.ids, batch.mask,
                                          remat=self.cfg.remat)
                return lm_loss(logits, batch.ids, batch.mask)

            def step(state, batch):
                loss, grads = jax.value_and_grad(loss_fn)(state.params, batch)
                updates, opt_state = self.tx.update(
                    grads, state.opt_state, state.params)
                params = optax.apply_updates(state.params, updates)
                return (LMTrainState(params, opt_state, state.step + 1),
                        {"loss": loss, "grad_norm": optax.global_norm(grads)})

            # donate the state: params/opt-state update in place instead of
            # two full copies coexisting (~3.3 GB at 1B f32 — the margin
            # that lets the "names" remat policy fit the optimizer step on
            # one chip). Callers must drop the old state, which the train
            # loop's `state, _ = trainer.train_step(state, ...)` does.
            if self.mesh is not None:
                bsh = NamedSharding(self.mesh, P("data", None))
                self._jit_step = jax.jit(
                    step, in_shardings=(None, LMBatch(bsh, bsh)),
                    donate_argnums=0)
            else:
                self._jit_step = jax.jit(step, donate_argnums=0)
        return self._jit_step(state, batch)


def corpus_lm_texts(chunks) -> list[str]:
    """Chat-templated LM samples from parsed corpus chunks — the same
    template ``DeviceLLMClient`` renders at serving time, so train and serve
    distributions match."""
    from mediquery_rag.llm.device_client import render_chat
    from mediquery_rag.llm.messages import ai, user

    return [render_chat([user(c.title), ai(c.content)], for_training=True)
            for c in chunks]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--corpus", default="data/medical_data.txt")
    ap.add_argument("--out", default="checkpoints/lm")
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import time

    from mediquery_rag.ingest import parse_corpus_file
    from mediquery_rag.models.generate import Generator
    from mediquery_rag.parallel import make_mesh

    mcfg = DecoderConfig() if args.layers is None else DecoderConfig(
        layers=args.layers)
    mesh = None
    if args.dp * args.tp > 1:
        mesh = make_mesh({"data": args.dp, "model": args.tp})

    chunks = parse_corpus_file(args.corpus)
    texts = corpus_lm_texts(chunks)
    print(f"corpus: {len(chunks)} chunks -> {len(texts)} LM samples")

    tok = ByteTokenizer(mcfg.max_len)
    loader = LMLoader(texts, tok, args.batch_size, seed=args.seed)
    trainer = LMTrainer(mcfg, TrainConfig(batch_size=args.batch_size,
                                          lr=args.lr, warmup_steps=20),
                        mesh=mesh)
    state = trainer.init_state(jax.random.PRNGKey(args.seed))

    step, t0 = 0, time.time()
    for batch in loader.batches(epochs=args.epochs):
        state, metrics = trainer.train_step(state, batch)
        step += 1
        if step % 10 == 0 or step == 1:
            print(f"step {step}: loss {float(metrics['loss']):.4f} "
                  f"({time.time() - t0:.1f}s)")

    gen = Generator(mcfg, params=jax.device_get(state.params))
    gen.save(args.out)
    print(f"saved LM -> {args.out}")


if __name__ == "__main__":
    main()
