"""Contrastive trainer: sharded InfoNCE fine-tuning of the embedder.

The reference consumed a frozen third-party embedding model; a standalone
framework must be able to *train* its retriever. In-batch-negative InfoNCE
over (query, doc) pairs is the standard recipe for dense retrievers.

Parallelism (SURVEY §2c mapping):
- DP: batch sharded over the ``data`` mesh axis;
- TP: Megatron column/row layout from ``Embedder.partition_specs`` over the
  ``model`` axis — XLA/GSPMD inserts the psums;
- the in-batch similarity matrix ``q @ d.T`` is computed on globally-gathered
  embeddings (they are tiny: [B, 768]), so the contrastive loss sees all
  negatives regardless of the data sharding;
- remat (jax.checkpoint) per transformer block trades FLOPs for HBM.

PP/EP are N/A for this model family (documented in SURVEY §2c); SP is
unnecessary at 512-token sequences but the ``data`` axis can be repurposed
for sequence sharding if long-context embedders land later.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from mediquery_rag.config import EmbedderConfig, TrainConfig
from mediquery_rag.models.embedder import Embedder


class TrainState(NamedTuple):
    params: dict
    opt_state: optax.OptState
    step: jax.Array


class Batch(NamedTuple):
    q_ids: jax.Array    # [B, S]
    q_mask: jax.Array
    d_ids: jax.Array    # [B, S]
    d_mask: jax.Array
    n_ids: jax.Array | None = None    # [B, S] mined hard negatives
    n_mask: jax.Array | None = None


def info_nce_loss(q_emb, d_emb, temperature, n_emb=None):
    """Bidirectional in-batch-negative InfoNCE. Embeddings L2-normalized.
    ``n_emb`` ([B, D] mined hard negatives) extends the q->d direction's
    candidate set to [d; n] — every negative is shared across the batch."""
    logits = jnp.dot(q_emb, d_emb.T, preferred_element_type=jnp.float32)
    labels = jnp.arange(logits.shape[0])
    l_dq = optax.softmax_cross_entropy_with_integer_labels(
        logits.T / temperature, labels).mean()
    if n_emb is not None:
        neg = jnp.dot(q_emb, n_emb.T, preferred_element_type=jnp.float32)
        logits = jnp.concatenate([logits, neg], axis=1)
    l_qd = optax.softmax_cross_entropy_with_integer_labels(
        logits / temperature, labels).mean()
    return 0.5 * (l_qd + l_dq)


class ContrastiveTrainer:
    def __init__(
        self,
        model_cfg: EmbedderConfig = EmbedderConfig(),
        train_cfg: TrainConfig = TrainConfig(),
        mesh: Mesh | None = None,
    ):
        self.model = Embedder(model_cfg)
        self.cfg = train_cfg
        self.mesh = mesh
        self.tx = optax.chain(
            optax.clip_by_global_norm(1.0),
            optax.adamw(
                optax.warmup_cosine_decay_schedule(
                    0.0, train_cfg.lr, train_cfg.warmup_steps,
                    train_cfg.decay_steps
                ),
                weight_decay=train_cfg.weight_decay,
            ),
        )
        self._jit_step = None

    def init_state(self, key: jax.Array) -> TrainState:
        params = self.model.init(key)
        if self.mesh is not None:
            pspecs = self.model.partition_specs()
            params = jax.tree_util.tree_map(
                lambda x, s: jax.device_put(x, NamedSharding(self.mesh, s)),
                params, pspecs,
            )
        opt_state = self.tx.init(params)  # moments inherit param shardings
        return TrainState(params, opt_state, jnp.int32(0))

    # -- the step ------------------------------------------------------------

    def _loss_fn(self, params, batch: Batch, rng):
        # the two towers see different dropout masks (SimCSE-style views)
        # when cfg.dropout > 0; rng=None disables dropout entirely
        rq = rd = rn = None
        if rng is not None and self.model.cfg.dropout > 0.0:
            rq, rd, rn = jax.random.split(rng, 3)
        q = self.model.apply(params, batch.q_ids, batch.q_mask,
                             remat=self.cfg.remat, dropout_rng=rq)
        d = self.model.apply(params, batch.d_ids, batch.d_mask,
                             remat=self.cfg.remat, dropout_rng=rd)
        n = None
        if batch.n_ids is not None:
            n = self.model.apply(params, batch.n_ids, batch.n_mask,
                                 remat=self.cfg.remat, dropout_rng=rn)
        return info_nce_loss(q, d, self.cfg.temperature, n_emb=n)

    def train_step(self, state: TrainState, batch: Batch):
        """One update. Returns (new_state, metrics). Jitted + cached."""
        if self._jit_step is None:
            base_rng = jax.random.PRNGKey(42)

            def step(state, batch):
                rng = jax.random.fold_in(base_rng, state.step)
                loss, grads = jax.value_and_grad(self._loss_fn)(
                    state.params, batch, rng)
                updates, opt_state = self.tx.update(
                    grads, state.opt_state, state.params
                )
                params = optax.apply_updates(state.params, updates)
                gnorm = optax.global_norm(grads)
                return (
                    TrainState(params, opt_state, state.step + 1),
                    {"loss": loss, "grad_norm": gnorm},
                )

            if self.mesh is not None:
                sh = NamedSharding(self.mesh, P("data", None))
                has_neg = batch.n_ids is not None
                self._jit_step = jax.jit(
                    step,
                    in_shardings=(None, Batch(
                        sh, sh, sh, sh,
                        sh if has_neg else None,
                        sh if has_neg else None)),
                )
            else:
                self._jit_step = jax.jit(step)
        return self._jit_step(state, batch)
