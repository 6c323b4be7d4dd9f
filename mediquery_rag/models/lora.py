"""LoRA fine-tuning for the on-device decoder (low-rank adaptation).

Why this exists: the reference rented a frozen chat model (qwen2.5:7b over
Ollama, reference medical_engine.py:46) and could never adapt it; this
framework imports pretrained checkpoints (models/hf_import.py) and needs
cheap domain adaptation to its JSON contracts (triage / follow-up /
extraction prompts, graph/prompts.py) without retraining — or even
storing optimizer state for — billions of base weights. LoRA trains
rank-r deltas for the big projection matrices only: grads + AdamW moments
shrink from O(P) to O(L*r*(in+out)), and the tuned adapter merges back
into the base at export time, so the serving path (bf16 cast, int8/int4
weight-only quantization, speculative lanes, KV quant) is untouched and
pays ZERO inference overhead.

accelerator-first shape: the decoder's blocks are stacked ``[L, in, out]`` pytrees
executed with ``lax.scan`` (models/decoder.py), so adapters mirror that
stacking — ``a: [L, in, r]``, ``b: [L, r, out]`` — and the merge is ONE
batched einsum per target; the merged forward is the exact scanned program
the base model compiles. Training materializes ``W + (alpha/r) a@b``
inside the step jit with ``stop_gradient`` on the base: XLA fuses the
add into the forward, autodiff routes grads to (a, b) only, and the only
extra HBM is one transient copy of the targeted weights (fine at the
ranks/model sizes adapters are for).
"""

from __future__ import annotations

import json
import os
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from mediquery_rag.config import DecoderConfig, LoraConfig, TrainConfig
from mediquery_rag.models.decoder import Decoder, _is_quant
from mediquery_rag.models.train_lm import LMBatch, lm_loss

Adapters = dict  # {target: {"a": [L, in, r], "b": [L, r, out]}}


def lora_init(key: jax.Array, params: dict, cfg: LoraConfig) -> Adapters:
    """Fresh adapters for ``params``: ``a`` gaussian (fan-in scaled), ``b``
    zero — so the merged model starts EXACTLY at the base (delta == 0)."""
    adapters: Adapters = {}
    for i, t in enumerate(cfg.targets):
        if t not in params["blocks"]:
            raise ValueError(f"unknown LoRA target {t!r}; blocks have "
                             f"{sorted(params['blocks'])}")
        w = params["blocks"][t]
        if _is_quant(w):
            raise ValueError(
                f"target {t!r} is weight-quantized; LoRA trains against "
                "FLOAT base params (load the float checkpoint, merge, then "
                "quantize for serving)")
        layers, fan_in, out = w.shape
        k = jax.random.fold_in(key, i)
        adapters[t] = {
            "a": jax.random.normal(k, (layers, fan_in, cfg.rank), jnp.float32)
            * (fan_in ** -0.5),
            "b": jnp.zeros((layers, cfg.rank, out), jnp.float32),
        }
    return adapters


def lora_delta(ab: dict, scale: float) -> jax.Array:
    """``(alpha/r) a@b`` as one batched-over-layers einsum, f32."""
    return jnp.einsum("lir,lro->lio", ab["a"].astype(jnp.float32),
                      ab["b"].astype(jnp.float32),
                      preferred_element_type=jnp.float32) * scale


def lora_merge(params: dict, adapters: Adapters, cfg: LoraConfig) -> dict:
    """Base params with adapters folded in: ``W' = W + (alpha/r) a@b``.
    Pure — returns a new tree sharing every untouched leaf."""
    scale = cfg.alpha / cfg.rank
    blocks = dict(params["blocks"])
    for t, ab in adapters.items():
        w = blocks[t]
        if _is_quant(w):
            raise ValueError(f"cannot merge into quantized target {t!r}")
        blocks[t] = (w.astype(jnp.float32) + lora_delta(ab, scale)).astype(
            w.dtype)
    return {**params, "blocks": blocks}


def lora_partition_specs(model: Decoder, cfg: LoraConfig) -> Adapters:
    """Adapter shardings derived from the base Megatron specs: ``a`` follows
    the target's IN-dim sharding (row-parallel targets shard a's fan-in),
    ``b`` its OUT-dim sharding (column-parallel targets shard b's fan-out);
    the tiny rank axis is always replicated."""
    base = model.partition_specs()["blocks"]
    specs: Adapters = {}
    for t in cfg.targets:
        _, in_ax, out_ax = base[t]
        specs[t] = {"a": P(None, in_ax, None), "b": P(None, None, out_ax)}
    return specs


# -- training ------------------------------------------------------------------


class LoraTrainState(NamedTuple):
    adapters: Adapters
    opt_state: optax.OptState
    step: jax.Array


class LoraTrainer:
    """``LMTrainer``'s loop shape with the base FROZEN: optimizer state
    exists only for the adapters; base params ride through the step jit as
    an explicit argument (never a closure — a closed-over 7B tree would be
    baked into the compiled program as a constant)."""

    def __init__(self, model_cfg: DecoderConfig = DecoderConfig(),
                 lora_cfg: LoraConfig = LoraConfig(),
                 train_cfg: TrainConfig = TrainConfig(),
                 mesh: Mesh | None = None):
        self.model = Decoder(model_cfg)
        self.lora = lora_cfg
        self.cfg = train_cfg
        self.mesh = mesh
        # no weight decay: decaying a/b pulls the delta toward zero at a
        # rate that depends on the a/b factor split, not the delta itself
        self.tx = optax.chain(
            optax.clip_by_global_norm(1.0),
            optax.adam(optax.warmup_cosine_decay_schedule(
                0.0, train_cfg.lr, train_cfg.warmup_steps,
                train_cfg.decay_steps)),
        )
        self._jit_step = None

    def init_state(self, key: jax.Array, base_params: dict) -> LoraTrainState:
        adapters = lora_init(key, base_params, self.lora)
        if self.mesh is not None:
            specs = lora_partition_specs(self.model, self.lora)
            adapters = jax.tree_util.tree_map(
                lambda x, s: jax.device_put(x, NamedSharding(self.mesh, s)),
                adapters, specs)
        return LoraTrainState(adapters, self.tx.init(adapters), jnp.int32(0))

    def train_step(self, state: LoraTrainState, base_params: dict,
                   batch: LMBatch):
        if self._jit_step is None:
            scale = self.lora.alpha / self.lora.rank

            def loss_fn(adapters, base, batch):
                merged = lora_merge(jax.lax.stop_gradient(base), adapters,
                                    self.lora)
                logits = self.model.apply(merged, batch.ids, batch.mask,
                                          remat=self.cfg.remat)
                return lm_loss(logits, batch.ids, batch.mask)

            def step(state, base, batch):
                loss, grads = jax.value_and_grad(loss_fn)(
                    state.adapters, base, batch)
                updates, opt_state = self.tx.update(
                    grads, state.opt_state, state.adapters)
                adapters = optax.apply_updates(state.adapters, updates)
                # delta magnitude is the honest progress meter for LoRA
                # (loss alone can't separate base quality from adaptation)
                dnorm = optax.global_norm(
                    [lora_delta(ab, scale) for ab in adapters.values()])
                return (LoraTrainState(adapters, opt_state, state.step + 1),
                        {"loss": loss,
                         "grad_norm": optax.global_norm(grads),
                         "delta_norm": dnorm})

            if self.mesh is not None:
                bsh = NamedSharding(self.mesh, P("data", None))
                self._jit_step = jax.jit(
                    step, in_shardings=(None, None, LMBatch(bsh, bsh)))
            else:
                self._jit_step = jax.jit(step)
        return self._jit_step(state, base_params, batch)


# -- persistence -----------------------------------------------------------------


def save_adapters(path: str, adapters: Adapters, cfg: LoraConfig) -> None:
    """Adapters + config as one .npz + meta.json (tiny — host-side file)."""
    os.makedirs(path, exist_ok=True)
    flat = {}
    for t, ab in adapters.items():
        flat[f"{t}.a"] = np.asarray(ab["a"])
        flat[f"{t}.b"] = np.asarray(ab["b"])
    np.savez(os.path.join(path, "adapters.npz"), **flat)
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump({"rank": cfg.rank, "alpha": cfg.alpha,
                   "targets": list(cfg.targets)}, f)


def load_adapters(path: str) -> tuple[Adapters, LoraConfig]:
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    cfg = LoraConfig(rank=meta["rank"], alpha=meta["alpha"],
                     targets=tuple(meta["targets"]))
    z = np.load(os.path.join(path, "adapters.npz"))
    adapters: Adapters = {}
    for t in cfg.targets:
        adapters[t] = {"a": jnp.asarray(z[f"{t}.a"]),
                       "b": jnp.asarray(z[f"{t}.b"])}
    return adapters, cfg


def main() -> None:
    """``python -m mediquery_rag.models.lora`` — fine-tune a saved
    decoder checkpoint on corpus chat samples, save adapters + the merged
    model (same loop shape as models/train_lm.py's CLI)."""
    import argparse
    import time

    ap = argparse.ArgumentParser()
    ap.add_argument("--base", required=True,
                    help="Generator checkpoint dir (models/generate.py save)")
    ap.add_argument("--corpus", default="data/medical_data.txt")
    ap.add_argument("--out", default="checkpoints/lora")
    ap.add_argument("--merged-out", default="",
                    help="also save the merged model here")
    ap.add_argument("--rank", type=int, default=8)
    ap.add_argument("--alpha", type=float, default=16.0)
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    from mediquery_rag.ingest import parse_corpus_file
    from mediquery_rag.models.generate import Generator
    from mediquery_rag.models.train_lm import LMLoader, corpus_lm_texts
    from mediquery_rag.parallel import make_mesh

    gen = Generator.from_checkpoint(args.base)
    mesh = None
    if args.dp * args.tp > 1:
        mesh = make_mesh({"data": args.dp, "model": args.tp})
        specs = gen.model.partition_specs()
        gen.params = jax.tree_util.tree_map(
            lambda x, s: jax.device_put(x, NamedSharding(mesh, s)),
            gen.params, specs)

    lcfg = LoraConfig(rank=args.rank, alpha=args.alpha)
    texts = corpus_lm_texts(parse_corpus_file(args.corpus))
    loader = LMLoader(texts, gen.tokenizer, args.batch_size, seed=args.seed)
    trainer = LoraTrainer(gen.cfg, lcfg,
                          TrainConfig(batch_size=args.batch_size, lr=args.lr,
                                      warmup_steps=20), mesh=mesh)
    state = trainer.init_state(jax.random.PRNGKey(args.seed), gen.params)

    step, t0 = 0, time.time()
    for batch in loader.batches(epochs=args.epochs):
        state, metrics = trainer.train_step(state, gen.params, batch)
        step += 1
        if step % 10 == 0 or step == 1:
            print(f"step {step}: loss {float(metrics['loss']):.4f} "
                  f"delta {float(metrics['delta_norm']):.3f} "
                  f"({time.time() - t0:.1f}s)")

    adapters = jax.device_get(state.adapters)
    save_adapters(args.out, adapters, lcfg)
    print(f"saved adapters -> {args.out}")
    if args.merged_out:
        merged = Generator(gen.cfg,
                           params=jax.device_get(
                               lora_merge(gen.params, adapters, lcfg)),
                           tokenizer=gen.tokenizer)
        merged.save(args.merged_out)
        print(f"saved merged model -> {args.merged_out}")


if __name__ == "__main__":
    main()
