"""LoRA adapter tests: zero-init identity, frozen base, training effect,
merge-for-serving, persistence, and TP shardings on the virtual mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mediquery_rag.config import DecoderConfig, LoraConfig, TrainConfig
from mediquery_rag.models.byte_tokenizer import ByteTokenizer
from mediquery_rag.models.decoder import Decoder
from mediquery_rag.models.lora import (
    LoraTrainer, load_adapters, lora_init, lora_merge, lora_partition_specs,
    save_adapters,
)
from mediquery_rag.models.train_lm import LMLoader

DCFG = DecoderConfig(vocab_size=384, hidden=64, layers=2, heads=4,
                     kv_heads=2, mlp_dim=128, max_len=256, dtype="float32")
LCFG = LoraConfig(rank=4, alpha=8.0)


@pytest.fixture(scope="module")
def base():
    model = Decoder(DCFG)
    return model, model.init(jax.random.PRNGKey(0))


def _batch(n=8):
    texts = [f"问题{i}：血压高。答案{i}：少盐多动。" for i in range(n)]
    return next(LMLoader(texts, ByteTokenizer(256), n).batches(epochs=1))


def test_zero_init_is_identity(base):
    """b starts at zero, so merge(params, fresh adapters) == params."""
    model, params = base
    adapters = lora_init(jax.random.PRNGKey(1), params, LCFG)
    merged = lora_merge(params, adapters, LCFG)
    batch = _batch(4)
    l0 = model.apply(params, batch.ids, batch.mask)
    l1 = model.apply(merged, batch.ids, batch.mask)
    np.testing.assert_allclose(np.asarray(l0), np.asarray(l1), atol=1e-6)


def test_training_moves_loss_not_base(base):
    model, params = base
    trainer = LoraTrainer(DCFG, LCFG, TrainConfig(lr=3e-3, warmup_steps=2,
                                                  remat=False))
    state = trainer.init_state(jax.random.PRNGKey(2), params)
    batch = _batch(8)
    before = jax.tree_util.tree_map(lambda x: np.asarray(x).copy(), params)
    losses = []
    for _ in range(12):
        state, metrics = trainer.train_step(state, params, batch)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] * 0.9, losses
    assert float(metrics["delta_norm"]) > 0.0
    # the base never moves: only adapters carry gradients
    for (p, a), (_, b) in zip(
            jax.tree_util.tree_leaves_with_path(params),
            jax.tree_util.tree_leaves_with_path(before)):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_merged_generator_serves(base):
    from mediquery_rag.models import Generator
    model, params = base
    adapters = lora_init(jax.random.PRNGKey(3), params, LCFG)
    # give b some mass so the merge actually changes the weights
    adapters = jax.tree_util.tree_map(
        lambda x: x + 0.01 if x.ndim == 3 else x, adapters)
    merged = lora_merge(params, adapters, LCFG)
    gen = Generator(DCFG, params=merged)
    out = gen.generate(["血压"], max_new_tokens=4)
    assert len(out) == 1 and isinstance(out[0], str)


def test_quantized_base_rejected(base):
    from mediquery_rag.models import Generator
    model, params = base
    gen = Generator(DCFG, params=jax.tree_util.tree_map(lambda x: x, params))
    gen.params = {**gen.params, "blocks": dict(gen.params["blocks"])}
    gen.quantize_weights(bits=8)
    with pytest.raises(ValueError, match="quantized"):
        lora_init(jax.random.PRNGKey(4), gen.params, LCFG)


def test_save_load_roundtrip(base, tmp_path):
    _, params = base
    adapters = lora_init(jax.random.PRNGKey(5), params, LCFG)
    save_adapters(str(tmp_path / "ad"), adapters, LCFG)
    loaded, cfg = load_adapters(str(tmp_path / "ad"))
    assert cfg == LCFG
    for t in LCFG.targets:
        np.testing.assert_array_equal(np.asarray(adapters[t]["a"]),
                                      np.asarray(loaded[t]["a"]))


def test_tp_specs_and_mesh_step(base):
    """Adapter shardings follow the base Megatron layout and one DP x TP
    train step runs on the 8-device virtual mesh."""
    from jax.sharding import PartitionSpec as P
    from mediquery_rag.parallel import make_mesh

    model, params = base
    specs = lora_partition_specs(model, LCFG)
    assert specs["qkv"]["b"] == P(None, None, "model")      # column parallel
    assert specs["attn_out"]["a"] == P(None, "model", None)  # row parallel
    assert specs["qkv"]["a"] == P(None, None, None)

    mesh = make_mesh({"data": 4, "model": 2})
    trainer = LoraTrainer(DCFG, LCFG, TrainConfig(warmup_steps=1), mesh=mesh)
    from jax.sharding import NamedSharding
    sharded = jax.tree_util.tree_map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)),
        params, model.partition_specs())
    state = trainer.init_state(jax.random.PRNGKey(6), sharded)
    state, metrics = trainer.train_step(state, sharded, _batch(8))
    assert jnp.isfinite(metrics["loss"])
