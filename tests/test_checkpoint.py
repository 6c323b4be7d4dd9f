"""Orbax checkpoint tests: sharded index round-trip on the 8-dev mesh,
train-state round-trip."""

import jax
import jax.numpy as jnp
import numpy as np

from mediquery_rag.config import EmbedderConfig, EngineConfig, TrainConfig
from mediquery_rag.engine import ShardedFlatIndex
from mediquery_rag.engine.checkpoint import (
    load_sharded_index,
    load_train_state,
    save_sharded_index,
    save_train_state,
)
from mediquery_rag.models import HashCharTokenizer
from mediquery_rag.models.trainer import Batch, ContrastiveTrainer
from mediquery_rag.parallel import corpus_mesh

TINY = EmbedderConfig(vocab_size=512, hidden=64, layers=2, heads=4,
                      mlp_dim=128, max_len=128, dtype="float32")


def _vecs(n, d, seed=0):
    x = jax.random.normal(jax.random.PRNGKey(seed), (n, d))
    return x / jnp.linalg.norm(x, axis=-1, keepdims=True)


class TestShardedIndexCheckpoint:
    def test_roundtrip_preserves_search(self, tmp_path):
        mesh = corpus_mesh(8)
        cfg = EngineConfig(dim=64, dtype="float32", corpus_tile=256,
                           )
        c = _vecs(3000, 64)
        idx = ShardedFlatIndex.build(c, mesh, cfg)
        save_sharded_index(idx, str(tmp_path / "ck"))
        idx2 = load_sharded_index(str(tmp_path / "ck"), mesh)
        assert idx2.n == idx.n
        # restored array is actually sharded over the mesh
        assert len(idx2.corpus.sharding.device_set) == 8
        q = _vecs(4, 64, seed=1)
        _, i1 = idx.search(q, k=5)
        _, i2 = idx2.search(q, k=5)
        np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))

    def test_int8_roundtrip(self, tmp_path):
        mesh = corpus_mesh(8)
        cfg = EngineConfig(dim=64, dtype="int8", corpus_tile=256)
        idx = ShardedFlatIndex.build(_vecs(2000, 64, seed=2), mesh, cfg)
        save_sharded_index(idx, str(tmp_path / "ck8"))
        idx2 = load_sharded_index(str(tmp_path / "ck8"), mesh)
        assert idx2.corpus_scale is not None
        q = _vecs(3, 64, seed=3)
        _, i1 = idx.search(q, k=5)
        _, i2 = idx2.search(q, k=5)
        np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))

    def test_second_roundtrip(self, tmp_path):
        mesh = corpus_mesh(8)
        cfg = EngineConfig(dim=64, dtype="float32", corpus_tile=256,
                           )
        idx = ShardedFlatIndex.build(_vecs(1000, 64, seed=4), mesh, cfg)
        save_sharded_index(idx, str(tmp_path / "cka"))
        idx2 = load_sharded_index(str(tmp_path / "cka"), mesh)
        assert idx2.n == 1000


class TestTrainStateCheckpoint:
    def test_resume_training(self, tmp_path):
        tok = HashCharTokenizer(TINY.vocab_size, TINY.max_len)
        tr = ContrastiveTrainer(TINY, TrainConfig(remat=False, warmup_steps=1))
        state = tr.init_state(jax.random.PRNGKey(0))
        q_ids, q_mask = tok.batch_encode([f"q{i}" for i in range(8)])
        d_ids, d_mask = tok.batch_encode([f"d{i}" for i in range(8)])
        batch = Batch(jnp.asarray(q_ids), jnp.asarray(q_mask),
                      jnp.asarray(d_ids), jnp.asarray(d_mask))
        state, _ = tr.train_step(state, batch)
        save_train_state(state, str(tmp_path / "ts"))
        restored = load_train_state(str(tmp_path / "ts"), state)
        assert int(restored.step) == 1
        np.testing.assert_allclose(
            np.asarray(jax.tree_util.tree_leaves(restored.params)[0]),
            np.asarray(jax.tree_util.tree_leaves(state.params)[0]))
        # training continues from the restored state
        state2, m = tr.train_step(restored, batch)
        assert int(state2.step) == 2


class TestShardedIVFCheckpoint:
    def test_roundtrip(self, tmp_path):
        import jax
        import jax.numpy as jnp
        import numpy as np
        from mediquery_rag.config import EngineConfig
        from mediquery_rag.engine.checkpoint import (
            load_sharded_ivf, save_sharded_ivf)
        from mediquery_rag.engine.sharded_ivf import ShardedIVFIndex
        from mediquery_rag.parallel import corpus_mesh

        mesh = corpus_mesh(8)
        c = jax.random.normal(jax.random.PRNGKey(170), (2000, 64))
        c = c / jnp.linalg.norm(c, axis=-1, keepdims=True)
        cfg = EngineConfig(dim=64, dtype="int8", ivf_nlist=16,
                           ivf_kmeans_iters=3)
        idx = ShardedIVFIndex.build(c, mesh, cfg)
        save_sharded_ivf(idx, str(tmp_path / "sivf"))
        idx2 = load_sharded_ivf(str(tmp_path / "sivf"), mesh)
        assert idx2.bucket_scales is not None
        q = jax.random.normal(jax.random.PRNGKey(171), (5, 64))
        s1, i1 = idx.search(q, k=5, nprobe=8)
        s2, i2 = idx2.search(q, k=5, nprobe=8)
        np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))
        np.testing.assert_allclose(np.asarray(s1), np.asarray(s2),
                                   rtol=1e-5, atol=1e-5)


class TestInt4Checkpoints:
    def test_sharded_flat_int4_roundtrip(self, tmp_path):
        mesh = corpus_mesh(8)
        cfg = EngineConfig(dim=64, dtype="int4", corpus_tile=256,
                           )
        idx = ShardedFlatIndex.build(_vecs(2000, 64, seed=4), mesh, cfg)
        assert idx.corpus_scale.shape[0] == 2     # (even, odd) scale planes
        save_sharded_index(idx, str(tmp_path / "ck4"))
        idx2 = load_sharded_index(str(tmp_path / "ck4"), mesh)
        assert idx2.corpus.shape == idx.corpus.shape
        q = _vecs(3, 64, seed=5)
        s1, i1 = idx.search(q, k=5)
        s2, i2 = idx2.search(q, k=5)
        np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))
        np.testing.assert_allclose(np.asarray(s1), np.asarray(s2),
                                   rtol=1e-6)

    def test_sharded_ivf_int4_roundtrip(self, tmp_path):
        import jax
        import jax.numpy as jnp
        from mediquery_rag.engine.checkpoint import (
            load_sharded_ivf, save_sharded_ivf)
        from mediquery_rag.engine.sharded_ivf import ShardedIVFIndex

        mesh = corpus_mesh(8)
        c = jax.random.normal(jax.random.PRNGKey(180), (2000, 64))
        c = c / jnp.linalg.norm(c, axis=-1, keepdims=True)
        cfg = EngineConfig(dim=64, dtype="int4", ivf_nlist=16,
                           ivf_kmeans_iters=3)
        idx = ShardedIVFIndex.build(c, mesh, cfg)
        save_sharded_ivf(idx, str(tmp_path / "sivf4"))
        idx2 = load_sharded_ivf(str(tmp_path / "sivf4"), mesh)
        # packed byte-rows: cap/2 physical rows per bucket survive the trip
        assert idx2.buckets.shape == idx.buckets.shape
        assert idx2.bucket_ids.shape == idx.bucket_ids.shape
        q = jax.random.normal(jax.random.PRNGKey(181), (5, 64))
        s1, i1 = idx.search(q, k=5, nprobe=8)
        s2, i2 = idx2.search(q, k=5, nprobe=8)
        np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))
        np.testing.assert_allclose(np.asarray(s1), np.asarray(s2),
                                   rtol=1e-5, atol=1e-5)
