"""Engine-level tests: flat / sharded / IVF indexes vs brute-force oracle.

SURVEY §4 classes (3) recall parity vs brute force and (4) multi-chip on the
8-device virtual CPU mesh (same shard_map code as a real multi-GPU host).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mediquery_rag.config import EngineConfig
from mediquery_rag.engine import FlatIndex, IVFIndex, ShardedFlatIndex
from mediquery_rag.obs import recall_at_k
from mediquery_rag.ops import flat_search_xla
from mediquery_rag.parallel import corpus_mesh


def _vecs(n, d, seed=0):
    x = jax.random.normal(jax.random.PRNGKey(seed), (n, d))
    return x / jnp.linalg.norm(x, axis=-1, keepdims=True)


CFG = EngineConfig(dim=64, dtype="float32", corpus_tile=256)


class TestFlatIndex:
    def test_search_matches_oracle(self):
        c = _vecs(1000, 64)
        q = _vecs(7, 64, seed=1)
        idx = FlatIndex.build(c, CFG)
        s, i = idx.search(q, k=5)
        s_ref, i_ref = flat_search_xla(q, c, 5)
        np.testing.assert_array_equal(np.asarray(i), np.asarray(i_ref))
        np.testing.assert_allclose(np.asarray(s), np.asarray(s_ref), rtol=1e-5)

    def test_single_query_squeeze(self):
        idx = FlatIndex.build(_vecs(300, 64), CFG)
        s, i = idx.search(_vecs(1, 64, seed=2)[0], k=3)
        assert s.shape == (3,) and i.shape == (3,)

    def test_unnormalized_input_cosine(self):
        raw = jax.random.normal(jax.random.PRNGKey(3), (500, 64)) * 5.0
        idx = FlatIndex.build(raw, CFG)
        q = jax.random.normal(jax.random.PRNGKey(4), (4, 64)) * 0.1
        s, i = idx.search(q, k=5)
        cn = raw / jnp.linalg.norm(raw, axis=-1, keepdims=True)
        qn = q / jnp.linalg.norm(q, axis=-1, keepdims=True)
        _, i_ref = flat_search_xla(qn, cn, 5)
        np.testing.assert_array_equal(np.asarray(i), np.asarray(i_ref))

    def test_add(self):
        c = _vecs(300, 64)
        extra = _vecs(50, 64, seed=9)
        idx = FlatIndex.build(c, CFG).add(extra)
        assert idx.n == 350
        q = extra[:2]
        _, i = idx.search(q, k=1)
        np.testing.assert_array_equal(np.asarray(i[:, 0]), [300, 301])

    def test_search_stream_matches_search(self):
        """Pipelined two-stage stream == per-batch search, bit-identical —
        on the shipping int4+rerank config (both stages exercised) and on
        plain bf16 (trivial stage 2)."""
        import dataclasses

        c = _vecs(1200, 64)
        batches = [_vecs(5, 64, seed=10 + j) for j in range(4)]
        for cfg in (dataclasses.replace(CFG, dtype="int4", rerank_factor=4),
                    CFG):
            idx = FlatIndex.build(c, cfg)
            got = list(idx.search_stream(batches, k=5, depth=2))
            assert len(got) == len(batches)
            for qb, (s, i) in zip(batches, got):
                s_ref, i_ref = idx.search(qb, k=5)
                np.testing.assert_array_equal(np.asarray(i), np.asarray(i_ref))
                np.testing.assert_array_equal(np.asarray(s), np.asarray(s_ref))

    def test_search_stream_depth_one_and_single_batch(self):
        c = _vecs(400, 64)
        idx = FlatIndex.build(c, CFG)
        q = _vecs(3, 64, seed=21)
        (pair,) = idx.search_stream([q], k=4, depth=1)
        s_ref, i_ref = idx.search(q, k=4)
        np.testing.assert_array_equal(np.asarray(pair[1]), np.asarray(i_ref))

    def test_save_load_roundtrip(self, tmp_path):
        c = _vecs(200, 64)
        idx = FlatIndex.build(c, CFG)
        idx.save(str(tmp_path / "ix"))
        idx2 = FlatIndex.load(str(tmp_path / "ix"))
        assert idx2.n == idx.n
        q = _vecs(3, 64, seed=5)
        _, i1 = idx.search(q, k=4)
        _, i2 = idx2.search(q, k=4)
        np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))


class TestShardedFlatIndex:
    def test_matches_oracle_on_8dev_mesh(self):
        assert len(jax.devices()) == 8, "conftest must force 8 cpu devices"
        mesh = corpus_mesh(8)
        c = _vecs(5000, 64)
        q = _vecs(9, 64, seed=6)
        idx = ShardedFlatIndex.build(c, mesh, CFG)
        s, i = idx.search(q, k=10)
        s_ref, i_ref = flat_search_xla(q, c, 10)
        np.testing.assert_array_equal(np.asarray(i), np.asarray(i_ref))
        np.testing.assert_allclose(np.asarray(s), np.asarray(s_ref), rtol=1e-5)

    def test_int8_sharded_matches(self):
        mesh = corpus_mesh(8)
        cfg = EngineConfig(dim=64, dtype="int8", corpus_tile=256)
        c = _vecs(4000, 64, seed=20)
        idx = ShardedFlatIndex.build(c, mesh, cfg)
        assert idx.corpus_scale is not None
        q = _vecs(5, 64, seed=21)
        _, i = idx.search(q, k=10)
        _, i_ref = flat_search_xla(q, c, 10)
        assert recall_at_k(i, i_ref) >= 0.95

    def test_uneven_last_shard(self):
        """n not divisible by shards: trailing shards are partially padded."""
        mesh = corpus_mesh(8)
        c = _vecs(1000, 64, seed=7)  # 8 shards x 256-tile => pad to 2048
        idx = ShardedFlatIndex.build(c, mesh, CFG)
        q = _vecs(3, 64, seed=8)
        _, i = idx.search(q, k=5)
        assert (np.asarray(i) < 1000).all()
        _, i_ref = flat_search_xla(q, c, 5)
        np.testing.assert_array_equal(np.asarray(i), np.asarray(i_ref))


class TestHierarchicalDCNMesh:
    """Multi-slice layout: 8 virtual devices as 2 slices x 4 chips. The
    corpus shards over the (dcn, ici) product; the top-k merge all-gathers
    within the slice (ICI) and exchanges only the k finalists across slices
    (DCN) — parallel/collectives.py:hierarchical_topk_merge. Results must be
    IDENTICAL to the flat single-axis merge and the oracle."""

    def _mesh(self):
        from mediquery_rag.parallel import slice_mesh
        return slice_mesh(2, 4)

    def test_flat_f32_matches_oracle(self):
        cfg = EngineConfig(dim=64, dtype="float32", corpus_tile=256,
                           dcn_axis="dcn")
        c = _vecs(5000, 64)
        q = _vecs(9, 64, seed=6)
        idx = ShardedFlatIndex.build(c, self._mesh(), cfg)
        s, i = idx.search(q, k=10)
        s_ref, i_ref = flat_search_xla(q, c, 10)
        np.testing.assert_array_equal(np.asarray(i), np.asarray(i_ref))
        np.testing.assert_allclose(np.asarray(s), np.asarray(s_ref),
                                   rtol=1e-5)

    def test_flat_uneven_rows(self):
        """n not divisible by 8 shards: trailing shards partially padded —
        offsets/valid counts must use the row-major (dcn, ici) linear id."""
        cfg = EngineConfig(dim=64, dtype="float32", corpus_tile=256,
                           dcn_axis="dcn")
        c = _vecs(1000, 64, seed=7)
        idx = ShardedFlatIndex.build(c, self._mesh(), cfg)
        q = _vecs(3, 64, seed=8)
        _, i = idx.search(q, k=5)
        assert (np.asarray(i) < 1000).all()
        _, i_ref = flat_search_xla(q, c, 5)
        np.testing.assert_array_equal(np.asarray(i), np.asarray(i_ref))

    def test_int8_matches_single_axis_merge(self):
        c = _vecs(4000, 64, seed=20)
        q = _vecs(5, 64, seed=21)
        cfg1 = EngineConfig(dim=64, dtype="int8", corpus_tile=256,
                            )
        cfg2 = EngineConfig(dim=64, dtype="int8", corpus_tile=256,
                            dcn_axis="dcn")
        i1 = ShardedFlatIndex.build(c, corpus_mesh(8), cfg1).search(q, k=10)[1]
        i2 = ShardedFlatIndex.build(c, self._mesh(), cfg2).search(q, k=10)[1]
        np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))

    def test_int4_matches_single_axis_merge(self):
        c = _vecs(4096, 64, seed=22)
        q = _vecs(5, 64, seed=23)
        cfg1 = EngineConfig(dim=64, dtype="int4", corpus_tile=256,
                            )
        cfg2 = EngineConfig(dim=64, dtype="int4", corpus_tile=256,
                            dcn_axis="dcn")
        i1 = ShardedFlatIndex.build(c, corpus_mesh(8), cfg1).search(q, k=10)[1]
        i2 = ShardedFlatIndex.build(c, self._mesh(), cfg2).search(q, k=10)[1]
        np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))

    def test_ivf_matches_single_axis_merge(self):
        from mediquery_rag.engine import ShardedIVFIndex
        c = _vecs(2000, 64, seed=24)
        q = _vecs(6, 64, seed=25)
        cfg1 = EngineConfig(dim=64, dtype="int8", ivf_nlist=16,
                            ivf_kmeans_iters=2)
        cfg2 = EngineConfig(dim=64, dtype="int8", ivf_nlist=16,
                            ivf_kmeans_iters=2, dcn_axis="dcn")
        ivf1 = ShardedIVFIndex.build(c, corpus_mesh(8), cfg1)
        ivf2 = ShardedIVFIndex.build(c, self._mesh(), cfg2)
        _, j1 = ivf1.search(q, k=5, nprobe=4)
        _, j2 = ivf2.search(q, k=5, nprobe=4)
        np.testing.assert_array_equal(np.asarray(j1), np.asarray(j2))

    def test_checkpoint_roundtrip_hierarchical(self, tmp_path):
        from mediquery_rag.engine.checkpoint import (
            load_sharded_index, save_sharded_index,
        )
        cfg = EngineConfig(dim=64, dtype="int8", corpus_tile=256,
                           dcn_axis="dcn")
        mesh = self._mesh()
        c = _vecs(2000, 64, seed=26)
        idx = ShardedFlatIndex.build(c, mesh, cfg)
        save_sharded_index(idx, str(tmp_path / "hx"))
        idx2 = load_sharded_index(str(tmp_path / "hx"), mesh)
        assert idx2.cfg.dcn_axis == "dcn"
        q = _vecs(4, 64, seed=27)
        _, i1 = idx.search(q, k=5)
        _, i2 = idx2.search(q, k=5)
        np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))

    def test_bad_dcn_axis_rejected(self):
        cfg = EngineConfig(dim=64, dtype="float32", corpus_tile=256,
                           dcn_axis="nope")
        with pytest.raises(ValueError, match="not an axis"):
            ShardedFlatIndex.build(_vecs(512, 64), self._mesh(), cfg)


class TestIVFIndex:
    def test_full_probe_is_exact(self):
        """nprobe == nlist degenerates to exact search."""
        c = _vecs(2000, 64, seed=10)
        cfg = EngineConfig(dim=64, dtype="float32", ivf_nlist=16, ivf_kmeans_iters=4)
        idx = IVFIndex.build(c, cfg)
        q = _vecs(5, 64, seed=11)
        s, i = idx.search(q, k=5, nprobe=16)
        _, i_ref = flat_search_xla(q, c, 5)
        np.testing.assert_array_equal(np.sort(np.asarray(i)), np.sort(np.asarray(i_ref)))

    def test_partial_probe_recall(self):
        """Clustered corpus (realistic embedding geometry): partial probe must
        keep high recall. Uniform random data is the no-structure worst case
        where any ANN degenerates — not the parity regime."""
        key = jax.random.PRNGKey(12)
        centers = jax.random.normal(key, (64, 64))
        assign = jax.random.randint(jax.random.PRNGKey(1), (4000,), 0, 64)
        c = centers[assign] + 0.3 * jax.random.normal(jax.random.PRNGKey(2), (4000, 64))
        c = c / jnp.linalg.norm(c, axis=-1, keepdims=True)
        cfg = EngineConfig(dim=64, dtype="float32", ivf_nlist=64, ivf_kmeans_iters=6)
        idx = IVFIndex.build(c, cfg)
        q = c[:16] + 0.05 * jax.random.normal(jax.random.PRNGKey(3), (16, 64))
        _, i = idx.search(q, k=10, nprobe=16)
        _, i_ref = flat_search_xla(
            q / jnp.linalg.norm(q, axis=-1, keepdims=True), c, 10)
        rec = recall_at_k(i, i_ref)
        assert rec >= 0.9, f"IVF recall@10 too low at nprobe=16/64: {rec}"

    def test_split_oversized_bounds_clusters_and_lifts_recall(self):
        """Balanced-split k-means (r4): on skewed clustered data the
        bounded-cap layout evicted whole dense regions to far buckets
        (measured 28% alt-placement at 10M, recall plateau 0.94);
        split_oversized makes capacity where the density is."""
        from mediquery_rag.ops.kmeans import (
            assign_clusters, kmeans, split_oversized)
        rng = np.random.default_rng(0)
        centers = rng.standard_normal((40, 64)).astype(np.float32)
        sizes = rng.dirichlet(np.ones(40) * 0.4)      # heavily skewed
        asg = rng.choice(40, 12000, p=sizes)
        c = centers[asg] + 0.35 * rng.standard_normal((12000, 64)).astype(
            np.float32)
        c = jnp.asarray(c / np.linalg.norm(c, axis=1, keepdims=True))
        cents = kmeans(c, jax.random.PRNGKey(0), nlist=128, iters=6,
                       balance=0.05)
        cap = 188  # 2x avg (12000/128), rounded to 32
        counts0 = np.bincount(np.asarray(assign_clusters(c, cents)),
                              minlength=128)
        cents2 = split_oversized(c, cents, cap_rows=cap, n_total=12000)
        counts1 = np.bincount(np.asarray(assign_clusters(c, cents2)),
                              minlength=128)
        assert counts0.max() > cap          # the skew is real
        assert counts1.max() <= cap         # ...and the split bounds it
        # end-to-end: the builder path (cfg flag on by default) keeps
        # partial-probe recall high on this geometry
        cfg = EngineConfig(dim=64, dtype="float32", ivf_nlist=128,
                           ivf_kmeans_iters=6, ivf_cap_factor=1.25)
        idx = IVFIndex.build(c, cfg)
        q = c[:16] + 0.05 * jax.random.normal(jax.random.PRNGKey(3),
                                              (16, 64))
        _, i = idx.search(q, k=10, nprobe=16)
        _, i_ref = flat_search_xla(
            q / jnp.linalg.norm(q, axis=-1, keepdims=True), c, 10)
        assert recall_at_k(i, i_ref) >= 0.9

    def test_save_load(self, tmp_path):
        c = _vecs(1000, 64, seed=14)
        cfg = EngineConfig(dim=64, dtype="float32", ivf_nlist=16, ivf_kmeans_iters=3)
        idx = IVFIndex.build(c, cfg)
        idx.save(str(tmp_path / "ivf"))
        idx2 = IVFIndex.load(str(tmp_path / "ivf"))
        q = _vecs(4, 64, seed=15)
        _, i1 = idx.search(q, k=5)
        _, i2 = idx2.search(q, k=5)
        np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))

    def test_int8_ivf(self):
        cfg = EngineConfig(dim=64, dtype="int8", ivf_nlist=16,
                           ivf_kmeans_iters=4)
        c = _vecs(2000, 64, seed=30)
        idx = IVFIndex.build(c, cfg)
        assert idx.bucket_scales is not None
        assert idx.buckets.dtype.name == "int8"
        q = _vecs(6, 64, seed=31)
        s, i = idx.search(q, k=5, nprobe=16)   # full probe = exact-ish
        _, i_ref = flat_search_xla(q, c, 5)
        assert recall_at_k(i, i_ref) >= 0.95
        # rescaled scores approximate true cosine
        s_ref, _ = flat_search_xla(q, c, 5)
        import numpy as np
        np.testing.assert_allclose(np.asarray(s), np.asarray(s_ref), atol=0.03)

    def test_int8_ivf_save_load(self, tmp_path):
        cfg = EngineConfig(dim=64, dtype="int8", ivf_nlist=8,
                           ivf_kmeans_iters=3)
        c = _vecs(500, 64, seed=32)
        idx = IVFIndex.build(c, cfg)
        idx.save(str(tmp_path / "i8"))
        idx2 = IVFIndex.load(str(tmp_path / "i8"))
        q = _vecs(3, 64, seed=33)
        _, i1 = idx.search(q, k=4)
        _, i2 = idx2.search(q, k=4)
        import numpy as np
        np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))


class TestShardedIVF:
    def test_matches_single_chip_ivf(self):
        from mediquery_rag.engine.sharded_ivf import ShardedIVFIndex
        mesh = corpus_mesh(8)
        key = jax.random.PRNGKey(40)
        centers = jax.random.normal(key, (32, 64))
        asg = jax.random.randint(jax.random.PRNGKey(41), (3000,), 0, 32)
        c = centers[asg] + 0.3 * jax.random.normal(jax.random.PRNGKey(42), (3000, 64))
        c = c / jnp.linalg.norm(c, axis=-1, keepdims=True)
        cfg = EngineConfig(dim=64, dtype="float32", ivf_nlist=32,
                           ivf_kmeans_iters=5)
        base = IVFIndex.build(c, cfg, key=jax.random.PRNGKey(0))
        sharded = ShardedIVFIndex.build(c, mesh, cfg, key=jax.random.PRNGKey(0))
        q = c[:8] + 0.05 * jax.random.normal(jax.random.PRNGKey(43), (8, 64))
        s1, i1 = base.search(q, k=10, nprobe=8)
        s2, i2 = sharded.search(q, k=10, nprobe=8)
        # same centroids (same key) => same probes => identical results
        np.testing.assert_array_equal(np.sort(np.asarray(i1), axis=1),
                                      np.sort(np.asarray(i2), axis=1))

    def test_full_probe_exact(self):
        from mediquery_rag.engine.sharded_ivf import ShardedIVFIndex
        mesh = corpus_mesh(8)
        c = _vecs(2000, 64, seed=44)
        cfg = EngineConfig(dim=64, dtype="float32", ivf_nlist=16,
                           ivf_kmeans_iters=4)
        idx = ShardedIVFIndex.build(c, mesh, cfg)
        q = _vecs(5, 64, seed=45)
        _, i = idx.search(q, k=5, nprobe=16)
        _, i_ref = flat_search_xla(q, c, 5)
        np.testing.assert_array_equal(np.sort(np.asarray(i), axis=1),
                                      np.sort(np.asarray(i_ref), axis=1))

    def test_int8_matches_single_chip_int8(self):
        """int8 sharded IVF must carry the per-row scales (not score raw
        int8 dots) — results must equal the single-chip int8 index."""
        from mediquery_rag.engine.sharded_ivf import ShardedIVFIndex
        mesh = corpus_mesh(8)
        c = _vecs(2000, 64, seed=48)
        cfg = EngineConfig(dim=64, dtype="int8", ivf_nlist=16,
                           ivf_kmeans_iters=4)
        base = IVFIndex.build(c, cfg, key=jax.random.PRNGKey(0))
        idx = ShardedIVFIndex.build(c, mesh, cfg, key=jax.random.PRNGKey(0))
        assert idx.bucket_scales is not None
        q = _vecs(6, 64, seed=49)
        s1, i1 = base.search(q, k=5, nprobe=8)
        s2, i2 = idx.search(q, k=5, nprobe=8)
        np.testing.assert_array_equal(
            np.sort(np.asarray(i1), axis=1),
            np.sort(np.asarray(i2), axis=1))
        np.testing.assert_allclose(
            np.sort(np.asarray(s1), axis=1),
            np.sort(np.asarray(s2), axis=1), rtol=1e-4, atol=1e-4)


class TestTuning:
    def test_tune_nprobe_finds_cheapest(self):
        from mediquery_rag.engine.tuning import tune_nprobe
        key = jax.random.PRNGKey(50)
        centers = jax.random.normal(key, (32, 64))
        asg = jax.random.randint(jax.random.PRNGKey(51), (3000,), 0, 32)
        c = centers[asg] + 0.3 * jax.random.normal(jax.random.PRNGKey(52), (3000, 64))
        c = c / jnp.linalg.norm(c, axis=-1, keepdims=True)
        cfg = EngineConfig(dim=64, dtype="float32", ivf_nlist=32, ivf_kmeans_iters=5)
        iv = IVFIndex.build(c, cfg)
        flat = FlatIndex.build(c, CFG)
        q = c[:16] + 0.05 * jax.random.normal(jax.random.PRNGKey(53), (16, 64))
        out = tune_nprobe(iv, flat, q, k=10, target_recall=0.95)
        assert out["recall"] >= 0.95
        assert out["nprobe"] <= 16          # clustered data needs few probes
        # sweep is monotone-ish: the chosen nprobe is the first passing one
        for np_, rec in out["sweep"][:-1]:
            assert rec < 0.95 or np_ == out["nprobe"]


class TestIVFKernelVsOracle:
    def test_probe_kernel_matches_gather_oracle(self):
        from mediquery_rag.ops.ivf_probe import (
            ivf_probe_search, ivf_probe_search_xla)
        cfg = EngineConfig(dim=64, dtype="float32", ivf_nlist=16,
                           ivf_kmeans_iters=3)
        c = _vecs(1500, 64, seed=60)
        iv = IVFIndex.build(c, cfg)
        q = _vecs(6, 64, seed=61)
        cs = q @ iv.centroids.T
        _, pid = jax.lax.top_k(cs, 4)
        pid = pid.astype(jnp.int32)
        qs = q.astype(iv.buckets.dtype)
        s1, i1 = ivf_probe_search(pid, qs, iv.buckets, iv.bucket_ids, k=5)
        s2, i2 = ivf_probe_search_xla(pid, qs, iv.buckets, iv.bucket_ids, k=5)
        np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))
        np.testing.assert_allclose(np.asarray(s1), np.asarray(s2), rtol=1e-5)

    def test_batch_kernel_matches_gather_oracle(self):
        """Many queries probing the same buckets, at batch sizes that do
        and do not divide the probe op's query groups."""
        from mediquery_rag.ops.ivf_probe import (
            ivf_probe_search, ivf_probe_search_xla)
        cfg = EngineConfig(dim=64, dtype="float32", ivf_nlist=16,
                           ivf_kmeans_iters=3)
        # clustered corpus => heavy probe overlap across queries
        key = jax.random.PRNGKey(70)
        centers = jax.random.normal(key, (8, 64))
        asg = jax.random.randint(jax.random.PRNGKey(71), (1500,), 0, 8)
        c = centers[asg] + 0.3 * jax.random.normal(
            jax.random.PRNGKey(72), (1500, 64))
        c = c / jnp.linalg.norm(c, axis=-1, keepdims=True)
        iv = IVFIndex.build(c, cfg)
        for b, nprobe in ((1, 3), (6, 4), (33, 2)):
            q = _vecs(b, 64, seed=73 + b)
            cs = q @ iv.centroids.T
            _, pid = jax.lax.top_k(cs, nprobe)
            pid = pid.astype(jnp.int32)
            qs = q.astype(iv.buckets.dtype)
            s1, i1 = ivf_probe_search(pid, qs, iv.buckets, iv.bucket_ids, k=5)
            s2, i2 = ivf_probe_search_xla(pid, qs, iv.buckets, iv.bucket_ids,
                                          k=5)
            np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))
            np.testing.assert_allclose(np.asarray(s1), np.asarray(s2),
                                       rtol=1e-5)


class TestFlatMutation:
    """Incremental add/delete with stable doc ids (Chroma/hnswlib parity)."""

    def test_add_then_search_finds_new_docs(self):
        c = _vecs(600, 64, seed=90)
        idx = FlatIndex.build(c[:500], CFG)
        idx2 = idx.add(c[500:])
        assert idx2.n == 600
        q = c[550]
        _, i = idx2.search(q, k=1)
        assert int(i[0]) == 550

    def test_delete_masks_and_keeps_ids_stable(self):
        c = _vecs(300, 64, seed=91)
        idx = FlatIndex.build(c, CFG)
        q = c[7]
        _, i = idx.search(q, k=2)
        assert int(i[0]) == 7
        idx2 = idx.delete([7])
        s2, i2 = idx2.search(q, k=2)
        assert 7 not in np.asarray(i2).tolist()
        # remaining results carry original ids
        _, i_ref = flat_search_xla(q[None], np.delete(np.asarray(c), 7, 0), 1)
        # second-best of original == best after delete (id shifted by the
        # deletion in the oracle, so compare vectors not raw positions)
        best = int(np.asarray(i2)[0])
        assert best != 7 and best < 300

    def test_delete_then_add_no_id_reuse(self):
        c = _vecs(200, 64, seed=92)
        idx = FlatIndex.build(c, CFG).delete([0, 5])
        assert idx.next_id == 200
        idx2 = idx.add(_vecs(3, 64, seed=93))
        _, i = idx2.search(_vecs(1, 64, seed=93)[0], k=1)
        assert int(i[0]) == 200                   # first new doc's stable id
        assert idx2.n == 201

    def test_int8_add_delete(self):
        cfg = EngineConfig(dim=64, dtype="int8", corpus_tile=256)
        c = _vecs(400, 64, seed=94)
        idx = FlatIndex.build(c[:350], cfg).add(c[350:]).delete([10, 20, 30])
        q = c[360]
        _, i = idx.search(q, k=1)
        assert int(i[0]) == 360
        for gone in (10, 20, 30):
            _, ig = idx.search(c[gone], k=3)
            assert gone not in np.asarray(ig).tolist()

    def test_save_load_preserves_ids(self, tmp_path):
        c = _vecs(300, 64, seed=95)
        idx = FlatIndex.build(c, CFG).delete([1, 2, 3]).add(_vecs(2, 64, seed=96))
        idx.save(str(tmp_path / "f"))
        idx2 = FlatIndex.load(str(tmp_path / "f"))
        assert idx2.next_id == idx.next_id == 302
        q = c[100]
        _, i1 = idx.search(q, k=4)
        _, i2 = idx2.search(q, k=4)
        np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))


class TestIVFMutation:
    def test_add_and_delete(self):
        cfg = EngineConfig(dim=64, dtype="float32", ivf_nlist=8,
                           ivf_kmeans_iters=3)
        c = _vecs(800, 64, seed=97)
        idx = IVFIndex.build(c[:700], cfg)
        idx = idx.add(c[700:])
        assert idx.n == 800 and idx.live == 800
        q = c[750]
        _, i = idx.search(q, k=1, nprobe=8)
        assert int(i[0]) == 750
        idx = idx.delete([750])
        assert idx.live == 799
        _, i = idx.search(q, k=3, nprobe=8)
        assert 750 not in np.asarray(i).tolist()
        # no id reuse
        idx = idx.add(c[750:751])
        _, i = idx.search(q, k=1, nprobe=8)
        assert int(i[0]) == 800

    def test_add_grows_cap(self):
        cfg = EngineConfig(dim=64, dtype="float32", ivf_nlist=4,
                           ivf_kmeans_iters=3)
        c = _vecs(256, 64, seed=98)
        idx = IVFIndex.build(c, cfg)
        cap0 = idx.cap
        # cram enough near-identical vectors to overflow one bucket
        extra = jnp.tile(c[:1], (cap0 + 8, 1)) + 0.01 * _vecs(cap0 + 8, 64, seed=99)
        idx2 = idx.add(extra)
        assert idx2.cap > cap0
        _, i = idx2.search(c[0], k=5, nprobe=4)
        assert all(int(x) >= 0 for x in np.asarray(i))

    def test_int8_add_delete(self):
        cfg = EngineConfig(dim=64, dtype="int8", ivf_nlist=8,
                           ivf_kmeans_iters=3)
        c = _vecs(500, 64, seed=100)
        idx = IVFIndex.build(c[:450], cfg).add(c[450:]).delete([460])
        q = c[470]
        _, i = idx.search(q, k=1, nprobe=8)
        assert int(i[0]) == 470
        _, ig = idx.search(c[460], k=3, nprobe=8)
        assert 460 not in np.asarray(ig).tolist()

    def test_save_load_after_mutation(self, tmp_path):
        cfg = EngineConfig(dim=64, dtype="float32", ivf_nlist=8,
                           ivf_kmeans_iters=3)
        c = _vecs(400, 64, seed=101)
        idx = IVFIndex.build(c, cfg).delete([5]).add(_vecs(2, 64, seed=102))
        idx.save(str(tmp_path / "iv"))
        idx2 = IVFIndex.load(str(tmp_path / "iv"))
        assert idx2.next_id == idx.next_id == 402
        assert idx2.live == idx.live
        q = c[30]
        _, i1 = idx.search(q, k=4, nprobe=8)
        _, i2 = idx2.search(q, k=4, nprobe=8)
        np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))


class TestBoundedCapIVF:
    def _clustered(self, n, d, k_true, seed):
        key = jax.random.PRNGKey(seed)
        centers = jax.random.normal(key, (k_true, d))
        sizes = np.maximum((np.random.default_rng(seed).zipf(1.5, k_true)), 1)
        probs = sizes / sizes.sum()
        asg = np.random.default_rng(seed + 1).choice(k_true, n, p=probs)
        c = centers[asg] + 0.3 * jax.random.normal(
            jax.random.PRNGKey(seed + 2), (n, d))
        return c / jnp.linalg.norm(c, axis=-1, keepdims=True)

    def test_cap_bounded_and_recall_kept(self):
        """Zipf-skewed cluster sizes: unbounded cap would blow up memory;
        the bounded layout must stay within cap_factor while keeping recall."""
        c = self._clustered(6000, 64, 32, seed=110)
        unbounded = EngineConfig(dim=64, dtype="float32", ivf_nlist=64,
                                 ivf_kmeans_iters=6, ivf_balance=0.0,
                                 ivf_cap_factor=0.0)
        bounded = EngineConfig(dim=64, dtype="float32", ivf_nlist=64,
                               ivf_kmeans_iters=6, ivf_balance=0.05,
                               ivf_cap_factor=2.0)
        iu = IVFIndex.build(c, unbounded)
        ib = IVFIndex.build(c, bounded)
        avg = 6000 / 64
        assert ib.cap <= -(-int(2.0 * avg) // 32) * 32
        assert ib.nbytes <= iu.nbytes
        assert ib.live == 6000                    # no rows dropped
        q = c[:32] + 0.05 * jax.random.normal(jax.random.PRNGKey(111), (32, 64))
        _, i_ref = flat_search_xla(
            q / jnp.linalg.norm(q, axis=-1, keepdims=True), c, 10)
        _, i_b = ib.search(q, k=10, nprobe=16)
        assert recall_at_k(i_b, i_ref) >= 0.9

    def test_every_doc_exactly_once(self):
        c = self._clustered(3000, 64, 16, seed=112)
        cfg = EngineConfig(dim=64, dtype="float32", ivf_nlist=32,
                           ivf_kmeans_iters=5, ivf_cap_factor=1.5)
        idx = IVFIndex.build(c, cfg)
        ids = np.asarray(idx.bucket_ids).reshape(-1)
        ids = ids[ids >= 0]
        assert len(ids) == 3000 and len(set(ids.tolist())) == 3000


class TestBucketLadder:
    def test_bucket_sizes(self):
        from mediquery_rag.engine.flat import bucket_queries
        for b, want in ((1, 1), (2, 4), (4, 4), (5, 8), (8, 8), (9, 16),
                        (17, 32), (64, 64), (65, 80)):
            q = np.zeros((b, 8), np.float32)
            qp, br = bucket_queries(q)
            assert br == b and qp.shape[0] == want, (b, qp.shape)

    def test_odd_batch_sizes_correct(self):
        """Results at awkward batch sizes match the oracle (padding rows
        must never leak into real rows' results)."""
        c = _vecs(1000, 64, seed=120)
        idx = FlatIndex.build(c, CFG)
        for b in (1, 2, 3, 5, 9, 17, 33):
            q = _vecs(b, 64, seed=121 + b)
            s, i = idx.search(q, k=5)
            assert i.shape == (b, 5) if b > 1 else True
            _, i_ref = flat_search_xla(q, c, 5)
            np.testing.assert_array_equal(np.asarray(i), np.asarray(i_ref))

    def test_odd_batch_ivf(self):
        cfg = EngineConfig(dim=64, dtype="float32", ivf_nlist=16,
                           ivf_kmeans_iters=3)
        c = _vecs(1500, 64, seed=130)
        iv = IVFIndex.build(c, cfg)
        _, i_ref = flat_search_xla(_vecs(7, 64, seed=131), c, 5)
        _, i = iv.search(_vecs(7, 64, seed=131), k=5, nprobe=16)
        np.testing.assert_array_equal(np.sort(np.asarray(i), 1),
                                      np.sort(np.asarray(i_ref), 1))


class TestStreamingIVFBuild:
    """build_streaming must produce the SAME index as in-memory build when
    the k-means sample matches (n <= ivf_sample => both use every row)."""

    def test_matches_in_memory_build(self):
        c = np.asarray(_vecs(3000, 64, seed=150), np.float32)
        cfg = EngineConfig(dim=64, dtype="float32", ivf_nlist=16,
                           ivf_kmeans_iters=4)
        mem = IVFIndex.build(c, cfg, key=jax.random.PRNGKey(0))

        def make_chunks(rows=512):
            def gen():
                for i in range(0, len(c), rows):
                    yield c[i:i + rows]
            return gen

        st = IVFIndex.build_streaming(make_chunks(), 3000, cfg,
                                      key=jax.random.PRNGKey(0),
                                      chunk_rows=512)
        assert st.cap == mem.cap
        np.testing.assert_array_equal(np.asarray(st.bucket_ids),
                                      np.asarray(mem.bucket_ids))
        q = _vecs(9, 64, seed=151)
        s1, i1 = mem.search(q, k=5, nprobe=8)
        s2, i2 = st.search(q, k=5, nprobe=8)
        np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))
        np.testing.assert_allclose(np.asarray(s1), np.asarray(s2),
                                   rtol=1e-5, atol=1e-5)

    def test_int8_streaming(self):
        c = np.asarray(_vecs(2000, 64, seed=152), np.float32)
        cfg = EngineConfig(dim=64, dtype="int8", ivf_nlist=8,
                           ivf_kmeans_iters=3)
        mem = IVFIndex.build(c, cfg, key=jax.random.PRNGKey(0))

        def gen():
            for i in range(0, len(c), 300):      # short tail chunk
                yield c[i:i + 300]

        st = IVFIndex.build_streaming(gen, 2000, cfg,
                                      key=jax.random.PRNGKey(0),
                                      chunk_rows=300)
        q = _vecs(7, 64, seed=153)
        s1, i1 = mem.search(q, k=5, nprobe=8)
        s2, i2 = st.search(q, k=5, nprobe=8)
        np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))
        np.testing.assert_allclose(np.asarray(s1), np.asarray(s2),
                                   rtol=1e-5, atol=1e-5)

    def test_bf16_transfer_preserves_recall(self):
        """transfer_dtype='bfloat16' (the large-scale build knob: half the
        H2D bytes) may flip boundary assignments but must keep retrieval
        recall vs the exact f32 build."""
        c = np.asarray(_vecs(2000, 64, seed=155), np.float32)
        cfg = EngineConfig(dim=64, dtype="int8", ivf_nlist=8,
                           ivf_kmeans_iters=3)
        mem = IVFIndex.build(c, cfg, key=jax.random.PRNGKey(0))

        def gen():
            for i in range(0, len(c), 500):
                yield c[i:i + 500]

        st = IVFIndex.build_streaming(gen, 2000, cfg,
                                      key=jax.random.PRNGKey(0),
                                      chunk_rows=500,
                                      transfer_dtype="bfloat16")
        q = _vecs(16, 64, seed=156)
        _, i1 = mem.search(q, k=10, nprobe=8)
        _, i2 = st.search(q, k=10, nprobe=8)
        overlap = np.mean([
            len(set(np.asarray(i1)[r].tolist())
                & set(np.asarray(i2)[r].tolist())) / 10
            for r in range(16)])
        assert overlap >= 0.9, f"bf16-transfer recall overlap {overlap}"

    def test_bad_transfer_dtype_rejected(self):
        c = np.asarray(_vecs(500, 64, seed=157), np.float32)
        cfg = EngineConfig(dim=64, dtype="float32", ivf_nlist=8,
                           ivf_kmeans_iters=2)
        with pytest.raises(ValueError, match="transfer_dtype"):
            IVFIndex.build_streaming(lambda: iter([c]), 500, cfg,
                                     chunk_rows=500,
                                     transfer_dtype="int8")

    def test_device_chunks_stay_on_device(self):
        """A device-resident chunk generator (the scale10m pattern) must
        build without a host round trip of the full chunks and match the
        in-memory build."""
        import jax.numpy as jnp
        c = np.asarray(_vecs(1500, 64, seed=158), np.float32)
        cfg = EngineConfig(dim=64, dtype="float32", ivf_nlist=8,
                           ivf_kmeans_iters=3)
        mem = IVFIndex.build(c, cfg, key=jax.random.PRNGKey(0))

        def gen():
            for i in range(0, len(c), 500):
                yield jnp.asarray(c[i:i + 500])      # device chunks

        st = IVFIndex.build_streaming(gen, 1500, cfg,
                                      key=jax.random.PRNGKey(0),
                                      chunk_rows=500)
        q = _vecs(7, 64, seed=159)
        s1, i1 = mem.search(q, k=5, nprobe=8)
        s2, i2 = st.search(q, k=5, nprobe=8)
        np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))

    def test_row_count_mismatch_rejected(self):
        c = np.asarray(_vecs(500, 64, seed=154), np.float32)
        cfg = EngineConfig(dim=64, dtype="float32", ivf_nlist=8,
                           ivf_kmeans_iters=2)
        with pytest.raises(AssertionError, match="expected"):
            IVFIndex.build_streaming(lambda: iter([c]), 600, cfg)


class TestShardedFromStreaming:
    def test_streaming_index_shards_and_matches(self):
        from mediquery_rag.engine.sharded_ivf import ShardedIVFIndex
        mesh = corpus_mesh(8)
        c = np.asarray(_vecs(2000, 64, seed=160), np.float32)
        cfg = EngineConfig(dim=64, dtype="int8", ivf_nlist=16,
                           ivf_kmeans_iters=3)

        def gen():
            for i in range(0, len(c), 256):
                yield c[i:i + 256]

        base = IVFIndex.build_streaming(gen, 2000, cfg,
                                        key=jax.random.PRNGKey(0),
                                        chunk_rows=256)
        sharded = ShardedIVFIndex.from_single(base, mesh)
        q = _vecs(6, 64, seed=161)
        s1, i1 = base.search(q, k=5, nprobe=16)
        s2, i2 = sharded.search(q, k=5, nprobe=16)
        np.testing.assert_array_equal(np.sort(np.asarray(i1), 1),
                                      np.sort(np.asarray(i2), 1))
        np.testing.assert_allclose(np.sort(np.asarray(s1), 1),
                                   np.sort(np.asarray(s2), 1),
                                   rtol=1e-4, atol=1e-4)


class TestReviewRegressions:
    def test_plain_list_query(self):
        """1-D Python list queries are supported (regressed once when
        squeeze detection used getattr(q, 'ndim'))."""
        c = _vecs(300, 64, seed=170)
        idx = FlatIndex.build(c, CFG)
        q_list = np.asarray(c[5]).tolist()
        s, i = idx.search(q_list, k=3)
        assert int(i[0]) == 5
        cfg = EngineConfig(dim=64, dtype="float32", ivf_nlist=8,
                           ivf_kmeans_iters=2)
        iv = IVFIndex.build(c, cfg)
        _, i2 = iv.search(q_list, k=3, nprobe=8)
        assert int(i2[0]) == 5

    def test_k_over_kernel_cap_rejected(self):
        c = _vecs(300, 64, seed=171)
        idx = FlatIndex.build(c, CFG)
        with pytest.raises(ValueError, match="128"):
            idx.search(_vecs(2, 64, seed=172), k=129)

    def test_rerank_at_kernel_cap_still_reranks(self):
        """k=128 with rerank configured: no overfetch headroom, but the
        exact re-score must still run (reorders int8 candidates)."""
        cfg = EngineConfig(dim=64, dtype="int8", corpus_tile=256,
                           rerank_factor=4)
        c = _vecs(500, 64, seed=173)
        idx = FlatIndex.build(c, cfg)
        s, i = idx.search(_vecs(2, 64, seed=174), k=128)
        assert i.shape == (2, 128)
        # scores are exact f32 cosines (|s| <= 1 + eps), not raw int8 dots
        assert float(jnp.max(jnp.abs(s))) <= 1.01
