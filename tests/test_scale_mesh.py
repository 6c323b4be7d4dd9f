"""Virtual-mesh correctness at 100K x 768 (VERDICT r1 task 8).

The sharded engines' correctness claims (engine/sharded_ivf.py docstring:
"worst-case skew degrades latency, never correctness"; uneven trailing
shards; int4 row-pair packing across shard borders) were previously tested
only at toy sizes (256 rows/shard). These tests pin them down at production
shape — 100,300 x 768 (not divisible by 8 shards, not by the corpus tile)
on the 8-device virtual CPU mesh — by comparing the sharded engines against
their single-chip counterparts on identical quantized data: sharding must
change NOTHING about the result set.

Reference contract: Chroma/hnswlib returns identical results regardless of
internal segmentation; our mesh partition is the device analogue.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mediquery_rag.config import EngineConfig
from mediquery_rag.engine import FlatIndex, IVFIndex, ShardedFlatIndex
from mediquery_rag.engine.sharded_ivf import ShardedIVFIndex
from mediquery_rag.ops import flat_search_xla
from mediquery_rag.parallel import corpus_mesh

N, D = 100_300, 768          # 100300 % 8 != 0 and % 1024 != 0: uneven shards
NCENTERS = 512


def _norm(x):
    return x / jnp.linalg.norm(x, axis=-1, keepdims=True)


@pytest.fixture(scope="module")
def corpus():
    """Clustered unit vectors — realistic embedding geometry (same recipe
    as bench.py), f32 on host."""
    kc, ka, kn = jax.random.split(jax.random.PRNGKey(0), 3)
    centers = _norm(jax.random.normal(kc, (NCENTERS, D)))
    assign = jax.random.randint(ka, (N,), 0, NCENTERS)
    x = centers[assign] + 0.35 * jax.random.normal(kn, (N, D))
    return jax.block_until_ready(_norm(x.astype(jnp.float32)))


@pytest.fixture(scope="module")
def queries(corpus):
    """16 queries: perturbed corpus rows spread across the whole id range
    (so hits land in every shard, including the uneven last one)."""
    rows = corpus[:: N // 16][:16]
    q = rows + 0.05 * jax.random.normal(jax.random.PRNGKey(7), (16, D))
    return _norm(q)


def _rowsets_equal(i_a, i_b):
    a, b = np.asarray(i_a), np.asarray(i_b)
    assert a.shape == b.shape
    for r in range(a.shape[0]):
        assert set(a[r].tolist()) == set(b[r].tolist()), (
            f"row {r}: {sorted(a[r].tolist())} != {sorted(b[r].tolist())}")


class TestShardedFlatInt4AtScale:
    def test_matches_single_chip_and_covers_oracle(self, corpus, queries):
        """int4 sharded flat at 100K: row-pair packing happens BEFORE the
        shard split (pairs never straddle borders), trailing shard is
        ~47% padding — results must equal the single-chip int4 scan
        exactly, and the rerank-candidate set must cover the f32 oracle."""
        mesh = corpus_mesh(8)
        cfg = EngineConfig(dim=D, dtype="int4", corpus_tile=1024,
                           )
        sharded = ShardedFlatIndex.build(corpus, mesh, cfg)
        # uneven premise: pad unit is 8 shards x 1024-tile = 8192 rows
        n_pad = sharded.corpus.shape[0] * 2      # packed byte-rows x 2
        assert n_pad == 106_496 and n_pad // 8 * 7 < N < n_pad

        single = FlatIndex.build(corpus, cfg)
        s_sh, i_sh = sharded.search(queries, k=10)
        s_si, i_si = single.search(queries, k=10)
        _rowsets_equal(i_sh, i_si)
        np.testing.assert_allclose(np.asarray(s_sh), np.asarray(s_si),
                                   rtol=1e-4, atol=1e-5)
        assert (np.asarray(i_sh) < N).all()      # no pad/packing leakage

        # candidate-generation contract (the shipping int4 config): the
        # top-40 int4 candidates must contain the f32 oracle's top-10
        _, i40 = sharded.search(queries, k=40)
        _, i_ref = flat_search_xla(queries, corpus, 10)
        i40, i_ref = np.asarray(i40), np.asarray(i_ref)
        cover = np.mean([
            len(set(i40[r].tolist()) & set(i_ref[r].tolist())) / 10
            for r in range(i_ref.shape[0])])
        assert cover >= 0.9, cover


class TestShardedIVFAtScale:
    @pytest.fixture(scope="class")
    def built(self, corpus):
        # nlist=60 over 8 shards: per_shard=8, last shard holds only 4
        # real clusters + sentinel (uneven cluster partition)
        cfg = EngineConfig(dim=D, dtype="bfloat16", ivf_nlist=60,
                           ivf_nprobe=8, ivf_kmeans_iters=4,
                           ivf_sample=16384, ivf_cap_factor=1.5)
        base = IVFIndex.build(corpus, cfg, key=jax.random.PRNGKey(1))
        sharded = ShardedIVFIndex.from_single(base, corpus_mesh(8))
        assert sharded.per_shard == 8 and sharded.nlist == 60
        return base, sharded

    def test_worst_case_skew_all_probes_one_shard(self, built):
        """All probes routed to shard 0 (the docstring's worst case): 7 of
        8 chips score only their empty sentinel bucket; the merge must
        still return exactly the single-chip answer."""
        base, sharded = built
        cents = np.asarray(base.centroids)
        q = _norm(jnp.asarray(cents[:8])
                  + 0.01 * jax.random.normal(jax.random.PRNGKey(2), (8, D)))
        # verify the skew premise on host: every top-1 probe is a shard-0
        # cluster (ids 0..7)
        pid = np.argmax(np.asarray(q) @ cents.T, axis=1)
        assert (pid < sharded.per_shard).all(), pid
        s_sh, i_sh = sharded.search(q, k=10, nprobe=1)
        s_si, i_si = base.search(q, k=10, nprobe=1)
        _rowsets_equal(i_sh, i_si)
        np.testing.assert_allclose(np.asarray(s_sh), np.asarray(s_si),
                                   rtol=2e-2, atol=1e-2)  # bf16 scoring

    def test_general_probes_match_single_chip(self, built, queries):
        """nprobe=8, B=16: every shard serves some probes under
        shard_map at scale."""
        base, sharded = built
        s_sh, i_sh = sharded.search(queries, k=10, nprobe=8)
        s_si, i_si = base.search(queries, k=10, nprobe=8)
        _rowsets_equal(i_sh, i_si)
        np.testing.assert_allclose(np.asarray(s_sh), np.asarray(s_si),
                                   rtol=2e-2, atol=1e-2)


class TestShardedIVFInt4AtScale:
    def test_int4_ivf_matches_single_chip(self, corpus, queries):
        """int4 split-half packed buckets sharded at 100K: byte-rows are
        cap/2 per bucket — the shard relayout must slice at byte-row
        granularity without splitting nibble pairs."""
        cfg = EngineConfig(dim=D, dtype="int4", ivf_nlist=64, ivf_nprobe=4,
                           ivf_kmeans_iters=4, ivf_sample=16384,
                           ivf_cap_factor=1.5)
        base = IVFIndex.build(corpus, cfg, key=jax.random.PRNGKey(3))
        sharded = ShardedIVFIndex.from_single(base, corpus_mesh(8))
        s_sh, i_sh = sharded.search(queries, k=10, nprobe=4)
        s_si, i_si = base.search(queries, k=10, nprobe=4)
        _rowsets_equal(i_sh, i_si)
        np.testing.assert_allclose(np.asarray(s_sh), np.asarray(s_si),
                                   rtol=1e-3, atol=1e-3)
