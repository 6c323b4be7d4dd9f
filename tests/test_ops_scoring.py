"""Op-level numerics: the flat scan + two-stage top-k vs the one-stage oracle.

SURVEY.md §4 test class (2): kernel numerics vs jnp reference on small
matrices (the reference had no tests at all; this is net-new strategy).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mediquery_rag.ops import exact_topk, flat_search, flat_search_xla, merge_topk
from mediquery_rag.ops.topk import merge_topk_many


def _corpus(n, d, seed=0, dtype=jnp.float32):
    x = jax.random.normal(jax.random.PRNGKey(seed), (n, d), dtype=jnp.float32)
    x = x / jnp.linalg.norm(x, axis=-1, keepdims=True)
    return x.astype(dtype)


def _pad_rows(x, tile):
    n = x.shape[0]
    n_pad = -(-n // tile) * tile
    return jnp.pad(x, ((0, n_pad - n), (0, 0))), n


@pytest.mark.parametrize("b,n,k", [(1, 300, 5), (8, 1024, 4), (33, 777, 10)])
def test_flat_search_matches_oracle_f32(b, n, k):
    tile = 256
    c = _corpus(n, 64, seed=1)
    q = _corpus(b, 64, seed=2)
    c_pad, n_valid = _pad_rows(c, tile)
    s, i = flat_search(q, c_pad, k, n_valid=n_valid, corpus_tile=tile)
    s_ref, i_ref = flat_search_xla(q, c, k)
    np.testing.assert_allclose(np.asarray(s), np.asarray(s_ref), rtol=1e-5, atol=1e-5)
    # indices may differ only under exact score ties; with random f32 data they don't
    np.testing.assert_array_equal(np.asarray(i), np.asarray(i_ref))


def test_flat_search_bf16_recall_parity():
    """bf16 storage must keep recall@10 vs the f32 oracle (BASELINE config 4)."""
    n, d, b, k = 4096, 128, 16, 10
    c32 = _corpus(n, d, seed=3)
    q = _corpus(b, d, seed=4)
    c_pad, n_valid = _pad_rows(c32.astype(jnp.bfloat16), 512)
    _, i_bf16 = flat_search(q, c_pad, k, n_valid=n_valid, corpus_tile=512)
    _, i_ref = flat_search_xla(q, c32, k)
    hits = sum(
        len(set(np.asarray(i_bf16[r]).tolist()) & set(np.asarray(i_ref[r]).tolist()))
        for r in range(b)
    )
    recall = hits / (b * k)
    assert recall >= 0.9, f"bf16 recall@10 too low: {recall}"


def test_flat_search_scores_sorted_desc():
    c = _corpus(500, 32, seed=5)
    q = _corpus(4, 32, seed=6)
    c_pad, n_valid = _pad_rows(c, 128)
    s, _ = flat_search(q, c_pad, 8, n_valid=n_valid, corpus_tile=128)
    s = np.asarray(s)
    assert (np.diff(s, axis=1) <= 1e-6).all()


def test_flat_search_masks_padding():
    """Padded rows (zeros) must never be returned even when real scores < 0."""
    d = 32
    c = -jnp.abs(_corpus(100, d, seed=7))  # all-negative scores vs any query
    q = jnp.abs(_corpus(2, d, seed=8))
    c_pad, n_valid = _pad_rows(c, 128)
    _, i = flat_search(q, c_pad, 5, n_valid=n_valid, corpus_tile=128)
    assert (np.asarray(i) < 100).all()


def test_flat_search_lane_collisions_force_rescan():
    """Adversarial layout for the two-level merge: the global top-k all live
    in the SAME lane (positions differing by multiples of 128 inside one
    tile), so the lane-winner pass alone would miss all but one — the
    second-best rescan must recover them exactly."""
    d, k = 32, 8
    n = 512                                  # one 512-wide tile, 4 segments
    rng = np.random.default_rng(11)
    base_dir = rng.standard_normal(d).astype(np.float32)
    base_dir /= np.linalg.norm(base_dir)
    c = 0.01 * rng.standard_normal((n, d)).astype(np.float32)
    # plant the top-k at lane 7 of each segment: positions 7, 135, 263, 391
    # (and more in lane 40) with descending alignment to the query direction
    hot = [7, 135, 263, 391, 40, 168, 296, 424]
    for rank, posn in enumerate(hot):
        c[posn] = (1.0 - 0.01 * rank) * base_dir \
            + 0.001 * rng.standard_normal(d)
    c = c / np.linalg.norm(c, axis=1, keepdims=True)
    q = jnp.asarray(base_dir)[None, :]
    c_pad, n_valid = _pad_rows(jnp.asarray(c), 512)
    s, i = flat_search(q, c_pad, k, n_valid=n_valid, corpus_tile=512)
    s_ref, i_ref = flat_search_xla(q, jnp.asarray(c), k)
    np.testing.assert_array_equal(np.asarray(i), np.asarray(i_ref))
    np.testing.assert_allclose(np.asarray(s), np.asarray(s_ref),
                               rtol=1e-5, atol=1e-5)


def test_flat_search_duplicate_scores_no_duplicate_indices():
    """EXACT duplicate rows across lanes/segments: the merge must return k
    distinct indices (consumed-winner masking) and scores equal to the
    oracle's."""
    d, k = 32, 6
    row = np.ones(d, np.float32) / np.sqrt(d)
    c = np.tile(row, (300, 1))               # every score identical
    q = jnp.asarray(row)[None, :]
    c_pad, n_valid = _pad_rows(jnp.asarray(c), 256)
    s, i = flat_search(q, c_pad, k, n_valid=n_valid, corpus_tile=256)
    i = np.asarray(i)[0]
    assert len(set(i.tolist())) == k, i
    assert (i < 300).all()
    np.testing.assert_allclose(np.asarray(s)[0], np.ones(k), rtol=1e-5)


def test_merge_topk():
    s_a = jnp.array([[9.0, 5.0, 1.0]])
    i_a = jnp.array([[10, 11, 12]])
    s_b = jnp.array([[7.0, 6.0]])
    i_b = jnp.array([[20, 21]])
    s, i = merge_topk(s_a, i_a, s_b, i_b, 4)
    np.testing.assert_array_equal(np.asarray(s[0]), [9.0, 7.0, 6.0, 5.0])
    np.testing.assert_array_equal(np.asarray(i[0]), [10, 20, 21, 11])


def test_merge_topk_many_matches_flat():
    n, d, b, k, parts = 1024, 32, 4, 6, 8
    c = _corpus(n, d, seed=9)
    q = _corpus(b, d, seed=10)
    per = n // parts
    ss, ii = [], []
    for p in range(parts):
        shard = c[p * per : (p + 1) * per]
        s, i = exact_topk(q @ shard.T, k)
        ss.append(s)
        ii.append(i + p * per)
    s, i = merge_topk_many(jnp.stack(ss), jnp.stack(ii), k)
    s_ref, i_ref = exact_topk(q @ c.T, k)
    np.testing.assert_allclose(np.asarray(s), np.asarray(s_ref), rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(i), np.asarray(i_ref))
