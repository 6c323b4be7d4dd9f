"""Exact flat scan + top-k — the hot primitive of the engine.

This replaces the hnswlib C++ graph search that the reference reached through
``vectorstore.similarity_search(q, k=5)`` (reference: src/agents/nodes.py:93,
src/medical_engine.py:52). The corpus lives in device memory as an
``[N, D]`` matrix; one matmul scores every row against the query batch and
an exact two-stage top-k (ops/topk.py) selects the best ``k`` per query.

Plain XLA on every platform (ops/route.py). The ``[B, N]`` f32 score matrix
is written and read once: 8·B bytes per corpus row beside the 2·D bytes a
bf16 row costs to read, i.e. 8% more traffic at the server's batches of
1-16 and 33% at B=64. Corpus rows are padded to a whole number of top-k
blocks (``corpus_tile``) at build time; pad rows are masked to ``-inf``
through ``n_valid``, a traced value, so a resized corpus or a shard with
fewer valid rows reuses the compiled program.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from mediquery_rag.ops import route
from mediquery_rag.ops.topk import masked_topk

NEG_INF = float("-inf")


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def matmul_precision(dtype) -> jax.lax.Precision:
    """f32 storage asks for full f32 products: on the GPU a default-
    precision f32 matmul may run in TF32 (about three decimal digits)."""
    if jnp.dtype(dtype) == jnp.float32:
        return jax.lax.Precision.HIGHEST
    return jax.lax.Precision.DEFAULT


def scores_xt(queries: jax.Array, corpus: jax.Array) -> jax.Array:
    """``queries @ corpus.T`` in f32, queries cast to the storage dtype."""
    return jax.lax.dot_general(
        queries.astype(corpus.dtype), corpus,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=matmul_precision(corpus.dtype),
    )


def check_search_args(k: int, n_rows: int, corpus_tile: int) -> None:
    if corpus_tile <= 0:
        raise ValueError(f"corpus_tile={corpus_tile} must be positive")
    if k > corpus_tile:
        raise ValueError(f"k={k} > corpus_tile={corpus_tile}")
    if n_rows % corpus_tile:
        raise ValueError(
            f"corpus rows {n_rows} not a multiple of tile {corpus_tile}")


@functools.partial(jax.jit, static_argnames=("k", "corpus_tile"))
def _flat_search(queries, corpus, n_valid, *, k, corpus_tile):
    return masked_topk(scores_xt(queries, corpus), n_valid, k, corpus_tile)


def flat_search(
    queries: jax.Array,
    corpus_padded: jax.Array,
    k: int,
    *,
    n_valid: int | jax.Array | None = None,
    corpus_tile: int = 2048,
) -> tuple[jax.Array, jax.Array]:
    """Exact top-k dot-product search.

    Args:
      queries: ``[B, D]`` query matrix (L2-normalized by the caller for cosine).
      corpus_padded: ``[N_pad, D]`` corpus, rows padded to a multiple of
        ``corpus_tile`` (``engine.FlatIndex`` stores it this way).
      k: neighbors to return (``k <= corpus_tile``).
      n_valid: number of real corpus rows (defaults to ``N_pad``).
      corpus_tile: columns per first-stage top-k block.

    Returns:
      (scores ``[B, k]`` f32 desc-sorted, indices ``[B, k]`` i32).
    """
    route.impl("flat_search")
    n_pad = corpus_padded.shape[0]
    check_search_args(k, n_pad, corpus_tile)
    n_valid = n_pad if n_valid is None else n_valid
    return _flat_search(queries, corpus_padded,
                        jnp.asarray(n_valid, jnp.int32),
                        k=k, corpus_tile=corpus_tile)


@functools.partial(jax.jit, static_argnames=("k",))
def flat_search_xla(
    queries: jax.Array, corpus: jax.Array, k: int
) -> tuple[jax.Array, jax.Array]:
    """One-stage oracle: materialize ``[B, N]`` scores, then ``lax.top_k``."""
    return jax.lax.top_k(scores_xt(queries, corpus), k)
