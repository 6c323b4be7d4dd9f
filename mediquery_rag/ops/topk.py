"""Top-k selection and merge primitives.

The reference's nearest-neighbor selection lives inside hnswlib's C++ priority
queues (via ChromaDB, reference medical_engine.py:52). Here selection is an
on-device primitive: ``exact_topk`` is the XLA oracle, ``merge_topk`` combines
partial top-k lists (used for cross-shard ICI merges and IVF probe merges).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from mediquery_rag.ops import route


def exact_topk(scores: jax.Array, k: int) -> tuple[jax.Array, jax.Array]:
    """XLA top-k over the last axis. Returns (values, indices), sorted desc.

    The one-stage oracle for :func:`two_stage_topk`.
    """
    return jax.lax.top_k(scores, k)


def two_stage_topk(scores: jax.Array, k: int,
                   block: int) -> tuple[jax.Array, jax.Array]:
    """Exact top-k over the last axis of ``[B, N]`` in two stages: the
    top-k of every ``block`` columns, then the top-k of those winners.

    Every global top-k element is in its own block's top-k, so the result
    equals ``lax.top_k(scores, k)``; each sort is ``block`` or
    ``N/block*k`` long instead of ``N``. Falls back to one stage when
    ``N`` is not a whole number of blocks larger than one block.
    """
    b, n = scores.shape
    if k > block or n <= block or n % block:
        return jax.lax.top_k(scores, k)
    nb = n // block
    v1, i1 = jax.lax.top_k(scores.reshape(b, nb, block), k)   # [B, nb, k]
    cols = i1 + (jnp.arange(nb, dtype=i1.dtype) * block)[None, :, None]
    vals, pos = jax.lax.top_k(v1.reshape(b, nb * k), k)
    return vals, jnp.take_along_axis(cols.reshape(b, nb * k), pos, axis=-1)


def _pow2_floor(n: int) -> int:
    return 1 << (max(1, n).bit_length() - 1)


def _pow2_ceil(n: int) -> int:
    return 1 << (max(1, n) - 1).bit_length()


def _block_topk_kernel(nv_ref, s_ref, v_ref, i_ref, *, k, bn):
    """One program: the top-``k`` of a ``[bq, bn]`` tile of scores, by
    ``k`` rounds of row max + first arg-max + mask-out, all in registers.
    Columns at or past ``n_valid`` load as ``-inf``."""
    bq, kp = v_ref.shape
    r0 = pl.program_id(0) * bq
    c0 = pl.program_id(1) * bn
    pos = jax.lax.broadcasted_iota(jnp.int32, (bq, bn), 1)
    s = pl_triton.load(s_ref.at[pl.ds(r0, bq), pl.ds(c0, bn)],
                       mask=c0 + pos < nv_ref[0], other=-jnp.inf)
    slot = jax.lax.broadcasted_iota(jnp.int32, (bq, kp), 1)

    def body(t, carry):
        s, vals, idx = carry
        m = jnp.max(s, axis=1, keepdims=True)                  # [bq, 1]
        p = jnp.min(jnp.where(s == m, pos, bn), axis=1, keepdims=True)
        vals = jnp.where(slot == t, m, vals)
        idx = jnp.where(slot == t, c0 + p, idx)
        return jnp.where(pos == p, -jnp.inf, s), vals, idx

    _, vals, idx = jax.lax.fori_loop(
        0, k, body, (s, jnp.full((bq, kp), -jnp.inf, jnp.float32),
                     jnp.zeros((bq, kp), jnp.int32)))
    v_ref[...] = vals
    i_ref[...] = idx


def triton_topk_shape(b: int, k: int) -> tuple[int, int] | None:
    """(row tile, padded k) of the block top-k kernel, or None when the
    batch has no power-of-two row tile or k is too large to unroll."""
    bq = b if b < 16 else 16
    if b % bq or bq & (bq - 1) or k > 64:
        return None
    return bq, _pow2_ceil(k)


@functools.partial(jax.jit, static_argnames=("k", "block", "interpret"))
def block_topk_triton(scores, n_valid, *, k, block, interpret=False):
    """Exact top-k of ``[B, N]`` f32 scores over the first ``n_valid``
    columns: a Triton-route Pallas kernel keeps each ``block``-column
    tile's top-k, then ``lax.top_k`` merges the ``N/block * k``
    candidates."""
    b, n = scores.shape
    bq, kp = triton_topk_shape(b, k)
    nb = -(-n // block)
    nv = jnp.minimum(jnp.asarray(n_valid, jnp.int32), n).reshape(1)
    out_spec = pl.BlockSpec((bq, kp), lambda r, c: (r, c))
    vals, idx = pl.pallas_call(
        functools.partial(_block_topk_kernel, k=k, bn=block),
        out_shape=[jax.ShapeDtypeStruct((b, nb * kp), jnp.float32),
                   jax.ShapeDtypeStruct((b, nb * kp), jnp.int32)],
        grid=(b // bq, nb),
        out_specs=[out_spec, out_spec],
        compiler_params=pl_triton.CompilerParams(num_warps=4, num_stages=1),
        backend="triton",
        interpret=interpret,
        name="block_topk",
    )(nv, scores)
    v, p = jax.lax.top_k(vals, k)
    return v, jnp.take_along_axis(idx, p, axis=-1)


def masked_topk(scores: jax.Array, n_valid, k: int,
                block: int) -> tuple[jax.Array, jax.Array]:
    """Exact top-k over the first ``n_valid`` columns (the rest are
    padding rows of the corpus and never selected): the block top-k
    kernel on the GPU (ops/route.py), :func:`two_stage_topk` on the CPU.
    """
    if (route.impl("block_topk") == "triton"
            and triton_topk_shape(scores.shape[0], k) is not None):
        return block_topk_triton(scores, n_valid, k=k,
                                 block=min(_pow2_floor(block), 1024))
    col = jax.lax.broadcasted_iota(jnp.int32, scores.shape, 1)
    scores = jnp.where(col < n_valid, scores, -jnp.inf)
    return two_stage_topk(scores, k, block)


def merge_topk(
    scores_a: jax.Array,
    idx_a: jax.Array,
    scores_b: jax.Array,
    idx_b: jax.Array,
    k: int,
) -> tuple[jax.Array, jax.Array]:
    """Merge two partial top-k lists along the last axis.

    Shapes: scores_* [..., ka], [..., kb] -> ([..., k], [..., k]).
    Used to fold per-shard partial results after an all-gather over ICI
    (the comm pattern BASELINE.json names: "multi-chip shards merge partial
    top-k via all-gather over ICI").
    """
    s = jnp.concatenate([scores_a, scores_b], axis=-1)
    i = jnp.concatenate([idx_a, idx_b], axis=-1)
    vals, pos = jax.lax.top_k(s, k)
    return vals, jnp.take_along_axis(i, pos, axis=-1)


def merge_topk_many(
    scores: jax.Array, idx: jax.Array, k: int
) -> tuple[jax.Array, jax.Array]:
    """Merge ``[n_parts, ..., kp]`` partial lists into one ``[..., k]`` list.

    ``scores``/``idx`` carry a leading parts axis (e.g. the all-gather axis).
    """
    n = scores.shape[0]
    s = jnp.moveaxis(scores, 0, -2).reshape(*scores.shape[1:-1], n * scores.shape[-1])
    i = jnp.moveaxis(idx, 0, -2).reshape(*idx.shape[1:-1], n * idx.shape[-1])
    vals, pos = jax.lax.top_k(s, k)
    return vals, jnp.take_along_axis(i, pos, axis=-1)
