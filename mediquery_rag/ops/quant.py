"""Int8 / int4 quantized scoring: 1/2 and 1/4 the bytes of bf16.

The flat scan reads the whole corpus per batch (ops/scoring.py), so storage
dtype is the throughput lever: an int8 corpus + per-row scales reads ~1/2
the bytes of bf16 per scan; nibble-packed int4 reads ~1/4. Quantization is
symmetric per-row (scale = max|x| / 127 or / 7); queries are quantized to
int8 on the fly and scored with an int8 x int8 -> int32 product, then
rescaled by the corpus row scales. The per-query scale is a positive
constant per row, so it never changes the ranking and is applied to the
returned ``k`` scores only.

int4 packs two consecutive LOGICAL ROWS per byte-row (row-pair layout: low
nibble = row 2r biased +8, high nibble = row 2r+1 signed). Both rows'
scores are linear in two int8 products over the packed bytes (see
:func:`quantize_rows_int4`), so the scan never materializes unpacked codes.
int4 is meant to be paired with ``rerank_factor`` (exact f16 host rerank)
to buy back the last recall points.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from mediquery_rag.ops import route
from mediquery_rag.ops.scoring import check_search_args
from mediquery_rag.ops.topk import masked_topk

_DIMS = (((1,), (1,)), ((), ()))


def quantize_rows(x: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Symmetric per-row int8 quantization. Returns (q [N,D] i8, scale [N] f32)."""
    xf = x.astype(jnp.float32)
    amax = jnp.max(jnp.abs(xf), axis=-1)
    scale = jnp.maximum(amax, 1e-12) / 127.0
    q = jnp.clip(jnp.round(xf / scale[:, None]), -127, 127).astype(jnp.int8)
    return q, scale


def quantize_rows_int4(x: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Symmetric per-row int4, two LOGICAL ROWS packed per byte-row.

    Byte ``[r, j]`` stores logical row ``2r``'s code for dim ``j`` BIASED by
    +8 in the low nibble (``ulo = lo + 8`` in [1, 15]) and row ``2r+1``'s
    code signed in the high nibble: ``byte = 16*hi + ulo`` in [-111, 127].
    The bias makes BOTH rows' scores linear in quantities an int8 product
    consumes raw: with ``dotU = q . (byte & 15)`` and ``dotP = q . byte``,

        even-row score = dotU - 8*sum(q),    odd-row score = (dotP - dotU)/16

    Returns (packed ``[P, D]`` i8, scale planes ``[2, P]`` f32) with
    ``P = ceil(N/2)``; plane 0 holds even logical rows' scales, plane 1 odd.
    Odd N gets a zero phantom row (scores 0, masked by ``n_valid``
    downstream).
    """
    xf = x.astype(jnp.float32)
    n = xf.shape[0]
    amax = jnp.max(jnp.abs(xf), axis=-1)
    scale = jnp.maximum(amax, 1e-12) / 7.0
    q = jnp.clip(jnp.round(xf / scale[:, None]), -7, 7).astype(jnp.int32)
    if n % 2:
        q = jnp.pad(q, ((0, 1), (0, 0)))
        scale = jnp.pad(scale, ((0, 1)), constant_values=1.0)
    lo, hi = q[0::2], q[1::2]
    packed = ((hi * 16) + (lo + 8)).astype(jnp.int8)
    scale2 = jnp.stack([scale[0::2], scale[1::2]])
    return packed, scale2


def int4_codes(x: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Symmetric per-row int4 CODES (unpacked, one per byte) + scales.

    The scatter-friendly intermediate for IVF builds: codes land in bucket
    slots like int8 rows, then :func:`ivf_pack_slots_int4` pairs them.
    """
    xf = x.astype(jnp.float32)
    amax = jnp.max(jnp.abs(xf), axis=-1)
    scale = jnp.maximum(amax, 1e-12) / 7.0
    codes = jnp.clip(jnp.round(xf / scale[:, None]), -7, 7).astype(jnp.int8)
    return codes, scale


def ivf_pack_slots_int4(codes: jax.Array, nlist: int, cap: int) -> jax.Array:
    """Bucket-local split-half packing for IVF: slot ``j`` of a bucket goes
    to the LOW nibble (biased +8) of packed row ``j``, slot ``j + cap/2`` to
    the HIGH nibble — so the probe scores ``concat([even, odd])`` line up
    with the slot-ordered ``bucket_ids``/``bucket_scales`` arrays with zero
    reordering. ``codes`` is ``[nlist*cap, D]`` (int4 codes in int8 bytes,
    slot order); returns ``[nlist*cap/2, D]`` i8.
    """
    if cap % 2:
        raise ValueError(f"int4 IVF needs even cap, got {cap}")
    d = codes.shape[1]
    # arithmetic stays in int8: hi*16 in [-112, 112], +lo+8 <= 127 — an
    # int32 upcast materializes a 4x buffer (33 GB at 10M, OOM)
    c3 = codes.reshape(nlist, cap, d).astype(jnp.int8)
    caph = cap // 2
    lo, hi = c3[:, :caph], c3[:, caph:]
    return ((hi * jnp.int8(16)) + (lo + jnp.int8(8))).reshape(
        nlist * caph, d)


def ivf_unpack_slots_int4(packed: jax.Array, nlist: int,
                          cap: int) -> jax.Array:
    """Inverse of :func:`ivf_pack_slots_int4`: ``[nlist*cap/2, D]`` i8 ->
    slot-ordered codes ``[nlist*cap, D]`` i8."""
    d = packed.shape[1]
    caph = cap // 2
    p = packed.reshape(nlist, caph, d).astype(jnp.int32)
    lo = (p & 15) - 8
    hi = p >> 4
    return jnp.concatenate([lo, hi], axis=1).reshape(
        nlist * cap, d).astype(jnp.int8)


def unpack_int4(packed: jax.Array) -> jax.Array:
    """Inverse of the row-pair packing: ``[P, D]`` i8 -> ``[2P, D]`` i32."""
    p = packed.astype(jnp.int32)
    lo = (p & 15) - 8                       # low nibble is biased unsigned
    hi = p >> 4                             # arithmetic shift (ulo >= 0)
    ph, d = p.shape
    return jnp.stack([lo, hi], axis=1).reshape(2 * ph, d)


def dequantize_int4(packed: jax.Array, scale2: jax.Array,
                    n: int | None = None) -> jax.Array:
    """``[P, D]`` i8 + ``[2, P]`` scale planes -> ``[n, D]`` f32."""
    ph = packed.shape[0]
    n = 2 * ph if n is None else n
    scale = scale2.T.reshape(2 * scale2.shape[1])     # logical per-row order
    return (unpack_int4(packed)[:n].astype(jnp.float32)
            * scale[:n, None])


def int4_pair_scores(q8: jax.Array, packed: jax.Array):
    """Unscaled scores of int8 queries ``[B, D]`` against split/paired int4
    bytes ``[P, D]``: returns (low-nibble rows, high-nibble rows), each
    ``[B, P]`` f32. Both int32 products are exact; |dotP| <= 127*127*D
    stays below 2^24 for D <= 1040, so the f32 conversion is exact too."""
    dot_u = jax.lax.dot_general(q8, packed & jnp.int8(15), _DIMS,
                                preferred_element_type=jnp.int32)
    dot_p = jax.lax.dot_general(q8, packed, _DIMS,
                                preferred_element_type=jnp.int32)
    corr = 8 * jnp.sum(q8.astype(jnp.int32), axis=1, keepdims=True)
    lo = (dot_u - corr).astype(jnp.float32)
    hi = (dot_p - dot_u).astype(jnp.float32) * 0.0625
    return lo, hi


@functools.partial(jax.jit, static_argnames=("k", "corpus_tile"))
def _int8_search(queries, corpus_q, corpus_scale, n_valid, *, k,
                 corpus_tile):
    q8, qs = quantize_rows(queries)
    raw = jax.lax.dot_general(q8, corpus_q, _DIMS,
                              preferred_element_type=jnp.int32)
    scores = raw.astype(jnp.float32) * corpus_scale[None, :]
    s, i = masked_topk(scores, n_valid, k, corpus_tile)
    return s * qs[:, None], i


@functools.partial(jax.jit, static_argnames=("k", "corpus_tile"))
def _int4_search(queries, corpus_q, corpus_scale, n_valid, *, k,
                 corpus_tile):
    q8, qs = quantize_rows(queries)
    lo, hi = int4_pair_scores(q8, corpus_q)
    even = lo * corpus_scale[0][None, :]
    odd = hi * corpus_scale[1][None, :]
    b, p = even.shape
    # logical row 2r+t sits at column 2r+t: interleave the two planes
    scores = jnp.stack([even, odd], axis=-1).reshape(b, 2 * p)
    s, i = masked_topk(scores, n_valid, k, corpus_tile)
    return s * qs[:, None], i


def int4_flat_search(
    queries: jax.Array,
    corpus_q: jax.Array,       # [N_pad/2, D] i8 row-pair packed (pads zero)
    corpus_scale: jax.Array,   # [2, N_pad/2] f32 scale planes (even, odd)
    k: int,
    *,
    n_valid: int | jax.Array | None = None,
    corpus_tile: int = 2048,
) -> tuple[jax.Array, jax.Array]:
    """Exact top-k over a row-pair-packed int4 corpus (1/4 the bytes of bf16).

    Queries are quantized to int8 on the fly — asymmetric precision (i8
    query x i4 corpus) keeps the query side essentially lossless, so all
    quantization error lives in the corpus codes. ``corpus_tile`` counts
    LOGICAL rows per top-k block and must be even.
    """
    route.impl("int4_flat_search")
    nph, dc = corpus_q.shape
    n_pad = 2 * nph
    if dc != queries.shape[1]:
        raise ValueError(f"query dim {queries.shape[1]} != packed corpus "
                         f"dim {dc}")
    if corpus_tile % 2:
        raise ValueError(f"int4 corpus_tile must be even, got {corpus_tile}")
    check_search_args(k, n_pad, corpus_tile)
    if corpus_scale.shape != (2, nph):
        raise ValueError(
            f"scale planes {corpus_scale.shape} != (2, {nph})")
    n_valid = n_pad if n_valid is None else n_valid
    return _int4_search(queries, corpus_q, corpus_scale,
                        jnp.asarray(n_valid, jnp.int32),
                        k=k, corpus_tile=corpus_tile)


def int8_flat_search(
    queries: jax.Array,
    corpus_q: jax.Array,       # [N_pad, D] int8 (pad rows zero)
    corpus_scale: jax.Array,   # [N_pad] f32
    k: int,
    *,
    n_valid: int | jax.Array | None = None,
    corpus_tile: int = 2048,
) -> tuple[jax.Array, jax.Array]:
    """Exact top-k over an int8 corpus. Queries are quantized on the fly."""
    route.impl("int8_flat_search")
    n_pad = corpus_q.shape[0]
    check_search_args(k, n_pad, corpus_tile)
    n_valid = n_pad if n_valid is None else n_valid
    return _int8_search(queries, corpus_q, corpus_scale,
                        jnp.asarray(n_valid, jnp.int32),
                        k=k, corpus_tile=corpus_tile)
