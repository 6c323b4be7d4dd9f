"""Weight-only quantized matvec for LM decode.

Decode at small batch is weight-BANDWIDTH bound: every token re-reads all
params, so tok/s ~ bandwidth / weight_bytes, and an int8 weight halves the
bytes of bf16. What matters is that the int8 matrix is read once, at byte
rate, without a bf16 copy of it being written and read back.

Two implementations of the same math, ``x @ (w8 * s).T`` with bf16 (or
f32) activations and f32 accumulation (ops/route.py picks one per
platform):

- ``"triton"``: a Pallas kernel through the Triton route. Each program
  owns ``block_f`` output channels, walks the input dim in ``block_k``
  slices (int8 bytes unpacked from int32 words -> activation dtype in
  registers -> tensor-core dot) and applies the per-channel scale in the
  epilogue. Stacked ``[L, F, D]``
  weights are indexed by the layer number inside the kernel, so the
  decoder's layer loop never copies a layer out of the stack. Rows are
  padded to 16, and the reduction order over D does not depend on how many
  rows are live — a row's result is the same at every batch size.
- ``"xla"``: dequantize-into-dot, compiled by XLA.

Weights are stored TRANSPOSED ``[out, in]`` so the contraction is over the
minor axis.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from mediquery_rag.ops import route

_ROWS = 16          # tensor-core dot needs M >= 16: rows pad to this
_MAX_ROWS = 32      # decode steps and verify windows; above this (prefill)
                    # the product is compute-shaped: use XLA
_STAGE_BYTES = 48 * 1024   # weight + activation tile bytes per pipeline
                           # stage: the kernel's 3 stages stay inside a
                           # block's 227 KB of shared memory


def _largest_pow2_divisor(n: int, cap: int) -> int:
    b = 1
    while b * 2 <= cap and n % (b * 2) == 0:
        b *= 2
    return b


def triton_blocks(f: int, d: int, rows: int = _ROWS,
                  x_bytes: int = 2) -> tuple[int, int] | None:
    """(block_f, block_k) for an ``[F, D]`` weight and ``rows`` padded
    activation rows of ``x_bytes`` each, or None when the shape has no
    power-of-two tiling the Triton route accepts (then the XLA route
    runs). ``block_k`` counts 4-byte words of the weight row (see
    :func:`_matvec_kernel`). ``block_f`` shrinks until there are >= 264
    programs (two per SM of a 132-SM card) or it reaches 16; ``block_k``
    shrinks until one stage's tiles fit ``_STAGE_BYTES``."""
    if d % 4:
        return None
    block_k = _largest_pow2_divisor(d // 4, 128)
    block_f = _largest_pow2_divisor(f, 64)
    if block_k < 16 or block_f < 16:
        return None
    while block_f > 16 and f // block_f < 264:
        block_f //= 2
    while block_k > 16 and block_k * 4 * (block_f + rows * x_bytes) \
            > _STAGE_BYTES:
        block_k //= 2
    return block_f, block_k


def _matvec_kernel(l_ref, x_ref, w_ref, s_ref, o_ref, *, block_k, n_k, d4):
    """One program: ``block_f`` output channels of one layer.

    ``w_ref`` is the int8 weight viewed as int32 words ``[L, F, D/4]``
    (byte t of word j is input column 4j + t). Word offsets stay below
    2**31 for any stack under 8 GB, where byte offsets would overflow the
    32-bit addressing Pallas picks for arrays under 4 GB. ``x_ref`` holds
    the activations with columns regrouped by byte lane: column
    ``t*D/4 + j`` is input column ``4j + t``."""
    block_f = o_ref.shape[1]
    f0 = pl.multiple_of(pl.program_id(0) * block_f, block_f)
    layer = l_ref[0]

    def body(i, acc):
        k0 = pl.multiple_of(i * block_k, block_k)
        w = w_ref[layer, pl.ds(f0, block_f), pl.ds(k0, block_k)]  # i32
        for t in range(4):
            # byte t, sign-extended: shift it to the top, shift back down
            wt = jnp.right_shift(jnp.left_shift(w, 24 - 8 * t), 24)
            xt = x_ref[:, pl.ds(t * d4 + k0, block_k)]          # [R, bk]
            acc = acc + jax.lax.dot_general(
                xt, wt.astype(xt.dtype), (((1,), (1,)), ((), ())),
                preferred_element_type=jnp.float32)             # [R, bf]
        return acc

    acc = jax.lax.fori_loop(
        0, n_k, body, jnp.zeros((x_ref.shape[0], block_f), jnp.float32))
    o_ref[...] = acc * s_ref[layer, pl.ds(f0, block_f)][None, :]


@functools.partial(jax.jit,
                   static_argnames=("block_f", "block_k", "interpret"))
def _matvec_triton(layer, x, w8, scales, *, block_f, block_k, interpret):
    r, d = x.shape
    L, f, _ = w8.shape
    d4 = d // 4
    # free reinterpretations: int8 x4 -> int32 words, and the activation
    # columns regrouped by byte lane (a tiny [R, D] transpose)
    w32 = jax.lax.bitcast_convert_type(w8.reshape(L, f, d4, 4), jnp.int32)
    xg = x.reshape(r, d4, 4).transpose(0, 2, 1).reshape(r, d)
    return pl.pallas_call(
        functools.partial(_matvec_kernel, block_k=block_k,
                          n_k=d4 // block_k, d4=d4),
        out_shape=jax.ShapeDtypeStruct((r, f), jnp.float32),
        grid=(f // block_f,),
        out_specs=pl.BlockSpec((r, block_f), lambda j: (0, j)),
        compiler_params=pl_triton.CompilerParams(num_warps=4,
                                                 num_stages=3),
        backend="triton",
        interpret=interpret,
        name="int8_weight_matvec",
    )(layer, xg, w32, scales)


def _matvec_xla(x, w8, scales):
    # the barrier keeps the int8->float convert out of the GEMM: the
    # product then runs as a plain float GEMM with f32 sums, the same
    # arithmetic as the kernel, at every row count
    w = jax.lax.optimization_barrier(w8.astype(x.dtype))
    return jnp.einsum("bd,fd->bf", x, w,
                      preferred_element_type=jnp.float32) * scales[None, :]


def quant_matvec(
    x: jax.Array,          # [B, D] activations (bf16 or f32)
    w8: jax.Array,         # [F, D] int8, TRANSPOSED (out, in) — or
                           # [L, F, D] stacked per-layer with ``layer``
    scales: jax.Array,     # [F] f32 per-output-channel ([L, F] stacked)
    *,
    layer: jax.Array | None = None,   # i32 scalar — the layer of stacked
                                      # weights to use
    impl: str | None = None,          # "triton" | "xla"; None = route
    interpret: bool = False,          # Pallas interpret mode (tests only)
) -> jax.Array:
    """``x @ (w8 * scales).T`` with int8 weights. Returns [B, F] f32."""
    impl = impl or route.impl("quant_matvec")
    b, d = x.shape
    f = w8.shape[-2]
    if not jnp.issubdtype(x.dtype, jnp.floating) or x.dtype == jnp.float16:
        x = x.astype(jnp.float32)
    rp = -(-b // _ROWS) * _ROWS
    blocks = triton_blocks(f, d, rp, x.dtype.itemsize)
    if impl == "triton" and (blocks is None or b > _MAX_ROWS):
        impl = "xla"
    if impl == "xla":
        if layer is not None:
            layer = jnp.asarray(layer, jnp.int32).reshape(())
            w8 = jax.lax.dynamic_index_in_dim(w8, layer, 0, keepdims=False)
            scales = jax.lax.dynamic_index_in_dim(scales, layer, 0,
                                                  keepdims=False)
        return _matvec_xla(x, w8, scales)
    if impl != "triton":
        raise ValueError(f"impl must be 'triton' or 'xla', got {impl!r}")
    if w8.ndim == 2:
        w8, scales = w8[None], scales[None]
        layer = 0
    bf, bk = blocks
    if rp != b:
        x = jnp.pad(x, ((0, rp - b), (0, 0)))
    out = _matvec_triton(jnp.asarray(layer, jnp.int32).reshape(1), x, w8,
                         scales, block_f=bf, block_k=bk,
                         interpret=interpret)
    return out[:b]


def quantize_weight(w: jax.Array) -> tuple[jax.Array, jax.Array]:
    """``[in, out]`` float -> (``[out, in]`` i8, ``[out]`` f32 scales).
    Symmetric per-output-channel; the transpose bakes the kernel layout."""
    wt = w.astype(jnp.float32).T                        # [out, in]
    amax = jnp.max(jnp.abs(wt), axis=-1)
    s = jnp.maximum(amax, 1e-12) / 127.0
    q = jnp.clip(jnp.round(wt / s[:, None]), -127, 127).astype(jnp.int8)
    return q, s


# -- int4 weight-only --------------------------------------------------------
#
# The reference serves its LLM through Ollama, whose default GGUF quant for
# qwen2.5:7b is 4-bit (Q4_K_M), so 4-bit weight-only is the parity point.
# Layout: output channels r (low nibble, code biased +8) and r + F/2 (high
# nibble, signed) share byte-row r of a [F/2, D] i8 matrix.
#
# Quality: naive per-output-channel int4 (RTN) is visibly lossy because
# weight magnitude varies along the INPUT axis too. Group-wise scales (the
# GGML/GPTQ answer) are one option; here an AWQ-style per-input-dim
# equalizer ``t[d] = (max_r |w[r,d]|)^alpha`` is divided out of the weights
# before quantization and multiplied back in at dequantization.


def quantize_weight_int4(w: jax.Array, *, alpha: float = 0.5):
    """``[in, out]`` float -> int4-packed serving form.

    Returns ``{"q4": [out/2, in] i8 nibble-packed, "s": [2, out/2] f32
    per-channel scale planes (0 = channels [0, F/2), 1 = [F/2, F)),
    "t": [1, in] f32 activation equalizer}``. ``out`` must be even.
    """
    wt = w.astype(jnp.float32).T                        # [F, D]
    f, d = wt.shape
    if f % 2:
        raise ValueError(f"int4 packing needs an even out dim, got {f}")
    amax_d = jnp.maximum(jnp.max(jnp.abs(wt), axis=0), 1e-12)   # [D]
    t = amax_d ** alpha
    t = t / jnp.exp(jnp.mean(jnp.log(t)))               # scale-neutral
    wn = wt / t[None, :]
    s = jnp.maximum(jnp.max(jnp.abs(wn), axis=-1), 1e-12) / 7.0  # [F]
    c = jnp.clip(jnp.round(wn / s[:, None]), -7, 7).astype(jnp.int32)
    f2 = f // 2
    lo, hi = c[:f2], c[f2:]
    packed = (hi * 16 + (lo + 8)).astype(jnp.int8)      # [F/2, D]
    s2 = jnp.stack([s[:f2], s[f2:]])                    # [2, F/2]
    return {"q4": packed, "s": s2, "t": t.reshape(1, d)}


def dequantize_weight_int4(wq, dtype=jnp.float32) -> jax.Array:
    """Serving form -> ``[out, in]`` dense weights."""
    p = wq["q4"].astype(jnp.int32)
    lo = (p & 15) - 8
    hi = (p - (lo + 8)) // 16         # exact: byte = 16*hi + (lo + 8)
    codes = jnp.concatenate([lo, hi], axis=0).astype(jnp.float32)
    s = wq["s"].reshape(-1)                             # [F] plane-ordered
    return (codes * s[:, None] * wq["t"]).astype(dtype)


def quant_matvec_int4(
    x: jax.Array,          # [B, D] activations (any float dtype)
    wq: dict,              # quantize_weight_int4 output (stacked [L, ...]
                           # leaves with ``layer``)
    *,
    layer: jax.Array | None = None,
) -> jax.Array:
    """``x @ W`` with int4 weights: unpack + dequantize into the dot
    (plain XLA on every platform). Returns [B, F] f32."""
    route.impl("quant_matvec_int4")
    if layer is not None:
        layer = jnp.asarray(layer, jnp.int32).reshape(())
        wq = jax.tree_util.tree_map(
            lambda a: jax.lax.dynamic_index_in_dim(a, layer, 0,
                                                   keepdims=False), wq)
    xdt = x.dtype if x.dtype in (jnp.bfloat16, jnp.float32) else jnp.float32
    w = dequantize_weight_int4(wq, xdt)
    return jnp.einsum("bd,fd->bf", x.astype(xdt), w,
                      preferred_element_type=jnp.float32)


def quantize_decoder_params(params, bits: int = 8,
                            fuse_gateup: bool | None = None):
    """Weight-only quantization for LM serving: every big matmul weight
    becomes ``{"q": [.., out, in] i8, "s": [.., out] f32}`` (``bits=8``) or
    the int4 form ``{"q4", "s", "t"}`` (``bits=4`` — quantize_weight_int4;
    models/decoder._mm consumes all three forms). Pure — compose with init
    under one jit at 7B+ scale so the float tree never coexists with the
    quantized one. Stacked per-layer weights convert layer-by-layer
    (``lax.map``) to keep the f32 transient at one layer, not L layers.

    ``fuse_gateup`` concatenates gate‖up along the out axis into ONE
    ``w_gateup`` matrix before quantizing (channel order [gate | up]) —
    the decode step then streams both projections in one matvec
    (models/decoder._mlp_ff splits the output). Default: on at int8 —
    per-output-channel scales make it mathematically lossless — and OFF
    at int4, where the two matrices would have to share one per-input-dim
    equalizer ``t`` (measured top-1-vs-float agreement dropped 0.81→0.69
    on the tiny test model; pass ``fuse_gateup=True`` explicitly to trade
    that quality for the dispatch fusion).
    """
    if fuse_gateup is None:
        fuse_gateup = bits == 8
    if bits == 4:
        q2 = quantize_weight_int4
        q3 = lambda w: jax.lax.map(quantize_weight_int4, w)  # noqa: E731
    elif bits == 8:
        def q2(w):
            q, s = quantize_weight(w)
            return {"q": q, "s": s}

        def q3(w):                                      # [L, in, out]
            q, s = jax.lax.map(quantize_weight, w)
            return {"q": q, "s": s}
    else:
        raise ValueError(f"bits must be 4 or 8, got {bits}")

    out = dict(params)
    out["blocks"] = dict(params["blocks"])
    mats = ["qkv", "attn_out", "w_down"]
    if fuse_gateup:
        def q3_pair(pair):                              # per-layer concat
            wg, wu = pair                               # [in, F] each
            if bits == 4:
                return quantize_weight_int4(
                    jnp.concatenate([wg, wu], axis=-1))
            q, s = quantize_weight(jnp.concatenate([wg, wu], axis=-1))
            return {"q": q, "s": s}

        out["blocks"]["w_gateup"] = jax.lax.map(
            q3_pair, (params["blocks"]["w_gate"], params["blocks"]["w_up"]))
        del out["blocks"]["w_gate"], out["blocks"]["w_up"]
    else:
        mats += ["w_gate", "w_up"]
    for k in mats:
        out["blocks"][k] = q3(params["blocks"][k])
    out["lm_head"] = q2(params["lm_head"])
    return out
