"""Host-streaming flat index: exact search over corpora LARGER than HBM.

The HBM-resident tiers cap at device memory — ~16 GB/chip holds ~10M x
768-d rows at int8+scales (FlatIndex), ~8x that sharded (ShardedFlatIndex).
Past that, this tier keeps the quantized corpus in host RAM or an on-disk
memmap and streams fixed-size chunks through the chip: every chunk is
scored by the same scan + top-k ops (ops/quant.py /
ops/scoring.py) and folded into a running device-resident top-k; only the
final ``[B, k]`` lists ever come back to the host. The reference's stack
has no answer at this scale at all (hnswlib graphs must fit in RAM *and*
blow up memory 3-4x over raw vectors; reference medical_engine.py:52).

accelerator-first shape:
- every chunk is the SAME static shape ``[chunk_rows, D]`` (the last one
  zero-padded, masked via ``n_valid``), so the whole search is ONE compiled
  program re-dispatched per chunk — no shape churn, each novel shape
  being a fresh compile;
- double-buffered: the H2D copy of chunk i+1 is dispatched before the
  kernel on chunk i (`jax.device_put` is async), so transfer overlaps
  compute;
- the running (scores, ids) merge happens on device (ops/topk.merge_topk)
  — the host loop moves corpus bytes, never candidate lists.

Speed-of-light here is HOST→DEVICE bandwidth, not HBM: this is a CAPACITY
tier, not a latency tier. Amortize the streamed bytes over large query
batches (the per-chunk kernel cost is independent of how many queries ride
the pass up to the compute limit). Storage is int8 (+per-row scales) — half
the stream bytes of bf16 at ~equal recall, pairable with ``rerank_factor``
via a host refine copy exactly like FlatIndex.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from mediquery_rag.config import EngineConfig
from mediquery_rag.engine.flat import (
    _round_up, as_query_batch, bucket_queries, l2_normalize,
)
from mediquery_rag.ops.quant import int8_flat_search, quantize_rows
from mediquery_rag.ops.scoring import flat_search
from mediquery_rag.ops.topk import merge_topk


@partial(jax.jit, static_argnames=("chunk_rows",))
def _prep_chunk_int8(block, chunk_rows: int):
    """Normalize + quantize one corpus block on device, padded to the
    fixed chunk shape. Returns (int8 codes, f32 scales) for host pullback."""
    v = l2_normalize(block.astype(jnp.float32))
    q, s = quantize_rows(v)
    pad = chunk_rows - q.shape[0]
    return jnp.pad(q, ((0, pad), (0, 0))), jnp.pad(s, ((0, pad),))


def _prep_chunk_int8_host(block: np.ndarray, chunk_rows: int):
    """Numpy mirror of ``_prep_chunk_int8`` (same f32 math, same
    round-half-to-even). The device path is usually faster, but its f32
    H2D costs 4x the bytes the tier exists to avoid — ``prep="host"``
    skips the device entirely, for hosts whose link to the device is the
    bottleneck."""
    v = block.astype(np.float32)
    v /= np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-12)
    amax = np.max(np.abs(v), axis=-1)
    scale = np.maximum(amax, 1e-12) / 127.0
    q = np.clip(np.round(v / scale[:, None]), -127, 127).astype(np.int8)
    pad = chunk_rows - q.shape[0]
    if pad:
        q = np.pad(q, ((0, pad), (0, 0)))
        scale = np.pad(scale, ((0, pad),))
    return q, scale.astype(np.float32)


@partial(jax.jit, static_argnames=("k", "corpus_tile", "kind"))
def _fold_chunk(q, chunk, scale, n_valid, offset, run_s, run_i, *, k,
                corpus_tile, kind):
    """Score one chunk and merge into the running top-k (all on device)."""
    if kind == "int8":
        s, i = int8_flat_search(q, chunk, scale, k, n_valid=n_valid,
                                corpus_tile=corpus_tile)
    else:
        s, i = flat_search(q, chunk.astype(q.dtype), k, n_valid=n_valid,
                           corpus_tile=corpus_tile)
    return merge_topk(run_s, run_i, s, i + offset, k)


@dataclass
class StreamingFlatIndex:
    chunks: list        # [chunk_rows, D] int8 (or storage dtype) per chunk
    scales: list        # [chunk_rows] f32 per chunk (int8 only, else None)
    n: int              # global valid rows
    cfg: EngineConfig
    chunk_rows: int

    SUPPORTED = ("int8", "bfloat16", "float32")

    @classmethod
    def build(cls, vectors, cfg: EngineConfig = EngineConfig(),
              chunk_rows: int = 1 << 20,
              prep: str = "device") -> "StreamingFlatIndex":
        """Chunk + quantize ``vectors`` (host array / memmap). Each chunk is
        prepped ON DEVICE (normalize+quantize at HBM speed) and pulled back,
        so peak device memory is one chunk — building 100M rows needs only
        100M rows of HOST memory. ``prep="host"`` (int8 only) quantizes in
        numpy instead: zero device traffic, for hosts where the build's
        f32 H2D dominates."""
        return cls.build_from_blocks(
            (vectors[i : i + chunk_rows]
             for i in range(0, len(vectors), chunk_rows)),
            cfg, chunk_rows=chunk_rows, prep=prep)

    @classmethod
    def build_from_blocks(cls, blocks, cfg: EngineConfig = EngineConfig(),
                          chunk_rows: int = 1 << 20,
                          prep: str = "device") -> "StreamingFlatIndex":
        """Build from an iterator of row blocks (e.g. a streaming embedding
        pipeline). Blocks are repacked to exactly ``chunk_rows`` rows."""
        if cfg.dtype not in cls.SUPPORTED:
            raise ValueError(
                f"streaming tier supports {cls.SUPPORTED}, got {cfg.dtype!r}")
        if prep not in ("device", "host"):
            raise ValueError(f"prep must be 'device' or 'host', got {prep!r}")
        if prep == "host" and cfg.dtype != "int8":
            raise ValueError("prep='host' supports int8 storage only")
        chunk_rows = _round_up(chunk_rows, cfg.corpus_tile)  # whole blocks
        chunks, scales, n = [], [], 0
        buf: list[np.ndarray] = []
        buf_rows = 0

        def flush():
            nonlocal buf, buf_rows
            if not buf_rows:
                return
            block = np.concatenate(buf, axis=0) if len(buf) > 1 else buf[0]
            if cfg.dtype == "int8" and prep == "host":
                c8h, sch = _prep_chunk_int8_host(block, chunk_rows)
                chunks.append(c8h)
                scales.append(sch)
            elif cfg.dtype == "int8":
                c8, sc = _prep_chunk_int8(jnp.asarray(block), chunk_rows)
                chunks.append(np.asarray(c8))
                scales.append(np.asarray(sc))
            else:
                v = np.asarray(
                    l2_normalize(jnp.asarray(block, jnp.float32)).astype(
                        jnp.dtype(cfg.dtype)))
                pad = chunk_rows - v.shape[0]
                chunks.append(np.pad(v, ((0, pad), (0, 0))))
                scales.append(None)
            buf, buf_rows = [], 0

        for block in blocks:
            block = np.asarray(block)
            while block.shape[0]:
                take = min(chunk_rows - buf_rows, block.shape[0])
                buf.append(block[:take])
                buf_rows += take
                n += take
                block = block[take:]
                if buf_rows == chunk_rows:
                    flush()
        flush()
        if not chunks:
            raise ValueError("no rows")
        return cls(chunks=chunks, scales=scales, n=n, cfg=cfg,
                   chunk_rows=chunk_rows)

    def search(self, queries, k: int | None = None, *,
               prefetch: bool = True):
        """Exact global top-k, streaming every chunk through the device.
        Double-buffered H2D; the running top-k never leaves the chip.
        ``prefetch=False`` forces fully synchronous copies (each chunk
        lands before its fold dispatches) — the benchmark ablation that
        measures what the overlap buys (benchmarks/streaming.py --sync)."""
        k = self.cfg.top_k if k is None else k
        queries, squeeze = as_query_batch(queries)
        q_pad, b = bucket_queries(queries)
        q = l2_normalize(jnp.asarray(q_pad, jnp.float32)) \
            if self.cfg.metric == "cosine" else jnp.asarray(q_pad, jnp.float32)

        kind = "int8" if self.cfg.dtype == "int8" else "float"
        run_s = jnp.full((q.shape[0], k), -jnp.inf, jnp.float32)
        run_i = jnp.zeros((q.shape[0], k), jnp.int32)
        dev_next = jax.device_put(self.chunks[0])
        dev_next_s = (jax.device_put(self.scales[0])
                      if kind == "int8" else None)
        zero_s = (jnp.zeros((0,), jnp.float32) if kind != "int8" else None)
        for ci in range(len(self.chunks)):
            dev_c, dev_s = dev_next, dev_next_s
            if not prefetch:
                jax.block_until_ready(dev_c)   # kill the copy/fold overlap
            elif ci + 1 < len(self.chunks):    # prefetch next chunk (async)
                dev_next = jax.device_put(self.chunks[ci + 1])
                if kind == "int8":
                    dev_next_s = jax.device_put(self.scales[ci + 1])
            offset = ci * self.chunk_rows
            n_valid = min(self.chunk_rows, self.n - offset)
            run_s, run_i = _fold_chunk(
                q, dev_c, dev_s if kind == "int8" else zero_s,
                jnp.int32(n_valid), jnp.int32(offset), run_s, run_i,
                k=k, corpus_tile=self.cfg.corpus_tile, kind=kind)
            if not prefetch:
                jax.block_until_ready((run_s, run_i))  # fold before next copy
                if ci + 1 < len(self.chunks):
                    dev_next = jax.device_put(self.chunks[ci + 1])
                    if kind == "int8":
                        dev_next_s = jax.device_put(self.scales[ci + 1])
        run_s, run_i = run_s[:b], run_i[:b]
        if squeeze:
            return run_s[0], run_i[0]
        return run_s, run_i

    # -- persistence (raw .bin + memmap: the corpus never fits in one npz) --

    def save(self, path: str) -> None:
        """Raw contiguous .bin files + meta — loads back as an on-disk
        memmap (chunks become zero-copy views; pages fault in only as
        ``jax.device_put`` streams them)."""
        os.makedirs(path, exist_ok=True)
        d = self.chunks[0].shape[1]
        with open(os.path.join(path, "corpus.bin"), "wb") as f:
            for c in self.chunks:
                f.write(np.ascontiguousarray(c).tobytes())
        if self.scales[0] is not None:
            with open(os.path.join(path, "scales.bin"), "wb") as f:
                for s in self.scales:
                    f.write(np.ascontiguousarray(s).tobytes())
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump({"n": self.n, "d": d, "chunk_rows": self.chunk_rows,
                       "n_chunks": len(self.chunks),
                       "cfg": self.cfg.__dict__,
                       "kind": "streaming_flat"}, f)

    @classmethod
    def load(cls, path: str) -> "StreamingFlatIndex":
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        cfg = EngineConfig.from_saved(meta["cfg"])
        rows, d, nc = meta["chunk_rows"], meta["d"], meta["n_chunks"]
        if cfg.dtype == "int8":
            np_dt = np.dtype(np.int8)
        elif cfg.dtype == "float32":
            np_dt = np.dtype(np.float32)
        else:                       # bfloat16 via ml_dtypes (a jax dep)
            import ml_dtypes
            np_dt = np.dtype(ml_dtypes.bfloat16)
        raw = np.memmap(os.path.join(path, "corpus.bin"), dtype=np_dt,
                        mode="r", shape=(nc * rows, d))
        chunks = [raw[i * rows:(i + 1) * rows] for i in range(nc)]
        scales: list = [None] * nc
        if cfg.dtype == "int8":
            sraw = np.memmap(os.path.join(path, "scales.bin"),
                             dtype=np.float32, mode="r", shape=(nc * rows,))
            scales = [sraw[i * rows:(i + 1) * rows] for i in range(nc)]
        return cls(chunks=chunks, scales=scales, n=meta["n"], cfg=cfg,
                   chunk_rows=rows)

    @property
    def nbytes_host(self) -> int:
        n = sum(c.nbytes for c in self.chunks)
        return n + sum(s.nbytes for s in self.scales if s is not None)
