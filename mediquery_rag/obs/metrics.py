"""Recall / QPS / latency measurement.

``device_time`` runs N iterations inside ONE jitted ``lax.scan`` whose
carry depends on every iteration's output, fetches a scalar once,
subtracts a measured no-op round trip and divides by N: per-call host
dispatch and synchronization costs drop out of the number.
"""

from __future__ import annotations

import time
from contextlib import contextmanager

import jax
import jax.numpy as jnp
import numpy as np


def recall_at_k(found_idx, true_idx) -> float:
    """Mean overlap fraction between found and ground-truth index lists.

    Shapes [B, k] (or [k]); returns a float in [0, 1].
    """
    f = np.asarray(found_idx)
    t = np.asarray(true_idx)
    if f.ndim == 1:
        f, t = f[None], t[None]
    hits = 0
    for r in range(f.shape[0]):
        hits += len(set(f[r].tolist()) & set(t[r].tolist()))
    return hits / (t.shape[0] * t.shape[1])


def _scalarize(out) -> jax.Array:
    leaves = jax.tree_util.tree_leaves(out)
    acc = jnp.float32(0)
    for leaf in leaves:
        acc = acc + jnp.sum(leaf).astype(jnp.float32)
    return acc


def device_time(fn, stacked_inputs, *consts, iters: int | None = None,
                reps: int = 5) -> float:
    """Seconds per iteration of ``fn(x, *consts)`` measured on device.

    ``stacked_inputs``: pytree whose leaves have a leading iteration axis.
    Every iteration's output feeds a scalar accumulator so nothing can be
    elided, cached, or reordered away.
    """
    first = jax.tree_util.tree_leaves(stacked_inputs)[0]
    n = first.shape[0] if iters is None else iters

    @jax.jit
    def many(xs, *cs):
        def body(acc, x):
            return acc + _scalarize(fn(x, *cs)), None
        acc, _ = jax.lax.scan(body, jnp.float32(0), xs)
        return acc

    # two-point measurement: time n iterations and n/2 iterations and take
    # the difference — the fixed per-call overhead (host round trip,
    # dispatch) appears in BOTH and cancels, unlike subtracting a separately
    # measured no-op (whose jitter can exceed a fast kernel's total time and
    # drive the estimate negative)
    half = max(n // 2, 1)
    xs_half = jax.tree_util.tree_map(lambda l: l[:half], stacked_inputs)

    float(many(stacked_inputs, *consts))  # compile + warm
    if half != n:
        float(many(xs_half, *consts))

    def best(f, *a):
        b = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            float(f(*a))
            b = min(b, time.perf_counter() - t0)
        return b

    t_total = best(many, stacked_inputs, *consts)
    if half == n:
        return t_total / n
    t_half = best(many, xs_half, *consts)
    dt = t_total - t_half
    if dt <= 0:
        # jitter swamped the kernel; report the conservative upper bound
        return t_total / n
    return dt / (n - half)


class Timer:
    """Host-side wall-clock stage timer (for the agent/app layers, where
    ~ms accuracy is fine). Collects p50/p99 per stage label."""

    def __init__(self):
        self.samples: dict[str, list[float]] = {}

    @contextmanager
    def stage(self, label: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.samples.setdefault(label, []).append(time.perf_counter() - t0)

    def summary(self) -> dict[str, dict[str, float]]:
        out = {}
        for label, xs in self.samples.items():
            a = np.asarray(xs)
            out[label] = {
                "count": len(xs),
                "mean_s": float(a.mean()),
                "p50_s": float(np.percentile(a, 50)),
                "p99_s": float(np.percentile(a, 99)),
            }
        return out


@contextmanager
def trace(label: str):
    """jax.profiler annotation wrapper (no-op overhead when not profiling)."""
    with jax.profiler.TraceAnnotation(label):
        yield


# --- MFU accounting -----------------------------------------------------------
# One stated FLOP model for every compute-bound number, so "fast" claims are
# checkable against the device's ceiling. The peak is the caller's: a table
# of published peaks keyed by device kind belongs with the benchmark.


def lm_matmul_flops(*, hidden: int, layers: int, mlp_dim: int,
                    vocab: int, heads: int, kv_heads: int | None,
                    seq_len: int, causal: bool = True,
                    swiglu: bool = True) -> float:
    """Per-TOKEN matmul FLOPs of one LM forward pass (matmul work only —
    norms/softmax/rope are noise at these shapes).

    Counts 2*m*n*k per matmul: qkv (GQA-sized), attn_out, SwiGLU's three
    projections, lm_head, plus attention's QK^T and PV at the average
    causal visible length S/2. For a dense model this is the familiar
    ~2N + attention; training model-FLOPs are 3x (fwd + 2x bwd — the MFU
    convention counts NO remat recompute, so remat shows up as lower
    hardware efficiency, not a bigger numerator)."""
    kvh = kv_heads or heads
    dh = hidden // heads
    per_layer = (
        2 * hidden * (heads * dh + 2 * kvh * dh)     # qkv projection
        + 2 * hidden * hidden                        # attn_out
        # SwiGLU: gate, up, down; GELU encoder (Embedder): wi, wo
        + (3 if swiglu else 2) * 2 * hidden * mlp_dim
    )
    vis = seq_len / 2 if causal else seq_len
    attn = 2 * 2 * heads * dh * vis                  # QK^T + PV
    return layers * (per_layer + attn) + 2 * hidden * vocab


def mfu(flops_per_token: float, tokens_per_s: float,
        peak: float) -> float:
    """Model-FLOPs utilization in [0, 1] against ``peak`` FLOP/s."""
    return flops_per_token * tokens_per_s / peak
