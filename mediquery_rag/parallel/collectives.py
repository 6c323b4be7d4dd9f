"""Cross-shard top-k merge over ICI.

BASELINE.json: "multi-chip shards merge partial top-k via all-gather over
ICI". Each shard computes a local (scores, global-indices) top-k; the merge
all-gathers the tiny ``[B, k]`` candidate lists (bytes, not the corpus) and
reduces with one final top-k. Cheap at small k: 8 shards x k=10 x B=64 is
~20 KB on the wire.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from mediquery_rag.ops.topk import merge_topk_many


def hierarchical_topk_merge(
    local_scores: jax.Array,
    local_idx: jax.Array,
    k: int,
    *,
    ici_axis: str,
    dcn_axis: str,
) -> tuple[jax.Array, jax.Array]:
    """Two-level merge for multi-slice deployments (DCN between slices).

    Level 1 rides ICI: all-gather the ``[B, kp]`` partials within the slice
    and reduce to k. Level 2 rides DCN: exchange only the k per-slice
    FINALISTS across slices and reduce once more. Per-chip DCN traffic drops
    from ``S_total*kp`` candidates (what a flat all-gather over the full mesh
    would ship over the slow inter-slice links) to ``S_dcn*k`` — the
    scaling-book layout rule: keep the wide collective on ICI, send only
    reduced results over DCN.

    Returns replicated ``([B, k], [B, k])`` on every chip of every slice.
    """
    s1, i1 = sharded_topk_merge(local_scores, local_idx, k, ici_axis)
    gs = jax.lax.all_gather(s1, dcn_axis)   # [S_dcn, B, k]
    gi = jax.lax.all_gather(i1, dcn_axis)
    return merge_topk_many(gs, gi, k)


def grouped_topk_merge(
    local_scores: jax.Array,
    local_idx: jax.Array,
    k: int,
    axes: tuple[str, ...],
) -> tuple[jax.Array, jax.Array]:
    """Merge partial top-k over 1 or 2 mesh axes.

    One axis -> the flat ICI all-gather merge; two axes ``(dcn, ici)`` ->
    the hierarchical merge (wide gather on ICI, k-finalist exchange on DCN).
    """
    if len(axes) == 1:
        return sharded_topk_merge(local_scores, local_idx, k, axes[0])
    if len(axes) == 2:
        return hierarchical_topk_merge(
            local_scores, local_idx, k, ici_axis=axes[1], dcn_axis=axes[0])
    raise ValueError(f"expected 1 or 2 mesh axes, got {axes!r}")


def sharded_topk_merge(
    local_scores: jax.Array,
    local_idx: jax.Array,
    k: int,
    axis_name: str,
) -> tuple[jax.Array, jax.Array]:
    """Inside shard_map: merge per-shard partial top-k into the global top-k.

    Args:
      local_scores/local_idx: this shard's ``[B, kp]`` partials (global ids).
      k: final neighbors to keep.
      axis_name: mesh axis to gather over (rides ICI on a real slice).

    Returns replicated ``([B, k], [B, k])`` on every shard.
    """
    gs = jax.lax.all_gather(local_scores, axis_name)  # [S, B, kp]
    gi = jax.lax.all_gather(local_idx, axis_name)
    return merge_topk_many(gs, gi, k)
