"""On-device spherical k-means — the IVF coarse quantizer trainer.

Chroma's HNSW has no training phase; the accelerator-native IVF index replaces graph
construction with k-means clustering done entirely on device: assignment is
a [chunk, nlist] matmul + argmax, the centroid update a scatter-add of the
row data (an earlier one-hot matmul materialized ~13 GB of memory traffic
per Lloyd iteration at 262K x 4096). Build cost per Lloyd iteration is
~2*S*nlist*D FLOPs, so at the 10M build's sample size the wall cost is
compile + host control more than device work.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


@functools.partial(
    jax.jit, static_argnames=("nlist", "iters", "chunk", "balance")
)
def kmeans(
    x: jax.Array,
    key: jax.Array,
    *,
    nlist: int,
    iters: int = 10,
    chunk: int = 8192,
    # chunk sizes the [chunk, nlist] one-hot HBM footprint of the centroid
    # update; 8192 x 1024 f32 = 32 MB keeps the Lloyd scan bandwidth-sane
    balance: float = 0.0,
    init: jax.Array | None = None,
) -> jax.Array:
    """Spherical k-means. ``x``: [S, D] L2-normalized f32. Returns [nlist, D].

    Centroids stay L2-normalized each iteration so assignment == cosine
    argmax. Empty clusters keep their previous centroid.

    ``balance > 0`` penalizes oversubscribed clusters during assignment
    (score - balance * (count/avg - 1), counts from the previous Lloyd
    pass): the bucket layout's cap is set by the LARGEST cluster, so a
    skewed clustering costs cap/avg in both HBM and probe DMA. Typical
    values 0.02-0.1 (cosine scores live in [-1, 1]).

    ``init`` ([nlist, D]) skips the random-row initialization — used by
    ``split_oversized`` to polish split centroids with a few Lloyd steps.
    """
    s, d = x.shape
    chunk = min(chunk, s)
    n_chunks = -(-s // chunk)
    s_pad = n_chunks * chunk
    xp = jnp.pad(x, ((0, s_pad - s), (0, 0)))
    valid = (jnp.arange(s_pad) < s).astype(jnp.float32)
    xc = xp.reshape(n_chunks, chunk, d)
    vc = valid.reshape(n_chunks, chunk)
    avg = s / nlist

    if init is not None:
        cents0 = init
    else:
        perm = jax.random.permutation(key, s)[:nlist]
        cents0 = x[perm]

    def lloyd(carry, _):
        cents, prev_counts = carry
        penalty = balance * (prev_counts / avg - 1.0) if balance else None

        def per_chunk(acc, inp):
            sums, counts = acc
            xb, vb = inp
            scores = jnp.dot(xb, cents.T, preferred_element_type=jnp.float32)
            if penalty is not None:
                scores = scores - penalty[None, :]
            assign = jnp.argmax(scores, axis=-1)                    # [chunk]
            # centroid update via scatter-add, NOT a one-hot matmul: the
            # [chunk, nlist] one-hot materializes 134 MB/chunk at
            # 8192 x 4096 and its two consumers re-read it — ~13 GB of
            # HBM traffic per Lloyd iteration at 262K x 4096, which made
            # an 8-iteration fit (<1 s of device FLOPs) cost ~80 s wall
            # (r4 streaming-build breakdown). The scatter writes only the
            # 25 MB of row data.
            assign = jnp.where(vb > 0, assign, nlist)   # pad rows -> OOB,
            sums = sums.at[assign].add(xb, mode="drop")  # dropped by scatter
            counts = counts.at[assign].add(jnp.ones_like(vb), mode="drop")
            return (sums, counts), None

        (sums, counts), _ = jax.lax.scan(
            per_chunk,
            (jnp.zeros((nlist, d), jnp.float32), jnp.zeros((nlist,), jnp.float32)),
            (xc, vc),
        )
        new = jnp.where(counts[:, None] > 0, sums / jnp.maximum(counts[:, None], 1), cents)
        norm = jnp.linalg.norm(new, axis=-1, keepdims=True)
        new = new / jnp.maximum(norm, 1e-12)
        return (new, counts), None

    (cents, _), _ = jax.lax.scan(
        lloyd, (cents0, jnp.full((nlist,), avg, jnp.float32)), None,
        length=iters)
    return cents


def split_oversized(
    sample: jax.Array,
    cents: jax.Array,
    *,
    cap_rows: int,
    n_total: int,
    margin: float = 0.85,
    max_iters: int = 16,
    polish_iters: int = 2,
    balance: float = 0.1,
) -> jax.Array:
    """Balanced-split refinement: bound the largest cluster under the cap.

    On clustered corpora the bounded-cap layout's weakness is systemic:
    dense regions overflow *together*, so rows evicted from a full bucket
    find every nearby bucket full too and land far away — unreachable at
    any practical nprobe (measured r4, 10M x 768 / 1024 natural clusters:
    28% of rows alt-placed, recall@10 plateaus at 0.94 by nprobe 32).
    The fix is to make capacity where the density is: clusters whose
    SAMPLE-estimated row count exceeds ``margin * cap_rows`` are split in
    two (centroid pulled toward two distinct member rows), and the
    centroid slots are recycled from the smallest clusters — nlist, and
    therefore the bucket array's HBM, never changes. A few Lloyd polish
    steps re-settle the split centroids. Host control / device matmuls;
    per iteration cost is one sample assignment (~ms at 262K x 4096).

    ``sample``: [S, D] the k-means training sample (L2-normalized).
    ``cap_rows``: the layout cap the builder will enforce, in CORPUS rows.
    ``n_total``: corpus rows (sample counts scale by n_total/S).
    """
    import numpy as np

    s = sample.shape[0]
    nlist = cents.shape[0]
    cap_sample = cap_rows * s / n_total * margin
    # all device work runs at FIXED shapes: the number of splits varies
    # every iteration, and eager ops at a novel shape are each a fresh
    # compile. Indices are padded
    # to K_SPLIT = nlist//2 — the theoretical per-iteration maximum
    # (every split consumes a victim), so the cap never drops splits the
    # unbounded loop would have made; pad slots carry the OOB index nlist
    # and are dropped by the scatter. The padded gathers/scatters cost
    # ~6 MB at nlist=4096 — noise next to the assignment matmul.
    K_SPLIT = nlist // 2

    def pad_idx(a: np.ndarray, fill: int) -> jax.Array:
        a = a[:K_SPLIT]
        return jnp.asarray(np.pad(a, (0, K_SPLIT - a.size),
                                  constant_values=fill).astype(np.int32))

    # two polish regimes, best iterate wins. A size-balance penalty in the
    # polish keeps split children apart when EVERY region is dense (10M
    # clustered sample: overflow mass 0.20 of rows unpenalized vs 0.03
    # penalized) — but on heavily SKEWED data the penalty lets sparse
    # clusters poach from dense ones and drags child centroids out of the
    # very balls they were split for (12K/128 test geometry: unpenalized
    # bounds the max cluster, penalized leaves it 1.5x over). Neither
    # setting wins both, so: a penalized phase, then an unpenalized phase,
    # and every iterate is scored by its TRUE (unpenalized-assignment)
    # overflow mass — the best one is returned.
    best_mass, best_cents = np.inf, cents
    for bal in [balance] * max_iters + [0.0] * max_iters:
        asg = np.asarray(assign_clusters(sample, cents))
        counts = np.bincount(asg, minlength=nlist)
        mass = float(np.maximum(counts - cap_sample, 0).sum())
        if mass < best_mass:
            best_mass, best_cents = mass, cents
        over = np.where(counts > cap_sample)[0]
        if over.size == 0:
            break
        over = over[np.argsort(-counts[over])]
        over_set = set(over.tolist())
        victims = np.array([c for c in np.argsort(counts)
                            if c not in over_set][:over.size])
        over = over[:victims.size]
        if over.size == 0:
            break
        # two distinct member rows per split cluster (first + median of the
        # sorted-by-cluster order) pull the two child centroids apart along
        # the cluster's own spread — cheaper than a 2-means and enough,
        # since the Lloyd polish below re-settles them
        order = np.argsort(asg, kind="stable")
        starts = np.searchsorted(asg[order], over, side="left")
        first = order[starts]
        mid = order[starts + counts[over] // 2]
        cents = _apply_split(cents, sample, pad_idx(over, nlist),
                             pad_idx(victims, nlist), pad_idx(first, 0),
                             pad_idx(mid, 0))
        if polish_iters:
            # polish INSIDE the loop: the next iteration's count check then
            # verifies the post-Lloyd sizes, so the exit condition really
            # means "no cluster exceeds the cap estimate"
            cents = kmeans(sample, jax.random.PRNGKey(0), nlist=nlist,
                           iters=polish_iters, init=cents, balance=bal)
    else:
        # loop exhausted without converging: the final iterate was split +
        # polished but never scored — score it
        counts = np.bincount(np.asarray(assign_clusters(sample, cents)),
                             minlength=nlist)
        mass = float(np.maximum(counts - cap_sample, 0).sum())
        if mass < best_mass:
            best_mass, best_cents = mass, cents
    # a convergence break scored the converged iterate (mass 0) as best
    # just before breaking, so best_cents is correct on every exit path
    return best_cents


@jax.jit
def _apply_split(cents, sample, over, victims, first, mid):
    """One split application at fixed [K_SPLIT] index shapes. Pad slots
    hold the OOB index ``nlist`` — their gather clips (harmless, the row
    is never written) and their scatter drops."""
    c_over = cents[over]                      # OOB gather clips
    m1 = sample[first]
    m2 = sample[mid]
    c1 = _renorm(0.5 * (c_over + m1))
    c2 = _renorm(0.5 * (c_over + m2))
    cents = cents.at[over].set(c1, mode="drop")
    cents = cents.at[victims].set(c2, mode="drop")
    return cents


@jax.jit
def _renorm(v: jax.Array) -> jax.Array:
    return v / jnp.maximum(jnp.linalg.norm(v, axis=-1, keepdims=True), 1e-12)


@functools.partial(jax.jit, static_argnames=("chunk",))
def assign_clusters(x: jax.Array, cents: jax.Array, *, chunk: int = 65536) -> jax.Array:
    """Nearest-centroid assignment for every row of ``x``. Returns [N] i32."""
    n, d = x.shape
    chunk = min(chunk, n)
    n_chunks = -(-n // chunk)
    n_pad = n_chunks * chunk
    xp = jnp.pad(x, ((0, n_pad - n), (0, 0))).reshape(n_chunks, chunk, d)

    def per_chunk(_, xb):
        scores = jnp.dot(xb, cents.T, preferred_element_type=jnp.float32)
        return None, jnp.argmax(scores, axis=-1).astype(jnp.int32)

    _, out = jax.lax.scan(per_chunk, None, xp)
    return out.reshape(n_pad)[:n]


@functools.partial(jax.jit, static_argnames=("r", "chunk"))
def assign_clusters_topr(
    x: jax.Array, cents: jax.Array, *, r: int, chunk: int = 65536
) -> tuple[jax.Array, jax.Array]:
    """Top-``r`` nearest centroids per row, with scores.

    Returns (cluster ids [N, r] i32 best-first, scores [N, r] f32). Feeds
    the bounded-cap bucket layout: overflow rows fall back to their
    next-best cluster instead of inflating the global cap.
    """
    n, d = x.shape
    chunk = min(chunk, n)
    n_chunks = -(-n // chunk)
    n_pad = n_chunks * chunk
    xp = jnp.pad(x, ((0, n_pad - n), (0, 0))).reshape(n_chunks, chunk, d)

    def per_chunk(_, xb):
        # bf16 inputs halve the matmul cost of the [chunk, nlist] assignment
        # matmul (63 TFLOP at 10M x 4096); accumulation stays f32 and
        # near-boundary flips only trade which probe finds a row
        scores = jnp.dot(xb.astype(jnp.bfloat16),
                         cents.T.astype(jnp.bfloat16),
                         preferred_element_type=jnp.float32)
        s, i = jax.lax.top_k(scores, r)
        return None, (i.astype(jnp.int32), s)

    _, (ids, scores) = jax.lax.scan(per_chunk, None, xp)
    return ids.reshape(n_pad, r)[:n], scores.reshape(n_pad, r)[:n]
