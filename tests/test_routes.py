"""The platform routes of ops/ and what they dispatch to, on the CPU.

- route choice by platform, and the error for a backend without a route;
- the Triton-route int8 matvec in Pallas interpret mode against XLA's
  dequantize-into-dot, at several shapes and through the stacked layer
  index (the kernel compiled for the GPU is checked in chip_smoke.py);
- the exact two-stage top-k and the Triton-route block top-k (interpret
  mode) against ``lax.top_k``, with padding rows masked through
  ``n_valid``;
- the compile-cache directory rule.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mediquery_rag import compile_cache
from mediquery_rag.ops import route
from mediquery_rag.ops.matvec import (quant_matvec, quantize_weight,
                                      triton_blocks)
from mediquery_rag.ops import topk as topk_mod
from mediquery_rag.ops.topk import (block_topk_triton, masked_topk,
                                    triton_topk_shape, two_stage_topk)


class TestRoutes:
    def test_cpu_takes_xla_everywhere(self):
        assert route.platform() == "cpu"
        assert set(route.table().values()) == {"xla"}

    def test_gpu_route_table(self):
        t = route.table("gpu")
        assert t["quant_matvec"] == "triton"
        assert t["flat_search"] == "xla"
        assert set(t) == set(route.ROUTES)

    def test_unknown_backend_raises(self, monkeypatch):
        monkeypatch.setattr(jax, "default_backend", lambda: "metal")
        with pytest.raises(RuntimeError, match="no route"):
            route.platform()
        from mediquery_rag.ops.scoring import flat_search
        c = jnp.zeros((256, 8), jnp.float32)
        with pytest.raises(RuntimeError, match="no route"):
            flat_search(jnp.zeros((2, 8)), c, 4, corpus_tile=256)

    def test_every_op_routes_on_both_platforms(self):
        for op, routes in route.ROUTES.items():
            assert set(routes) == set(route.PLATFORMS), op


def _weights(layers, d, f, seed=0):
    rng = np.random.default_rng(seed)
    w = jnp.asarray(rng.standard_normal((layers, d, f)).astype(np.float32))
    return jax.lax.map(quantize_weight, w)


class TestTritonMatvecInterpret:
    @pytest.mark.parametrize("b,d,f", [
        (1, 64, 128),        # one row, one block_k
        (5, 256, 384),       # rows pad to 16, f not a power of two
        (16, 512, 1024),     # a full row tile, several k steps
        (32, 128, 256),      # two row tiles, block_k cut to fit a stage
    ])
    def test_matches_xla_dequant_dot(self, b, d, f):
        q, s = _weights(1, d, f, seed=b)
        x = jnp.asarray(np.random.default_rng(b).standard_normal((b, d)),
                        jnp.bfloat16)
        got = quant_matvec(x, q[0], s[0], impl="triton", interpret=True)
        ref = quant_matvec(x, q[0], s[0], impl="xla")
        assert got.shape == (b, f) and got.dtype == jnp.float32
        # same bf16 products, f32 sums in another order: |err| <~ 1e-5 rel
        np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                                   rtol=1e-4, atol=1e-3)

    @pytest.mark.parametrize("layer", [0, 1, 2])
    def test_stacked_layer_index(self, layer):
        q, s = _weights(3, 128, 256, seed=7)
        x = jnp.asarray(np.random.default_rng(1).standard_normal((4, 128)),
                        jnp.bfloat16)
        got = quant_matvec(x, q, s, layer=jnp.int32(layer), impl="triton",
                           interpret=True)
        ref = quant_matvec(x, q[layer], s[layer], impl="xla")
        np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                                   rtol=1e-4, atol=1e-3)

    def test_rows_independent_of_batch(self):
        """A row's result does not depend on how many rows ride along (the
        server-vs-lockstep greedy invariant rests on it)."""
        q, s = _weights(1, 256, 128, seed=3)
        x = jnp.asarray(np.random.default_rng(2).standard_normal((9, 256)),
                        jnp.bfloat16)
        full = quant_matvec(x, q[0], s[0], impl="triton", interpret=True)
        one = quant_matvec(x[4:5], q[0], s[0], impl="triton",
                           interpret=True)
        np.testing.assert_array_equal(np.asarray(full[4:5]),
                                      np.asarray(one))

    def test_block_choice(self):
        assert triton_blocks(4608, 3584) == (16, 128)
        assert triton_blocks(37888, 3584)[1] == 128
        assert triton_blocks(3584, 18944) == (16, 128)
        assert triton_blocks(100, 64) is None       # no 16-multiple tiling
        # 32 rows: the stage's tiles would take 64 KB, so block_k halves
        assert triton_blocks(37888, 3584, rows=32) == (64, 64)
        assert triton_blocks(37888, 3584, rows=16) == (64, 128)

    def test_prefill_rows_take_xla(self):
        """More rows than a decode step (a prefill chunk) run XLA's GEMM,
        whatever the route says."""
        q, s = _weights(1, 128, 256)
        x = jnp.asarray(np.random.default_rng(0).standard_normal((40, 128)),
                        jnp.bfloat16)
        got = quant_matvec(x, q[0], s[0], impl="triton", interpret=True)
        ref = quant_matvec(x, q[0], s[0], impl="xla")
        np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))

    def test_untileable_shape_takes_xla(self):
        q, s = _weights(1, 64, 100)
        x = jnp.ones((2, 64), jnp.bfloat16)
        got = quant_matvec(x, q[0], s[0], impl="triton", interpret=True)
        ref = quant_matvec(x, q[0], s[0], impl="xla")
        np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))

    def test_bad_impl_raises(self):
        q, s = _weights(1, 64, 128)
        with pytest.raises(ValueError, match="impl"):
            quant_matvec(jnp.ones((1, 64)), q[0], s[0], impl="mosaic")


class TestTwoStageTopk:
    @pytest.mark.parametrize("b,n,k,block", [
        (3, 4096, 10, 512), (1, 2048, 1, 256), (7, 1024, 32, 128),
        (2, 1000, 5, 256),            # not a whole number of blocks
    ])
    def test_matches_lax_top_k(self, b, n, k, block):
        s = jax.random.normal(jax.random.PRNGKey(n + k), (b, n))
        v1, i1 = two_stage_topk(s, k, block)
        v2, i2 = jax.lax.top_k(s, k)
        np.testing.assert_array_equal(np.asarray(v1), np.asarray(v2))
        np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))

    def test_padding_rows_never_selected(self):
        s = jax.random.normal(jax.random.PRNGKey(0), (4, 2048))
        s = s.at[:, 1500:].set(100.0)           # pad rows score highest
        v, i = masked_topk(s, 1500, 8, 256)
        assert int(jnp.max(i)) < 1500
        v2, i2 = jax.lax.top_k(s[:, :1500], 8)
        np.testing.assert_array_equal(np.asarray(i), np.asarray(i2))

    def test_ties_take_lowest_index(self):
        s = jnp.zeros((1, 1024)).at[0, jnp.array([700, 5, 300])].set(1.0)
        _, i = two_stage_topk(s, 3, 256)
        assert np.asarray(i).tolist() == [[5, 300, 700]]


class TestBlockTopkInterpret:
    """The Triton-route block top-k kernel (the GPU's selection stage of
    every flat search) in Pallas interpret mode: ids and scores equal to
    ``lax.top_k`` over the valid columns."""

    @pytest.mark.parametrize("b,n,n_valid,k,block", [
        (16, 4096, 4000, 10, 512),    # pad columns inside the last tile
        (1, 2048, 2048, 1, 256),      # one row, no padding
        (32, 1000, 777, 16, 256),     # two row tiles, N not whole tiles
        (4, 4096, 100, 10, 1024),     # every valid column in one tile
    ])
    def test_matches_lax_top_k(self, b, n, n_valid, k, block):
        s = jax.random.normal(jax.random.PRNGKey(b + k), (b, n))
        v, i = block_topk_triton(s, n_valid, k=k, block=block,
                                 interpret=True)
        v2, i2 = jax.lax.top_k(s[:, :n_valid], k)
        np.testing.assert_array_equal(np.asarray(i), np.asarray(i2))
        np.testing.assert_array_equal(np.asarray(v), np.asarray(v2))

    def test_ties_take_lowest_index(self):
        s = jnp.zeros((1, 2048)).at[0, jnp.array([1900, 7, 600])].set(1.0)
        _, i = block_topk_triton(s, 2048, k=3, block=512, interpret=True)
        assert np.asarray(i).tolist() == [[7, 600, 1900]]

    def test_tile_shape(self):
        assert triton_topk_shape(64, 10) == (16, 16)
        assert triton_topk_shape(4, 1) == (4, 1)
        assert triton_topk_shape(3, 10) is None      # no pow2 row tile
        assert triton_topk_shape(64, 100) is None    # k too large

    def test_masked_topk_routes_to_kernel(self, monkeypatch):
        """On a platform routed to "triton", masked_topk calls the kernel
        with a power-of-two tile; shapes the kernel cannot take fall back
        to the two-stage XLA top-k."""
        calls = []
        monkeypatch.setitem(route.ROUTES["block_topk"], "cpu", "triton")
        monkeypatch.setattr(
            topk_mod, "block_topk_triton",
            lambda s, nv, *, k, block: calls.append(block) or
            two_stage_topk(s, k, block))
        s = jax.random.normal(jax.random.PRNGKey(0), (4, 3072))
        masked_topk(s, 3072, 5, 1536)
        assert calls == [1024]
        masked_topk(s[:3], 3072, 5, 1536)            # 3 rows: XLA
        assert calls == [1024]


class TestCompileCache:
    def test_default_is_repo_dir(self, monkeypatch):
        monkeypatch.delenv(compile_cache.ENV, raising=False)
        assert compile_cache.cache_dir() == compile_cache.DEFAULT_DIR
        assert compile_cache.DEFAULT_DIR.endswith(".jax_cache")
        import os
        assert os.path.dirname(compile_cache.DEFAULT_DIR) == \
            compile_cache.REPO_ROOT

    def test_env_wins_and_nothing_else_is_set(self, monkeypatch, tmp_path):
        monkeypatch.setenv(compile_cache.ENV, str(tmp_path))
        seen = {}
        monkeypatch.setattr(jax.config, "update",
                            lambda k, v: seen.__setitem__(k, v))
        assert compile_cache.enable() == str(tmp_path)
        assert "jax_compilation_cache_dir" not in seen

    def test_default_sets_the_repo_dir(self, monkeypatch):
        monkeypatch.delenv(compile_cache.ENV, raising=False)
        seen = {}
        monkeypatch.setattr(jax.config, "update",
                            lambda k, v: seen.__setitem__(k, v))
        compile_cache.enable()
        assert seen["jax_compilation_cache_dir"] == \
            compile_cache.DEFAULT_DIR
