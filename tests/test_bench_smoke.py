"""Smoke test of bench.py's OWN wiring (the driver-captured headline artifact).

A retune of one dtype's tile that leaves another dtype's pad behind would
crash the headline artifact while every op test stays green. This test
executes the exact prep+search functions main() uses, at tiny N
with deliberately DIFFERENT per-dtype tiles none of which divide N, so any
future retune that desynchronizes a pad from its tile fails here first.
"""

import jax.numpy as jnp
import numpy as np

import bench


class TestBenchWiring:
    def test_prep_and_search_with_mismatched_tiles(self):
        # n divides none of the tiles; tiles differ per dtype (the r3 trap)
        n, d, b, iters = 1000, 128, 8, 2
        tc, tc8, tc4 = 256, 512, 128
        data = bench.prep_corpus(n=n, d=d, b=b, iters=iters,
                                 tc=tc, tc8=tc8, tc4=tc4)
        c, c_bf16, c_pad, c8p, csp, c4p, cs4p, qs = data
        n_pad, n_pad8, n_pad4 = bench.pads(n, tc, tc8, tc4)
        assert c_pad.shape == (n_pad, d) and n_pad % tc == 0
        assert c8p.shape == (n_pad8, d) and n_pad8 % tc8 == 0
        assert csp.shape == (n_pad8,)
        assert c4p.shape[0] == n_pad4 // 2 and n_pad4 % tc4 == 0
        assert qs.shape == (iters, b, d)

        r = bench.run_searches(data, n=n, k=10, tc=tc, tc8=tc8,
                               tc4=tc4, rerank=4)
        # unit-norm gaussians at n=1000: every quantized path should agree
        # closely with the f32 oracle
        assert r["recall_bf16"] >= 0.95
        assert r["recall_int8"] >= 0.90
        assert r["recall_int4_rr"] >= 0.90
        assert r["i_rr"].shape == (b, 10)
        assert int(jnp.max(r["i_rr"])) < n  # padding rows never surface

    def test_headline_constants_are_consistent(self):
        """The shipping constants themselves: each pad divides its tile."""
        n_pad, n_pad8, n_pad4 = bench.pads(bench.N, bench.TC, bench.TC8,
                                           bench.TC4)
        assert n_pad % bench.TC == 0
        assert n_pad8 % bench.TC8 == 0
        assert n_pad4 % bench.TC4 == 0
        # int4 row-pair layout needs an even padded row count
        assert n_pad4 % 2 == 0

    def test_host_rerank_stage_shapes(self):
        """The host-rerank stage main() times, at tiny shapes."""
        from mediquery_rag.engine.flat import host_rerank
        n, d, b, k, rerank = 200, 64, 4, 5, 4
        refine = np.random.default_rng(0).standard_normal((n, d)).astype(
            np.float16)
        q = np.random.default_rng(1).standard_normal((b, d)).astype(
            np.float32)
        s = np.zeros((b, rerank * k), np.float32)
        i = np.random.default_rng(2).integers(0, n, (b, rerank * k))
        out_s, out_i = host_rerank(refine, q, s, i, k, cosine=False)
        assert out_i.shape == (b, k)
