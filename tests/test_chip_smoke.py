"""chip_smoke.py's phases at tiny sizes on the CPU route, and its refusal
to run without a GPU. The full-size run is ``python chip_smoke.py`` on the
card; the ``gpu``-marked tests run its phases there and skip elsewhere."""

import os
import shutil

import jax
import pytest

import chip_smoke as cs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _all_ok(result):
    bad = [c for c in result["checks"] if not c["ok"]]
    assert not bad, (result["phase"], bad)


@pytest.fixture(scope="module")
def meter():
    return cs.CompileMeter()


@pytest.fixture
def gpu():
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a CUDA GPU (runs chip_smoke.py phases there)")


def test_main_refuses_cpu(capsys):
    assert cs.main([]) == 2
    out = capsys.readouterr()
    assert out.out == ""                       # no result line
    assert "needs a CUDA GPU" in out.err


@pytest.mark.parametrize("kind", ["bf16_flat", "int8_flat", "int4_flat",
                                  "int8_ivf"])
def test_phase_a_tiny(meter, kind):
    (r,) = list(cs.phase_a(meter, rows=20_000, dim=256, batch=8, k=10,
                           chunk=5_000, nlist=16, nprobe=8,
                           corpus_tile=256, kinds=(kind,)))
    assert r["phase"] == f"A.{kind}"
    assert set(r["routes"].values()) == {"xla"}
    _all_ok(r)


def test_phase_b_tiny(meter):
    r = cs.phase_b(meter, batch=4, seq=16, cfg_kw=dict(
        vocab_size=512, hidden=64, layers=2, heads=4, mlp_dim=128,
        max_len=32))
    assert r["tokens_per_query"] == 16
    _all_ok(r)


def test_phase_c_tiny(meter, tmp_path):
    os.makedirs(tmp_path / "data")
    shutil.copy(os.path.join(ROOT, "data", "medical_data.txt"),
                tmp_path / "data")
    rs = list(cs.phase_c(
        meter, cfg_kw=dict(hidden=64, layers=2, heads=4, kv_heads=2,
                           mlp_dim=128, vocab_size=384),
        max_len=512, prompt_bytes=(20, 60, 100, 140), max_new=8,
        n_qa=1, n_search=2, root=str(tmp_path)))
    assert [r["phase"] for r in rs] == ["C.lm_bf16", "C.lm_int8"]
    for r in rs:
        assert r["greedy_exact"] == 4
        assert r["cuts"]["max_len"] == {"published": 131072, "used": 512}
        _all_ok(r)


def test_phase_d_tiny(meter):
    rs = list(cs.phase_d(meter, rows=40_000, dim=64, batch=8, k=10,
                         chunk=5_000, nlist=16, nprobe=8, corpus_tile=250,
                         n_devices=4))
    assert [r["phase"] for r in rs] == ["D.sharded_bf16_flat",
                                        "D.sharded_int8_ivf"]
    for r in rs:
        assert len(r["shard_rows"]) == 4     # one shard per device
        _all_ok(r)


def test_corpus_chunks_match_materialized():
    c = cs.Corpus(12_000, 32, 1, chunk=4_000)
    whole = c.materialize()
    parts = list(c.chunks())
    assert sum(p.shape[0] for p in parts) == 12_000
    assert bool((jax.numpy.concatenate(parts) == whole).all())


@pytest.mark.gpu
def test_chip_smoke_phases_on_gpu(gpu, meter):
    """Phase B at full width on the card (the cheapest full-size phase)."""
    _all_ok(cs.phase_b(meter))


@pytest.mark.gpu
def test_kernels_match_plain_on_gpu(gpu):
    """The two Triton-route kernels, compiled for the card, against their
    plain XLA versions (the same comparisons as phases A and C)."""
    import jax.numpy as jnp

    from mediquery_rag.ops.matvec import quantize_decoder_params

    c = cs.Corpus(1_000_000, 768, 0, chunk=62_500)
    corpus = c.materialize()
    _, checks = cs.compare_block_topk(c.queries(64), corpus, 999_000, 10,
                                      2048)
    assert all(ch["ok"] for ch in checks), checks
    key = jax.random.PRNGKey(0)
    params = {"blocks": {n: jax.random.normal(key, (2, 3584, f), jnp.bfloat16)
                         for n, f in (("qkv", 4608), ("attn_out", 3584),
                                      ("w_gate", 18944), ("w_up", 18944))},
              "lm_head": jax.random.normal(key, (3584, 4096), jnp.bfloat16)}
    params["blocks"]["w_down"] = jax.random.normal(key, (2, 18944, 3584),
                                                   jnp.bfloat16)
    _, checks = cs.compare_quant_matvec(quantize_decoder_params(params))
    assert all(ch["ok"] for ch in checks), checks
