"""Beyond-HBM streaming tier tests (engine/streaming.py): chunked exact
search vs oracle, uneven tails, block builds, memmap persistence."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mediquery_rag.config import EngineConfig
from mediquery_rag.engine import FlatIndex, StreamingFlatIndex
from mediquery_rag.obs import recall_at_k
from mediquery_rag.ops import flat_search_xla


def _vecs(n, d, seed=0):
    x = jax.random.normal(jax.random.PRNGKey(seed), (n, d))
    return x / jnp.linalg.norm(x, axis=-1, keepdims=True)


CFG8 = EngineConfig(dim=64, dtype="int8", corpus_tile=256)
CFGF = EngineConfig(dim=64, dtype="float32", corpus_tile=256)


class TestStreamingFlatIndex:
    def test_f32_streaming_matches_oracle(self):
        """float chunks: streamed exact search == the one-shot oracle."""
        c = _vecs(3000, 64)
        q = _vecs(7, 64, seed=1)
        idx = StreamingFlatIndex.build(np.asarray(c), CFGF, chunk_rows=1024)
        assert len(idx.chunks) == 3          # 1024+1024+952(padded)
        s, i = idx.search(q, k=10)
        s_ref, i_ref = flat_search_xla(q, c, 10)
        np.testing.assert_array_equal(np.asarray(i), np.asarray(i_ref))
        np.testing.assert_allclose(np.asarray(s), np.asarray(s_ref),
                                   rtol=1e-5)

    def test_int8_recall_matches_resident_int8(self):
        """The streamed int8 scan gives the SAME results as the HBM-resident
        int8 FlatIndex (same kernel, same quantization) and >=0.95 recall
        vs f32."""
        c = _vecs(4000, 64, seed=2)
        q = _vecs(6, 64, seed=3)
        stream = StreamingFlatIndex.build(np.asarray(c), CFG8,
                                          chunk_rows=1024)
        resident = FlatIndex.build(c, CFG8)
        _, i_s = stream.search(q, k=10)
        _, i_r = resident.search(q, k=10)
        _, i_ref = flat_search_xla(q, c, 10)
        assert recall_at_k(i_s, i_ref) >= 0.95
        np.testing.assert_array_equal(np.asarray(i_s), np.asarray(i_r))

    def test_host_prep_matches_device_prep(self):
        """prep='host' (numpy quantization) produces the same codes/scales
        as the device path — same f32 math, same round-half-to-even — and
        identical search results."""
        c = _vecs(2500, 64, seed=9)
        dev = StreamingFlatIndex.build(np.asarray(c), CFG8, chunk_rows=1024)
        host = StreamingFlatIndex.build(np.asarray(c), CFG8, chunk_rows=1024,
                                        prep="host")
        for cd, ch, sd, sh in zip(dev.chunks, host.chunks,
                                  dev.scales, host.scales):
            assert np.abs(cd.astype(np.int32) - ch.astype(np.int32)).max() <= 1
            np.testing.assert_allclose(sd, sh, rtol=1e-6)
        q = _vecs(5, 64, seed=10)
        _, i_d = dev.search(q, k=10)
        _, i_h = host.search(q, k=10)
        assert recall_at_k(i_h, i_d) >= 0.95

    def test_host_prep_rejects_non_int8(self):
        with pytest.raises(ValueError):
            StreamingFlatIndex.build(np.zeros((10, 64), np.float32), CFGF,
                                     prep="host")
        with pytest.raises(ValueError):
            StreamingFlatIndex.build(np.zeros((10, 64), np.float32), CFG8,
                                     prep="gpu")

    def test_single_query_squeeze_and_tail_masking(self):
        c = _vecs(1100, 64, seed=4)          # tail chunk only 76 rows valid
        idx = StreamingFlatIndex.build(np.asarray(c), CFGF, chunk_rows=1024)
        s, i = idx.search(_vecs(1, 64, seed=5)[0], k=5)
        assert s.shape == (5,) and (np.asarray(i) < 1100).all()
        _, i_ref = flat_search_xla(_vecs(1, 64, seed=5), c, 5)
        np.testing.assert_array_equal(np.asarray(i), np.asarray(i_ref)[0])

    def test_build_from_blocks_any_block_size(self):
        """Blocks from a streaming embed pipeline repack to fixed chunks."""
        c = np.asarray(_vecs(2500, 64, seed=6))
        blocks = [c[0:300], c[300:1500], c[1500:1501], c[1501:2500]]
        idx = StreamingFlatIndex.build_from_blocks(iter(blocks), CFGF,
                                                   chunk_rows=1024)
        assert idx.n == 2500 and len(idx.chunks) == 3
        one = StreamingFlatIndex.build(c, CFGF, chunk_rows=1024)
        q = _vecs(4, 64, seed=7)
        np.testing.assert_array_equal(
            np.asarray(idx.search(q, k=5)[1]),
            np.asarray(one.search(q, k=5)[1]))

    def test_save_load_memmap_roundtrip(self, tmp_path):
        c = _vecs(2000, 64, seed=8)
        idx = StreamingFlatIndex.build(np.asarray(c), CFG8, chunk_rows=1024)
        idx.save(str(tmp_path / "sx"))
        idx2 = StreamingFlatIndex.load(str(tmp_path / "sx"))
        assert idx2.n == idx.n
        assert isinstance(idx2.chunks[0], np.memmap)   # disk-backed
        q = _vecs(3, 64, seed=9)
        np.testing.assert_array_equal(
            np.asarray(idx.search(q, k=5)[1]),
            np.asarray(idx2.search(q, k=5)[1]))

    def test_bf16_save_load(self, tmp_path):
        cfg = EngineConfig(dim=64, dtype="bfloat16", corpus_tile=256,
                           )
        c = _vecs(1500, 64, seed=10)
        idx = StreamingFlatIndex.build(np.asarray(c), cfg, chunk_rows=512)
        idx.save(str(tmp_path / "bx"))
        idx2 = StreamingFlatIndex.load(str(tmp_path / "bx"))
        q = _vecs(3, 64, seed=11)
        _, i1 = idx.search(q, k=5)
        _, i2 = idx2.search(q, k=5)
        np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))
        _, i_ref = flat_search_xla(q, c, 5)
        assert recall_at_k(i1, i_ref) >= 0.9

    def test_unsupported_dtype_rejected(self):
        cfg = EngineConfig(dim=64, dtype="int4", corpus_tile=256)
        with pytest.raises(ValueError, match="supports"):
            StreamingFlatIndex.build(np.zeros((512, 64), np.float32), cfg)
