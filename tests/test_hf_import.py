"""HF checkpoint import: numerical parity vs the torch reference.

The importer (models/hf_import.py) is proven correct the only way that
counts: a qwen2-architecture model is built with transformers (random init,
tiny dims), saved as a real safetensors checkpoint, imported into the JAX
decoder, and the LOGITS are compared — full forward, prefill, and the
KV-cache decode loop. Any mapping/transposition/RoPE/GQA/bias mistake shows
up as a numeric mismatch here. With parity proven on random weights, a real
qwen2.5 checkpoint (same format, same code path) imports correctly by
construction; loading one is gated on MEDIQUERY_HF_LLM below.

The BPE tokenizer (models/bpe_tokenizer.py) is proven the same way: a
qwen2-structured tokenizer.json (Split-regex pre-tokenizer + byte-level BPE)
is trained in-test with the `tokenizers` library, and our in-repo merge loop
must produce identical ids on zh/en/mixed/emoji/whitespace inputs.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")

QWEN_PRETOK = (
    r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}| ?"
    r"[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+"
)


def _tiny_qwen(tmp_path, *, tie=False, vocab=160):
    from transformers import Qwen2Config, Qwen2ForCausalLM

    cfg = Qwen2Config(
        vocab_size=vocab, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=512, rope_theta=10000.0, rms_norm_eps=1e-6,
        tie_word_embeddings=tie, attention_dropout=0.0,
    )
    torch.manual_seed(7)
    model = Qwen2ForCausalLM(cfg).eval()
    d = tmp_path / ("qwen_tied" if tie else "qwen")
    model.save_pretrained(str(d), safe_serialization=True)
    return model, str(d)


class TestQwen2Import:
    @pytest.mark.parametrize("tie", [False, True])
    def test_logits_parity_full_forward(self, tmp_path, tie):
        from mediquery_rag.models import Decoder
        from mediquery_rag.models.hf_import import load_qwen2

        hf_model, d = _tiny_qwen(tmp_path, tie=tie)
        cfg, params = load_qwen2(d, dtype="float32", param_dtype="float32")
        assert cfg.qkv_bias and cfg.kv_heads == 2 and cfg.vocab_size == 160

        ids = np.array([[5, 9, 23, 77, 41, 3, 8, 150],
                        [0, 0, 11, 64, 12, 99, 42, 7]], dtype=np.int32)
        mask = np.ones_like(ids, dtype=np.float32)
        mask[1, :2] = 0.0  # left padding on row 1

        dec = Decoder(cfg)
        ours = np.asarray(dec.apply(params, jnp.asarray(ids),
                                    jnp.asarray(mask)))

        with torch.no_grad():
            theirs = hf_model(
                input_ids=torch.tensor(ids, dtype=torch.long),
                attention_mask=torch.tensor(mask, dtype=torch.long),
            ).logits.float().numpy()

        # compare only real-token positions (padded cols differ by design)
        live = mask.astype(bool)
        np.testing.assert_allclose(ours[live], theirs[live],
                                   rtol=2e-4, atol=2e-4)

    def test_greedy_decode_parity(self, tmp_path):
        """prefill + KV-cache decode must reproduce HF's greedy continuation."""
        from mediquery_rag.models import Decoder
        from mediquery_rag.models.hf_import import load_qwen2

        hf_model, d = _tiny_qwen(tmp_path)
        cfg, params = load_qwen2(d, dtype="float32", param_dtype="float32")
        dec = Decoder(cfg)

        ids = np.array([[5, 9, 23, 77, 41, 3, 8, 150]], dtype=np.int32)
        steps = 6

        with torch.no_grad():
            out = hf_model.generate(
                torch.tensor(ids, dtype=torch.long), max_new_tokens=steps,
                do_sample=False, num_beams=1)
        theirs = out[0, ids.shape[1]:].numpy()

        mask = jnp.ones(ids.shape, jnp.float32)
        logits, cache = dec.prefill(params, jnp.asarray(ids), mask,
                                    cache_len=ids.shape[1] + steps)
        mine = []
        for _ in range(steps):
            tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
            mine.append(int(tok[0]))
            logits, cache = dec.decode_step(params, cache, tok)
        np.testing.assert_array_equal(np.asarray(mine), theirs)

    def test_generator_end_to_end(self, tmp_path):
        """load_qwen2_generator drives the full serving engine on an
        imported checkpoint (with a real BPE tokenizer alongside)."""
        from mediquery_rag.models.hf_import import load_qwen2_generator

        hf_model, d = _tiny_qwen(tmp_path, vocab=300)
        _write_tiny_tokenizer(d, vocab_target=300)
        gen = load_qwen2_generator(d, dtype="float32", param_dtype="float32")
        outs = gen.generate(["你好，血压", "hello bp"], max_new_tokens=4)
        assert len(outs) == 2 and all(isinstance(o, str) for o in outs)

    def test_generator_int4_serving(self, tmp_path):
        """Imported checkpoints serve at the reference's Ollama tier
        (4-bit weight-only) through DeviceLLMClient.from_hf(quantize=4)."""
        from mediquery_rag.llm.device_client import DeviceLLMClient

        _, d = _tiny_qwen(tmp_path, vocab=300)
        _write_tiny_tokenizer(d, vocab_target=300)
        client = DeviceLLMClient.from_hf(d, quantize=4, max_new_tokens=4)
        assert "q4" in client.generator.params["lm_head"]
        out = client.complete("血压高")
        assert isinstance(out, str)


def _write_tiny_tokenizer(model_dir, vocab_target=300):
    """Train a qwen2-STRUCTURED tokenizer.json (Split regex pre-tokenizer +
    byte-level BPE) with the `tokenizers` library on a small zh/en sample."""
    from tokenizers import Regex, Tokenizer, decoders, models
    from tokenizers import pre_tokenizers, trainers

    tok = Tokenizer(models.BPE())
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(QWEN_PRETOK), behavior="isolated",
                             invert=False),
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False),
    ])
    tok.decoder = decoders.ByteLevel()
    trainer = trainers.BpeTrainer(
        vocab_size=vocab_target - 3, show_progress=False,
        special_tokens=[], initial_alphabet=pre_tokenizers.ByteLevel.alphabet())
    sample = [
        "高血压患者的饮食建议：低盐低脂，多吃蔬菜水果。",
        "糖尿病如何运动？ 每周 150 分钟中等强度运动。",
        "What should I eat for high blood pressure?",
        "Regular exercise helps control blood sugar levels.",
        "BMI = 体重(kg) / 身高(m)^2   正常范围 18.5-23.9",
    ]
    tok.train_from_iterator(sample, trainer)
    tok.add_special_tokens(["<|endoftext|>", "<|im_start|>", "<|im_end|>"])
    tok.save(os.path.join(model_dir, "tokenizer.json"))
    with open(os.path.join(model_dir, "tokenizer_config.json"), "w") as f:
        json.dump({"eos_token": "<|im_end|>",
                   "pad_token": "<|endoftext|>"}, f)
    return tok


class TestBPETokenizer:
    CASES = [
        "高血压患者的饮食建议",
        "What should I eat?  I'm diabetic.",
        "混合 mixed 文本 with  spaces\nand newlines\t tabs",
        "数字 12345 and punctuation!!! ……",
        "emoji 🌡️💊 test",
        "",
        "   ",
        "BMI=23.9；血压 120/80 mmHg",
    ]

    @pytest.fixture()
    def pair(self, tmp_path):
        lib_tok = _write_tiny_tokenizer(str(tmp_path))
        from mediquery_rag.models.bpe_tokenizer import BPETokenizer
        ours = BPETokenizer.from_pretrained(str(tmp_path), max_len=512)
        return lib_tok, ours

    def test_encode_matches_tokenizers_lib(self, pair):
        lib_tok, ours = pair
        for text in self.CASES:
            expect = lib_tok.encode(text).ids
            got = ours.encode(text)
            assert got == expect, f"mismatch on {text!r}"

    def test_specials_and_roundtrip(self, pair):
        lib_tok, ours = pair
        text = "<|im_start|>user\n血压高怎么办?<|im_end|>"
        expect = lib_tok.encode(text).ids
        assert ours.encode(text) == expect
        assert ours.eos_id == ours.vocab["<|im_end|>"]
        assert ours.pad_id == ours.vocab["<|endoftext|>"]
        # decode drops specials, recovers the plain text
        assert "血压高怎么办?" in ours.decode(
            [i for i in expect if i != ours.eos_id])

    def test_batch_encode_contract(self, pair):
        _, ours = pair
        ids, mask = ours.batch_encode(["血压", "高血压患者的饮食建议建议建议"])
        assert ids.shape[1] % 128 == 0 and ids.shape == mask.shape
        # left-padded: masks end at the last column
        assert mask[0, -1] == 1.0 and mask[0, 0] == 0.0
        row = ids[0][mask[0] > 0]
        assert ours.decode(row) == "血压"


def _tiny_bert(tmp_path, vocab=120):
    from transformers import BertConfig, BertModel

    cfg = BertConfig(
        vocab_size=vocab, hidden_size=48, intermediate_size=96,
        num_hidden_layers=2, num_attention_heads=4,
        max_position_embeddings=128, type_vocab_size=2,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
        layer_norm_eps=1e-12,
    )
    torch.manual_seed(11)
    model = BertModel(cfg).eval()
    d = tmp_path / "bert"
    model.save_pretrained(str(d), safe_serialization=True)
    return model, str(d)


class TestBertImport:
    def test_hidden_states_and_pooling_parity(self, tmp_path):
        from mediquery_rag.models import BertEncoder
        from mediquery_rag.models.hf_import import load_bert

        hf_model, d = _tiny_bert(tmp_path)
        cfg, params = load_bert(d, dtype="float32")
        enc = BertEncoder(cfg)

        ids = np.array([[2, 9, 23, 77, 41, 3, 8, 101],
                        [2, 11, 64, 12, 0, 0, 0, 0]], dtype=np.int32)
        mask = np.ones_like(ids, dtype=np.float32)
        mask[1, 4:] = 0.0  # right padding on row 1

        ours = np.asarray(enc.hidden_states(
            params, jnp.asarray(ids), jnp.asarray(mask)))
        with torch.no_grad():
            theirs = hf_model(
                input_ids=torch.tensor(ids, dtype=torch.long),
                attention_mask=torch.tensor(mask, dtype=torch.long),
            ).last_hidden_state.numpy()
        live = mask.astype(bool)
        np.testing.assert_allclose(ours[live], theirs[live],
                                   rtol=2e-4, atol=2e-4)

        # mean-pooled sentence embeddings match the sentence-transformers
        # recipe applied to the torch hidden states
        pooled = np.asarray(enc.apply(params, jnp.asarray(ids),
                                      jnp.asarray(mask)))
        ref = (theirs * mask[..., None]).sum(1) / mask.sum(1, keepdims=True)
        ref = ref / np.linalg.norm(ref, axis=-1, keepdims=True)
        np.testing.assert_allclose(pooled, ref, rtol=2e-4, atol=2e-4)

    def test_wordpiece_matches_transformers(self, tmp_path):
        from transformers import BertTokenizerFast

        from mediquery_rag.models import WordPieceTokenizer

        pieces = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]",
                  "高", "血", "压", "患", "者", "饮", "食", "的", "建", "议",
                  "what", "should", "i", "eat", "blood", "pressure",
                  "##s", "##ing", "##ed", "bp", "120", "80", "1", "2", "0",
                  "##0", "##2", "/", "?", "!", ",", "。", "，", "mm", "##hg"]
        d = tmp_path / "wp"
        d.mkdir()
        (d / "vocab.txt").write_text("\n".join(pieces) + "\n",
                                     encoding="utf-8")
        (d / "tokenizer_config.json").write_text(
            json.dumps({"do_lower_case": True}))

        theirs = BertTokenizerFast(str(d / "vocab.txt"), do_lower_case=True)
        ours = WordPieceTokenizer.from_pretrained(str(d))
        cases = [
            "高血压患者的饮食建议",
            "What should I eat?",
            "BP 120/80 mmHg!",
            "混合 mixed 病例 eating",
            "unknownword 高血压",
            "",
        ]
        for text in cases:
            expect = theirs(text)["input_ids"]
            got = ours.encode(text)
            assert got == expect, f"mismatch on {text!r}"

    def test_bert_text_embedder_end_to_end(self, tmp_path):
        from mediquery_rag.models import BertTextEmbedder

        _, d = _tiny_bert(tmp_path)
        pieces = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "高", "血", "压",
                  "饮", "食", "好"]
        with open(os.path.join(d, "vocab.txt"), "w", encoding="utf-8") as f:
            f.write("\n".join(pieces) + "\n")
        emb = BertTextEmbedder.from_hf(d)
        out = emb.embed(["高血压", "饮食好", "血压"])
        assert out.shape == (3, 48)
        np.testing.assert_allclose(np.linalg.norm(out, axis=-1), 1.0,
                                   rtol=1e-5)
        # deterministic + distinct inputs give distinct embeddings
        assert not np.allclose(out[0], out[1])


class TestRealCheckpoint:
    """Only runs when a real HF qwen2-class checkpoint directory is provided
    (no weights ship in this image — zero egress)."""

    path = os.environ.get("MEDIQUERY_HF_LLM", "")

    @pytest.mark.skipif(not path or not os.path.isdir(path),
                        reason="set MEDIQUERY_HF_LLM to a qwen2 checkpoint dir")
    def test_real_weights_chat(self):
        from mediquery_rag.llm.device_client import DeviceLLMClient

        client = DeviceLLMClient.from_hf(self.path, max_new_tokens=16)
        out = client.complete("只回答“是”或“否”：高血压患者应该减少盐摄入吗？")
        assert out.strip()
