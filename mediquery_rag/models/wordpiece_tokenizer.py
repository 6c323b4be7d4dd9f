"""WordPiece tokenizer — loads BERT-family ``vocab.txt`` / tokenizer.json.

The tokenizer of the reference's embedding model (shaw/dmeta-embedding-zh —
a Chinese BERT derivative, reference medical_engine.py:43) lived inside the
Ollama daemon; serving imported BERT weights on the device
(models/bert_encoder.py) needs the matching WordPiece in-repo. Implements
the BERT tokenization algorithm: basic tokenization (unicode cleanup, CJK
chars isolated, optional lowercase + accent stripping, punctuation splits)
followed by greedy longest-match WordPiece with ``##`` continuations.

Output contract: RIGHT-padded ``(ids [B, L] i32, mask [B, L] f32)`` with
``[CLS] ... [SEP]`` framing — BERT's convention (positions count from
column 0), unlike the decoder tokenizers' left padding.
"""

from __future__ import annotations

import json
import os
import unicodedata

import numpy as np


def _is_punct(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) \
            or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return ((0x4E00 <= cp <= 0x9FFF) or (0x3400 <= cp <= 0x4DBF)
            or (0x20000 <= cp <= 0x2A6DF) or (0x2A700 <= cp <= 0x2B73F)
            or (0x2B740 <= cp <= 0x2B81F) or (0x2B820 <= cp <= 0x2CEAF)
            or (0xF900 <= cp <= 0xFAFF) or (0x2F800 <= cp <= 0x2FA1F))


class WordPieceTokenizer:
    def __init__(self, vocab: dict[str, int], *, max_len: int = 512,
                 do_lower_case: bool = True, unk: str = "[UNK]",
                 cls: str = "[CLS]", sep: str = "[SEP]", pad: str = "[PAD]"):
        self.vocab = vocab
        self.max_len = max_len
        self.do_lower_case = do_lower_case
        self.unk_id = vocab[unk]
        self.cls_id = vocab[cls]
        self.sep_id = vocab[sep]
        self.pad_id = vocab[pad]
        self.id_to_token = {i: t for t, i in vocab.items()}

    @classmethod
    def from_pretrained(cls, model_dir: str, *, max_len: int = 512
                        ) -> "WordPieceTokenizer":
        """Load from an HF BERT checkpoint dir (vocab.txt, or the WordPiece
        model inside tokenizer.json), honoring do_lower_case."""
        lower = True
        cfg_path = os.path.join(model_dir, "tokenizer_config.json")
        if os.path.exists(cfg_path):
            with open(cfg_path, encoding="utf-8") as f:
                lower = bool(json.load(f).get("do_lower_case", True))
        vpath = os.path.join(model_dir, "vocab.txt")
        if os.path.exists(vpath):
            with open(vpath, encoding="utf-8") as f:
                vocab = {line.rstrip("\n"): i for i, line in enumerate(f)}
        else:
            with open(os.path.join(model_dir, "tokenizer.json"),
                      encoding="utf-8") as f:
                tj = json.load(f)
            if tj["model"].get("type") != "WordPiece":
                raise ValueError("tokenizer.json is not a WordPiece model")
            vocab = dict(tj["model"]["vocab"])
            norm = tj.get("normalizer") or {}
            if norm.get("type") == "BertNormalizer":
                lower = bool(norm.get("lowercase", True))
        return cls(vocab, max_len=max_len, do_lower_case=lower)

    # -- the BERT basic + wordpiece passes -------------------------------------

    def _basic(self, text: str) -> list[str]:
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or unicodedata.category(ch) in ("Cc", "Cf"):
                continue
            if _is_cjk(cp):
                out.append(f" {ch} ")
            elif ch.isspace():
                out.append(" ")
            else:
                out.append(ch)
        tokens = []
        for word in "".join(out).split():
            if self.do_lower_case:
                word = word.lower()
                word = "".join(c for c in unicodedata.normalize("NFD", word)
                               if unicodedata.category(c) != "Mn")
            cur = []
            for ch in word:
                if _is_punct(ch):
                    if cur:
                        tokens.append("".join(cur))
                        cur = []
                    tokens.append(ch)
                else:
                    cur.append(ch)
            if cur:
                tokens.append("".join(cur))
        return tokens

    def _wordpiece(self, word: str) -> list[int]:
        if len(word) > 100:
            return [self.unk_id]
        ids, start = [], 0
        while start < len(word):
            end = len(word)
            piece_id = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    piece_id = self.vocab[sub]
                    break
                end -= 1
            if piece_id is None:
                return [self.unk_id]   # whole word becomes UNK
            ids.append(piece_id)
            start = end
        return ids

    # -- public interface -----------------------------------------------------

    def encode(self, text: str) -> list[int]:
        ids = [self.cls_id]
        for word in self._basic(text):
            ids.extend(self._wordpiece(word))
        ids = ids[: self.max_len - 1]
        ids.append(self.sep_id)
        return ids

    def decode(self, ids) -> str:
        parts = []
        special = {self.cls_id, self.sep_id, self.pad_id}
        for i in ids:
            i = int(i)
            if i in special:
                continue
            tok = self.id_to_token.get(i, "")
            parts.append(tok[2:] if tok.startswith("##") else " " + tok)
        return "".join(parts).strip()

    def batch_encode(self, texts: list[str], *, pad_to: int | None = None):
        """RIGHT-padded batch (BERT positions count from col 0). Returns
        (ids [B, L] i32, mask [B, L] f32), L a 64 multiple."""
        encoded = [self.encode(t) for t in texts]
        longest = max((len(e) for e in encoded), default=2)
        if pad_to is None:
            length = min(-(-longest // 64) * 64, self.max_len)
        else:
            length = pad_to
        ids = np.full((len(texts), length), self.pad_id, dtype=np.int32)
        mask = np.zeros((len(texts), length), dtype=np.float32)
        for r, e in enumerate(encoded):
            e = e[:length]
            ids[r, : len(e)] = e
            mask[r, : len(e)] = 1.0
        return ids, mask
