"""DeviceLLMClient — the chat LLM served on the device itself.

Completes SURVEY §2b row 2: the reference's chat inference ran out-of-process
in Ollama's GGML C++ runtime (ChatOllama qwen2.5:7b, medical_engine.py:46);
here the same ``LLMClient`` seam is satisfied by an in-repo JAX decoder
(models/decoder.py) behind the batched KV-cache generation engine
(models/generate.py). Drop-in anywhere an ``HTTPChatClient`` goes —
AppContext, graph nodes, consultation — no HTTP daemon required.
"""

from __future__ import annotations

from typing import Sequence

from mediquery_rag.llm.messages import Message
from mediquery_rag.models.generate import Generator

# Plain-text role markers (the byte-level vocab has no reserved role tokens;
# markers are ordinary UTF-8 the model learns like any other bytes).
_ROLE = {"system": "<|system|>", "user": "<|user|>", "assistant": "<|assistant|>"}
_END = "<|end|>"


def render_chat(messages: Sequence[Message] | str, *,
                for_training: bool = False, template: str = "plain") -> str:
    """Messages -> the decoder's prompt string. Serving prompts end with an
    open assistant turn; training samples close it (EOS is appended by the
    tokenizer, so ``_END`` only terminates *inner* turns).

    ``template="chatml"`` renders the qwen2.5-instruct ChatML format
    (<|im_start|>role\\n...<|im_end|>) for HF-imported checkpoints, whose
    tokenizers carry those markers as special tokens."""
    from mediquery_rag.llm.client import _as_messages

    if template == "chatml":
        parts = [f"<|im_start|>{m.role}\n{m.content}<|im_end|>\n"
                 for m in _as_messages(messages)]
        if for_training:
            if not parts or _as_messages(messages)[-1].role != "assistant":
                raise ValueError(
                    "training samples must end with an assistant turn")
            return "".join(parts).removesuffix("<|im_end|>\n")
        return "".join(parts) + "<|im_start|>assistant\n"

    parts = []
    for m in _as_messages(messages):
        parts.append(f"{_ROLE.get(m.role, _ROLE['user'])}\n{m.content}{_END}")
    text = "".join(parts)
    if for_training:
        if not parts or _as_messages(messages)[-1].role != "assistant":
            raise ValueError("training samples must end with an assistant turn")
        return text.removesuffix(_END)  # tokenizer's EOS closes the turn
    return text + _ROLE["assistant"] + "\n"


def _turn_stops(template: str) -> tuple[str, ...]:
    """The role/stop markers a model reply must be cut at (shared by
    _cut_turn and the SSE streaming path's incremental cutter)."""
    return (("<|im_start|>", "<|im_end|>") if template == "chatml"
            else (_END, *_ROLE.values()))


def _cut_turn(out: str, template: str) -> str:
    """The model may imitate the chat template and open another turn; cut
    at the first role/stop marker. Shared with serve/llm.py's client."""
    for stop in _turn_stops(template):
        idx = out.find(stop)
        if idx >= 0:
            out = out[:idx]
    return out.strip()


class DeviceLLMClient:
    """``LLMClient`` implementation backed by the on-device decoder."""

    def __init__(self, generator: Generator, *, max_new_tokens: int = 256,
                 temperature: float = 0.0, template: str = "plain"):
        self.generator = generator
        self.max_new_tokens = max_new_tokens
        self.temperature = temperature
        self.template = template
        self._constraints: dict = {}   # schema json -> compiled JsonConstraint

    def complete(self, messages: Sequence[Message] | str, **kw) -> str:
        return self.complete_batch([messages], **kw)[0]

    def _constraint_for(self, schema: dict):
        import json as _json

        key = _json.dumps(schema, sort_keys=True)
        c = self._constraints.get(key)
        if c is None:
            from mediquery_rag.models.constrain import JsonConstraint

            c = JsonConstraint.compile(
                schema, self.generator.tokenizer,
                vocab_size=self.generator.cfg.vocab_size)
            self._constraints[key] = c
        return c

    def complete_batch(self, message_lists, **kw) -> list[str]:
        """Batched completion — one device program for N conversations (the
        capability the reference's one-request-at-a-time HTTP client never
        had). Pass ``schema=`` (models/constrain.py restricted JSON schema)
        to grammar-constrain decoding: the output is valid JSON of that
        schema by construction — the guarantee the reference hoped for from
        qwen's JSON mode and wrapped in try/except when it broke."""
        prompts = [render_chat(m, template=self.template)
                   for m in message_lists]
        constraint = (self._constraint_for(kw["schema"])
                      if kw.get("schema") is not None else None)
        outs = self.generator.generate(
            prompts,
            max_new_tokens=kw.get("max_new_tokens", self.max_new_tokens),
            temperature=kw.get("temperature", self.temperature),
            constraint=constraint,
        )
        if constraint is not None:
            # grammar + EOS already terminate the output; marker-cutting
            # would corrupt JSON whose string content happens to contain one
            return [o.strip() for o in outs]
        return [_cut_turn(o, self.template) for o in outs]

    @classmethod
    def from_checkpoint(cls, path: str, **kw) -> "DeviceLLMClient":
        return cls(Generator.from_checkpoint(path), **kw)

    @classmethod
    def from_hf(cls, model_dir: str, *, quantize: bool | int = False,
                kv_dtype: str = "", **kw) -> "DeviceLLMClient":
        """Serve a real HF qwen2-class checkpoint on the device: imported
        weights + the checkpoint's BPE tokenizer + ChatML prompts (what
        qwen2.5-instruct was trained on). ``quantize=8`` (or ``True``)
        converts to int8 weight-only serving (7B-class in ~7 GB);
        ``quantize=4`` to int4 (~3.8 GB — the same 4-bit tier the
        reference's Ollama GGUF runs at). See ops/matvec.py.
        ``kv_dtype="int8"`` additionally quantizes the KV cache at write
        time — half the cache HBM, so 2x the lanes or context."""
        from mediquery_rag.models.hf_import import load_qwen2_generator

        gen = load_qwen2_generator(model_dir, kv_dtype=kv_dtype)
        if quantize:
            gen.quantize_weights(bits=8 if quantize is True else quantize)
        kw.setdefault("template", "chatml")
        return cls(gen, **kw)
