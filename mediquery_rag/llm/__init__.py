"""Pluggable LLM clients.

The reference reaches its LLM over HTTP to an Ollama daemon
(ChatOllama qwen2.5:7b, medical_engine.py:46). LLM serving is out of the
retrieval core's critical path (SURVEY §2b), so the framework keeps a thin
injectable client protocol: a real HTTP client for a local server, and
scripted fakes so every LLM touchpoint is testable offline — preserving the
reference's constructor-injection shape (nodes.py:21, s_c.py:283).
"""

from mediquery_rag.llm.messages import Message, ai, system, user  # noqa: F401
from mediquery_rag.llm.client import (  # noqa: F401
    FakeLLM,
    HTTPChatClient,
    LLMClient,
    RuleLLM,
)


def __getattr__(name):
    # Lazy: DeviceLLMClient pulls in jax/the decoder; plain clients shouldn't.
    if name in ("DeviceLLMClient", "render_chat"):
        from mediquery_rag.llm import device_client

        return getattr(device_client, name)
    raise AttributeError(name)
