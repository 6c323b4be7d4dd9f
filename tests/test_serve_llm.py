"""Continuous-batching LLM server (serve/llm.py + decoder.decode_step_slots).

The invariant that makes continuous batching correct: a request's tokens
must not depend on WHO ELSE shares the batch or WHEN they arrived. Greedy
decoding is deterministic, so every test pins server output against the
lockstep ``Generator.generate`` path on the same prompts.
"""

import numpy as np
import pytest

from mediquery_rag.config import DecoderConfig
from mediquery_rag.models.generate import Generator
from mediquery_rag.serve.llm import LLMServer

TINY = DecoderConfig(vocab_size=384, hidden=64, layers=2, heads=4,
                     mlp_dim=128, max_len=1024, dtype="float32")

PROMPTS = ["高血压的饮食建议", "头痛", "BMI 如何计算？体重 70kg 身高 1.75m"]


@pytest.fixture(scope="module")
def gen():
    return Generator(TINY)


@pytest.fixture(scope="module")
def oracle(gen):
    """Lockstep greedy continuation at the SAME token budget (the budget is
    tokens, not chars — decode() drops pad/noise ids, so char slicing would
    compare different-length decodes)."""
    cache: dict = {}

    def get(p: str, n: int) -> str:
        if (p, n) not in cache:
            cache[(p, n)] = gen.generate([p], max_new_tokens=n)[0]
        return cache[(p, n)]

    return get


class TestServer:
    def test_concurrent_matches_lockstep(self, gen, oracle):
        with LLMServer(gen, slots=4, chunk=8) as srv:
            futs = [srv.submit(p, max_new_tokens=48) for p in PROMPTS]
            outs = [f.result(timeout=300) for f in futs]
        for p, o in zip(PROMPTS, outs):
            assert o == oracle(p, 48)

    def test_more_requests_than_slots(self, gen, oracle):
        # 2 lanes, 6 requests: lanes must be reused and outputs still
        # independent of scheduling
        with LLMServer(gen, slots=2, chunk=8) as srv:
            futs = [srv.submit(p, max_new_tokens=32)
                    for p in PROMPTS * 2]
            outs = [f.result(timeout=300) for f in futs]
        for p, o in zip(PROMPTS * 2, outs):
            assert o == oracle(p, 32)

    def test_staggered_arrival(self, gen, oracle):
        # second request arrives while the first is mid-generation;
        # neither result may change
        import time
        with LLMServer(gen, slots=4, chunk=4) as srv:
            f1 = srv.submit(PROMPTS[0], max_new_tokens=40)
            while srv.stats["chunks"] == 0:   # first request is running
                time.sleep(0.005)
            f2 = srv.submit(PROMPTS[1], max_new_tokens=40)
            o1, o2 = f1.result(timeout=300), f2.result(timeout=300)
        assert o1 == oracle(PROMPTS[0], 40)
        assert o2 == oracle(PROMPTS[1], 40)

    def test_max_new_tokens_budget(self, gen):
        with LLMServer(gen, slots=2, chunk=8) as srv:
            out = srv.complete(PROMPTS[0], max_new_tokens=5)
        # 5 byte-tokens decode to at most 5 chars
        assert len(out.encode("utf-8")) <= 5

    def test_cache_exhaustion_truncates(self, gen):
        # cache barely fits the prompt: generation must end gracefully
        with LLMServer(gen, slots=2, chunk=8, cache_len=256) as srv:
            out = srv.complete("健康" * 60, max_new_tokens=500)
        assert isinstance(out, str)

    def test_temperature_sampling_completes(self, gen):
        with LLMServer(gen, slots=2, chunk=8) as srv:
            outs = srv.complete_batch(PROMPTS[:2], max_new_tokens=16,
                                      temperature=0.9)
        assert len(outs) == 2 and all(isinstance(o, str) for o in outs)

    def test_ignore_eos_decodes_full_budget(self, gen):
        # the load-benchmark contract: exactly max_new tokens decode, EOS
        # or not, and finish_reason is always "length". The tiny random
        # model hits EOS within a few tokens on some prompts — without
        # ignore_eos the same prompt finishes with "stop" earlier.
        with LLMServer(gen, slots=2, chunk=8) as srv:
            futs = [srv.submit(p, max_new_tokens=24, ignore_eos=True)
                    for p in PROMPTS]
            for f in futs:
                f.result(timeout=300)
                assert getattr(f, "finish_reason") == "length"
            assert srv.stats["tokens_out"] == 24 * len(PROMPTS)

    def test_ignore_eos_stream_flows_past_eos(self, gen):
        # streamed deltas must keep arriving after a mid-transcript EOS
        # (decode() stops at EOS; the server stores PAD in its place)
        deltas = []
        with LLMServer(gen, slots=1, chunk=8) as srv:
            fut = srv.submit(PROMPTS[0], max_new_tokens=40,
                             on_text=deltas.append, ignore_eos=True)
            out = fut.result(timeout=300)
        assert "".join(deltas) == out

    def test_stats(self, gen):
        with LLMServer(gen, slots=2, chunk=8) as srv:
            srv.complete(PROMPTS[0], max_new_tokens=8)
            stats = dict(srv.stats)
        assert stats["requests"] == 1 and stats["prefills"] == 1
        assert stats["chunks"] >= 1


class TestSessions:
    """Prefix cache: extending a parked lane must give bit-identical greedy
    output to a cold full prefill of the same transcript."""

    def test_two_turn_session_matches_cold(self, gen):
        from mediquery_rag.serve.llm import ChatSession
        with LLMServer(gen, slots=2, chunk=8) as srv:
            s = ChatSession(srv, max_new_tokens=24)
            r1 = s.ask("高血压饮食")
            assert srv.stats["prefills"] >= 1
            r2 = s.ask("运动呢？")
            assert srv.stats["extends"] == 1        # turn 2 reused the lane
            assert srv.stats["prefix_tokens_reused"] > 0
            transcript = list(s.messages[:-1])      # up to the 2nd question

        # cold server: full prefill of the same rendered transcript
        from mediquery_rag.llm.device_client import _cut_turn, render_chat
        with LLMServer(gen, slots=2, chunk=8) as srv2:
            out = srv2.complete(render_chat(transcript), max_new_tokens=24)
        assert _cut_turn(out, "plain") == r2
        assert isinstance(r1, str)

    def test_session_survives_other_traffic(self, gen):
        from mediquery_rag.serve.llm import ChatSession
        with LLMServer(gen, slots=3, chunk=8) as srv:
            s = ChatSession(srv, max_new_tokens=16)
            s.ask("头痛")
            # unrelated traffic lands on other lanes, session lane parks
            srv.complete_batch(["咳嗽", "发烧"], max_new_tokens=16)
            s.ask("需要吃药吗")
            assert srv.stats["extends"] == 1

    def test_eviction_under_session_pressure(self, gen):
        from mediquery_rag.serve.llm import ChatSession
        with LLMServer(gen, slots=2, chunk=8) as srv:
            sessions = [ChatSession(srv, max_new_tokens=8) for _ in range(4)]
            for s in sessions:
                s.ask("血压")
            # all four ran; only 2 lanes exist, so 2 sessions were evicted
            assert len(srv._sessions) <= 2
            # an evicted session still works (falls back to full prefill)
            sessions[0].ask("继续")

    def test_divergent_prefix_still_correct(self, gen, oracle):
        # turn 2 shares only the BOS token with turn 1: the lane rolls back
        # to column 1 and re-prefills nearly everything — and the result
        # must still match a cold run exactly
        with LLMServer(gen, slots=2, chunk=8) as srv:
            srv.complete("问题A", session="s1", max_new_tokens=8)
            out = srv.complete(PROMPTS[0], session="s1", max_new_tokens=32)
            assert srv.stats["extends"] == 1
            # just BOS (+ a coincidentally shared UTF-8 lead byte)
            assert srv.stats["prefix_tokens_reused"] <= 3
        assert out == oracle(PROMPTS[0], 32)


class TestConstrainedServing:
    """Per-lane grammar constraints: constrained and free-text requests
    share one batch, each lane decoding under its own schema's DFA."""

    def test_mixed_schemas_one_batch(self, gen):
        import json
        from mediquery_rag.models.constrain import (
            EXTRACT_SCHEMA, FOLLOWUP_SCHEMA, RISK_SCHEMA, JsonConstraint)
        with LLMServer(gen, slots=4, chunk=8) as srv:
            futs = [
                srv.submit("疼痛5分", schema=RISK_SCHEMA, temperature=0.9),
                srv.submit("主诉头痛", schema=FOLLOWUP_SCHEMA,
                           temperature=0.9),
                srv.submit("我对青霉素过敏", schema=EXTRACT_SCHEMA,
                           temperature=0.9),
                srv.submit("自由文本", max_new_tokens=16),   # unconstrained
            ]
            outs = [f.result(timeout=300) for f in futs]
        for schema, out in zip(
                (RISK_SCHEMA, FOLLOWUP_SCHEMA, EXTRACT_SCHEMA), outs):
            json.loads(out)
            c = JsonConstraint.compile(schema, gen.tokenizer,
                                       vocab_size=gen.cfg.vocab_size)
            assert c.accepts(out)
        assert isinstance(outs[3], str)

    def test_matches_lockstep_constrained(self, gen):
        # greedy constrained serving == the Generator's constrained path
        from mediquery_rag.models.constrain import (RISK_SCHEMA,
                                                        JsonConstraint)
        c = JsonConstraint.compile(RISK_SCHEMA, gen.tokenizer,
                                   vocab_size=gen.cfg.vocab_size)
        want = gen.generate(["血压 180/120"], constraint=c)[0]
        with LLMServer(gen, slots=1, chunk=8) as srv:
            got = srv.complete("血压 180/120", schema=RISK_SCHEMA)
        assert got == want

    def test_tiny_budget_cannot_truncate(self, gen):
        import json
        from mediquery_rag.models.constrain import RISK_SCHEMA
        with LLMServer(gen, slots=2, chunk=8) as srv:
            out = srv.complete("x", schema=RISK_SCHEMA, max_new_tokens=1,
                               temperature=0.9)
        json.loads(out)

    def test_app_risk_seam_over_server(self, gen):
        from mediquery_rag.app.risk import assess_answer_risk
        from mediquery_rag.serve.llm import ServedLLMClient
        with LLMServer(gen, slots=2, chunk=8) as srv:
            client = ServedLLMClient(srv, temperature=0.9)
            r = assess_answer_risk("疼痛程度如何？", "大概5分吧", client)
        assert r.source == "llm"
        assert r.level in {"CRITICAL", "HIGH", "MEDIUM", "LOW"}


class TestStreaming:
    def test_stream_deltas_concat_to_result(self, gen):
        chunks = []
        with LLMServer(gen, slots=2, chunk=4) as srv:
            out = srv.submit(PROMPTS[0], max_new_tokens=32,
                             on_text=chunks.append).result(timeout=300)
        assert "".join(chunks) == out
        assert len(chunks) >= 2          # arrived incrementally, not at once

    def test_broken_consumer_does_not_kill_serving(self, gen):
        def boom(_):
            raise RuntimeError("consumer bug")
        with LLMServer(gen, slots=2, chunk=8) as srv:
            out = srv.submit(PROMPTS[1], max_new_tokens=16,
                             on_text=boom).result(timeout=300)
        assert isinstance(out, str)

    def test_latency_percentiles(self, gen):
        with LLMServer(gen, slots=2, chunk=8) as srv:
            srv.complete_batch(PROMPTS, max_new_tokens=16)
            lat = srv.latency()
        assert lat["n"] == len(PROMPTS)
        assert 0 < lat["ttft_p50_s"] <= lat["p99_s"]


class TestServedClient:
    def test_llm_client_seam(self, gen):
        from mediquery_rag.serve.llm import ServedLLMClient
        with LLMServer(gen, slots=2, chunk=8) as srv:
            client = ServedLLMClient(srv, max_new_tokens=16)
            out = client.complete("血压高怎么办？")
        assert isinstance(out, str)


class TestOpenAIChatEndpoint:
    """/v1/chat/completions over the on-device LLM server: the framework SERVES
    the OpenAI-compatible API the reference consumed from Ollama — the
    repo's own HTTPChatClient must work against it unchanged."""

    @pytest.fixture(scope="class")
    def http(self, gen):
        from mediquery_rag.serve.server import SearchServer

        class _NoStore:
            def batch_search(self, queries, k, **kw):
                return [[] for _ in queries]

        with LLMServer(gen, slots=2, chunk=8) as llm_srv:
            srv = SearchServer(_NoStore(), llm_server=llm_srv)
            port = srv.start(port=0)
            yield port
            srv.shutdown()

    def _post(self, port, payload):
        import json as js
        import urllib.request
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/chat/completions",
            data=js.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            return js.loads(r.read())

    def test_basic_completion_shape(self, http):
        out = self._post(http, {
            "messages": [{"role": "user", "content": "血压高怎么办"}],
            "max_tokens": 16})
        assert out["object"] == "chat.completion"
        msg = out["choices"][0]["message"]
        assert msg["role"] == "assistant" and isinstance(msg["content"], str)
        assert out["choices"][0]["finish_reason"] in {"stop", "length"}

    def test_truncation_reports_length(self, http):
        """OpenAI contract: a generation cut by max_tokens must say
        finish_reason="length", not "stop" (clients retry/continue on it)."""
        out = self._post(http, {
            "messages": [{"role": "user", "content": "请详细介绍高血压"}],
            "max_tokens": 2})
        fr = out["choices"][0]["finish_reason"]
        # toy model could conceivably emit EOS within 2 tokens; otherwise
        # the budget cut must be reported honestly
        content = out["choices"][0]["message"]["content"]
        if fr == "stop":
            assert len(content) < 64
        else:
            assert fr == "length"

    def test_stream_bad_request_is_http_400(self, http):
        """Validation failures must surface BEFORE SSE headers commit —
        a clean HTTP 400, never a 200 event-stream with a stray status."""
        import json as js
        import urllib.error
        import urllib.request
        req = urllib.request.Request(
            f"http://127.0.0.1:{http}/v1/chat/completions",
            data=js.dumps({"stream": True}).encode(),  # no "messages"
            headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=60)
        assert ei.value.code == 400

    def test_own_http_client_works_against_it(self, http):
        from mediquery_rag.llm.client import HTTPChatClient
        client = HTTPChatClient(base_url=f"http://127.0.0.1:{http}",
                                model="mediquery")
        out = client.complete("头痛怎么办")
        assert isinstance(out, str)

    def test_metrics_endpoint(self, http):
        import urllib.request
        with urllib.request.urlopen(
                f"http://127.0.0.1:{http}/metrics", timeout=30) as r:
            text = r.read().decode()
            ctype = r.headers["Content-Type"]
        assert "text/plain" in ctype
        assert "# TYPE" in text
        assert "mediquery_llm_requests" in text
        assert "mediquery_search_" in text

    def test_schema_extension_yields_valid_json(self, http):
        import json as js
        from mediquery_rag.models.constrain import RISK_SCHEMA
        out = self._post(http, {
            "messages": [{"role": "user", "content": "疼痛5分"}],
            "temperature": 0.9, "schema": RISK_SCHEMA})
        obj = js.loads(out["choices"][0]["message"]["content"])
        assert obj["risk"] in {"CRITICAL", "HIGH", "MEDIUM", "LOW"}

    def test_streaming_sse(self, http):
        import json as js
        import urllib.request
        req = urllib.request.Request(
            f"http://127.0.0.1:{http}/v1/chat/completions",
            data=js.dumps({
                "messages": [{"role": "user", "content": "咳嗽"}],
                "max_tokens": 24, "stream": True}).encode(),
            headers={"Content-Type": "application/json"})
        chunks, finish, done = [], None, False
        with urllib.request.urlopen(req, timeout=120) as r:
            for line in r:
                line = line.decode().strip()
                if not line.startswith("data: "):
                    continue
                data = line[len("data: "):]
                if data == "[DONE]":
                    done = True
                    break
                obj = js.loads(data)
                assert obj["object"] == "chat.completion.chunk"
                delta = obj["choices"][0]["delta"]
                if "content" in delta:
                    chunks.append(delta["content"])
                finish = obj["choices"][0]["finish_reason"]
        assert done and finish in {"stop", "length"}
        assert len(chunks) >= 1

    def test_stream_concat_equals_nonstream_content(self, http):
        """Concatenated SSE deltas must equal the non-streaming content for
        the same request (the stream passes through the same turn-cut +
        strip), greedy so both runs decode identically."""
        import json as js
        import urllib.request
        body = {"messages": [{"role": "user", "content": "咳嗽有痰"}],
                "max_tokens": 24, "temperature": 0.0}
        plain = self._post(http, body)["choices"][0]["message"]["content"]
        req = urllib.request.Request(
            f"http://127.0.0.1:{http}/v1/chat/completions",
            data=js.dumps({**body, "stream": True}).encode(),
            headers={"Content-Type": "application/json"})
        chunks = []
        with urllib.request.urlopen(req, timeout=120) as r:
            for line in r:
                line = line.decode().strip()
                if not line.startswith("data: "):
                    continue
                data = line[len("data: "):]
                if data == "[DONE]":
                    break
                delta = js.loads(data)["choices"][0]["delta"]
                if "content" in delta:
                    chunks.append(delta["content"])
        assert "".join(chunks) == plain


class TestCancellationAndBackpressure:
    """A gone client must not keep burning device time: cancellation frees the
    lane at the next chunk boundary; a bounded backlog sheds load with
    ServerSaturated (HTTP 429) instead of queueing unboundedly."""

    def test_cancel_queued_request(self, gen):
        from concurrent.futures import CancelledError
        with LLMServer(gen, slots=1, chunk=4) as srv:
            f1 = srv.submit(PROMPTS[0], max_new_tokens=48)
            f2 = srv.submit(PROMPTS[1], max_new_tokens=48)
            assert f2.cancel()
            assert isinstance(f1.result(timeout=300), str)
            with pytest.raises(CancelledError):
                f2.result(timeout=30)

    def test_cancel_mid_generation_frees_lane(self, gen, oracle):
        import time
        with LLMServer(gen, slots=1, chunk=4) as srv:
            f1 = srv.submit(PROMPTS[0], max_new_tokens=512)
            while srv.stats["chunks"] == 0:
                time.sleep(0.005)
            assert f1.cancel()     # futures are never marked running
            out = srv.complete(PROMPTS[1], max_new_tokens=16, timeout=300)
            assert out == oracle(PROMPTS[1], 16)
            assert srv.stats["cancelled"] >= 1

    def test_backlog_rejection_and_drain(self, gen):
        import time
        from mediquery_rag.serve.llm import ServerSaturated
        with LLMServer(gen, slots=1, chunk=4, max_backlog=1) as srv:
            f1 = srv.submit(PROMPTS[0], max_new_tokens=256)
            while srv.stats["prefills"] == 0:  # f1 owns the only lane
                time.sleep(0.005)
            f2 = srv.submit(PROMPTS[1], max_new_tokens=8)
            with pytest.raises(ServerSaturated):
                srv.submit(PROMPTS[2], max_new_tokens=8)
            assert srv.stats["rejected"] == 1
            f1.cancel()            # lane frees -> backlog drains
            assert isinstance(f2.result(timeout=300), str)

    def test_sse_disconnect_cancels_lane(self, gen):
        from mediquery_rag.serve.server import SearchServer

        class _NoStore:
            def batch_search(self, queries, k, **kw):
                return [[] for _ in queries]

        with LLMServer(gen, slots=1, chunk=4) as srv:
            s = SearchServer(_NoStore(), llm_server=srv)
            try:
                def write_sse(_payload):      # client hangs up immediately
                    raise BrokenPipeError
                body = {"messages": [
                    {"role": "user", "content": "高血压怎么办"}],
                    "max_tokens": 512}
                prompt, kw = s._chat_prompt(body)
                with pytest.raises(BrokenPipeError):
                    s._stream_chat(body, prompt, kw, write_sse)
                # the lane must free up and serve the next request
                out = srv.complete("头痛", max_new_tokens=8, timeout=300)
                assert isinstance(out, str)
                assert srv.stats["cancelled"] >= 1
            finally:
                s.service.shutdown()


class TestFaultContainment:
    """A dispatch failure must fail the in-flight futures and leave the
    server serving — never a silently dead worker thread with every
    caller hung on .result()."""

    def test_dispatch_failure_fails_futures_and_recovers(self, gen, oracle):
        with LLMServer(gen, slots=2, chunk=8) as srv:
            real = srv._chunk_program()      # compile, then sabotage

            def bad(*a, **k):
                raise RuntimeError("injected dispatch failure")

            srv._chunk_cache[(False, False)] = bad
            f = srv.submit(PROMPTS[0], max_new_tokens=16)
            with pytest.raises(RuntimeError, match="injected"):
                f.result(timeout=300)
            assert srv.stats["errors"] >= 1
            srv._chunk_cache[(False, False)] = real   # "transient" fault clears
            out = srv.complete(PROMPTS[1], max_new_tokens=16, timeout=300)
            assert out == oracle(PROMPTS[1], 16)

    def test_close_fails_outstanding_futures(self, gen):
        srv = LLMServer(gen, slots=1, chunk=4)
        f1 = srv.submit(PROMPTS[0], max_new_tokens=512)
        f2 = srv.submit(PROMPTS[1], max_new_tokens=8)    # queued behind f1
        srv.close()
        for f in (f1, f2):
            with pytest.raises(Exception):
                f.result(timeout=10)


class TestInt4Serving:
    def test_int4_weights_through_slot_lanes(self):
        """The continuous-batching engine must serve an int4-quantized
        model unchanged (decode_step_slots reaches the q4 form of _mm):
        outputs match the SAME quantized model's lockstep generate."""
        import jax
        gen4 = Generator(TINY, key=jax.random.PRNGKey(5))
        gen4.quantize_weights(bits=4)
        want = [gen4.generate([p], max_new_tokens=24)[0] for p in PROMPTS]
        with LLMServer(gen4, slots=2, chunk=8) as srv:
            futs = [srv.submit(p, max_new_tokens=24) for p in PROMPTS]
            outs = [f.result(timeout=300) for f in futs]
        assert outs == want


class TestStreamVisible:
    """The incremental turn-cutter backing SSE streaming."""

    STOPS = ("<|user|>", "<|end|>")

    def test_plain_text_passes(self):
        from mediquery_rag.serve.server import _stream_visible
        assert _stream_visible("你好，多喝水", self.STOPS) == (6, False)

    def test_full_marker_cuts(self):
        from mediquery_rag.serve.server import _stream_visible
        n, hit = _stream_visible("多喝水<|user|>假问题", self.STOPS)
        assert (n, hit) == (3, True)

    def test_partial_marker_held_back(self):
        from mediquery_rag.serve.server import _stream_visible
        n, hit = _stream_visible("多喝水<|us", self.STOPS)
        assert (n, hit) == (3, False)

    def test_trailing_whitespace_held(self):
        from mediquery_rag.serve.server import _stream_visible
        n, hit = _stream_visible("多喝水 \n", self.STOPS)
        assert (n, hit) == (3, False)

    def test_whitespace_before_marker_stripped(self):
        from mediquery_rag.serve.server import _stream_visible
        n, hit = _stream_visible("多喝水 \n<|end|>x", self.STOPS)
        assert (n, hit) == (3, True)

    def test_incremental_totals_match_cut_turn(self):
        """Feeding any prefix split must emit exactly _cut_turn(full)."""
        from mediquery_rag.llm.device_client import _cut_turn, _turn_stops
        from mediquery_rag.serve.server import _stream_visible
        stops = _turn_stops("plain")
        full = "  建议多休息、多喝水。 <|user|>下一个问题"
        for split in range(len(full)):
            acc, sent, out = "", 0, ""
            for piece in (full[:split], full[split:]):
                acc += piece
                vis, hit = _stream_visible(acc, stops)
                if sent == 0:
                    while sent < vis and acc[sent].isspace():
                        sent += 1
                if vis > sent:
                    out += acc[sent:vis]
                    sent = vis
                if hit:
                    break
            assert out == _cut_turn(full, "plain"), f"split={split}"


class TestChunkedPrefill:
    """Chunked prefill: a long admission lands piece by piece so decode
    quanta interleave — one arrival must not stall co-tenant generation
    for its whole prefill, and the pieced-together prefill must be exactly
    equivalent to the monolithic one."""

    LONG = "高血压患者的日常饮食应当注意低盐低脂并保持适量运动与充足睡眠。" * 6

    def test_long_admission_interleaves_and_stays_exact(self, gen, oracle):
        import time
        with LLMServer(gen, slots=2, chunk=4, prefill_chunk=128) as srv:
            f1 = srv.submit(PROMPTS[0], max_new_tokens=48)
            while srv.stats["chunks"] == 0:    # co-tenant is decoding
                time.sleep(0.005)
            f2 = srv.submit(self.LONG, max_new_tokens=24)
            o1 = f1.result(timeout=300)
            o2 = f2.result(timeout=300)
            stats = dict(srv.stats)
        assert o1 == oracle(PROMPTS[0], 48)
        assert o2 == oracle(self.LONG, 24)
        assert stats["prefill_pieces"] >= 2    # actually landed in pieces

    def test_alone_on_server_uses_monolithic(self, gen):
        with LLMServer(gen, slots=2, chunk=8, prefill_chunk=128) as srv:
            srv.complete(self.LONG, max_new_tokens=8)
            assert srv.stats["prefill_pieces"] == 0
            assert srv.stats["prefills"] == 1

    def test_chunked_session_parks_and_extends(self, gen, oracle):
        import time
        with LLMServer(gen, slots=2, chunk=4, prefill_chunk=128) as srv:
            hold = srv.submit(PROMPTS[1], max_new_tokens=64)
            while srv.stats["chunks"] == 0:
                time.sleep(0.005)
            srv.complete(self.LONG, session="s1", max_new_tokens=8)
            assert srv.stats["prefill_pieces"] >= 2
            hold.result(timeout=300)
            out = srv.complete(self.LONG + "运动方面呢？", session="s1",
                               max_new_tokens=24)
            assert srv.stats["extends"] == 1   # parked lane was reused
        assert out == oracle(self.LONG + "运动方面呢？", 24)

    def test_chunked_admission_with_spec_lanes(self, gen, oracle):
        import jax
        import time
        draft = Generator(DecoderConfig(
            vocab_size=384, hidden=32, layers=1, heads=2, mlp_dim=64,
            max_len=1024, dtype="float32"), key=jax.random.PRNGKey(7))
        with LLMServer(gen, slots=2, chunk=10, prefill_chunk=128,
                       draft=draft, gamma=4) as srv:
            f1 = srv.submit(PROMPTS[0], max_new_tokens=48)
            while srv.stats["chunks"] == 0:
                time.sleep(0.005)
            f2 = srv.submit(self.LONG, max_new_tokens=24)
            o1 = f1.result(timeout=300)
            o2 = f2.result(timeout=300)
            stats = dict(srv.stats)
        assert o1 == oracle(PROMPTS[0], 48)
        assert o2 == oracle(self.LONG, 24)
        assert stats["spec_rounds"] > 0
        assert stats["prefill_pieces"] >= 2


class TestSpeculativeServing:
    """Speculative continuous batching: a draft model accelerates greedy
    lanes (propose->verify quanta) without changing a single output token.
    Every test pins server-with-draft output against the plain lockstep
    oracle — losslessness is the whole contract."""

    DRAFT = DecoderConfig(vocab_size=384, hidden=32, layers=1, heads=2,
                          mlp_dim=64, max_len=1024, dtype="float32")

    @pytest.fixture(scope="class")
    def draft(self):
        import jax
        return Generator(self.DRAFT, key=jax.random.PRNGKey(7))

    def test_adversarial_draft_lossless(self, gen, draft, oracle):
        # random (untrained) draft disagrees with the target constantly;
        # outputs must STILL be bit-identical to lockstep greedy
        with LLMServer(gen, slots=4, chunk=8, draft=draft, gamma=3) as srv:
            futs = [srv.submit(p, max_new_tokens=40) for p in PROMPTS]
            outs = [f.result(timeout=300) for f in futs]
            stats = dict(srv.stats)
        for p, o in zip(PROMPTS, outs):
            assert o == oracle(p, 40)
        assert stats["spec_rounds"] > 0
        assert stats["spec_tokens"] > 0
        assert stats["draft_syncs"] >= len(PROMPTS)

    def test_perfect_draft_accepts_everything(self, gen, oracle):
        # the target drafting for itself agrees on every proposal: tokens
        # per round == gamma+1, i.e. spec_tokens/spec_rounds ~ gamma+1
        with LLMServer(gen, slots=2, chunk=10, draft=gen, gamma=4) as srv:
            out = srv.submit(PROMPTS[0], max_new_tokens=40).result(
                timeout=300)
            stats = dict(srv.stats)
        assert out == oracle(PROMPTS[0], 40)
        assert stats["spec_tokens"] >= 4 * stats["spec_rounds"]

    def test_sampled_lane_forces_fallback_and_recovery(self, gen, draft,
                                                       oracle):
        # a temperature>0 lane disables spec quanta while it runs; the
        # greedy lane sharing the batch must still be exact, and spec
        # quanta must resume (draft resync) after the sampled lane leaves
        with LLMServer(gen, slots=2, chunk=8, draft=draft, gamma=3) as srv:
            f_greedy = srv.submit(PROMPTS[0], max_new_tokens=64)
            f_sampled = srv.submit(PROMPTS[1], max_new_tokens=8,
                                   temperature=0.9)
            o_greedy = f_greedy.result(timeout=300)
            f_sampled.result(timeout=300)
            stats = dict(srv.stats)
        assert o_greedy == oracle(PROMPTS[0], 64)
        assert stats["spec_rounds"] > 0      # resumed after fallback

    def test_constrained_lane_forces_fallback(self, gen, draft):
        import json
        from mediquery_rag.models.constrain import RISK_SCHEMA
        with LLMServer(gen, slots=2, chunk=8, draft=draft, gamma=3) as srv:
            out = srv.complete("血压 180/120", schema=RISK_SCHEMA)
        json.loads(out)

    def test_session_over_spec_server_matches_cold(self, gen, draft):
        from mediquery_rag.serve.llm import ChatSession
        with LLMServer(gen, slots=2, chunk=8, draft=draft, gamma=3) as srv:
            s = ChatSession(srv, max_new_tokens=24)
            s.ask("高血压饮食")
            r2 = s.ask("运动呢？")
            assert srv.stats["extends"] == 1
            transcript = list(s.messages[:-1])
        from mediquery_rag.llm.device_client import _cut_turn, render_chat
        with LLMServer(gen, slots=2, chunk=8) as srv2:   # no draft
            out = srv2.complete(render_chat(transcript), max_new_tokens=24)
        assert _cut_turn(out, "plain") == r2

    def test_small_draft_cache_windows_and_stays_lossless(self, gen,
                                                          oracle):
        # draft cache (256) far smaller than the target's (1024): lanes
        # must window-resync when the draft runs out of room, and the
        # output — the target's property alone — must not move
        import jax
        small = DecoderConfig(vocab_size=384, hidden=32, layers=1, heads=2,
                              mlp_dim=64, max_len=256, dtype="float32")
        draft = Generator(small, key=jax.random.PRNGKey(11))
        with LLMServer(gen, slots=1, chunk=10, draft=draft,
                       gamma=4) as srv:
            out = srv.submit(PROMPTS[0], max_new_tokens=200).result(
                timeout=600)
            stats = dict(srv.stats)
        assert out == oracle(PROMPTS[0], 200)
        assert stats["draft_syncs"] >= 2     # re-windowed at least once

    def test_cache_exhaustion_prefix_of_plain(self, gen, draft):
        # near the cache end a spec quantum needs gamma+1 columns, so the
        # spec server may stop up to gamma tokens earlier — but what it
        # does emit must be a prefix of the plain server's output
        prompt = "健康" * 60
        with LLMServer(gen, slots=1, chunk=8, cache_len=256) as plain:
            want = plain.complete(prompt, max_new_tokens=500)
        with LLMServer(gen, slots=1, chunk=8, cache_len=256, draft=draft,
                       gamma=3) as srv:
            got = srv.complete(prompt, max_new_tokens=500)
        assert want.startswith(got)
        assert len(want.encode()) - len(got.encode()) <= 4 * 3  # ≤γ+1 toks

    def test_vocab_mismatch_rejected(self, gen):
        import jax
        bad = Generator(DecoderConfig(
            vocab_size=512, hidden=32, layers=1, heads=2, mlp_dim=64,
            max_len=1024, dtype="float32"), key=jax.random.PRNGKey(1))
        with pytest.raises(ValueError, match="vocab"):
            LLMServer(gen, draft=bad)


class TestSlotStepPrimitive:
    def test_slot_step_matches_lockstep_step(self, gen):
        """decode_step_slots with a shared cursor must reproduce
        decode_step exactly (same cache writes, same logits)."""
        import jax
        import jax.numpy as jnp

        tok = gen.tokenizer
        ids, mask = tok.batch_encode(["高血压", "糖尿病运动"])
        logits, cache = jax.jit(
            lambda p, i, m: gen.model.prefill(p, i, m, 256))(
            gen.params, jnp.asarray(ids), jnp.asarray(mask))
        step_tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)

        l_ref, c_ref = jax.jit(gen.model.decode_step)(
            gen.params, cache, step_tok)

        from mediquery_rag.models.decoder import KVCache
        B = ids.shape[0]
        slot_cache = KVCache(
            k=cache.k, v=cache.v, key_mask=cache.key_mask,
            cursor=jnp.full((B,), cache.cursor, jnp.int32),
            next_pos=cache.next_pos)
        l_slot, c_slot = jax.jit(gen.model.decode_step_slots)(
            gen.params, slot_cache, step_tok, jnp.ones((B,), bool))

        np.testing.assert_allclose(np.asarray(l_ref), np.asarray(l_slot),
                                   rtol=1e-5)
        np.testing.assert_allclose(np.asarray(c_ref.k), np.asarray(c_slot.k),
                                   rtol=1e-5)
        assert np.array_equal(np.asarray(c_ref.key_mask),
                              np.asarray(c_slot.key_mask))

    def test_inactive_lane_is_frozen(self, gen):
        """An inactive lane's mask/cursor/positions must not move, and its
        visible cache content must be unchanged."""
        import jax
        import jax.numpy as jnp

        tok = gen.tokenizer
        ids, mask = tok.batch_encode(["高血压", "糖尿病"])
        logits, cache = jax.jit(
            lambda p, i, m: gen.model.prefill(p, i, m, 256))(
            gen.params, jnp.asarray(ids), jnp.asarray(mask))
        from mediquery_rag.models.decoder import KVCache
        B = ids.shape[0]
        slot_cache = KVCache(
            k=cache.k, v=cache.v, key_mask=cache.key_mask,
            cursor=jnp.full((B,), cache.cursor, jnp.int32),
            next_pos=cache.next_pos)
        active = jnp.asarray([True, False])
        tokn = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        _, c2 = jax.jit(gen.model.decode_step_slots)(
            gen.params, slot_cache, tokn, active)
        assert int(c2.cursor[0]) == int(slot_cache.cursor[0]) + 1
        assert int(c2.cursor[1]) == int(slot_cache.cursor[1])
        assert int(c2.next_pos[1]) == int(slot_cache.next_pos[1])
        assert np.array_equal(np.asarray(c2.key_mask[1]),
                              np.asarray(slot_cache.key_mask[1]))

    def test_extend_slots_matches_sequential_steps(self, gen):
        """Multi-column extend == the same tokens fed one decode_step_slots
        at a time: identical per-position logits, cache writes, cursors."""
        import jax
        import jax.numpy as jnp

        tok = gen.tokenizer
        ids, mask = tok.batch_encode(["高血压", "糖尿病运动"])
        logits, cache = jax.jit(
            lambda p, i, m: gen.model.prefill(p, i, m, 256))(
            gen.params, jnp.asarray(ids), jnp.asarray(mask))
        from mediquery_rag.models.decoder import KVCache
        B = ids.shape[0]
        base = KVCache(
            k=cache.k, v=cache.v, key_mask=cache.key_mask,
            cursor=jnp.full((B,), cache.cursor, jnp.int32),
            next_pos=cache.next_pos)
        toks = jnp.asarray([[5, 9, 200], [77, 3, 150]], jnp.int32)
        act = jnp.ones((B,), bool)

        seq_logits, c_seq = [], base
        for i in range(3):
            l, c_seq = jax.jit(gen.model.decode_step_slots)(
                gen.params, c_seq, toks[:, i], act)
            seq_logits.append(np.asarray(l))

        l_ext, c_ext = jax.jit(gen.model.extend_slots)(
            gen.params, base, toks, act)
        np.testing.assert_allclose(
            np.asarray(l_ext), np.stack(seq_logits, axis=1),
            rtol=2e-4, atol=2e-4)
        assert np.array_equal(np.asarray(c_ext.cursor),
                              np.asarray(c_seq.cursor))
        assert np.array_equal(np.asarray(c_ext.next_pos),
                              np.asarray(c_seq.next_pos))
        assert np.array_equal(np.asarray(c_ext.key_mask),
                              np.asarray(c_seq.key_mask))
        np.testing.assert_allclose(np.asarray(c_ext.k),
                                   np.asarray(c_seq.k), rtol=1e-5,
                                   atol=1e-6)

    def test_extend_slots_inactive_lane_frozen(self, gen):
        import jax
        import jax.numpy as jnp

        tok = gen.tokenizer
        ids, mask = tok.batch_encode(["头痛", "咳嗽"])
        _, cache = jax.jit(
            lambda p, i, m: gen.model.prefill(p, i, m, 256))(
            gen.params, jnp.asarray(ids), jnp.asarray(mask))
        from mediquery_rag.models.decoder import KVCache
        B = ids.shape[0]
        base = KVCache(
            k=cache.k, v=cache.v, key_mask=cache.key_mask,
            cursor=jnp.full((B,), cache.cursor, jnp.int32),
            next_pos=cache.next_pos)
        toks = jnp.asarray([[5, 9], [7, 3]], jnp.int32)
        _, c2 = jax.jit(gen.model.extend_slots)(
            gen.params, base, toks, jnp.asarray([True, False]))
        assert int(c2.cursor[0]) == int(base.cursor[0]) + 2
        assert int(c2.cursor[1]) == int(base.cursor[1])
        assert int(c2.next_pos[1]) == int(base.next_pos[1])
        assert np.array_equal(np.asarray(c2.key_mask[1]),
                              np.asarray(base.key_mask[1]))


class TestTopP:
    """Per-lane nucleus sampling (OpenAI top_p parity). The sharp oracle:
    top_p small enough keeps only the argmax token, so sampled output
    must equal the greedy continuation exactly."""

    def test_tiny_top_p_equals_greedy(self, gen, oracle):
        with LLMServer(gen, slots=2, chunk=8) as srv:
            out = srv.complete(PROMPTS[0], max_new_tokens=32,
                               temperature=0.9, top_p=1e-6)
        assert out == oracle(PROMPTS[0], 32)

    def test_mixed_topp_and_greedy_lanes(self, gen, oracle):
        with LLMServer(gen, slots=2, chunk=8) as srv:
            f1 = srv.submit(PROMPTS[0], max_new_tokens=32)   # greedy
            f2 = srv.submit(PROMPTS[1], max_new_tokens=16,
                            temperature=0.9, top_p=0.8)
            o1, o2 = f1.result(timeout=300), f2.result(timeout=300)
        assert o1 == oracle(PROMPTS[0], 32)   # co-occupant-independent
        assert isinstance(o2, str)

    def test_top_p_one_is_plain_sampling(self, gen):
        # top_p=1.0 must not trace the nucleus sort (greedy program key)
        with LLMServer(gen, slots=2, chunk=8) as srv:
            srv.complete(PROMPTS[0], max_new_tokens=8, temperature=0.9,
                         top_p=1.0)
            assert all(not k[1] for k in srv._chunk_cache)

    def test_http_top_p_accepted(self, gen):
        import json as js
        import urllib.request
        from mediquery_rag.serve.server import SearchServer

        class _NoStore:
            def batch_search(self, queries, k, **kw):
                return [[] for _ in queries]

        with LLMServer(gen, slots=2, chunk=8) as llm_srv:
            srv = SearchServer(_NoStore(), llm_server=llm_srv)
            port = srv.start(port=0)
            try:
                req = urllib.request.Request(
                    f"http://127.0.0.1:{port}/v1/chat/completions",
                    data=js.dumps({
                        "messages": [{"role": "user", "content": "咳嗽"}],
                        "max_tokens": 12, "temperature": 0.9,
                        "top_p": 0.5}).encode(),
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=120) as r:
                    out = js.loads(r.read())
                assert isinstance(
                    out["choices"][0]["message"]["content"], str)
            finally:
                srv.shutdown()
