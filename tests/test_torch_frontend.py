"""The port's frontend operators (dynamo_tpu_torch.frontend: tokenizer,
backend, migration, preprocessor, the HTTP framing of http.py) against
the reference's own modules, on the CPU:

- `ByteTokenizer`, `IncrementalDetokenizer` (partial UTF-8 held back),
  `_longest_partial_suffix`, `StopChecker` and `BackendOperator` give
  the reference's outputs on the same inputs: hypothesis over random
  byte streams cut into items, stop strings, stop ids, min/max tokens
  (exact);
- `Migration`: the reference's cases of tests/test_frontend.py (replay of
  the accumulated tokens, the limit), and the replayed request and the
  backoff sequence equal the reference's (exact);
- the default chat template rendered without jinja2 equals jinja2's
  rendering (the reference's `render_chat`) byte for byte over
  hypothesis-drawn messages and tools;
- `preprocess_chat` / `preprocess_completions` give the reference's dicts
  for requests covering temperature, stop, max_tokens,
  max_completion_tokens, stop_token_ids, ignore_eos, min_tokens, seed,
  logit_bias, logprobs and token-id prompts, and the same errors (over
  context, invalid logit_bias) and the same guided specs (tool_choice
  required or named, response_format, guided_*); what the port does not
  serve yet is refused (images, a card's own chat template, a
  tokenizer.json);
- the HTTP/1.1 framing: keep-alive, chunked request bodies,
  `Expect: 100-continue`, 404 / 405, malformed requests.
"""

import asyncio
import json
import socket

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from dynamo_tpu.frontend import backend as ref_backend
from dynamo_tpu.frontend import migration as ref_migration
from dynamo_tpu.frontend.preprocessor import Preprocessor as RefPreprocessor
from dynamo_tpu.frontend.protocols import ModelCard as RefModelCard
from dynamo_tpu.frontend.tokenizer import ByteTokenizer as RefByteTokenizer
from dynamo_tpu.frontend.tokenizer import IncrementalDetokenizer as RefDetok
from dynamo_tpu.runtime.context import Context as RefContext
from dynamo_tpu.runtime.request_plane import RequestPlaneError as RefRequestPlaneError
from dynamo_tpu_torch.frontend import backend
from dynamo_tpu_torch.frontend.http import HttpService
from dynamo_tpu_torch.frontend.migration import Migration, is_migratable
from dynamo_tpu_torch.frontend.preprocessor import Preprocessor, render_default_chat
from dynamo_tpu_torch.frontend.protocols import ModelCard
from dynamo_tpu_torch.frontend.tokenizer import (
    ByteTokenizer,
    IncrementalDetokenizer,
    load_tokenizer,
)
from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.runtime.discovery import MemDiscovery
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.request_plane import RequestPlaneError

SETTINGS = settings(max_examples=60, deadline=None,
                    suppress_health_check=[HealthCheck.too_slow])


def _card(**kw):
    return ModelCard(name="m", context_length=1024, **kw)


def _ref_card(**kw):
    return RefModelCard(name="m", context_length=1024, **kw)


# -- tokenizer and detokenizer ---------------------------------------------------

byte_items = st.lists(st.lists(st.integers(0, 300), max_size=6), max_size=10)


@SETTINGS
@given(byte_items)
def test_byte_tokenizer_and_detokenizer_equal_reference(items):
    """Ids >= 256 (BOS, EOS, a large vocabulary's ids) are dropped and
    partial UTF-8 is held back exactly as the reference does."""
    port, ref = IncrementalDetokenizer(ByteTokenizer()), RefDetok(RefByteTokenizer())
    for ids in items:
        assert port.push(ids) == ref.push(ids)
    assert port.finish() == ref.finish()
    flat = [i for ids in items for i in ids]
    assert ByteTokenizer().decode(flat) == RefByteTokenizer().decode(flat)
    text = bytes(i for i in flat if i < 256).decode("utf-8", errors="replace")
    assert ByteTokenizer().encode(text) == RefByteTokenizer().encode(text)


def test_incremental_detok_holds_partial_utf8():
    detok = IncrementalDetokenizer(ByteTokenizer())
    euro = "€".encode("utf-8")
    assert detok.push([euro[0]]) == ""
    assert detok.push([euro[1]]) == ""
    assert detok.push([euro[2]]) == "€"
    assert detok.finish() == ""


def test_load_tokenizer_refuses_tokenizer_json():
    assert isinstance(load_tokenizer(None), ByteTokenizer)
    assert isinstance(load_tokenizer("byte"), ByteTokenizer)
    with pytest.raises(ValueError, match="tokenizer.json"):
        load_tokenizer("/models/llama/tokenizer.json")


# -- backend: stops and detokenization -------------------------------------------

stop_strings = st.lists(st.text(alphabet="abcEND€ ", min_size=0, max_size=4), max_size=3)
ascii_items = st.lists(st.lists(st.sampled_from(list(b"abcEND ") + [0xe2, 0x82, 0xac, 257]),
                                max_size=5), max_size=12)


@SETTINGS
@given(st.text(alphabet="abcEN€", max_size=12), stop_strings)
def test_partial_suffix_equals_reference(text, stops):
    assert backend._longest_partial_suffix(text, stops) == \
        ref_backend._longest_partial_suffix(text, stops)


def test_partial_suffix_helper():
    assert backend._longest_partial_suffix("hello wo", ["world"]) == 2
    assert backend._longest_partial_suffix("hello", ["world"]) == 0
    assert backend._longest_partial_suffix("abcEN", ["END"]) == 2


class _ListEngine:
    def __init__(self, items):
        self.items = items

    async def generate(self, request, context):
        for it in self.items:
            yield dict(it)


async def _run_backend(op, request, ctx):
    return [i async for i in op.generate(request, ctx)]


@SETTINGS
@given(ascii_items, stop_strings, st.integers(1, 40), st.integers(0, 5), st.booleans(),
       st.booleans())
def test_backend_operator_equals_reference(items, stops, max_tokens, min_tokens,
                                           ignore_eos, finish_last):
    """Every emitted item (text, token ids, finish, stop_sequence, passed
    through fields) and the context's stop equal the reference's."""
    outs = [{"token_ids": ids, "finish_reason": None, "phases": {"n": k}}
            for k, ids in enumerate(items)]
    if finish_last and outs:
        outs[-1]["finish_reason"] = "length"
    request = {"stop": {"stop_strings": stops, "max_tokens": max_tokens,
                        "min_tokens": min_tokens, "ignore_eos": ignore_eos,
                        "stop_ids": [257]}}
    port_ctx, ref_ctx = Context(), RefContext()
    got = asyncio.run(_run_backend(backend.BackendOperator(ByteTokenizer(), _ListEngine(outs)),
                                   request, port_ctx))
    want = asyncio.run(_run_backend(
        ref_backend.BackendOperator(RefByteTokenizer(), _ListEngine(outs)), request, ref_ctx))
    assert got == want
    assert port_ctx.is_stopped == ref_ctx.is_stopped


@SETTINGS
@given(st.lists(st.integers(0, 300), max_size=30), st.integers(1, 20), st.integers(0, 8),
       st.booleans())
def test_stop_checker_equals_reference(ids, max_tokens, min_tokens, ignore_eos):
    stop = {"max_tokens": max_tokens, "min_tokens": min_tokens, "ignore_eos": ignore_eos,
            "stop_ids": [257, 7], "stop_strings": ["", "ab"]}
    port, ref = backend.StopChecker(stop), ref_backend.StopChecker(stop)
    for k in range(0, len(ids), 3):
        assert port.check_tokens(ids[k:k + 3]) == ref.check_tokens(ids[k:k + 3])
    assert port.stop_strings == ref.stop_strings == ["ab"]
    assert port.find_stop_string("xxabyab") == ref.find_stop_string("xxabyab")


async def test_backend_stop_string_cuts_stream():
    items = [{"token_ids": list(b"hello "), "finish_reason": None},
             {"token_ids": list(b"EN"), "finish_reason": None},
             {"token_ids": list(b"D trailing"), "finish_reason": None},
             {"token_ids": list(b"never"), "finish_reason": None}]
    ctx = Context()
    out = await _run_backend(backend.BackendOperator(ByteTokenizer(), _ListEngine(items)),
                             {"stop": {"stop_strings": ["END"], "max_tokens": 100}}, ctx)
    assert "".join(i["text"] for i in out) == "hello "
    assert out[-1]["finish_reason"] == "stop" and ctx.is_stopped


# -- migration ------------------------------------------------------------------


class _FlakyEngine:
    """Yields two tokens, then dies `deaths` times with `code`, then
    finishes."""

    def __init__(self, err, deaths=1, code="disconnected"):
        self.calls = []
        self.err, self.deaths, self.code = err, deaths, code

    async def generate(self, request, context):
        self.calls.append((list(request["token_ids"]), dict(request["stop"]),
                           dict(request.get("annotations") or {})))
        if len(self.calls) <= self.deaths:
            yield {"token_ids": [100 + len(self.calls), 200], "finish_reason": None}
            raise self.err("worker died", code=self.code)
        yield {"token_ids": [102], "finish_reason": "length"}


@pytest.mark.parametrize("deaths,limit", [(1, 2), (2, 3), (3, 3)])
async def test_migration_replays_equal_reference(deaths, limit):
    """The replayed requests (prompt + tokens so far, budget less them,
    `migrated_tokens`), the stream and the phases equal the reference's;
    backoffs are not slept (base 0)."""
    req = {"token_ids": [1, 2], "stop": {"max_tokens": 10}}

    async def run(mig_cls, err, ctx):
        eng = _FlakyEngine(err, deaths)
        mig = mig_cls(eng, migration_limit=limit, backoff_base_s=0.0)
        out = [i async for i in mig.generate(req, ctx)]
        return eng.calls, [(i["token_ids"], i["finish_reason"]) for i in out], out, mig

    calls, toks, out, mig = await run(Migration, RequestPlaneError, Context())
    rcalls, rtoks, rout, _ = await run(ref_migration.Migration, RefRequestPlaneError,
                                       RefContext())
    assert calls == rcalls and toks == rtoks
    assert mig.migrations == deaths
    phases, rphases = out[-1]["phases"], rout[-1]["phases"]
    assert phases.keys() == rphases.keys()
    assert phases["migration_attempts"] == rphases["migration_attempts"] == deaths
    assert calls[1][0] == [1, 2, 101, 200]


async def test_migration_gives_up_after_limit_and_on_other_codes():
    mig = Migration(_FlakyEngine(RequestPlaneError, deaths=5), migration_limit=1,
                    backoff_base_s=0.0)
    with pytest.raises(RequestPlaneError):
        [_ async for _ in mig.generate({"token_ids": [1], "stop": {}}, Context())]
    mig = Migration(_FlakyEngine(RequestPlaneError, code="engine"), backoff_base_s=0.0)
    with pytest.raises(RequestPlaneError):
        [_ async for _ in mig.generate({"token_ids": [1], "stop": {}}, Context())]
    assert mig.migrations == 0
    assert is_migratable(RequestPlaneError("x", code="draining"))
    assert not is_migratable(RuntimeError("x"))


def test_migration_backoff_equals_reference():
    port = Migration(None)
    ref = ref_migration.Migration(None)
    for rid in ("a", "cmpl-1", "0123456789abcdef"):
        got = [port._backoff_s(rid, k) for k in range(1, 9)]
        assert got == [ref._backoff_s(rid, k) for k in range(1, 9)]
        assert got[-1] <= 2.0 and got[0] >= 0.025


# -- the chat template without jinja2 --------------------------------------------

scalars = st.one_of(st.none(), st.booleans(), st.integers(-5, 5),
                    st.text(alphabet="ab<>&'\"é☃\n{}%", max_size=6))
json_values = st.recursive(scalars, lambda inner: st.one_of(
    st.lists(inner, max_size=3),
    st.dictionaries(st.text(alphabet="xyz<'", max_size=3), inner, max_size=3)),
    max_leaves=8)
messages = st.lists(st.fixed_dictionaries(
    {}, optional={"role": st.sampled_from(["user", "assistant", "system", "tool", "<&>"]),
                  "content": scalars,
                  "tool_calls": st.one_of(st.just([]), st.lists(json_values, max_size=2))}),
    max_size=5)
tools_st = st.one_of(st.none(), st.just([]), st.lists(json_values, max_size=3))


@SETTINGS
@given(messages, tools_st)
def test_default_chat_template_equals_jinja2(msgs, tools):
    """Byte for byte: roles, contents with <>&' and non-ASCII unescaped,
    None as "None", tool calls and tools through tojson (sorted keys,
    ASCII escapes, \\u003c \\u003e \\u0026 \\u0027)."""
    want = RefPreprocessor(_ref_card()).render_chat(msgs, tools=tools)
    assert render_default_chat(msgs, tools) == want
    assert Preprocessor(_card()).render_chat(msgs, tools=tools) == want


# -- preprocessing -----------------------------------------------------------------

CHAT = [{"role": "system", "content": "be brief"}, {"role": "user", "content": "hi €"}]
REQUESTS = {
    "defaults": {},
    "greedy": {"temperature": 0},
    "sampled": {"temperature": 0.7, "top_p": 0.9, "top_k": 5, "seed": 3},
    "null_temperature": {"temperature": None},
    "stop_str": {"stop": "END", "max_tokens": 7},
    "stop_list": {"stop": ["a", "bc"], "max_completion_tokens": 9},
    "stop_ids": {"stop_token_ids": [5, 257], "ignore_eos": True, "min_tokens": 3},
    "penalties": {"frequency_penalty": 0.5, "presence_penalty": 0.25,
                  "repetition_penalty": 1.1},
    "logprobs": {"logprobs": 3},
    "chat_logprobs": {"logprobs": True, "top_logprobs": 40},
    "logit_bias": {"logit_bias": {"65": 150, "66": -3.5}},
    "tools_none": {"tools": [{"type": "function", "function": {"name": "f"}}],
                   "tool_choice": "none"},
    "tools_auto": {"tools": [{"type": "function", "function": {"name": "f"}}]},
    "model": {"model": "other-name", "max_tokens": 1},
}


@pytest.mark.parametrize("name", sorted(REQUESTS))
def test_preprocess_equals_reference(name):
    port, ref = Preprocessor(_card()), RefPreprocessor(_ref_card())
    extra = REQUESTS[name]
    chat = {"messages": CHAT, **extra}
    assert port.preprocess_chat(chat) == ref.preprocess_chat(chat)
    for prompt in ("hello there", [5, 6, 300, 7], ""):
        comp = {"prompt": prompt, **{k: v for k, v in extra.items()
                                     if not k.startswith("tool")}}
        assert port.preprocess_completions(comp) == ref.preprocess_completions(comp)


@pytest.mark.parametrize("req", [
    {"prompt": "x" * 1024}, {"prompt": list(range(2000))},
    {"prompt": "a", "logit_bias": {"999": 1}}, {"prompt": "a", "logit_bias": {"x": 1}},
    {"prompt": "a", "logit_bias": [1, 2]},
])
def test_preprocess_errors_equal_reference(req):
    port, ref = Preprocessor(_card()), RefPreprocessor(_ref_card())
    with pytest.raises(ValueError) as got:
        port.preprocess_completions(req)
    with pytest.raises(ValueError) as want:
        ref.preprocess_completions(req)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("req", [
    {"tools": [{"type": "function", "function": {"name": "f"}}], "tool_choice": "required"},
    {"tools": [{"type": "function", "function": {"name": "f"}}],
     "tool_choice": {"function": {"name": "f"}}},
    {"response_format": {"type": "json_object"}},
    {"guided_regex": "a+"}, {"guided_json": {"type": "object"}}, {"guided_choice": ["x"]},
])
def test_guided_requests_are_refused_naming_a4(req):
    """Guided decoding is served since it was ported (A.4): the requests
    once refused here now preprocess to the reference's request, with
    its guided spec."""
    chat = {"messages": CHAT, **req}
    got = Preprocessor(_card()).preprocess_chat(chat)
    assert got == RefPreprocessor(_ref_card()).preprocess_chat(chat)
    assert got["guided"]["kind"] == "regex"


def test_images_cards_and_templates_refused():
    img = [{"role": "user", "content": [
        {"type": "text", "text": "see"},
        {"type": "image_url", "image_url": {"url": "data:image/png;base64,AAAA"}}]}]
    msg = "model serves no vision encoder"
    with pytest.raises(ValueError, match=msg):
        Preprocessor(_card()).preprocess_chat({"messages": img})
    with pytest.raises(ValueError, match=msg):
        RefPreprocessor(_ref_card()).preprocess_chat({"messages": img})
    text_blocks = [{"role": "user", "content": [{"type": "text", "text": "a"},
                                                  {"type": "input_text", "text": "b"}]}]
    assert Preprocessor(_card()).preprocess_chat({"messages": text_blocks}) == \
        RefPreprocessor(_ref_card()).preprocess_chat({"messages": text_blocks})
    with pytest.raises(ValueError, match="chat template"):
        Preprocessor(_card(chat_template="{{ messages }}"))
    with pytest.raises(ValueError, match="tokenizer.json"):
        Preprocessor(_card(tokenizer="/m/tokenizer.json"))


# -- HTTP framing ------------------------------------------------------------------


async def _raw(port, data: bytes, read_until_close=True) -> bytes:
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(data)
    await writer.drain()
    out = await asyncio.wait_for(reader.read(), 10) if read_until_close else b""
    writer.close()
    return out


async def test_http_framing():
    """Two requests on one keep-alive connection (the second with a
    chunked body and Expect: 100-continue), unknown routes, a wrong
    method and a malformed request line."""
    rt = DistributedRuntime(discovery=MemDiscovery(realm="http-framing"))
    svc = HttpService(rt, port=0)
    await svc.start()
    try:
        body = json.dumps({"model": "nope", "prompt": "x"}).encode()
        chunked = b"%x\r\n%s\r\n%x\r\n%s\r\n0\r\n\r\n" % (5, body[:5], len(body) - 5, body[5:])
        out = await _raw(svc.port, (
            b"GET /live HTTP/1.1\r\nHost: x\r\n\r\n"
            b"POST /v1/completions HTTP/1.1\r\nHost: x\r\nTransfer-Encoding: chunked\r\n"
            b"Expect: 100-continue\r\nConnection: close\r\n\r\n" + chunked))
        parts = out.split(b"HTTP/1.1 ")
        assert parts[1].startswith(b"200 OK") and parts[1].endswith(b'{"live": true}')
        assert parts[2].startswith(b"100 Continue")
        assert parts[3].startswith(b"404 Not Found")
        assert parts[3].endswith(
            b'{"error": {"message": "model \'nope\' not found", "type": "model_not_found", '
            b'"code": 404}}')
        out = await _raw(svc.port, b"GET /nowhere HTTP/1.1\r\nConnection: close\r\n\r\n")
        assert out.startswith(b"HTTP/1.1 404") and out.endswith(b"404: Not Found")
        out = await _raw(svc.port, b"GET /v1/completions HTTP/1.0\r\n\r\n")
        assert out.startswith(b"HTTP/1.1 405") and b"Connection: close" in out
        out = await _raw(svc.port, b"NONSENSE\r\n\r\n")
        assert out.startswith(b"HTTP/1.1 400")
        out = await _raw(svc.port, b"POST /v1/completions HTTP/1.1\r\nContent-Length: 3\r\n"
                                   b"Connection: close\r\n\r\n{x}")
        assert out.startswith(b"HTTP/1.1 400") and b"invalid JSON body" in out
        out = await _raw(svc.port, b"GET /ready HTTP/1.1\r\nConnection: close\r\n\r\n")
        assert out.startswith(b"HTTP/1.1 503") and out.endswith(b'{"ready": false}')
    finally:
        await svc.stop()
        await rt.shutdown(drain_timeout=1)


class _Stall:
    """A worker engine that yields one token and then sends nothing until
    its request is stopped or killed, as the engine's stream watches its
    context; `closed` is set when its stream ends."""

    def __init__(self):
        self.closed = asyncio.Event()

    async def generate(self, request, context):
        try:
            yield {"token_ids": [65], "finish_reason": None}
            await context.wait_stopped()
        finally:
            self.closed.set()


@pytest.mark.parametrize("stream", [True, False])
async def test_dropped_client_closes_a_stalled_stream(stream):
    """The client drops its connection while the worker sends nothing (no
    write can fail): the frontend still notices at once and the worker's
    stream is closed within 5 s."""
    realm = f"stall-{stream}"
    wrt = DistributedRuntime(discovery=MemDiscovery(realm=realm))
    stall = _Stall()
    await wrt.serve_endpoint("dyn/worker/generate", stall,
                             metadata={"model_card": _card().to_dict()})
    frt = DistributedRuntime(discovery=MemDiscovery(realm=realm))
    svc = HttpService(frt, port=0)
    await svc.start()
    try:
        await svc.watcher.wait_for_model(timeout=10)
        reader, writer = await asyncio.open_connection("127.0.0.1", svc.port)
        body = json.dumps({"model": "m", "prompt": "x", "stream": stream}).encode()
        writer.write(b"POST /v1/completions HTTP/1.1\r\nContent-Length: %d\r\n\r\n%s"
                     % (len(body), body))
        await writer.drain()
        if stream:
            got = b""
            while b'"text": "A"' not in got:
                got += await asyncio.wait_for(reader.read(4096), 10)
        else:
            await asyncio.sleep(0.2)
        assert not stall.closed.is_set()
        sock = writer.get_extra_info("socket")
        sock.shutdown(socket.SHUT_RDWR)
        writer.close()
        await asyncio.wait_for(stall.closed.wait(), 5)
        assert svc._in_flight.get("m") == 0
    finally:
        await svc.stop(drain_timeout=1)
        await frt.shutdown(drain_timeout=1)
        await wrt.shutdown(drain_timeout=1)


async def test_busy_threshold_sheds_with_503():
    """busy_threshold 1: with one stream in flight a second request is
    shed with the reference's 503 body; once the first ends, requests
    pass again."""
    realm = "busy"
    wrt = DistributedRuntime(discovery=MemDiscovery(realm=realm))
    stall = _Stall()
    await wrt.serve_endpoint("dyn/worker/generate", stall,
                             metadata={"model_card": _card().to_dict()})
    frt = DistributedRuntime(discovery=MemDiscovery(realm=realm))
    svc = HttpService(frt, port=0, busy_threshold=1)
    await svc.start()
    try:
        await svc.watcher.wait_for_model(timeout=10)
        reader, writer = await asyncio.open_connection("127.0.0.1", svc.port)
        body = json.dumps({"model": "m", "prompt": "x", "stream": True}).encode()
        writer.write(b"POST /v1/completions HTTP/1.1\r\nContent-Length: %d\r\n\r\n%s"
                     % (len(body), body))
        await writer.drain()
        got = b""
        while b'"text": "A"' not in got:
            got += await asyncio.wait_for(reader.read(4096), 10)
        second = json.dumps({"model": "m", "prompt": "y"}).encode()
        shed = await _raw(svc.port, b"POST /v1/completions HTTP/1.1\r\nConnection: close\r\n"
                                    b"Content-Length: %d\r\n\r\n%s" % (len(second), second))
        assert shed.startswith(b"HTTP/1.1 503 Service Unavailable")
        assert shed.endswith(b'{"error": {"message": "server busy, retry later", '
                             b'"type": "server_busy", "code": 503}}')
        writer.close()
        await asyncio.wait_for(stall.closed.wait(), 5)
        out = await _raw(svc.port, b"GET /metrics HTTP/1.1\r\nConnection: close\r\n\r\n")
        assert b'dynamo_frontend_in_flight{' in out and b'model="m"} 0.0' in out
        assert b"dynamo_frontend_requests_total{" in out
        assert b"dynamo_frontend_request_duration_seconds_count{" in out
    finally:
        await svc.stop(drain_timeout=1)
        await frt.shutdown(drain_timeout=1)
        await wrt.shutdown(drain_timeout=1)
