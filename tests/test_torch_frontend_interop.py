"""The port's frontend against the reference's `HttpService`, in front of
the same workers on one file-discovery root, on the CPU at f32 on a tiny
model whose params come from numpy: a port worker ("tiny-port") and a
reference worker on the JAX engine ("tiny-jax"). For the same greedy
requests the two frontends give equal unary JSON bodies and equal SSE
chunk sequences, except `id` and `created` (exact), and equal error
bodies; the port frontend's answers from the reference worker equal its
answers from the port worker (text and usage: the two engines' greedy
streams are equal, tests/test_torch_served.py). Both frontends run in
`round_robin` mode, the reference's default: a reference worker's KV
events ride ZMQ or in-process buses, which the port's TCP event plane
does not read.
"""

import asyncio
import http.client
import json

import jax
import jax.numpy as jnp
import pytest
import torch

from dynamo_tpu.engine.engine import InferenceEngine as JaxEngine
from dynamo_tpu.engine.model_runner import ModelRunner as JaxRunner
from dynamo_tpu.frontend.http import HttpService as RefHttpService
from dynamo_tpu.frontend.protocols import ModelCard as RefModelCard
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.models.config import get_config as jax_get_config
from dynamo_tpu.runtime.discovery import FileDiscovery as RefFileDiscovery
from dynamo_tpu.runtime.distributed import DistributedRuntime as RefRuntime
from dynamo_tpu.worker_common import serve_worker as ref_serve_worker
from dynamo_tpu_torch.engine.engine import InferenceEngine
from dynamo_tpu_torch.engine.model_runner import ModelRunner
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.frontend.http import HttpService
from dynamo_tpu_torch.frontend.protocols import ModelCard
from dynamo_tpu_torch.models.config import get_config
from dynamo_tpu_torch.runtime.discovery import FileDiscovery
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.worker_common import serve_worker

T = 60
PS = 4
GEOMETRY = dict(num_pages=64, page_size=PS, max_pages_per_seq=16,
                decode_buckets=(1, 2, 4, 8), prefill_buckets=(8, 16, 32))
MODELS = ("tiny-port", "tiny-jax")

CHAT = [{"role": "system", "content": "be brief <&>"}, {"role": "user", "content": "hi €"}]
REQUESTS = {
    "completion": {"prompt": "hello", "max_tokens": 5, "temperature": 0},
    "completion_ids": {"prompt": [5, 300, 7, 9], "max_tokens": 6, "temperature": 0,
                       "ignore_eos": True},
    "completion_stop": {"prompt": "ab", "max_tokens": 6, "temperature": 0, "stop": ["\x00"]},
    "completion_stream": {"prompt": "hello", "max_tokens": 5, "temperature": 0,
                          "stream": True},
    "completion_usage": {"prompt": "hey", "max_tokens": 4, "temperature": 0, "stream": True,
                         "stream_options": {"include_usage": True}},
    "chat": {"messages": CHAT, "max_tokens": 5, "temperature": 0},
    "chat_stream": {"messages": CHAT, "max_tokens": 4, "temperature": 0, "stream": True,
                    "stream_options": {"include_usage": True}},
    "n2": {"prompt": "hi", "max_tokens": 3, "temperature": 0, "n": 2},
    # errors
    "over_context": {"prompt": "x" * 80, "max_tokens": 2},
    "stream_n2": {"prompt": "hi", "stream": True, "n": 2},
    "bad_n": {"prompt": "hi", "n": "many"},
    "bad_priority": {"prompt": "hi", "priority": "high"},
}
CHAT_KINDS = {"chat", "chat_stream"}
ERRORS = {"over_context", "stream_n2", "bad_n", "bad_priority"}


def _request(port, method, path, body=None, headers=None):
    """(status, headers, body bytes) over http.client."""
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=T)
    try:
        c.request(method, path, json.dumps(body) if body is not None else None,
                  {"Content-Type": "application/json", **(headers or {})})
        r = c.getresponse()
        return r.status, dict(r.getheaders()), r.read()
    finally:
        c.close()


def sse_events(data: bytes):
    return [line[len("data: "):] for line in data.decode().split("\n\n")
            if line.startswith("data: ")]


@pytest.fixture(scope="module")
def answers(tmp_path_factory):
    """Every request of REQUESTS through both frontends for both models,
    plus the error answers that need no model."""
    root = str(tmp_path_factory.mktemp("discovery"))
    jparams = jax.device_get(jllama.init_params(
        jax_get_config("tiny"), jax.random.PRNGKey(7), jnp.float32))

    async def scenario():
        cfg = get_config("tiny")
        port_rt = DistributedRuntime(discovery=FileDiscovery(root, poll_interval=0.05))
        eng = InferenceEngine(ModelRunner(
            cfg, device="cpu", dtype=torch.float32,
            params=params_from_numpy(jparams, cfg, "cpu", torch.float32), **GEOMETRY),
            max_batch=4, chunk_size=16)
        port_w = await serve_worker(port_rt, eng, ModelCard(
            name="tiny-port", context_length=64, kv_block_size=PS))
        ref_rt = RefRuntime(discovery=RefFileDiscovery(root, poll_interval=0.05),
                            event_transport="inproc")
        jeng = JaxEngine(JaxRunner(jax_get_config("tiny"), params=jparams,
                                   dtype=jnp.float32, **GEOMETRY),
                         max_batch=4, chunk_size=16)
        ref_w = await ref_serve_worker(
            ref_rt, jeng, RefModelCard(name="tiny-jax", context_length=64, kv_block_size=PS),
            component="jax-worker", digest_period_s=0)
        port_front = DistributedRuntime(discovery=FileDiscovery(root, poll_interval=0.05))
        ref_front = RefRuntime(discovery=RefFileDiscovery(root, poll_interval=0.05),
                               event_transport="inproc")
        port_svc, ref_svc = HttpService(port_front, port=0), RefHttpService(ref_front, port=0)
        out = {"port": {}, "ref": {}}
        try:
            await port_svc.start()
            await ref_svc.start()

            async def both_models():
                while not all(set(MODELS) <= set(s.manager.list_models())
                              for s in (port_svc, ref_svc)):
                    await asyncio.sleep(0.05)

            await asyncio.wait_for(both_models(), T)
            pin = f"{port_w.instance.instance_id:x}"
            for name, body in REQUESTS.items():
                path = "/v1/chat/completions" if name in CHAT_KINDS else "/v1/completions"
                for model in MODELS:
                    for which, svc in (("ref", ref_svc), ("port", port_svc)):
                        out[which][name, model] = await asyncio.to_thread(
                            _request, svc.port, "POST", path, dict(body, model=model))
            for which, svc in (("ref", ref_svc), ("port", port_svc)):
                call = lambda *a: asyncio.to_thread(_request, svc.port, *a)  # noqa: E731
                out[which]["no_model"] = await call("POST", "/v1/completions",
                                                    {"model": "nope", "prompt": "x"})
                out[which]["get_no_model"] = await call("GET", "/v1/models/nope")
                out[which]["pinned"] = await call(
                    "POST", "/v1/completions",
                    {"model": "tiny-port", "prompt": "pin", "max_tokens": 3, "temperature": 0},
                    {"x-dynamo-worker-instance-id": pin})
                out[which]["bad_pin"] = await call(
                    "POST", "/v1/completions", {"model": "tiny-port", "prompt": "x"},
                    {"x-dynamo-worker-instance-id": "not-hex"})
                out[which]["health"] = await call("GET", "/health")
                out[which]["live"] = await call("GET", "/live")
                out[which]["ready"] = await call("GET", "/ready")
                out[which]["models"] = await call("GET", "/v1/models")
        finally:
            await port_svc.stop()
            await ref_svc.stop()
            await port_front.shutdown(drain_timeout=1)
            await ref_front.shutdown(drain_timeout=1)
            await port_rt.shutdown(drain_timeout=1)
            await port_w.stop()
            await ref_rt.shutdown(drain_timeout=1)
            await ref_w.stop()
        return out

    return asyncio.run(asyncio.wait_for(scenario(), 6 * T))


def _strip(obj):
    if isinstance(obj, dict):
        return {k: _strip(v) for k, v in obj.items() if k not in ("id", "created")}
    return obj


def _body(answer):
    """A JSON answer without id and created, or an SSE answer as its
    chunks without them ([DONE] kept)."""
    status, headers, body = answer
    if headers.get("Content-Type", "").startswith("text/event-stream"):
        return status, [e if e == "[DONE]" else _strip(json.loads(e)) for e in sse_events(body)]
    return status, _strip(json.loads(body))


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("name", sorted(REQUESTS))
def test_port_frontend_answers_equal_reference(answers, name, model):
    got = _body(answers["port"][name, model])
    assert got == _body(answers["ref"][name, model])
    assert got[0] == (400 if name in ERRORS else 200)
    if name == "completion_usage":
        assert got[1][-1] == "[DONE]" and got[1][-2]["usage"]["completion_tokens"] == 4


@pytest.mark.parametrize("name", ["no_model", "get_no_model", "pinned", "bad_pin", "health",
                                  "live", "ready"])
def test_port_frontend_other_answers_equal_reference(answers, name):
    assert _body(answers["port"][name]) == _body(answers["ref"][name])


def test_models_list_equal_reference(answers):
    def ids(a):
        return sorted(m["id"] for m in json.loads(a[2])["data"])

    assert ids(answers["port"]["models"]) == ids(answers["ref"]["models"]) == sorted(MODELS)


@pytest.mark.parametrize("name", ["completion", "completion_ids", "chat", "chat_stream",
                                  "completion_usage"])
def test_port_frontend_same_answer_from_either_worker(answers, name):
    """The port frontend's answer from the reference worker equals its
    answer from the port worker, but for the model's name."""
    def rename(x):
        return json.loads(json.dumps(x).replace("tiny-jax", "tiny-port"))

    status, body = _body(answers["port"][name, "tiny-jax"])
    assert (status, rename(body)) == _body(answers["port"][name, "tiny-port"])


# -- the sampling extras behind both frontends (a 512-token context) ---------

LONG_GEOMETRY = dict(num_pages=512, page_size=PS, max_pages_per_seq=128,
                     decode_buckets=(1, 2, 4, 8), prefill_buckets=(8, 16, 32, 64, 128, 256))
LONG_MODELS = ("tiny-port-long", "tiny-jax-long")
SCHEMA = {"type": "object", "properties": {"ok": {"type": "boolean"},
                                           "n": {"enum": [1, 2, 3]}},
          "required": ["ok", "n"], "additionalProperties": False}
TOOLS = [{"type": "function", "function": {"name": "set_unit", "parameters": {
    "type": "object", "properties": {"unit": {"enum": ["c", "f"]}},
    "required": ["unit"], "additionalProperties": False}}}]
JSON_FORMAT = {"type": "json_schema", "json_schema": {"name": "r", "schema": SCHEMA}}
LONG_REQUESTS = {
    "chat_json_schema": {"messages": CHAT, "max_tokens": 40, "temperature": 0,
                         "response_format": JSON_FORMAT},
    "chat_json_stream": {"messages": CHAT, "max_tokens": 40, "temperature": 0,
                         "response_format": JSON_FORMAT, "stream": True},
    "chat_tools_required": {"messages": CHAT, "tools": TOOLS, "tool_choice": "required",
                            "max_tokens": 120, "temperature": 0},
    "chat_tools_named_stream": {"messages": CHAT, "tools": TOOLS, "stream": True,
                                "tool_choice": {"type": "function",
                                                "function": {"name": "set_unit"}},
                                "max_tokens": 120, "temperature": 0},
    "completion_logprobs": {"prompt": "hello", "max_tokens": 5, "temperature": 0,
                            "logprobs": 3},
    "completion_logprobs_stream": {"prompt": "hello", "max_tokens": 5, "temperature": 0,
                                   "logprobs": 2, "stream": True},
    "chat_logprobs": {"messages": CHAT, "max_tokens": 4, "temperature": 0,
                      "logprobs": True, "top_logprobs": 2},
    "chat_logprobs_stream": {"messages": CHAT, "max_tokens": 4, "temperature": 0,
                             "logprobs": True, "top_logprobs": 3, "stream": True},
    "guided_choice": {"prompt": "pick", "max_tokens": 10, "temperature": 0,
                      "guided_choice": ["red", "green", "blue"]},
    "penalties_bias": {"prompt": "aaaa", "max_tokens": 6, "temperature": 0,
                       "repetition_penalty": 1.5, "frequency_penalty": 0.5,
                       "logit_bias": {"98": 100}},
}
EMBED_INPUTS = ["hello", "a b c", [5, 6, 7, 300]]


@pytest.fixture(scope="module")
def long_answers(tmp_path_factory):
    """Every request of LONG_REQUESTS and an embeddings request through
    both frontends for both long-context models."""
    root = str(tmp_path_factory.mktemp("discovery-long"))
    jparams = jax.device_get(jllama.init_params(
        jax_get_config("tiny"), jax.random.PRNGKey(7), jnp.float32))

    async def scenario():
        cfg = get_config("tiny")
        port_rt = DistributedRuntime(discovery=FileDiscovery(root, poll_interval=0.05))
        eng = InferenceEngine(ModelRunner(
            cfg, device="cpu", dtype=torch.float32,
            params=params_from_numpy(jparams, cfg, "cpu", torch.float32), **LONG_GEOMETRY),
            max_batch=4, chunk_size=64)
        port_w = await serve_worker(port_rt, eng, ModelCard(
            name="tiny-port-long", context_length=512, kv_block_size=PS))
        ref_rt = RefRuntime(discovery=RefFileDiscovery(root, poll_interval=0.05),
                            event_transport="inproc")
        jeng = JaxEngine(JaxRunner(jax_get_config("tiny"), params=jparams,
                                   dtype=jnp.float32, **LONG_GEOMETRY),
                         max_batch=4, chunk_size=64)
        ref_w = await ref_serve_worker(
            ref_rt, jeng, RefModelCard(name="tiny-jax-long", context_length=512,
                                       kv_block_size=PS),
            component="jax-worker", digest_period_s=0)
        port_front = DistributedRuntime(discovery=FileDiscovery(root, poll_interval=0.05))
        ref_front = RefRuntime(discovery=RefFileDiscovery(root, poll_interval=0.05),
                               event_transport="inproc")
        port_svc, ref_svc = HttpService(port_front, port=0), RefHttpService(ref_front, port=0)
        out = {"port": {}, "ref": {}}
        try:
            await port_svc.start()
            await ref_svc.start()

            async def both_models():
                while not all(set(LONG_MODELS) <= set(s.manager.list_models())
                              for s in (port_svc, ref_svc)):
                    await asyncio.sleep(0.05)

            await asyncio.wait_for(both_models(), T)
            for model in LONG_MODELS:
                for which, svc in (("ref", ref_svc), ("port", port_svc)):
                    for name, body in LONG_REQUESTS.items():
                        path = ("/v1/chat/completions" if "messages" in body
                                else "/v1/completions")
                        out[which][name, model] = await asyncio.to_thread(
                            _request, svc.port, "POST", path, dict(body, model=model))
                    out[which]["embeddings", model] = await asyncio.to_thread(
                        _request, svc.port, "POST", "/v1/embeddings",
                        {"model": model, "input": EMBED_INPUTS})
        finally:
            await port_svc.stop()
            await ref_svc.stop()
            await port_front.shutdown(drain_timeout=1)
            await ref_front.shutdown(drain_timeout=1)
            await port_rt.shutdown(drain_timeout=1)
            await port_w.stop()
            await ref_rt.shutdown(drain_timeout=1)
            await ref_w.stop()
        return out

    return asyncio.run(asyncio.wait_for(scenario(), 6 * T))


def _close(got, want, path="$"):
    """Equal JSON values, floats within 1e-4 and the values of "id" keys
    (a tool call's random id) ignored."""
    if isinstance(want, float) or isinstance(got, float):
        assert abs(got - want) <= 1e-4, (path, got, want)
    elif isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), (path, got, want)
        for k in want:
            if k != "id":
                _close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), (path, got, want)
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{path}[{i}]")
    else:
        assert got == want, (path, got, want)


@pytest.mark.parametrize("model", LONG_MODELS)
@pytest.mark.parametrize("name", sorted(LONG_REQUESTS) + ["embeddings"])
def test_port_frontend_extras_equal_reference(long_answers, name, model):
    got = _body(long_answers["port"][name, model])
    _close(got, _body(long_answers["ref"][name, model]))
    assert got[0] == 200
    status, body = got
    if name == "embeddings":
        assert [d["index"] for d in body["data"]] == [0, 1, 2]
        for d in body["data"]:
            assert abs(sum(v * v for v in d["embedding"]) - 1.0) < 1e-4
    elif name == "chat_tools_required":
        choice = body["choices"][0]
        if choice["finish_reason"] == "tool_calls":
            call = choice["message"]["tool_calls"][0]["function"]
            assert call["name"] == "set_unit"
            assert json.loads(call["arguments"])["unit"] in ("c", "f")
    elif name == "completion_logprobs":
        lp = body["choices"][0]["logprobs"]
        assert len(lp["tokens"]) == body["usage"]["completion_tokens"]
        assert all(v <= 0 for v in lp["token_logprobs"])
    elif name == "guided_choice":
        assert body["choices"][0]["text"] in ("red", "green", "blue")
    elif name == "chat_json_schema":
        choice = body["choices"][0]
        if choice["finish_reason"] == "stop":
            assert set(json.loads(choice["message"]["content"])) == {"ok", "n"}
