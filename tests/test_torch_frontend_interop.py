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
