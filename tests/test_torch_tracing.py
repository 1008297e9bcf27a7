"""The port's tracing (dynamo_tpu_torch/runtime/tracing.py), profiler ranges
(runtime/annotations.py) and per-hop spans, on the CPU.

- the reference's own tracing cases (tests/test_tracing.py) against the
  port's module: traceparent parsing, parenting and errors, the disabled
  no-op, the OTLP wire format and its events, the bounded exporter queue
  and flush, the migration attempt on the root span, the annotate gate;
- the span ring's read-time sampling and tail marks, against the
  reference's ring on the same spans;
- parity: one request through frontend (Migration) -> PushRouter ->
  request plane -> a served tiny engine over in-process discovery gives
  span trees with the same names and parentage in both packages, every
  span under one trace id;
- the StepProfiler's window on the thread that ticks it: a Chrome trace
  holding the step's ranges.
"""

import asyncio
import contextlib
import json
import queue as queue_mod

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.engine import InferenceEngine as JaxEngine
from dynamo_tpu.engine.model_runner import ModelRunner as JaxRunner
from dynamo_tpu.frontend.migration import Migration as RefMigration
from dynamo_tpu.frontend.protocols import ModelCard as RefModelCard
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.models.config import get_config as jax_get_config
from dynamo_tpu.runtime import tracing as ref_tracing
from dynamo_tpu.runtime.context import Context as RefContext
from dynamo_tpu.runtime.discovery import MemDiscovery as RefMemDiscovery
from dynamo_tpu.runtime.distributed import DistributedRuntime as RefRuntime
from dynamo_tpu.worker_common import serve_worker as ref_serve_worker
from dynamo_tpu_torch.engine.engine import InferenceEngine
from dynamo_tpu_torch.engine.model_runner import ModelRunner
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.frontend.migration import Migration
from dynamo_tpu_torch.frontend.protocols import ModelCard
from dynamo_tpu_torch.models.config import get_config
from dynamo_tpu_torch.runtime import annotations as ann
from dynamo_tpu_torch.runtime import tracing
from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.runtime.discovery import MemDiscovery
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.request_plane import RequestPlaneError
from dynamo_tpu_torch.runtime.tracing import (
    MemorySpanExporter,
    OtlpSpanExporter,
    Span,
    SpanContext,
    SpanRing,
    flush_tracing,
    parse_traceparent,
    set_exporter,
)
from dynamo_tpu_torch.worker_common import serve_worker

T = 60  # bound on every awaited scenario, seconds
PS = 4
GEOMETRY = dict(num_pages=64, page_size=PS, max_pages_per_seq=16,
                decode_buckets=(1, 2, 4, 8), prefill_buckets=(8, 16, 32))


@pytest.fixture
def mem_spans():
    exp = MemorySpanExporter()
    set_exporter(exp)
    yield exp
    set_exporter(None)


@pytest.fixture(autouse=True)
def _fresh_registries():
    yield
    MemDiscovery.reset()
    RefMemDiscovery.reset()


def test_traceparent_parse_and_format():
    ctx = parse_traceparent("00-" + "ab" * 16 + "-" + "cd" * 8 + "-01")
    assert ctx.trace_id == "ab" * 16 and ctx.span_id == "cd" * 8
    assert ctx.traceparent == "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01"
    assert parse_traceparent(None) is None
    assert parse_traceparent("garbage") is None
    assert parse_traceparent("00-" + "0" * 32 + "-" + "cd" * 8 + "-01") is None


def test_span_parenting_and_error(mem_spans):
    with tracing.span("root") as root:
        with tracing.span("child", parent=root.traceparent) as child:
            child.set_attribute("k", 1)
        with pytest.raises(ValueError):
            with tracing.span("bad", parent=root.traceparent):
                raise ValueError("boom")
    spans = {s.name: s for s in mem_spans.spans}
    assert spans["child"].context.trace_id == spans["root"].context.trace_id
    assert spans["child"].parent_span_id == spans["root"].context.span_id
    assert spans["root"].parent_span_id is None
    assert spans["bad"].status_error and "boom" in spans["bad"].status_error
    assert spans["child"].end_ns >= spans["child"].start_ns


def test_disabled_tracing_is_noop_but_forwards():
    set_exporter(None)
    md = {"traceparent": "00-" + "11" * 16 + "-" + "22" * 8 + "-01"}
    with tracing.span("x", parent=md["traceparent"]) as s:
        tracing.child_traceparent(md, s)
    # no exporter: the metadata is untouched, so downstream tracers connect
    assert md["traceparent"].startswith("00-" + "11" * 16)
    assert tracing.record_span("y", 1, 2, parent=md["traceparent"]) is None


def _wire_span(**kw):
    base = dict(name="n", context=SpanContext("a" * 32, "b" * 16),
                parent_span_id="c" * 16, start_ns=1, end_ns=2)
    base.update(kw)
    return Span(**base)


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_otlp_wire_format_matches_reference(pkg):
    """The port's OTLP wire dict of a span equals the reference's."""
    mod = tracing if pkg == "port" else ref_tracing
    exp = mod.OtlpSpanExporter.__new__(mod.OtlpSpanExporter)  # no thread
    s = mod.Span(name="n", context=mod.SpanContext("a" * 32, "b" * 16),
                 parent_span_id="c" * 16, start_ns=1, end_ns=2, kind=2,
                 attributes={"i": 3, "f": 1.5, "b": True, "s": "x"})
    s.record_error("bad")
    w = exp._wire(s)
    assert w["traceId"] == "a" * 32 and w["parentSpanId"] == "c" * 16
    assert w["kind"] == 2  # OTLP SERVER
    attrs = {a["key"]: a["value"] for a in w["attributes"]}
    assert attrs["i"] == {"intValue": "3"}
    assert attrs["b"] == {"boolValue": True}
    assert w["status"]["code"] == 2
    port = OtlpSpanExporter.__new__(OtlpSpanExporter)._wire(
        _wire_span(kind=2, attributes={"i": 3, "f": 1.5, "b": True, "s": "x"}))
    assert port["attributes"] == w["attributes"] and port["traceId"] == w["traceId"]


def test_otlp_wire_span_events():
    exp = OtlpSpanExporter.__new__(OtlpSpanExporter)  # no thread
    s = _wire_span(parent_span_id=None)
    s.add_event("phase.ttft_s", {"seconds": 0.25})
    s.add_event("migration", {"attempt": 1})
    w = exp._wire(s)
    assert [e["name"] for e in w["events"]] == ["phase.ttft_s", "migration"]
    ev = w["events"][0]
    assert int(ev["timeUnixNano"]) > 0
    assert ev["attributes"] == [{"key": "seconds", "value": {"doubleValue": 0.25}}]


def test_otlp_exporter_bounded_queue_and_flush():
    exp = OtlpSpanExporter.__new__(OtlpSpanExporter)  # no thread
    exp._q = queue_mod.Queue(maxsize=2)
    exp.dropped = 0
    exp._inflight = 0
    for i in range(5):
        exp.export(_wire_span(name=f"s{i}", parent_span_id=None))
    assert exp._q.qsize() == 2 and exp.dropped == 3
    assert exp.flush(timeout_s=0.1) is False  # nothing consumes the queue
    while not exp._q.empty():
        exp._q.get_nowait()
    assert exp.flush(timeout_s=0.1) is True
    exp._inflight = 2  # a batch in flight holds the drain
    assert exp.flush(timeout_s=0.1) is False
    exp._inflight = 0
    assert exp.flush(timeout_s=0.1) is True
    set_exporter(None)
    assert flush_tracing(0.1) is True
    set_exporter(exp)
    try:
        assert flush_tracing(0.1) is True
        assert tracing.dropped_spans() == 3
    finally:
        set_exporter(None)


async def test_migration_attempt_recorded(mem_spans):
    class Flaky:
        calls = 0

        async def generate(self, request, context):
            Flaky.calls += 1
            if Flaky.calls == 1:
                raise RequestPlaneError("gone", code="disconnected")
                yield
            yield {"token_ids": [1], "finish_reason": "stop"}

    mig = Migration(Flaky(), migration_limit=2, backoff_base_s=0.0)
    out = [item async for item in mig.generate({"token_ids": [5], "stop": {}}, Context())]
    assert out[-1]["finish_reason"] == "stop"
    root = next(s for s in mem_spans.spans if s.name == "frontend.request")
    assert root.attributes.get("migration.attempts") == 1
    assert [e["name"] for e in root.events][:1] == ["migration"]
    # a migrated request tail-marks its trace: the marker span carries it
    tail = next(s for s in mem_spans.spans if s.name == "trace.tail")
    assert tail.context.tail and tail.attributes["reason"] == "migration"
    assert tail.context.trace_id == root.context.trace_id


def test_trace_annotations_gate(monkeypatch):
    monkeypatch.delenv("DYN_ENABLE_JAX_TRACE", raising=False)
    ann._enabled.cache_clear()
    try:
        assert isinstance(ann.annotate("x"), contextlib.nullcontext)
        monkeypatch.setenv("DYN_ENABLE_JAX_TRACE", "1")
        ann._enabled.cache_clear()
        cm = ann.annotate("engine.decode")
        assert not isinstance(cm, contextlib.nullcontext)
        with cm:  # a record_function range; no card here, no NVTX
            pass
    finally:
        monkeypatch.delenv("DYN_ENABLE_JAX_TRACE", raising=False)
        ann._enabled.cache_clear()


@pytest.mark.parametrize("keep_prob", [1.0, 0.5, 0.0])
def test_span_ring_samples_at_read_like_the_reference(keep_prob):
    """The same spans into both rings: the same traces survive a
    snapshot (tail-marked ones always), and the payloads agree."""
    rng = np.random.default_rng(5)
    rings = [SpanRing(capacity=64, keep_prob=keep_prob),
             ref_tracing.SpanRing(capacity=64, keep_prob=keep_prob)]
    for i in range(40):
        tid = "".join(f"{x:02x}" for x in rng.integers(0, 256, 16))
        flags = "03" if i % 7 == 0 else "01"
        for mod, ring in zip((tracing, ref_tracing), rings):
            ring.export(mod.Span(name=f"s{i}", context=mod.SpanContext(tid, "ab" * 8, flags),
                                 parent_span_id=None, start_ns=i, end_ns=i + 1))
    port, ref = (r.payload() for r in rings)
    assert port == ref
    assert rings[0].tail_trace_ids() == rings[1].tail_trace_ids()
    assert len(rings[0].tail_trace_ids()) == 6
    if keep_prob == 0.0:
        assert port["n"] == 6  # only the tail-marked traces


def _tree(spans):
    """{(name, parent name)} and the trace ids of a request's spans."""
    by_id = {s.context.span_id: s for s in spans}
    edges = sorted((s.name.split(" ")[0] if s.name.startswith("rpc ") else s.name,
                    (by_id[s.parent_span_id].name.split(" ")[0]
                     if s.parent_span_id in by_id else None))
                   for s in spans)
    return edges, {s.context.trace_id for s in spans}


@pytest.fixture(scope="module")
def jparams():
    return jax.device_get(jllama.init_params(
        jax_get_config("tiny"), jax.random.PRNGKey(7), jnp.float32))


async def _one_request(rt_cls, disc_cls, serve, engine, card, mig_cls, ctx_cls, realm):
    w_rt = rt_cls(discovery=disc_cls(realm=realm), event_transport="inproc")
    c_rt = rt_cls(discovery=disc_cls(realm=realm), event_transport="inproc")
    worker = await serve(w_rt, engine, card)
    try:
        client = c_rt.client("dyn/tpu-worker/generate")
        await asyncio.wait_for(client.wait_ready(), T)
        mig = mig_cls(client, migration_limit=0)
        req = {"token_ids": [5, 6, 7, 8, 9, 10], "sampling": {"temperature": 0.0},
               "stop": {"max_tokens": 4, "stop_ids": []}}
        toks = []
        async for item in mig.generate(req, ctx_cls()):
            toks.extend(item["token_ids"])
        await client.close()
        return toks
    finally:
        await c_rt.shutdown()
        await w_rt.shutdown()
        await worker.stop()


async def test_span_trees_match_reference(jparams):
    """frontend.request -> route.push -> rpc <generate> -> worker.request
    -> worker.queue / worker.prefill / worker.stream in both packages,
    one trace id a request."""
    port_spans, ref_spans = MemorySpanExporter(), ref_tracing.MemorySpanExporter()
    set_exporter(port_spans)
    ref_tracing.set_exporter(ref_spans)
    try:
        cfg = get_config("tiny")
        runner = ModelRunner(cfg, device="cpu", dtype=torch.float32,
                             params=params_from_numpy(jparams, cfg, "cpu", torch.float32),
                             **GEOMETRY)
        port_toks = await asyncio.wait_for(_one_request(
            DistributedRuntime, MemDiscovery, serve_worker,
            InferenceEngine(runner, max_batch=4, chunk_size=16),
            ModelCard(name="tiny", context_length=64, kv_block_size=PS),
            Migration, Context, "spans-port"), T)
        jrun = JaxRunner(jax_get_config("tiny"), params=jparams, dtype=jnp.float32,
                         **GEOMETRY)
        ref_toks = await asyncio.wait_for(_one_request(
            RefRuntime, RefMemDiscovery, ref_serve_worker,
            JaxEngine(jrun, max_batch=4, chunk_size=16),
            RefModelCard(name="tiny", context_length=64, kv_block_size=PS),
            RefMigration, RefContext, "spans-ref"), T)
    finally:
        set_exporter(None)
        ref_tracing.set_exporter(None)
    assert port_toks == ref_toks and len(port_toks) == 4
    port_tree, port_ids = _tree(port_spans.spans)
    ref_tree, ref_ids = _tree(ref_spans.spans)
    assert port_tree == ref_tree
    assert len(port_ids) == 1 and len(ref_ids) == 1
    names = {e[0] for e in port_tree}
    assert {"frontend.request", "route.push", "rpc", "worker.request",
            "worker.queue", "worker.prefill", "worker.stream"} <= names


def test_step_profiler_window_holds_the_ticking_threads_ranges(tmp_path):
    """A window requested from another thread opens and closes on the
    thread that ticks it; its Chrome trace holds that thread's ranges."""
    import threading
    import time

    prof = ann.StepProfiler()
    fut = prof.request(30, str(tmp_path))
    done = threading.Event()

    def step_thread():
        x = torch.randn(64, 64)
        while not done.is_set():
            prof.tick()
            with ann.annotate("engine.decode"):
                x = torch.tanh(x @ x)
            time.sleep(0.002)

    th = threading.Thread(target=step_thread)
    th.start()
    try:
        path = fut.result(timeout=30)
    finally:
        done.set()
        th.join(timeout=30)
    assert not th.is_alive()
    assert prof.opened == prof.written == 1 and not prof.pending
    names = {e.get("name") for e in json.load(open(path))["traceEvents"]}
    assert "engine.decode" in names
    # closing with a window queued fails its future
    fut2 = prof.request(10, str(tmp_path))
    prof.close()
    with pytest.raises(RuntimeError):
        fut2.result(timeout=1)
