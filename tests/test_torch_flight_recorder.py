"""The port's flight recorder (dynamo_tpu_torch/runtime/flight_recorder.py)
and its engine records, on the CPU.

- the reference's own cases (tests/test_flight_recorder.py) against the
  port's module: ring wraparound, the disabled recorder, the frontend's
  finish phases and span events, the Chrome-trace schema, the
  /debug/timeline route (on the port's status server), the anomaly
  trigger's fire-once-per-excursion dump, counting without a dump
  directory, recorder on/off byte identity on the port engine, and the
  metrics text exposition;
- the anomaly dump's profile window through the engine's StepProfiler;
- parity: the port engine and the JAX engine, stepped through the same
  plans on the same tiny f32 params under DYN_FUSED_MIXED=1, record the
  same composition, field for field (`ragged` says which program the
  port's runner ran: compared where the reference's len(chunks) > 1
  guess means the same, and held to the runner's counters elsewhere);
- one record per dispatched iteration, whose sums match the runner's
  counters.
"""

import asyncio
import json
import os
import time
import types

import aiohttp
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.engine import InferenceEngine as JaxEngine
from dynamo_tpu.engine.model_runner import ModelRunner as JaxRunner
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.models.config import get_config as jax_get_config
from dynamo_tpu.runtime.context import Context as JaxContext
from dynamo_tpu_torch.engine.engine import InferenceEngine
from dynamo_tpu_torch.engine.model_runner import ModelRunner
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.frontend.migration import Migration
from dynamo_tpu_torch.models.config import get_config
from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.runtime.flight_recorder import (
    FlightRecorder,
    IterationRecord,
    to_chrome_trace,
)
from dynamo_tpu_torch.runtime.metrics import SimpleMetrics
from dynamo_tpu_torch.runtime.status import StatusServer

GEOMETRY = dict(num_pages=96, page_size=4, max_pages_per_seq=16,
                decode_buckets=(1, 2, 4, 8), prefill_buckets=(8, 16))
ENGINE = dict(max_batch=6, chunk_size=8, mixed_prefill_tokens=8,
              mixed_prefill_seqs=4, mixed_min_chunk=2)
COMPOSITION = ("kind", "decode_seqs", "decode_steps", "n_chunks", "chunk_tokens",
               "charged_tokens", "fused", "guided_rows", "accepted_per_step")


def _rec(seq, wall_s=0.004, kind="decode", **over):
    base = dict(
        seq=seq, ts=1700000000.0 + seq * 0.01, wall_s=wall_s, kind=kind,
        decode_seqs=2, decode_steps=4, n_chunks=0, chunk_tokens=0,
        charged_tokens=0, ragged=False, fused=False, n_waiting=0,
        n_running=2, kv_usage=0.25, g2_blocks=0, g3_blocks=0,
        prefetch_hits=0, compile_variants=1, compile_calls=seq + 1,
    )
    base.update(over)
    return IterationRecord(**base)


def test_ring_wraparound():
    fr = FlightRecorder(capacity=8, anomaly_k=0.0)
    for i in range(20):
        fr.append(_rec(i))
    assert len(fr) == 8
    assert fr.total_appended == 20
    assert [r.seq for r in fr.snapshot()] == list(range(12, 20))  # oldest first
    assert [r.seq for r in fr.snapshot(3)] == [17, 18, 19]
    assert fr.snapshot(0) == []


def test_disabled_recorder_is_noop():
    fr = FlightRecorder(capacity=0)
    assert not fr.enabled
    fr.append(_rec(0))
    assert len(fr) == 0 and fr.snapshot() == []
    assert fr.to_chrome_trace()["traceEvents"][0]["ph"] == "M"
    assert fr.stats()["enabled"] is False


def test_frontend_finish_phases_folds_e2e_and_events():
    events = []
    root = types.SimpleNamespace(
        add_event=lambda name, attributes=None: events.append(name))
    item = {"finish_reason": "stop",
            "phases": {"queue_wait_s": 0.01, "ttft_s": 0.02, "itl_s": [0.001]}}
    Migration._finish_phases(item, root, time.monotonic() - 1.0)
    assert item["phases"]["frontend_e2e_s"] >= 1.0
    assert "phase.ttft_s" in events and "phase.frontend_e2e_s" in events
    assert "phase.itl_s" not in events  # lists are not scalar span events
    bare = {"finish_reason": "stop", "phases": "corrupt"}
    Migration._finish_phases(bare, root, time.monotonic())
    assert isinstance(bare["phases"], dict) and "frontend_e2e_s" in bare["phases"]


def _trace_records():
    out = [_rec(i) for i in range(4)]
    out.append(_rec(4, kind="mixed", n_chunks=2, chunk_tokens=24,
                    charged_tokens=32, ragged=True, fused=True))
    out.append(_rec(5, wall_s=0.5, anomaly=True))
    return out


def test_chrome_trace_schema():
    trace = to_chrome_trace(_trace_records(), pid=7)
    assert json.loads(json.dumps(trace))["displayTimeUnit"] == "ms"
    events = trace["traceEvents"]
    for ev in events:
        for key in ("ph", "ts", "pid", "name"):
            assert key in ev, (key, ev)
        assert ev["pid"] == 7
    slices = [e for e in events if e["ph"] == "X"]
    assert len(slices) == 6
    for s in slices:
        assert s["dur"] >= 0 and s["name"] in ("prefill", "decode", "mixed")
    mixed = [s for s in slices if s["name"] == "mixed"][0]
    assert mixed["args"]["charged_tokens"] == 32 and mixed["args"]["ragged"] is True
    assert {e["name"] for e in events if e["ph"] == "C"} == {"queue", "scheduled_tokens", "kv"}
    instants = [e for e in events if e["ph"] == "i"]
    assert len(instants) == 1 and instants[0]["name"] == "anomaly"
    assert [s["ts"] for s in slices] == sorted(s["ts"] for s in slices)


async def test_debug_timeline_route():
    fr = FlightRecorder(capacity=16, anomaly_k=0.0)
    for i in range(6):
        fr.append(_rec(i))
    srv = StatusServer(types.SimpleNamespace(metrics=SimpleMetrics()), port=0,
                       host="127.0.0.1")
    base = await srv.start()
    try:
        async with aiohttp.ClientSession() as http:
            async with http.get(f"{base}/debug/timeline") as resp:
                assert resp.status == 404  # no source yet
            srv.add_timeline(lambda last_n=None: fr.to_chrome_trace(last_n))
            async with http.get(f"{base}/debug/timeline") as resp:
                assert resp.status == 200
                trace = await resp.json()
            async with http.get(f"{base}/debug/timeline?last_n=2") as resp:
                bounded = await resp.json()
    finally:
        await srv.stop()
    assert len([e for e in trace["traceEvents"] if e["ph"] == "X"]) == 6
    assert len([e for e in bounded["traceEvents"] if e["ph"] == "X"]) == 2


def _wait_files(d, n, suffix=".json", bound=10.0):
    deadline = time.monotonic() + bound
    files = []
    while time.monotonic() < deadline:
        files = sorted(f for f in os.listdir(d) if f.endswith(suffix)) if os.path.isdir(d) else []
        if len(files) >= n:
            break
        time.sleep(0.02)
    return files


def test_anomaly_fires_once_per_excursion(tmp_path):
    dump_dir = str(tmp_path / "dumps")
    fr = FlightRecorder(capacity=64, anomaly_k=3.0, anomaly_min_samples=8,
                        anomaly_dump_dir=dump_dir, anomaly_dump_last_n=16)
    seq = 0
    for _ in range(12):  # warm-up: a steady 4 ms baseline
        fr.append(_rec(seq, wall_s=0.004))
        seq += 1
    assert fr.anomalies_fired == 0
    fired = []
    for _ in range(5):  # a sustained excursion fires once, on its first
        r = _rec(seq, wall_s=1.0)
        fr.append(r)
        fired.append(r.anomaly)
        seq += 1
    assert fired == [True, False, False, False, False]
    assert fr.anomalies_fired == 1
    assert fr.stats()["ewma_s"]["decode"] < 0.01  # the stall did not move it
    for _ in range(3):  # recovery re-arms
        fr.append(_rec(seq, wall_s=0.004))
        seq += 1
    for _ in range(2):
        fr.append(_rec(seq, wall_s=1.0))
        seq += 1
    assert fr.anomalies_fired == 2
    fr.append(_rec(seq, wall_s=5.0, kind="prefill"))  # a fresh kind warms up
    assert fr.anomalies_fired == 2
    files = _wait_files(dump_dir, 2)
    assert len(files) == 2, files
    with open(os.path.join(dump_dir, files[0]), encoding="utf-8") as f:
        dump = json.load(f)
    assert dump["trigger_seq"] == 12 and dump["k"] == 3.0
    assert dump["trigger"]["anomaly"] is True
    assert dump["records"][-1]["seq"] == 11  # the snapshot predates the trigger


def test_anomaly_trigger_without_dump_dir_only_counts():
    fr = FlightRecorder(capacity=32, anomaly_k=2.0, anomaly_min_samples=4)
    for i in range(6):
        fr.append(_rec(i, wall_s=0.004))
    fr.append(_rec(6, wall_s=1.0))
    assert fr.anomalies_fired == 1
    assert fr.dumps_written == 0 and fr.dumps_dropped == 0


def test_anomaly_profile_window_through_the_step_profiler(tmp_path):
    """With anomaly_profile_ms, the dump thread asks `profile_fn` (the
    engine's StepProfiler) for a window; the thread ticking the profiler
    opens and closes it, and the recorder counts the trace written."""
    import threading

    from dynamo_tpu_torch.runtime.annotations import StepProfiler, annotate

    prof = StepProfiler()
    fr = FlightRecorder(capacity=32, anomaly_k=2.0, anomaly_min_samples=4,
                        anomaly_dump_dir=str(tmp_path), anomaly_profile_ms=20)
    fr.profile_fn = prof.request
    done = threading.Event()

    def step_thread():
        x = torch.randn(32, 32)
        while not done.is_set():
            prof.tick()
            with annotate("engine.decode"):
                x = torch.tanh(x @ x)
            time.sleep(0.002)

    th = threading.Thread(target=step_thread)
    th.start()
    try:
        for i in range(6):
            fr.append(_rec(i, wall_s=0.004))
        fr.append(_rec(6, wall_s=1.0))
        deadline = time.monotonic() + 30
        while fr.profiles_written < 1 and time.monotonic() < deadline:
            time.sleep(0.02)
    finally:
        done.set()
        th.join(timeout=30)
    assert fr.anomalies_fired == 1 and fr.profiles_written == 1
    assert fr.stats()["profiles_written"] == 1
    names = {e.get("name") for e in json.load(open(fr.last_profile))["traceEvents"]}
    assert "engine.decode" in names
    assert os.path.dirname(fr.last_profile) == str(tmp_path / "anomaly_profile")


def test_failed_dump_hook_and_profile_window_are_counted(tmp_path):
    """A dump that cannot be written, an anomaly hook that raises and a
    profile window with no opener are each counted, on stats() and on the
    bound metrics; none stops the recorder."""
    m = SimpleMetrics()
    not_a_dir = tmp_path / "a_file"
    not_a_dir.write_text("")
    fr = FlightRecorder(capacity=32, anomaly_k=2.0, anomaly_min_samples=4,
                        anomaly_dump_dir=str(not_a_dir), anomaly_profile_ms=5)
    fr.bind_metrics(m)
    assert fr.stats()["failures"] == {"dump": 0, "hook": 0, "profile": 0}

    def hook(rec):
        raise RuntimeError("hook broke")

    fr.on_anomaly(hook)
    for i in range(6):
        fr.append(_rec(i, wall_s=0.004))
    fr.append(_rec(6, wall_s=1.0))
    deadline = time.monotonic() + 30
    while fr.failures["profile"] < 1 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert fr.anomalies_fired == 1 and fr.dumps_written == 0
    assert fr.stats()["failures"] == {"dump": 1, "hook": 1, "profile": 1}
    text = m.render().decode()
    for what in ("dump", "hook", "profile"):
        assert f'what="{what}"}} 1.0' in text
    fr.append(_rec(7, wall_s=0.004))  # still recording
    assert fr.stats()["appended"] == 8


@pytest.fixture(scope="module")
def jparams():
    return jax.device_get(jllama.init_params(
        jax_get_config("tiny"), jax.random.PRNGKey(3), jnp.float32))


def _prompts():
    rng = np.random.default_rng(7)
    return [rng.integers(1, 500, size=n).tolist() for n in (6, 4, 9, 5, 13)]


def _req(prompt, max_tokens=6):
    return {"token_ids": list(prompt), "sampling": {"temperature": 0.0},
            "stop": {"max_tokens": max_tokens, "stop_ids": []}}


class _Stepped:
    """Stands in for the step thread: the test steps the engine, so both
    engines see the same plans."""

    def join(self, timeout=None):
        pass


async def _serve(engine, reqs, ctx_cls):
    engine._thread = _Stepped()

    async def one(req):
        toks = []
        async for item in engine.generate(req, ctx_cls()):
            assert item.get("finish_reason") != "error", item
            toks.extend(item["token_ids"])
            if item["finish_reason"]:
                break
        return toks

    async def settle():
        for _ in range(4):
            await asyncio.sleep(0)

    try:
        tasks = [asyncio.ensure_future(one(reqs[0]))]
        await settle()
        engine._loop_once()
        tasks += [asyncio.ensure_future(one(r)) for r in reqs[1:]]
        while not all(t.done() for t in tasks):
            await settle()
            engine._loop_once()
        return [t.result() for t in tasks]
    finally:
        engine.stop()


def _port_engine(jparams, **kw):
    cfg = get_config("tiny")
    runner = ModelRunner(cfg, device="cpu", dtype=torch.float32,
                         params=params_from_numpy(jparams, cfg, "cpu", torch.float32),
                         **GEOMETRY)
    return InferenceEngine(runner, **dict(ENGINE, **kw))


@pytest.mark.parametrize("fused,ragged", [("1", "1"), ("1", "0"), ("0", "1")])
async def test_records_match_jax_engine(jparams, monkeypatch, fused, ragged):
    monkeypatch.setenv("DYN_FUSED_MIXED", fused)
    monkeypatch.setenv("DYN_RAGGED_MIXED", ragged)
    reqs = [_req(p, max_tokens=8 if i == 0 else 5) for i, p in enumerate(_prompts())]
    jrun = JaxRunner(jax_get_config("tiny"), params=jparams, dtype=jnp.float32, **GEOMETRY)
    jeng = JaxEngine(jrun, **ENGINE)
    jres = await _serve(jeng, reqs, JaxContext)
    teng = _port_engine(jparams)
    tres = await _serve(teng, reqs, Context)
    assert tres == jres
    jrecs, trecs = jeng.recorder.snapshot(), teng.recorder.snapshot()
    assert len(trecs) == len(jrecs) == teng.iterations > 0
    for j, t in zip(jrecs, trecs):
        for f in COMPOSITION:
            assert getattr(t, f) == getattr(j, f), (f, t, j)
        if not (t.kind == "mixed" and t.fused):
            assert t.ragged == j.ragged, (t, j)
        else:
            # the port reports the program its runner ran
            assert t.ragged == (ragged == "1"), t
    assert any(t.kind == "mixed" for t in trecs)
    if fused == "1":
        assert any(t.fused and t.n_chunks >= 2 for t in trecs)
    # the records add up to the runner's counters
    st = teng.runner.stats
    assert sum(t.ragged for t in trecs) == (st["ragged_mixed_dispatches"]
                                            + st["ragged_verify_dispatches"])
    assert sum(t.n_chunks for t in trecs if t.fused) == st["mixed_chunks"]
    assert sum(t.n_chunks for t in trecs if not t.fused) == st["prefill_chunks"]
    assert (sum(t.decode_steps for t in trecs) - sum(t.ragged for t in trecs)
            == st["decode_steps"])
    fams = teng.runner.compile_stats()
    assert trecs[-1].compile_calls == sum(f["calls"] for f in fams.values())
    assert trecs[-1].compile_variants == sum(f["variants"] for f in fams.values())


async def _serve_threaded(jparams, recorder_size):
    engine = _port_engine(jparams, recorder_size=recorder_size)
    engine.start()
    try:
        async def one(p):
            toks = []
            async for item in engine.generate(_req(p, 8), Context()):
                toks.extend(item["token_ids"])
            return toks
        return await asyncio.gather(*[one(p) for p in _prompts()]), engine
    finally:
        engine.stop()


async def test_recorder_on_off_byte_identity(jparams):
    on, eng_on = await _serve_threaded(jparams, recorder_size=256)
    off, eng_off = await _serve_threaded(jparams, recorder_size=0)
    assert on == off
    assert eng_on.recorder.total_appended == eng_on.iterations > 0
    assert eng_off.recorder.total_appended == 0 and eng_off.iterations > 0


def test_simple_metrics_text_exposition():
    m = SimpleMetrics(labels={"dynamo_namespace": "ns"})
    c = m.counter("requests_total", "requests")
    c.inc()
    c.inc(2)
    m.gauge("queue_depth", "depth").set(7)
    h = m.child(dynamo_component="engine").histogram(
        "request_phase_seconds", "phase latency", phase="ttft")
    h.observe(0.5)
    h.observe(1.5)
    lines = m.render().decode().splitlines()
    assert "# TYPE dynamo_requests_total counter" in lines
    assert "# TYPE dynamo_queue_depth gauge" in lines
    assert "# TYPE dynamo_request_phase_seconds histogram" in lines

    def value(prefix):
        hits = [ln for ln in lines if ln.startswith(prefix)]
        assert len(hits) == 1, (prefix, hits)
        assert 'dynamo_namespace="ns"' in hits[0]
        return float(hits[0].rsplit(" ", 1)[1])

    assert value("dynamo_requests_total{") == 3.0
    assert value("dynamo_queue_depth{") == 7.0
    assert value("dynamo_request_phase_seconds_count{") == 2
    assert value("dynamo_request_phase_seconds_sum{") == 2.0
    assert m.render() == m.render()
