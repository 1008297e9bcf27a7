"""The port's status servers (dynamo_tpu_torch/runtime/status.py) and the
observability of the served worker and frontend, on the CPU.

- the status server's routes on the port's HTTP code: /live, /health
  (503 on a failing check), /metrics, /debug/<name> (a source that raises
  answers 500), /debug/traces (404 until a span ring is armed), an added
  route, 404 and 405;
- processes: two `python -m dynamo_tpu_torch.worker --device cpu
  --status-port P --sanitize --digest-period 0.3` workers and
  `python -m dynamo_tpu_torch.frontend --router-mode kv --status-port P
  --request-trace PATH` in front of them, all with DYN_TRACE_RING set;
  four streamed completions with a traceparent each; then every check
  chip_smoke's served observability phase makes on the card: zero
  sanitizer violations on a warm sanitizer, one timeline record per
  dispatched iteration with the composition summing to the runner's
  counters, each request's frontend root, routing span, server hop and
  engine spans joined under its trace id across the processes, both
  workers in /debug/fleet with TTFT counts equal to the requests each
  served, /debug/routing?rid= naming the worker whose spans hold that
  trace, the reference's series names in /metrics, the JSONL request
  trace, a window from `--profiler-port`'s `GET /profile`, and exit
  code 0 on SIGTERM.
"""

import asyncio
import http.client
import json
import os
import signal
import socket
import sys
import types
from pathlib import Path

import pytest

from dynamo_tpu_torch.runtime import tracing
from dynamo_tpu_torch.runtime.metrics import SimpleMetrics
from dynamo_tpu_torch.runtime.status import StatusServer
from dynamo_tpu_torch.frontend.http import json_response

ROOT = Path(__file__).resolve().parents[1]
T = 60  # bound on every awaited scenario, seconds
WORKER_ARGS = ["--model", "tiny", "--device", "cpu", "--num-pages", "128",
               "--page-size", "4", "--max-seq-len", "512", "--max-batch", "4",
               "--chunk-size", "16", "--sanitize", "--digest-period", "0.3"]
N_REQ = 4


def _free_port() -> int:
    """A port free right now (the status flags take 0 as off)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _request(port, method, path, body=None, headers=None):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=T)
    try:
        c.request(method, path, json.dumps(body) if body is not None else None,
                  {"Content-Type": "application/json", **(headers or {})})
        r = c.getresponse()
        return r.status, dict(r.getheaders()), r.read()
    finally:
        c.close()


async def _get(port, path):
    status, _, body = await asyncio.to_thread(_request, port, "GET", path)
    return status, body


async def _json(port, path):
    status, body = await _get(port, path)
    assert status == 200, (path, status, body[:200])
    return json.loads(body)


async def test_status_server_routes():
    metrics = SimpleMetrics()
    metrics.counter("requests_total", "requests").inc(3)
    srv = StatusServer(types.SimpleNamespace(metrics=metrics), port=0, host="127.0.0.1")
    healthy = [True]
    srv.add_check("engine", lambda: healthy[0])
    srv.add_debug("fleet", lambda q: {"echo": q.get("window_s", "default")})

    def boom(q):
        raise RuntimeError("source exploded")

    srv.add_debug("routing", boom)

    async def profile(q):
        return json_response({"ms": int(q.get("ms", 0))})

    srv.add_route("/profile", profile)
    await srv.start()
    port = srv.port
    tracing.set_exporter(None)
    try:
        assert (await _json(port, "/live"))["live"] is True
        assert (await _json(port, "/health"))["checks"] == {"engine": True}
        healthy[0] = False
        status, body = await _get(port, "/health")
        assert status == 503 and json.loads(body)["status"] == "unhealthy"
        status, body = await _get(port, "/metrics")
        assert status == 200 and b"dynamo_requests_total{" in body
        assert await _json(port, "/debug/fleet?window_s=5") == {"echo": "5"}
        assert await _json(port, "/debug/fleet") == {"echo": "default"}
        status, body = await _get(port, "/debug/routing")
        assert status == 500 and "source exploded" in json.loads(body)["error"]
        assert (await _get(port, "/debug/traces"))[0] == 404  # no ring
        assert (await _get(port, "/debug/timeline"))[0] == 404  # no source
        assert (await _get(port, "/debug/nothing"))[0] == 404
        assert await _json(port, "/profile?ms=250") == {"ms": 250}
        status, _, _ = await asyncio.to_thread(_request, port, "POST", "/live", {})
        assert status == 405
        ring = tracing.SpanRing(capacity=64)
        tracing.set_exporter(ring)
        with tracing.span("frontend.request"):
            pass
        traces = await _json(port, "/debug/traces")
        assert traces["n"] == 1 and traces["spans"][0]["name"] == "frontend.request"
        status, body = await _get(port, "/metrics")
        assert b"dynamo_tracing_dropped_spans{" in body
    finally:
        tracing.set_exporter(None)
        await srv.stop()


async def _spawn(args, root, marker, env):
    """A module as a process; returns (process, its stdout lines up to and
    including the one starting with `marker`)."""
    proc = await asyncio.create_subprocess_exec(
        sys.executable, "-m", *args, "--discovery-backend", "file", "--discovery-root", root,
        cwd=ROOT, env=env, stdout=asyncio.subprocess.PIPE, stderr=asyncio.subprocess.DEVNULL)
    lines = []
    while True:
        line = (await proc.stdout.readline()).decode()
        assert line, f"{args[0]} exited before serving: {lines}"
        lines.append(line.strip())
        if line.startswith(marker):
            return proc, lines


def _port_of(lines, prefix):
    return int(next(ln for ln in lines if ln.startswith(prefix)).split("port ")[1].split()[0])


def _sse_body(data: bytes):
    return [line[len("data: "):] for line in data.decode().split("\n\n")
            if line.startswith("data: ")]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("discovery"))
    trace_path = str(tmp_path_factory.mktemp("trace") / "requests.jsonl")
    env = dict(os.environ, PYTHONPATH=str(ROOT), DYN_TRACE_RING="4096")
    env.pop("DYN_SAN", None)

    async def scenario():
        procs, out = [], {"trace_path": trace_path}
        try:
            workers = []
            prof_port = _free_port()
            for i in range(2):
                sp = _free_port()
                extra = ["--profiler-port", str(prof_port)] if i == 0 else []
                p, lines = await _spawn(["dynamo_tpu_torch.worker", *WORKER_ARGS,
                                         "--status-port", str(sp), *extra], root,
                                        "worker serving", env)
                procs.append(p)
                assert _port_of(lines, "status server at port") == sp
                workers.append(sp)
            fe, lines = await _spawn(
                ["dynamo_tpu_torch.frontend", "--router-mode", "kv", "--http-host",
                 "127.0.0.1", "--http-port", "0", "--status-port", str(_free_port()),
                 "--request-trace", trace_path], root, "frontend serving at", env)
            procs.append(fe)
            port = int(lines[-1].rsplit(":", 1)[1])
            fe_status = _port_of(lines, "status server at port")

            async def models():
                while True:
                    status, body = await _get(port, "/v1/models")
                    if status == 200 and json.loads(body)["data"]:
                        return
                    await asyncio.sleep(0.05)

            await asyncio.wait_for(models(), T)
            # both workers' digest publishers reach the frontend's observer
            async def fleet_has_both():
                while len((await _json(fe_status, "/debug/fleet"))["workers"]) < 2:
                    await asyncio.sleep(0.1)

            await asyncio.wait_for(fleet_has_both(), T)
            reqs = []
            for i in range(N_REQ):
                tid = f"{i + 1:032x}"
                status, headers, body = await asyncio.to_thread(
                    _request, port, "POST", "/v1/completions",
                    {"model": "tiny", "prompt": f"request {i} " * (i + 2),
                     "max_tokens": 6, "temperature": 0, "stream": True},
                    {"traceparent": f"00-{tid}-{'ab' * 8}-01"})
                assert status == 200 and _sse_body(body)[-1] == "[DONE]"
                reqs.append((headers["X-Request-Id"], tid))
            out["reqs"] = reqs
            await asyncio.sleep(1.0)  # a digest period or three
            out["workers"] = []
            for sp in workers:
                w = {k: await _json(sp, f"/debug/{k}")
                     for k in ("sanitizer", "engine", "timeline")}
                w["traces"] = {tid: await _json(sp, f"/debug/traces?trace_id={tid}")
                               for _, tid in reqs}
                w["metrics"] = (await _get(sp, "/metrics"))[1].decode()
                w["live"] = await _json(sp, "/live")
                out["workers"].append(w)
            out["fleet"] = await _json(fe_status, "/debug/fleet")
            out["routing"] = {rid: await _json(fe_status, f"/debug/routing?rid={rid}")
                              for rid, _ in reqs}
            out["fe_traces"] = {tid: await _json(fe_status, f"/debug/traces?trace_id={tid}")
                                for _, tid in reqs}
            out["fe_metrics"] = (await _get(fe_status, "/metrics"))[1].decode()
            out["profile"] = await _json(prof_port, "/profile?ms=50")
            out["profile_events"] = json.load(open(out["profile"]["trace"]))["traceEvents"]
            out["profiles"] = (await _json(workers[0], "/debug/engine"))["profiles"]
            fe.send_signal(signal.SIGTERM)
            out["rcs"] = [await asyncio.wait_for(fe.wait(), T)]
            for p in procs[:2]:
                p.send_signal(signal.SIGTERM)
                out["rcs"].append(await asyncio.wait_for(p.wait(), T))
        finally:
            for p in procs:
                if p.returncode is None:
                    p.kill()
                    await p.wait()
        return out

    return asyncio.run(asyncio.wait_for(scenario(), 4 * T))


def test_workers_sanitizer_clean_and_live(served):
    for w in served["workers"]:
        rep = w["sanitizer"]
        assert rep["ok"] and rep["violations"] == [], rep
        assert rep["counters"]["steps"] == w["engine"]["iterations"]
        assert w["live"]["live"] is True


def test_timeline_one_record_an_iteration_summing_to_the_counters(served):
    for w in served["workers"]:
        recs = [e["args"] | {"kind": e["name"]}
                for e in w["timeline"]["traceEvents"] if e["ph"] == "X"]
        eng = w["engine"]
        st = eng["stats"]
        assert len(recs) == eng["iterations"] == eng["recorder"]["appended"]
        ragged = sum(r["ragged"] for r in recs)
        assert ragged == st["ragged_mixed_dispatches"] + st["ragged_verify_dispatches"]
        assert sum(r["n_chunks"] for r in recs if r["fused"]) == st["mixed_chunks"]
        assert sum(r["n_chunks"] for r in recs if not r["fused"]) == st["prefill_chunks"]
        assert sum(r["decode_steps"] for r in recs) - ragged == st["decode_steps"]


def _served_by(served, tid):
    """The worker index whose span ring holds trace `tid`."""
    hits = [i for i, w in enumerate(served["workers"]) if w["traces"][tid]["n"]]
    assert len(hits) == 1, hits
    return hits[0]


def test_each_request_is_one_trace_across_the_processes(served):
    for rid, tid in served["reqs"]:
        fe = served["fe_traces"][tid]["spans"]
        wk = served["workers"][_served_by(served, tid)]["traces"][tid]["spans"]
        spans = fe + wk
        assert {s["trace_id"] for s in spans} == {tid}
        names = {s["name"].split(" ")[0] for s in spans}
        assert {"frontend.request", "route.kv", "rpc", "worker.request", "worker.queue",
                "worker.prefill", "worker.stream"} <= names, names
        by_id = {s["span_id"]: s for s in spans}

        def root_of(s):
            while s["parent_span_id"] in by_id:
                s = by_id[s["parent_span_id"]]
            return s

        # every span reaches the frontend root through its parents; the
        # root continues the caller's traceparent
        assert all(root_of(s)["name"] == "frontend.request" for s in spans)
        assert root_of(spans[0])["parent_span_id"] == "ab" * 8


def test_fleet_and_routing_agree_with_who_served(served):
    fleet = served["fleet"]["workers"]
    assert len(fleet) == 2
    ids = {w["engine"]["instance"]: i for i, w in enumerate(served["workers"])}
    served_n = [0, 0]
    for rid, tid in served["reqs"]:
        i = _served_by(served, tid)
        served_n[i] += 1
        dec = served["routing"][rid]["decisions"]
        assert len(dec) == 1 and dec[0]["rid"] == rid and dec[0]["mode"] == "kv"
        assert ids[dec[0]["chosen"][0]] == i
        assert sum(c["chosen"] for c in dec[0]["candidates"]) == 1
    for key, row in fleet.items():
        i = ids[row["worker"][0]]
        ttft = row["phases"].get("ttft", {}).get("n", 0)
        assert ttft == served_n[i] == row["counters"]["requests"], (key, row, served_n)


def test_metrics_serve_the_reference_series(served):
    busy = {_served_by(served, tid) for _, tid in served["reqs"]}
    for i, w in enumerate(served["workers"]):
        text = w["metrics"]
        for name in ("dynamo_flight_recorder_anomalies_total{",
                     "dynamo_tracing_dropped_spans{"):
            assert name in text, name
        if i in busy:  # series a served request creates
            for name in ("dynamo_request_phase_seconds_count{", "dynamo_compile_variants{",
                         "dynamo_compile_seconds_total{"):
                assert name in text, name
            assert 'phase="ttft"' in text and 'family="decode"' in text
    for name in ("dynamo_frontend_requests_total{", "dynamo_frontend_ttft_seconds_count{",
                 "dynamo_tracing_dropped_spans{"):
        assert name in served["fe_metrics"], name


def test_hook_failures_are_counted_and_served_as_zero(served):
    """Every hook's failure count (recorder dumps, anomaly hooks and
    profile windows, the step profiler, the digest publisher and its
    engine probes) is on /debug/engine and on /metrics, and a clean run
    holds them at 0 with digests published."""
    for w in served["workers"]:
        eng = w["engine"]
        assert eng["hook_failures"] == {
            "recorder_dump": 0, "recorder_hook": 0, "recorder_profile": 0,
            "profile_window": 0, "digest_publish": 0, "digest_probe": 0}, eng
        assert eng["digest"]["published"] > 0
        for name in ("dynamo_digest_publish_failures_total{",
                     "dynamo_digest_probe_failures_total{",
                     "dynamo_flight_recorder_failures_total{"):
            lines = [ln for ln in w["metrics"].splitlines() if ln.startswith(name)]
            assert lines and all(ln.endswith(" 0.0") for ln in lines), (name, lines)


def test_profiler_port_writes_a_window(served):
    """GET /profile?ms=N on --profiler-port: a torch.profiler window the
    step thread opened and closed, written as a Chrome trace."""
    assert served["profile"]["ms"] == 50
    assert served["profile_events"] and served["profiles"]["written"] == 1


def test_request_trace_and_clean_exit(served):
    with open(served["trace_path"]) as f:
        lines = [json.loads(ln) for ln in f]
    assert sorted(r["request_id"] for r in lines) == sorted(r for r, _ in served["reqs"])
    assert all(r["osl"] == 6 and r["stream"] is True for r in lines)
    assert served["rcs"] == [0, 0, 0]
