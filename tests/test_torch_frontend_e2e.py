"""The port's frontend (dynamo_tpu_torch.frontend) in front of port
workers, end to end over the TCP request and event planes, on the CPU at
f32 on a tiny model whose params come from numpy. Every check is exact
(tokens, counts, JSON), and every wait is bounded:

- the reference's tests/test_e2e_stack.py cases `test_http_to_jax_engine_stream`
  and `test_stream_options_include_usage`, with a port worker;
- the reference's tests/test_router.py KV-router cases (prefix affinity,
  load spreading), with two port workers in place of its mockers, each
  routing confirmed by the route the KvPushRouter took;
- a client that drops its HTTP connection mid-stream leaves the worker's
  pool with no page held;
- disaggregation through the frontend's chain: greedy streams equal
  aggregated serving, and a repeated prefix hops to the prefill instance
  that holds it (KV overlap on the prefill pool's router);
- worker processes (`python -m dynamo_tpu_torch.worker --device cpu`): a
  SIGKILLed worker's stream migrates and finishes on the other, then
  `python -m dynamo_tpu_torch.frontend --router-mode kv` as a process in
  front of the survivor lists the model, streams a completion and exits
  0 on SIGTERM, as does the worker after it.
"""

import asyncio
import http.client
import json
import os
import signal
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.models import llama as jllama
from dynamo_tpu.models.config import get_config as jax_get_config
from dynamo_tpu_torch.engine.engine import InferenceEngine
from dynamo_tpu_torch.engine.model_runner import ModelRunner
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.frontend.http import HttpService
from dynamo_tpu_torch.frontend.protocols import ModelCard
from dynamo_tpu_torch.frontend.service import ModelManager, ModelWatcher
from dynamo_tpu_torch.models.config import get_config
from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.runtime.discovery import FileDiscovery, MemDiscovery
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.tokens.hashing import block_hashes
from dynamo_tpu_torch.worker_common import serve_worker

ROOT = Path(__file__).resolve().parents[1]
T = 60  # bound on every awaited scenario, seconds
PS = 4
GEOMETRY = dict(num_pages=256, page_size=PS, max_pages_per_seq=128,
                decode_buckets=(1, 2, 4, 8), prefill_buckets=(8, 16, 32))


@pytest.fixture(autouse=True)
def _fresh_registries():
    yield
    MemDiscovery.reset()


@pytest.fixture(scope="module")
def jparams():
    return jax.device_get(jllama.init_params(
        jax_get_config("tiny"), jax.random.PRNGKey(7), jnp.float32))


def _engine(jparams):
    cfg = get_config("tiny")
    runner = ModelRunner(cfg, device="cpu", dtype=torch.float32,
                         params=params_from_numpy(jparams, cfg, "cpu", torch.float32),
                         **GEOMETRY)
    return InferenceEngine(runner, max_batch=4, chunk_size=16)


def _card():
    return ModelCard(name="tiny", context_length=512, kv_block_size=PS)


async def _until(cond, what, bound=T):
    async def poll():
        while not cond():
            await asyncio.sleep(0.01)
    try:
        await asyncio.wait_for(poll(), bound)
    except asyncio.TimeoutError:
        raise AssertionError(f"timed out waiting for {what}") from None


def _request(port, method, path, body=None, headers=None):
    """One request over http.client (the standard library's client):
    (status, headers, body bytes)."""
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=T)
    try:
        c.request(method, path, json.dumps(body) if body is not None else None,
                  {"Content-Type": "application/json", **(headers or {})})
        r = c.getresponse()
        return r.status, dict(r.getheaders()), r.read()
    finally:
        c.close()


async def http_call(port, method, path, body=None, headers=None):
    return await asyncio.to_thread(_request, port, method, path, body, headers)


def sse_events(data: bytes):
    """The payloads of an SSE body, `[DONE]` included."""
    return [line[len("data: "):] for line in data.decode().split("\n\n")
            if line.startswith("data: ")]


class _Fleet:
    """Port workers served in this process (each on its own runtime, TCP
    request and event planes) and an HttpService in front of them."""

    def __init__(self):
        self.workers = []  # (runtime, ServedWorker)
        self.rt = self.svc = None

    @classmethod
    async def start(cls, jparams, realm, n=2, roles=(), mode="kv", **watch_kw):
        f = cls()
        for i in range(n):
            rt = DistributedRuntime(discovery=MemDiscovery(realm=realm))
            role = roles[i] if roles else None
            comp = role or "tpu-worker"
            w = await serve_worker(rt, _engine(jparams), _card(), component=comp,
                                   disagg_role=role, colocated=False)
            f.workers.append((rt, w))
        f.rt = DistributedRuntime(discovery=MemDiscovery(realm=realm))
        mgr = ModelManager()
        f.svc = HttpService(f.rt, mgr, ModelWatcher(f.rt, mgr, router_mode=mode, **watch_kw),
                            port=0)
        await f.svc.start()
        await f.svc.watcher.wait_for_model(timeout=T)
        entry = mgr.get("tiny")
        n_decode = sum(1 for r in roles if r != "prefill") if roles else n
        await _until(lambda: len(entry.client.instances) == n_decode, "the workers")
        return f

    @property
    def entry(self):
        return self.svc.manager.get("tiny")

    async def close(self):
        await self.svc.stop()
        await self.rt.shutdown(drain_timeout=1)
        for rt, w in self.workers:
            await rt.shutdown(drain_timeout=1)
            await w.stop()


def _spy_routes(kv_router):
    """(request id, worker, overlap) of every request the KvRouter
    charges."""
    routes = []
    add = kv_router.add_request

    def spy(rid, worker, hashes, overlap):
        routes.append((rid, worker, overlap))
        return add(rid, worker, hashes, overlap)

    kv_router.add_request = spy
    return routes


# -- the reference's stack cases ----------------------------------------------


async def test_http_to_engine_stream(jparams):
    """test_e2e_stack.py `test_http_to_jax_engine_stream`: unary usage is
    the truth (random-model bytes), the streamed chat ends in [DONE]."""
    async def run():
        f = await _Fleet.start(jparams, "stack", n=1, mode="round_robin")
        try:
            unary = await http_call(f.svc.port, "POST", "/v1/completions",
                                    {"model": "tiny", "prompt": "hi", "max_tokens": 5})
            stream = await http_call(f.svc.port, "POST", "/v1/chat/completions", {
                "model": "tiny", "messages": [{"role": "user", "content": "ab"}],
                "max_tokens": 4, "stream": True})
            models = await http_call(f.svc.port, "GET", "/v1/models")
            one = await http_call(f.svc.port, "GET", "/v1/models/tiny")
        finally:
            await f.close()
        return unary, stream, models, one

    unary, stream, models, one = await asyncio.wait_for(run(), T)
    assert unary[0] == 200 and json.loads(unary[2])["usage"]["completion_tokens"] == 5
    status, headers, body = stream
    assert status == 200 and headers["Content-Type"] == "text/event-stream"
    assert headers["Transfer-Encoding"] == "chunked" and headers["X-Request-Id"]
    events = sse_events(body)
    assert events[-1] == "[DONE]" and len(events) - 1 >= 2
    assert [m["id"] for m in json.loads(models[2])["data"]] == ["tiny"]
    assert json.loads(one[2]) == {"id": "tiny", "object": "model", "owned_by": "dynamo_tpu"}


async def test_stream_options_include_usage(jparams):
    """test_e2e_stack.py `test_stream_options_include_usage`: one last
    chunk with empty choices carries the totals, before [DONE]."""
    async def run():
        f = await _Fleet.start(jparams, "usage", n=1, mode="round_robin")
        try:
            return await http_call(f.svc.port, "POST", "/v1/chat/completions", {
                "model": "tiny", "messages": [{"role": "user", "content": "ab"}],
                "max_tokens": 5, "stream": True,
                "stream_options": {"include_usage": True}})
        finally:
            await f.close()

    status, _, body = await asyncio.wait_for(run(), T)
    events = sse_events(body)
    assert status == 200 and events[-1] == "[DONE]"
    chunks = [json.loads(e) for e in events[:-1]]
    usage = [c for c in chunks if c.get("usage") is not None]
    assert len(usage) == 1 and usage[0] is chunks[-1] and usage[0]["choices"] == []
    assert usage[0]["usage"]["completion_tokens"] == 5
    assert usage[0]["usage"]["total_tokens"] == usage[0]["usage"]["prompt_tokens"] + 5


# -- the reference's KV-router cases -------------------------------------------------


async def test_kv_router_prefix_affinity(jparams):
    """test_router.py `test_kv_router_e2e_prefix_affinity`: a 64-byte
    prefix seeds one worker; follow-ups sharing it select that worker with
    overlap, and routed over HTTP they land there."""
    async def run():
        f = await _Fleet.start(jparams, "affinity")
        try:
            entry = f.entry
            kv = entry.chain.sink.router
            await kv.start()
            await _until(lambda: len(kv.workers()) == 2, "both workers")
            routes = _spy_routes(kv)
            prefix = "x" * 64  # 65 ids with BOS: 16 blocks of 4
            await http_call(f.svc.port, "POST", "/v1/completions",
                            {"model": "tiny", "prompt": prefix, "max_tokens": 4})
            hs = block_hashes(entry.preprocessor.tokenize_prompt(prefix), PS)
            await _until(lambda: kv.indexer.index.find_matches(hs).scores.get(routes[0][1]) == 16,
                         "the index")
            seeded = routes[0][1]
            picks = []
            for i in range(4):
                w, overlap, _ = kv.find_best_match(
                    entry.preprocessor.tokenize_prompt(prefix + str(i)))
                picks.append((w, overlap))
                await http_call(f.svc.port, "POST", "/v1/completions",
                                {"model": "tiny", "prompt": prefix + str(i), "max_tokens": 2})
        finally:
            await f.close()
        return seeded, picks, routes

    seeded, picks, routes = await asyncio.wait_for(run(), T)
    assert picks == [(seeded, 16)] * 4
    assert [(w, o) for _, w, o in routes[1:]] == [(seeded, 16)] * 4


async def test_kv_router_load_spreads_distinct_prompts(jparams):
    """test_router.py `test_kv_router_e2e_load_spreads_distinct_prompts`."""
    async def run():
        f = await _Fleet.start(jparams, "spread")
        try:
            kv = f.entry.chain.sink.router
            await kv.start()
            await _until(lambda: len(kv.workers()) == 2, "both workers")
            targets = set()
            for i in range(8):
                token_ids = [100 + i] * 40
                w, overlap, hashes = kv.find_best_match(token_ids)
                kv.add_request(f"req-{i}", w, hashes, overlap)
                targets.add(w)
            routes = _spy_routes(kv)
            for i in range(8):
                kv.free(f"req-{i}")
            # and over HTTP, 8 distinct prompts at once
            await asyncio.gather(*[http_call(f.svc.port, "POST", "/v1/completions", {
                "model": "tiny", "prompt": [200 + i] * 40, "max_tokens": 3})
                for i in range(8)])
        finally:
            await f.close()
        return targets, routes

    targets, routes = await asyncio.wait_for(run(), T)
    assert len(targets) == 2
    assert len({w for _, w, _ in routes}) == 2


# -- a dropped client ----------------------------------------------------------------


async def test_dropped_client_frees_pages(jparams):
    """A client reads two SSE events of a 400-token stream and drops its
    connection: within 5 s no worker holds a page or a request, far
    before the stream could have finished."""
    async def run():
        f = await _Fleet.start(jparams, "dropped")
        engines = [w.engine for _, w in f.workers]
        try:
            reader, writer = await asyncio.open_connection("127.0.0.1", f.svc.port)
            body = json.dumps({"model": "tiny", "prompt": list(range(1, 41)),
                               "max_tokens": 400, "ignore_eos": True, "temperature": 0,
                               "stream": True}).encode()
            writer.write(b"POST /v1/completions HTTP/1.1\r\nHost: x\r\n"
                         b"Content-Length: %d\r\n\r\n%s" % (len(body), body))
            await writer.drain()
            got = b""
            while got.count(b"data: ") < 2:
                got += await asyncio.wait_for(reader.read(4096), T)
            held = [dict(e.pool.ref) for e in engines]
            writer.transport.abort()  # the client goes away
            t0 = asyncio.get_running_loop().time()
            await _until(lambda: all(not e.pool.ref and not e.scheduler.has_work()
                                     for e in engines), "the pages' release", bound=5)
            freed_s = asyncio.get_running_loop().time() - t0
            in_flight = f.svc._in_flight.get("tiny")
        finally:
            await f.close()
        return held, freed_s, in_flight

    held, freed_s, in_flight = await asyncio.wait_for(run(), T)
    assert sum(len(h) for h in held) > 0  # the stream held pages while it ran
    assert freed_s < 5 and in_flight == 0


# -- disaggregation through the frontend ------------------------------------------------


async def test_disagg_through_frontend(jparams):
    """Two prefill workers and a decode worker behind a `kv` frontend with
    disagg_min_prefill_tokens 8: greedy streams through the chain equal
    aggregated serving in process, every prompt was prefilled remotely,
    and a prompt repeating a 32-token prefix hops to the prefill instance
    that holds it, against the load tie-break."""
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 500, size=n).tolist() for n in (20, 33, 9, 28)]
    prefix = rng.integers(1, 500, size=32).tolist()

    def req(p):
        return {"model": "tiny", "prompt": p, "max_tokens": 6, "temperature": 0,
                "ignore_eos": True}

    async def run():
        agg = _engine(jparams)
        pre = None
        f = await _Fleet.start(jparams, "disagg", n=3, roles=("prefill", "prefill", "decode"),
                               disagg_min_prefill_tokens=8)
        try:
            entry = f.entry
            pre = entry.preprocessor
            want = []
            for p in prompts:
                want.append([t async for it in agg.generate(pre.preprocess_completions(req(p)),
                                                            Context())
                             for t in it["token_ids"]])
            await _until(lambda: entry.prefill_kv_router is not None
                         and len(entry.prefill_kv_router.workers()) == 2, "the prefill pool")
            pkv = entry.prefill_kv_router
            routes = _spy_routes(pkv)
            got = []
            for p in prompts:
                got.append([t async for it in entry.chain.generate(
                    pre.preprocess_completions(req(p)), Context())
                    for t in it["token_ids"]])
            low, high = pkv.workers()
            pkv.sequences.add_request("ballast", low, 10, 0)  # tilt the first hop
            await http_call(f.svc.port, "POST", "/v1/completions", req(prefix + [1, 2, 3]))
            pkv.sequences.free("ballast")
            hs = block_hashes(prefix, PS)
            await _until(lambda: pkv.indexer.index.find_matches(hs).scores.get(high) == 8,
                         "the prefill index")
            await http_call(f.svc.port, "POST", "/v1/completions", req(prefix + [7, 8, 9]))
            decode = f.workers[2][1]
            stats = dict(decode.engine.runner.stats)
        finally:
            agg.stop()
            await f.close()
        return want, got, routes, (low, high), decode.handler.fallbacks, stats

    want, got, routes, (low, high), fallbacks, stats = await asyncio.wait_for(run(), 2 * T)
    assert got == want and all(len(t) == 6 for t in got)
    assert fallbacks == 0 and stats["prefill_chunks"] == stats["mixed_chunks"] == 0
    assert len(routes) == len(prompts) + 2
    assert routes[-2][1] == high and routes[-2][2] == 0
    assert routes[-1][1] == high and routes[-1][2] == 8


# -- worker processes: migration and the frontend's main ----------------------------------

WORKER_ARGS = ["--device", "cpu", "--model", "tiny", "--num-pages", "256",
               "--page-size", "4", "--max-seq-len", "512", "--max-batch", "4",
               "--chunk-size", "16"]


async def _spawn(args, what, root, marker):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = await asyncio.create_subprocess_exec(
        sys.executable, "-m", *args, "--discovery-backend", "file", "--discovery-root", root,
        cwd=ROOT, env=env, stdout=asyncio.subprocess.PIPE, stderr=asyncio.subprocess.DEVNULL)
    while True:
        line = (await proc.stdout.readline()).decode()
        assert line, f"the {what} exited before serving"
        if line.startswith(marker):
            return proc, line.strip()


@pytest.fixture(scope="module")
def processes(tmp_path_factory):
    """Two worker processes on one file-discovery root and a `kv` frontend
    in this process; a 400-token stream whose worker is SIGKILLed after
    its first 16 tokens; then the frontend's main as a process in front
    of the survivor, SIGTERMed, then the survivor."""
    root = str(tmp_path_factory.mktemp("discovery"))

    async def scenario():
        procs = []
        rt = DistributedRuntime(discovery=FileDiscovery(root, poll_interval=0.05))
        mgr = ModelManager()
        svc = HttpService(rt, mgr, ModelWatcher(rt, mgr, router_mode="kv"), port=0)
        out = {}
        try:
            for _ in range(2):
                procs.append(await _spawn(["dynamo_tpu_torch.worker", *WORKER_ARGS],
                                          "worker", root, "worker serving"))
            await svc.start()
            await svc.watcher.wait_for_model(timeout=T)
            entry = mgr.get("tiny")
            await _until(lambda: len(entry.client.instances) == 2, "both workers")
            kv = entry.chain.sink.router
            routes = _spy_routes(kv)
            by_addr = {line.rsplit("(", 1)[1].rstrip(")"): p for p, line in procs}
            req = entry.preprocessor.preprocess_completions({
                "prompt": list(range(1, 30)), "max_tokens": 400, "ignore_eos": True,
                "temperature": 0})
            toks, killed, finish = [], None, None
            async for item in entry.chain.generate(req, Context()):
                toks.extend(item["token_ids"])
                finish = item.get("finish_reason") or finish
                if killed is None and len(toks) >= 16:
                    iid = routes[-1][1][0]
                    killed = by_addr[entry.client.instances[iid].address]
                    n_at_kill = len(toks)
                    killed.kill()
            out["migration"] = (toks, finish, n_at_kill, entry.chain.get("migration").migrations,
                                routes)
            await killed.wait()
            survivor = next(p for p, _ in procs if p is not killed)
            # the frontend's main in front of the survivor
            fe, line = await _spawn(["dynamo_tpu_torch.frontend", "--router-mode", "kv",
                                     "--http-host", "127.0.0.1", "--http-port", "0"],
                                    "frontend", root, "frontend serving at")
            procs.append((fe, line))
            port = int(line.rsplit(":", 1)[1])

            async def models():
                while True:
                    status, _, body = await http_call(port, "GET", "/v1/models")
                    if status == 200 and json.loads(body)["data"]:
                        return json.loads(body)

            out["models"] = await asyncio.wait_for(models(), T)
            out["stream"] = await http_call(port, "POST", "/v1/completions", {
                "model": "tiny", "prompt": "hello", "max_tokens": 8, "temperature": 0,
                "stream": True, "stream_options": {"include_usage": True}})
            fe.send_signal(signal.SIGTERM)
            out["frontend_rc"] = await asyncio.wait_for(fe.wait(), T)
            survivor.send_signal(signal.SIGTERM)
            out["worker_rc"] = await asyncio.wait_for(survivor.wait(), T)
        finally:
            for p, _ in procs:
                if p.returncode is None:
                    p.kill()
                    await p.wait()
            await svc.stop()
            await rt.shutdown(drain_timeout=1)
        return out

    return asyncio.run(asyncio.wait_for(scenario(), 4 * T))


def test_sigkilled_worker_stream_migrates_and_finishes(processes):
    toks, finish, n_at_kill, migrations, routes = processes["migration"]
    assert finish == "length" and len(toks) == 400
    assert migrations == 1 and 16 <= n_at_kill < 400
    # the retry went to the other worker, carrying the tokens so far
    assert len(routes) == 2 and routes[0][1] != routes[1][1]


def test_frontend_main_serves_and_exits_0(processes):
    assert [m["id"] for m in processes["models"]["data"]] == ["tiny"]
    status, _, body = processes["stream"]
    events = sse_events(body)
    assert status == 200 and events[-1] == "[DONE]"
    assert json.loads(events[-2])["usage"]["completion_tokens"] == 8
    assert processes["frontend_rc"] == 0 and processes["worker_rc"] == 0
