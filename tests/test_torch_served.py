"""The port's worker served over the runtime (dynamo_tpu_torch.worker_common
serve_worker, dynamo_tpu_torch.worker main), on the CPU at f32 on a tiny
model whose params come from numpy:

- across the wire against the reference: a reference client streams from a
  port worker and a port client from a reference JAX worker, over TCP and
  file discovery on one root, and the greedy streams equal the port
  engine's in process (which equal the JAX engine's); the reference's own
  HttpService streams SSE completions from the port worker with the text
  and usage it streams from the JAX worker;
- disaggregated serving over TCP: greedy streams through monolithic and
  chunked pulls equal aggregated serving; a prefill worker cut off
  mid-pull leads to local recompute and no import; a puller that
  disconnects and a request cancelled over the wire give their pages back;
- the KV events and forward-pass metrics a served worker publishes on the
  TCP event plane: the reference KvEventPublisher's payloads for the same
  engine events, and one FPM per engine iteration;
- `python -m dynamo_tpu_torch.worker --device cpu` as a subprocess answers a
  request and exits 0 on SIGTERM.

Sockets bind port 0, and every wait is bounded by asyncio.wait_for.
"""

import asyncio
import json
import os
import signal
import sys
from pathlib import Path

import aiohttp
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.engine import InferenceEngine as JaxEngine
from dynamo_tpu.engine.model_runner import ModelRunner as JaxRunner
from dynamo_tpu.frontend.http import HttpService
from dynamo_tpu.frontend.protocols import ModelCard as RefModelCard
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.models.config import get_config as jax_get_config
from dynamo_tpu.router.publisher import KvEventPublisher as RefKvEventPublisher
from dynamo_tpu.runtime.context import Context as RefContext
from dynamo_tpu.runtime.discovery import FileDiscovery as RefFileDiscovery
from dynamo_tpu.runtime.distributed import DistributedRuntime as RefRuntime
from dynamo_tpu.runtime.event_plane import InProcEventPublisher as RefInProcPublisher
from dynamo_tpu.worker_common import serve_worker as ref_serve_worker
from dynamo_tpu_torch.engine.engine import InferenceEngine
from dynamo_tpu_torch.engine.model_runner import ModelRunner
from dynamo_tpu_torch.engine.scheduler import DecodePlan, MixedPlan, PrefillPlan
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.frontend.protocols import ModelCard
from dynamo_tpu_torch.models.config import get_config
from dynamo_tpu_torch.router.prefill_router import DisaggPolicy, PrefillRouter
from dynamo_tpu_torch.router.protocols import FPM_SUBJECT, KV_EVENT_SUBJECT
from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.runtime.discovery import FileDiscovery, MemDiscovery
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.worker_common import serve_worker

ROOT = Path(__file__).resolve().parents[1]
T = 60  # bound on every awaited scenario, seconds
PS = 4
GEOMETRY = dict(num_pages=64, page_size=PS, max_pages_per_seq=16,
                decode_buckets=(1, 2, 4, 8), prefill_buckets=(8, 16, 32))
_rng = np.random.default_rng(11)
PROMPTS = [_rng.integers(1, 500, size=n).tolist() for n in (20, 33, 9, 28)]
MAX_TOKENS = 6


def _req(prompt, max_tokens=MAX_TOKENS):
    return {"token_ids": list(prompt), "sampling": {"temperature": 0.0},
            "stop": {"max_tokens": max_tokens, "stop_ids": []}}


def _card(name="tiny"):
    return ModelCard(name=name, context_length=64, kv_block_size=PS)


@pytest.fixture(autouse=True)
def _fresh_registries():
    yield
    MemDiscovery.reset()


@pytest.fixture(scope="module")
def jparams():
    return jax.device_get(jllama.init_params(
        jax_get_config("tiny"), jax.random.PRNGKey(7), jnp.float32))


def _engine(jparams, **kw):
    cfg = get_config("tiny")
    runner = ModelRunner(cfg, device="cpu", dtype=torch.float32,
                         params=params_from_numpy(jparams, cfg, "cpu", torch.float32),
                         **GEOMETRY)
    return InferenceEngine(runner, max_batch=4, chunk_size=16, **kw)


async def _collect(stream):
    toks, finish = [], None
    async for item in stream:
        toks.extend(item["token_ids"])
        finish = item.get("finish_reason") or finish
    return toks, finish


async def _until(cond, what):
    async def poll():
        while not cond():
            await asyncio.sleep(0.01)
    try:
        await asyncio.wait_for(poll(), T)
    except asyncio.TimeoutError:
        raise AssertionError(f"timed out waiting for {what}") from None


@pytest.fixture(scope="module")
def inproc_streams(jparams):
    """The port engine's greedy streams of PROMPTS served alone in
    process."""
    async def serve():
        eng = _engine(jparams)
        try:
            return [await _collect(eng.generate(_req(p), Context())) for p in PROMPTS]
        finally:
            eng.stop()

    return asyncio.run(serve())


# -- across the wire against the reference ----------------------------------


async def _sse(session, base, model):
    """One streamed completion: (text, usage)."""
    text, usage = "", None
    async with session.post(f"{base}/v1/completions", json={
            "model": model, "prompt": "hello", "max_tokens": 5, "temperature": 0.0,
            "stream": True,
            "stream_options": {"include_usage": True}}) as r:
        assert r.status == 200, await r.text()
        async for line in r.content:
            line = line.decode().strip()
            if not line.startswith("data: ") or line == "data: [DONE]":
                continue
            chunk = json.loads(line[len("data: "):])
            if chunk.get("usage") is not None:
                usage = chunk["usage"]
            for c in chunk.get("choices") or []:
                text += c.get("text") or ""
    return text, usage


@pytest.fixture(scope="module")
def across(jparams, tmp_path_factory):
    """A port worker and a reference JAX worker on one file-discovery
    root, a reference client of the first, a port client of the second,
    and the reference HttpService in front of both."""
    root = str(tmp_path_factory.mktemp("discovery"))

    async def scenario():
        port_rt = DistributedRuntime(discovery=FileDiscovery(root, poll_interval=0.05))
        port_eng = _engine(jparams)
        port_w = await serve_worker(port_rt, port_eng, _card("tiny-port"))
        ref_rt = RefRuntime(discovery=RefFileDiscovery(root, poll_interval=0.05),
                            event_transport="inproc")
        jeng = JaxEngine(JaxRunner(jax_get_config("tiny"), params=jparams,
                                   dtype=jnp.float32, **GEOMETRY),
                         max_batch=4, chunk_size=16)
        ref_w = await ref_serve_worker(
            ref_rt, jeng, RefModelCard(name="tiny-jax", context_length=64, kv_block_size=PS),
            component="jax-worker", digest_period_s=0)
        front = RefRuntime(discovery=RefFileDiscovery(root, poll_interval=0.05),
                           event_transport="inproc")
        client_rt = DistributedRuntime(discovery=FileDiscovery(root, poll_interval=0.05))
        svc = HttpService(front, port=0)
        try:
            ref_client = front.client("dyn/tpu-worker/generate")
            port_client = client_rt.client("dyn/jax-worker/generate")
            await ref_client.wait_ready(timeout=T)
            await port_client.wait_ready(timeout=T)
            from_port = [await _collect(ref_client.generate(_req(p), RefContext()))
                         for p in PROMPTS]
            from_ref = [await _collect(port_client.generate(_req(p), Context()))
                        for p in PROMPTS]
            base = await svc.start()
            await svc.watcher.wait_for_model(timeout=T)
            await _until(lambda: {"tiny-port", "tiny-jax"} <= set(
                m["id"] if isinstance(m, dict) else m
                for m in svc.manager.list_models()), "both models")
            async with aiohttp.ClientSession() as s:
                sse = {m: await _sse(s, base, m) for m in ("tiny-port", "tiny-jax")}
            await ref_client.close()
            await port_client.close()
        finally:
            await svc.stop()
            await front.shutdown(drain_timeout=1)
            await client_rt.shutdown(drain_timeout=1)
            await port_rt.shutdown(drain_timeout=1)
            await port_w.stop()
            await ref_rt.shutdown(drain_timeout=1)
            await ref_w.stop()
        return from_port, from_ref, sse

    return asyncio.run(asyncio.wait_for(scenario(), 4 * T))


def test_reference_client_streams_from_port_worker(across, inproc_streams):
    from_port, _, _ = across
    assert from_port == inproc_streams
    assert all(f == "length" and len(t) == MAX_TOKENS for t, f in from_port)


def test_port_client_streams_from_reference_worker(across, inproc_streams):
    _, from_ref, _ = across
    assert from_ref == inproc_streams


def test_reference_http_service_streams_from_port_worker(across):
    _, _, sse = across
    port_text, port_usage = sse["tiny-port"]
    jax_text, jax_usage = sse["tiny-jax"]
    assert port_usage is not None and port_usage["completion_tokens"] == 5
    assert port_usage == jax_usage
    assert port_text == jax_text


# -- disaggregated serving over TCP -------------------------------------------


async def _tcp_disagg(jparams, chunk_pages, realm):
    """A prefill and a decode worker served over TCP, each on its own
    runtime, neither colocated; a PrefillRouter over the prefill pool
    sends decode continuations to the decode worker."""
    def rt():
        return DistributedRuntime(discovery=MemDiscovery(realm=realm),
                                  event_transport="inproc")

    prefill, decode = _engine(jparams), _engine(jparams)
    p_rt, d_rt, front = rt(), rt(), rt()
    p_w = await serve_worker(p_rt, prefill, _card(), component="prefill",
                             disagg_role="prefill", colocated=False)
    d_w = await serve_worker(d_rt, decode, _card(), component="decode",
                             disagg_role="decode", disagg_chunk_pages=chunk_pages,
                             colocated=False)
    downstream, pool = front.client("dyn/decode/generate"), front.client("dyn/prefill/generate")
    await downstream.wait_ready(timeout=T)
    await pool.wait_ready(timeout=T)
    router = PrefillRouter(downstream, DisaggPolicy(min_prefill_tokens=8))
    router.activate(pool, "dyn/prefill/kv_fetch")

    async def close():
        await downstream.close()
        await pool.close()
        for r in (front, d_rt, p_rt):
            await r.shutdown(drain_timeout=1)
        await d_w.stop()
        await p_w.stop()

    return prefill, decode, p_w, d_w, router, close


@pytest.mark.parametrize("chunk_pages", [0, 2, 16])
async def test_tcp_disagg_matches_aggregated(jparams, inproc_streams, chunk_pages):
    async def run():
        prefill, decode, p_w, d_w, router, close = await _tcp_disagg(
            jparams, chunk_pages, f"tcpd{chunk_pages}")
        try:
            got = [await _collect(router.generate(_req(p), Context())) for p in PROMPTS[:2]]
            got += await asyncio.gather(*[_collect(router.generate(_req(p), Context()))
                                          for p in PROMPTS[2:]])
            await _until(lambda: not prefill._parked, "the parked pages' release")
        finally:
            await close()
        return got, prefill, decode, d_w

    got, prefill, decode, d_w = await asyncio.wait_for(run(), T)
    assert got == inproc_streams
    assert d_w.handler.fallbacks == 0
    st = decode.runner.stats
    assert st["prefill_chunks"] == st["mixed_chunks"] == 0
    pages = [-(-len(p) // PS) for p in PROMPTS]
    assert prefill.runner.stats["kv_pages_exported"] == st["kv_pages_imported"] == sum(pages)
    assert not prefill.pool.ref


async def test_prefill_worker_cut_mid_pull_recomputes(jparams, inproc_streams):
    """The prefill worker's sockets are cut after the first of several
    chunks: the decode worker imports nothing, prefills the prompt itself
    and streams the same tokens; the prefill side releases its pages."""
    async def run():
        prefill, decode, p_w, d_w, router, close = await _tcp_disagg(jparams, 2, "cut")
        stream = prefill.export_parked_kv_stream

        async def cut_after_first(rid, chunk):
            async for part in stream(rid, chunk):
                yield part
                for w in list(p_w.runtime.server._conns):
                    w.transport.abort()  # the SIGKILL of a socket

        prefill.export_parked_kv_stream = cut_after_first
        try:
            got = await _collect(router.generate(_req(PROMPTS[1]), Context()))
            await _until(lambda: not prefill._parked and not prefill.pool.ref,
                         "the prefill side's release")
        finally:
            await close()
        return got, decode, d_w

    got, decode, d_w = await asyncio.wait_for(run(), T)
    assert got == inproc_streams[1]
    assert d_w.handler.fallbacks == 1
    assert decode.runner.stats["kv_pages_imported"] == 0
    assert decode.runner.stats["prefill_chunks"] > 0


async def test_disconnected_puller_leaves_pages_discarded(jparams):
    async def run():
        prefill, decode, p_w, d_w, router, close = await _tcp_disagg(jparams, 2, "puller")
        free0 = prefill.pool.n_free
        try:
            pool = router._prefill_client
            iid = next(iter(pool.instances))
            preq = dict(_req(PROMPTS[1]), annotations={"disagg": "prefill"})
            items = [i async for i in pool.direct(preq, iid, Context())]
            rid = items[-1]["kv_transfer"]["request_id"]
            held = prefill.pool.n_free
            fetch = pool.runtime.client("dyn/prefill/kv_fetch")
            fetch.router.update_instance(iid, pool.instances[iid].address)
            it = fetch.direct({"request_id": rid, "chunk_pages": 1}, iid).__aiter__()
            first = await it.__anext__()
            fetch.router._pool.close()  # the puller's socket goes away
            await _until(lambda: not prefill._parked and prefill.pool.n_free == free0,
                         "the discard")
            with pytest.raises(Exception):
                await it.__anext__()
            await fetch.close()
        finally:
            await close()
        return free0, held, first

    free0, held, first = await asyncio.wait_for(run(), T)
    assert held < free0 and first["n_pages"] == 1 and first["offset"] == 0


async def test_cancel_over_the_wire_frees_pages(jparams):
    async def run():
        realm = "cancel"
        w_rt = DistributedRuntime(discovery=MemDiscovery(realm=realm), event_transport="inproc")
        c_rt = DistributedRuntime(discovery=MemDiscovery(realm=realm), event_transport="inproc")
        eng = _engine(jparams)
        w = await serve_worker(w_rt, eng, _card())
        free0 = eng.pool.n_free
        client = c_rt.client("dyn/tpu-worker/generate")
        await client.wait_ready(timeout=T)
        ctx = Context()
        n = 0
        try:
            async for item in client.generate(_req(PROMPTS[0], max_tokens=40), ctx):
                n += len(item["token_ids"])
                if n >= 2:
                    ctx.stop_generating()
            await _until(lambda: not eng.scheduler.has_work() and eng.pool.n_free == free0,
                         "the cancelled request's pages")
        finally:
            await client.close()
            await c_rt.shutdown(drain_timeout=1)
            await w_rt.shutdown(drain_timeout=1)
            await w.stop()
        return n

    assert 2 <= await asyncio.wait_for(run(), T) < 40


# -- KV events and forward-pass metrics -----------------------------------------


async def test_kv_events_and_fpm_on_the_tcp_event_plane(jparams):
    """What a served worker publishes equals what the reference's
    KvEventPublisher publishes for the same engine events, and the worker
    publishes one FPM per engine iteration of the kind of its plan."""
    async def run():
        w_rt = DistributedRuntime(discovery=MemDiscovery(realm="ev"), event_transport="tcp")
        c_rt = DistributedRuntime(discovery=MemDiscovery(realm="ev"), event_transport="tcp")
        eng = _engine(jparams)
        engine_events, plans = [], []
        eng.on_kv_event(engine_events.append)
        step_plan = eng.scheduler.step_plan

        def spy():
            plan = step_plan()
            if plan is not None:
                plans.append(plan)
            return plan

        eng.scheduler.step_plan = spy
        w = await serve_worker(w_rt, eng, _card())
        md = w.instance.metadata
        assert md["kv_publisher"].startswith("tcp://") and md["fpm_publisher"] == md["kv_publisher"]
        sub = c_rt.event_subscriber([KV_EVENT_SUBJECT, FPM_SUBJECT])
        sub.connect(md["kv_publisher"])
        pub = w_rt.event_publisher()
        await _until(lambda: pub._subs, "the subscription")
        got = {KV_EVENT_SUBJECT: [], FPM_SUBJECT: []}

        async def listen():
            async for subject, payload in sub.events():
                got[subject].append(payload)

        listener = asyncio.create_task(listen())
        client = c_rt.client("dyn/tpu-worker/generate")
        await client.wait_ready(timeout=T)
        try:
            for p in PROMPTS:
                await _collect(client.generate(_req(p), Context()))
            n_events = sum(len(e) for e in engine_events)
            await _until(lambda: len(got[FPM_SUBJECT]) == len(plans) and sum(
                len(b["events"]) for b in got[KV_EVENT_SUBJECT]) == n_events, "the events")
            kv_state = c_rt.client("dyn/tpu-worker/kv_state")
            await kv_state.wait_ready(timeout=T)
            state = [s async for s in kv_state.direct({}, w.instance.instance_id)]
            await kv_state.close()
        finally:
            listener.cancel()
            await sub.close()
            await client.close()
            await c_rt.shutdown(drain_timeout=1)
            await w_rt.shutdown(drain_timeout=1)
            await w.stop()

        # the reference publisher over the same engine events
        ref = RefKvEventPublisher(RefInProcPublisher(), w.instance.instance_id,
                                  flush_interval=0)
        await ref.start()
        ref_payloads = []
        ref._pub.publish = lambda subject, payload: _record(ref_payloads, payload)
        for batch in engine_events:
            ref.on_engine_events(batch)
        await _until(lambda: sum(len(b["events"]) for b in ref_payloads) == n_events,
                     "the reference publisher")
        ref_state = await ref.dump_state(None, None)
        await ref.stop()
        return got, plans, ref_payloads, state, ref_state, w

    got, plans, ref_payloads, state, ref_state, w = await asyncio.wait_for(run(), T)
    flat = [e for b in got[KV_EVENT_SUBJECT] for e in b["events"]]
    assert flat == [e for b in ref_payloads for e in b["events"]]
    stores = {h for e in flat if e["kind"] == "store" for h in e["block_hashes"]}
    assert all(e["worker"] == [w.instance.instance_id, 0] for e in flat)
    # every full page of every prompt was stored
    from dynamo_tpu_torch.tokens.hashing import block_hashes

    assert all(set(block_hashes(p, PS)) <= stores for p in PROMPTS)
    assert state == [ref_state]
    kinds = {PrefillPlan: "prefill", DecodePlan: "decode", MixedPlan: "mixed"}
    assert [m["kind"] for m in got[FPM_SUBJECT]] == [kinds[type(p)] for p in plans]
    assert all(m["worker"] == [w.instance.instance_id, 0] for m in got[FPM_SUBJECT])


async def _record(out, payload):
    out.append(payload)


# -- the worker's main as a process ------------------------------------------------


async def test_worker_main_serves_and_exits_0_on_sigterm(tmp_path):
    async def run():
        env = dict(os.environ, PYTHONPATH=str(ROOT))
        proc = await asyncio.create_subprocess_exec(
            sys.executable, "-m", "dynamo_tpu_torch.worker", "--device", "cpu",
            "--model", "tiny", "--num-pages", "64", "--page-size", "4",
            "--max-seq-len", "64", "--max-batch", "4", "--chunk-size", "16",
            "--discovery-backend", "file", "--discovery-root", str(tmp_path),
            cwd=ROOT, env=env, stdout=asyncio.subprocess.PIPE,
            stderr=asyncio.subprocess.DEVNULL)
        rt = DistributedRuntime(discovery=FileDiscovery(str(tmp_path), poll_interval=0.05),
                                event_transport="inproc")
        try:
            line = b""
            while b"worker serving" not in line:
                line = await proc.stdout.readline()
                assert line, "the worker exited before serving"
            client = rt.client("dyn/tpu-worker/generate")
            await client.wait_ready(timeout=T)
            toks, finish = await _collect(client.generate(_req(PROMPTS[0], 4), Context()))
            await client.close()
            proc.send_signal(signal.SIGTERM)
            rc = await proc.wait()
        finally:
            if proc.returncode is None:
                proc.kill()
                await proc.wait()
            await rt.shutdown(drain_timeout=1)
        return toks, finish, rc, line

    toks, finish, rc, line = await asyncio.wait_for(run(), 2 * T)
    assert rc == 0 and finish == "length" and len(toks) == 4
    assert line.decode().startswith("worker serving tiny at dyn/tpu-worker/generate")
