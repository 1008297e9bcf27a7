"""LoRA adapters served through the port's runtime (tests/test_lora.py's
serving cases on dynamo_tpu_torch), on the CPU:

- a worker's adapters are models of the frontend (`/v1/models`), their
  requests carry the adapter, and their greedy streams are the port
  engine's in process (round_robin and kv routing);
- LoRA-filtered routing: adapter requests land only on the workers
  holding the adapter, base requests on all of them, a worker joining
  with a new adapter registers it, and the adapter goes with its last
  holder while the base model keeps serving; the KV router refuses an
  adapter nobody holds;
- the prefill pool's filter: an adapter no prefill worker holds falls back
  to aggregated serving, a runtime load on a prefill worker makes it hop
  there;
- `PushRouter`'s allowed filter in every mode;
- the `rl` endpoint: describe, pause / resume, load_adapter (slot
  exhaustion, the re-registration and over-rank errors, a worker without
  slots), update_weights without a snapshot refused;
- block hashes seeded by an adapter equal the reference's `request_seed`
  hashes, in the router and in the engine's KV events;
- `python -m dynamo_tpu_torch.worker --lora ad-one` behind `python -m
  dynamo_tpu_torch.frontend`: ad-one is listed and served.
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
from dynamo_tpu.tokens import hashing as jhashing
from dynamo_tpu_torch.engine.engine import InferenceEngine
from dynamo_tpu_torch.engine.model_runner import ModelRunner
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.frontend.http import HttpService
from dynamo_tpu_torch.frontend.protocols import ModelCard
from dynamo_tpu_torch.frontend.service import ModelManager, ModelWatcher
from dynamo_tpu_torch.models import lora
from dynamo_tpu_torch.models.config import get_config
from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.runtime.discovery import FileDiscovery, MemDiscovery
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.request_plane import (
    PushRouter,
    RequestPlaneError,
    RouterMode,
)
from dynamo_tpu_torch.tokens.hashing import block_hashes, request_seed
from dynamo_tpu_torch.worker_common import serve_worker

ROOT = Path(__file__).resolve().parents[1]
CFG = get_config("tiny")
T = 60  # bound on every awaited scenario, seconds
PS = 4
GEOMETRY = dict(num_pages=64, page_size=PS, max_pages_per_seq=16,
                decode_buckets=(1, 2, 4, 8), prefill_buckets=(8, 16, 32))
PROMPT = [4, 2, 4, 2, 9, 11, 3, 7, 8, 1]


@pytest.fixture(autouse=True)
def _fresh_registries():
    yield
    MemDiscovery.reset()


@pytest.fixture(scope="module")
def params():
    jp = jax.device_get(jllama.init_params(jax_get_config("tiny"), jax.random.PRNGKey(7),
                                           jnp.float32))
    return params_from_numpy(jp, CFG, "cpu", torch.float32)


def _adapter(seed):
    return lora.random_adapter(CFG, seed=seed, scale=2.0)


def _engine(params, adapters=(), slots=None):
    slots = len(adapters) if slots is None else slots
    runner = ModelRunner(CFG, device="cpu", dtype=torch.float32, params=params,
                         lora_slots=slots, **GEOMETRY)
    for name, seed in adapters:
        runner.register_adapter(name, _adapter(seed))
    return InferenceEngine(runner, max_batch=4, chunk_size=16)


def _card(adapters=()):
    return ModelCard(name="tiny", context_length=64, kv_block_size=PS,
                     adapters=list(adapters))


async def _until(cond, what, bound=T):
    async def poll():
        while not cond():
            await asyncio.sleep(0.02)
    try:
        await asyncio.wait_for(poll(), bound)
    except asyncio.TimeoutError:
        raise AssertionError(f"timed out waiting for {what}") from None


def _http(port, method, path, body=None):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=T)
    try:
        c.request(method, path, json.dumps(body) if body is not None else None,
                  {"Content-Type": "application/json"})
        r = c.getresponse()
        return r.status, r.read()
    finally:
        c.close()


def _completion(model, prompt=PROMPT, n=5):
    return {"model": model, "prompt": list(prompt), "max_tokens": n, "temperature": 0.0,
            "ignore_eos": True}


async def _via(manager, model, prompt=PROMPT, n=5):
    """A greedy completion through the model entry's chain; an error item
    raises (a mis-routed adapter request surfaces here)."""
    entry = manager.get(model)
    req = entry.preprocessor.preprocess_completions(_completion(model, prompt, n))
    toks = []
    async for item in entry.chain.generate(req, Context()):
        if item.get("finish_reason") == "error":
            raise RuntimeError(item.get("error"))
        toks.extend(item.get("token_ids") or [])
    return toks


async def _direct(engine, prompt=PROMPT, adapter=None, n=5):
    req = {"token_ids": list(prompt), "sampling": {"temperature": 0.0},
           "stop": {"max_tokens": n, "stop_ids": [], "ignore_eos": True}}
    if adapter:
        req["adapter"] = adapter
    return [t async for it in engine.generate(req, Context()) for t in it["token_ids"]]


def _work(engine) -> int:
    """Prompt tokens an engine has prefilled."""
    st = engine.runner.stats
    return st["prefill_chunks"] + st["mixed_chunks"] + st["padded_prefill_dispatches"]


class _Fleet:
    """Port workers served in this process (each on its own runtime) and
    a frontend (HttpService) on one in-process discovery realm."""

    def __init__(self, realm):
        self.realm = realm
        self.workers = {}  # name -> (runtime, ServedWorker)
        self.svc = self.rt = None

    async def add(self, name, params, adapters=(), slots=None, role=None):
        rt = DistributedRuntime(discovery=MemDiscovery(realm=self.realm))
        eng = _engine(params, adapters, slots)
        w = await serve_worker(rt, eng, _card(a for a, _ in adapters),
                               component=role or "tpu-worker", disagg_role=role,
                               colocated=False)
        self.workers[name] = (rt, w)
        return eng

    async def remove(self, name):
        rt, w = self.workers.pop(name)
        await rt.shutdown(drain_timeout=1)
        await w.stop()

    async def start(self, mode, **watch_kw):
        self.rt = DistributedRuntime(discovery=MemDiscovery(realm=self.realm))
        mgr = ModelManager()
        self.svc = HttpService(self.rt, mgr, ModelWatcher(self.rt, mgr, router_mode=mode,
                                                          **watch_kw), port=0)
        await self.svc.start()
        await self.svc.watcher.wait_for_model(timeout=T)
        return mgr

    async def close(self):
        if self.svc is not None:
            await self.svc.stop()
            await self.rt.shutdown(drain_timeout=1)
        for name in list(self.workers):
            await self.remove(name)


@pytest.mark.parametrize("mode", ["round_robin", "kv"])
async def test_adapter_served_as_model_through_frontend(params, mode):
    want_eng = _engine(params, [("tuned", 3)])
    want_base = await _direct(want_eng)
    want_tuned = await _direct(want_eng, adapter="tuned")
    want_eng.stop()
    f = _Fleet(f"served-{mode}")
    try:
        await f.add("a", params, [("tuned", 3)])
        mgr = await f.start(mode)
        await _until(lambda: "tuned" in mgr.list_models(), "the adapter entry")
        status, body = await asyncio.to_thread(_http, f.svc.port, "GET", "/v1/models")
        assert status == 200 and [m["id"] for m in json.loads(body)["data"]] == ["tiny",
                                                                                "tuned"]
        entry = mgr.get("tuned")
        assert entry.preprocessor.preprocess_completions(
            _completion("tuned"))["adapter"] == "tuned"
        assert "adapter" not in mgr.get("tiny").preprocessor.preprocess_completions(
            _completion("tiny"))
        assert await _via(mgr, "tiny") == want_base
        assert await _via(mgr, "tuned") == want_tuned != want_base
        status, body = await asyncio.to_thread(_http, f.svc.port, "POST",
                                               "/v1/completions", _completion("tuned"))
        assert status == 200 and json.loads(body)["usage"]["completion_tokens"] == 5
    finally:
        await f.close()


@pytest.mark.parametrize("mode", ["round_robin", "kv"])
async def test_lora_filtered_routing(params, mode):
    """Adapter requests reach only its holders; base requests reach both
    workers; a third worker with a new adapter registers it late; the
    adapter goes with its last holder and the base model keeps
    serving."""
    f = _Fleet(f"routing-{mode}")
    try:
        eng_a = await f.add("a", params, [("tuned", 3)])
        eng_b = await f.add("b", params)  # the same base model, no adapter
        mgr = await f.start(mode)
        await _until(lambda: len(mgr.get("tiny").instance_ids) == 2
                     and "tuned" in mgr.list_models(), "both workers")
        assert mgr.get("tuned").instance_ids == {f.workers["a"][1].instance.instance_id}
        for i in range(6):
            assert await _via(mgr, "tuned", PROMPT[:6 + i % 3])
        assert _work(eng_b) == 0 and _work(eng_a) > 0
        # base requests two at a time: the kv router breaks a cost tie by
        # instance id (random), so requests one at a time may all land on
        # one worker; a pair's second pick sees the first's blocks and goes
        # to the other worker whichever id sorts first
        for i in range(0, 8, 2):
            got = await asyncio.gather(*(_via(mgr, "tiny", [j + 1] * (5 + j))
                                         for j in (i, i + 1)))
            assert all(got)
        assert _work(eng_b) > 0, "base requests never reached worker b"
        # a worker joining with a new adapter
        await f.add("c", params, [("late", 9)])
        await _until(lambda: "late" in mgr.list_models(), "the late adapter")
        for _ in range(3):
            assert await _via(mgr, "late")  # b or a would answer an error
        if mode == "kv":
            kv = mgr.get("tiny").chain.sink.router
            await kv.start()
            with pytest.raises(RequestPlaneError) as ei:
                kv.find_best_match(PROMPT, adapter="nobody", allowed_instances=set())
            assert ei.value.code == "no_instances"
            # the adapter's lineage: the reference's request_seed hashes, and
            # only the holder is a candidate
            ic = f.workers["c"][1].instance.instance_id
            w, _, hashes = kv.find_best_match(PROMPT, adapter="late",
                                              allowed_instances={ic})
            assert w[0] == ic and hashes == jhashing.block_hashes(
                PROMPT, PS, jhashing.request_seed("late", None))
        # the last holder of "tuned" goes
        await f.remove("a")
        await _until(lambda: "tuned" not in mgr.list_models(), "the adapter's removal")
        with pytest.raises(KeyError):
            mgr.get("tuned")
        assert await _via(mgr, "tiny")
        assert "late" in mgr.list_models()
    finally:
        await f.close()


async def test_prefill_pool_lora_filter(params):
    """A decode worker holding `tuned` and a prefill worker holding no
    adapter behind a kv frontend that disaggregates prompts of 8+ tokens:
    `tuned` requests fall back to aggregated serving (the empty set),
    base requests hop; after an rl load_adapter on the prefill worker,
    `tuned` requests hop there too, with the aggregated stream."""
    f = _Fleet("prefill-filter")
    try:
        eng_p = await f.add("p", params, slots=1, role="prefill")
        eng_d = await f.add("d", params, [("tuned", 3)], role="decode")
        mgr = await f.start("kv", disagg_min_prefill_tokens=8)
        base_entry = mgr.get("tiny")
        await _until(lambda: "tuned" in mgr.list_models()
                     and base_entry.prefill_router.active, "the disaggregated pool")
        aentry = mgr.get("tuned")
        await _until(lambda: aentry.prefill_router.active, "the adapter's prefill pool")
        assert aentry.prefill_router.allowed_prefill == set()
        assert base_entry.prefill_router.allowed_prefill is None
        agg = await _via(mgr, "tuned")
        assert _work(eng_p) == 0 and _work(eng_d) > 0
        assert await _via(mgr, "tiny")
        hops = _work(eng_p)
        assert hops > 0
        # load the adapter on the prefill worker: it joins the adapter's pool
        rl = f.rt.client("dyn/prefill/rl")
        await rl.wait_ready(timeout=T)
        async for item in rl.generate({"op": "load_adapter", "name": "tuned", "seed": 3,
                                       "scale": 2.0}):
            assert item.get("slot") == 1, item
        await rl.close()
        pid = f.workers["p"][1].instance.instance_id
        await _until(lambda: aentry.prefill_router.allowed_prefill == {pid},
                     "the republished prefill card")
        assert await _via(mgr, "tuned") == agg
        assert _work(eng_p) > hops
        assert f.workers["d"][1].handler.fallbacks == 0
    finally:
        await f.close()


def test_push_router_allowed_filter():
    for mode in (RouterMode.ROUND_ROBIN, RouterMode.RANDOM, RouterMode.P2C,
                 RouterMode.LEAST_LOADED):
        r = PushRouter("ns/c/e", mode)
        for i, addr in ((1, "tcp://a"), (2, "tcp://b"), (3, "tcp://c")):
            r.update_instance(i, addr)
        assert {r._pick(allowed={2})[0] for _ in range(8)} == {2}, mode
        assert {r._pick(allowed={1, 3})[0] for _ in range(16)} <= {1, 3}
        if mode == RouterMode.ROUND_ROBIN:
            assert {r._pick()[0] for _ in range(3)} == {1, 2, 3}
        with pytest.raises(RequestPlaneError) as ei:
            r._pick(allowed=set())
        assert ei.value.code == "no_instances"
        with pytest.raises(RequestPlaneError) as ei:
            r._pick(instance_id=1, allowed={2})
        assert ei.value.code == "cannot_connect"
        assert r._pick(instance_id=2, allowed={2})[0] == 2


async def test_rl_endpoint_and_runtime_adapter_loads(params):
    f = _Fleet("rl")
    try:
        eng = await f.add("a", params, slots=2)  # free slots, nothing at boot
        await f.add("b", params)  # no slots
        mgr = await f.start("round_robin")
        assert mgr.list_models() == ["tiny"]
        rl = f.rt.client("dyn/tpu-worker/rl")
        await rl.wait_ready(timeout=T)
        await _until(lambda: len(rl.instances) == 2, "both rl endpoints")
        ia, ib = (f.workers[n][1].instance.instance_id for n in ("a", "b"))

        async def call(iid, req):
            return [item async for item in rl.direct(req, iid)][0]

        d = await call(ia, {})
        assert d["model"] == "tiny" and not d["paused"] and d["adapters"] == []
        assert (await call(ia, {"op": "pause"}))["paused"] is True
        assert eng.paused
        items = [it async for it in eng.generate(
            {"token_ids": PROMPT, "sampling": {}, "stop": {"max_tokens": 2}}, Context())]
        assert items[-1]["finish_reason"] == "error" and "paused" in items[-1]["error"]
        assert (await call(ia, {"op": "resume"}))["paused"] is False
        assert "needs 'orbax'" in (await call(ia, {"op": "update_weights"}))["error"]
        assert "unknown rl op" in (await call(ia, {"op": "nope"}))["error"]
        assert "without --lora" in (await call(ib, {"op": "load_adapter",
                                                    "name": "x"}))["error"]
        assert "needs 'name'" in (await call(ia, {"op": "load_adapter"}))["error"]
        assert "exceeds" in (await call(ia, {"op": "load_adapter", "name": "big",
                                             "rank": 16}))["error"]
        got = await call(ia, {"op": "load_adapter", "name": "hotload", "seed": 5})
        assert got["adapter"] == "hotload" and got["slot"] == 1 and got["adapters"] == [
            "hotload"]
        await _until(lambda: "hotload" in mgr.list_models(), "the loaded adapter")
        assert mgr.get("hotload").instance_ids == {ia}
        base, tuned = await _via(mgr, "tiny"), await _via(mgr, "hotload")
        assert base and tuned and base != tuned
        # the runtime load equals the adapter registered at boot
        ref = _engine(params, [("hotload", 5)])
        assert await _direct(ref, adapter="hotload") == tuned
        ref.stop()
        # a rank-4 adapter zero-padded into the rank-8 tree
        assert (await call(ia, {"op": "load_adapter", "name": "small", "rank": 4,
                                "seed": 6}))["slot"] == 2
        assert "slots in use" in (await call(ia, {"op": "load_adapter", "name": "more",
                                                  "seed": 7}))["error"]
        err = (await call(ia, {"op": "load_adapter", "name": "hotload", "seed": 8}))["error"]
        assert "already registered" in err
        await _until(lambda: "small" in mgr.list_models(), "the second adapter")
        assert await _via(mgr, "small")
        await rl.close()
    finally:
        await f.close()


async def test_adapter_block_hashes_match_reference(params):
    toks = list(range(3, 40))
    for adapter in (None, "ad-one", "ad-two"):
        want = jhashing.block_hashes(toks, PS, jhashing.request_seed(adapter, None))
        assert block_hashes(toks, PS, request_seed(adapter, None)) == want
    assert request_seed("ad-one", 12345) == jhashing.request_seed("ad-one", 12345)
    base = set(block_hashes(toks, PS))
    one = block_hashes(toks, PS, request_seed("ad-one", None))
    assert not base & set(one)
    # the engine stores an adapter sequence's blocks under those hashes
    eng = _engine(params, [("ad-one", 1)])
    stored = []
    eng.on_kv_event(lambda evs: stored.extend(
        h for e in evs if e.kind == "store" for h in e.block_hashes))
    try:
        out = await _direct(eng, toks[:20], adapter="ad-one")
    finally:
        eng.stop()
    full = toks[:20] + out
    assert stored and stored == jhashing.block_hashes(
        full, PS, jhashing.request_seed("ad-one", None))[:len(stored)]


WORKER_ARGS = ["--device", "cpu", "--model", "tiny", "--num-pages", "64", "--page-size", "4",
               "--max-seq-len", "256", "--max-batch", "4", "--chunk-size", "16"]


async def _spawn(args, root, marker):
    proc = await asyncio.create_subprocess_exec(
        sys.executable, "-m", *args, "--discovery-backend", "file", "--discovery-root", root,
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT)),
        stdout=asyncio.subprocess.PIPE, stderr=asyncio.subprocess.DEVNULL)
    while True:
        line = (await asyncio.wait_for(proc.stdout.readline(), T)).decode()
        assert line, f"{args[0]} exited before serving"
        if line.startswith(marker):
            return proc, line.strip()


async def test_worker_and_frontend_processes_serve_an_adapter(tmp_path):
    """The worker's --lora flag and the frontend's main, as processes on a
    file-discovery root: the adapter is listed and served, then both exit
    0 on SIGTERM."""
    root = str(tmp_path)
    procs = []

    async def run():
        procs.append(await _spawn(["dynamo_tpu_torch.worker", *WORKER_ARGS, "--lora",
                                   "ad-one"], root, "worker serving"))
        fe, line = await _spawn(["dynamo_tpu_torch.frontend", "--router-mode", "kv",
                                 "--http-host", "127.0.0.1", "--http-port", "0"], root,
                                "frontend serving at")
        procs.append((fe, line))
        port = int(line.rsplit(":", 1)[1])
        while True:
            status, body = await asyncio.to_thread(_http, port, "GET", "/v1/models")
            ids = [m["id"] for m in json.loads(body)["data"]] if status == 200 else []
            if "ad-one" in ids:
                break
            await asyncio.sleep(0.1)
        outs = {}
        for model in ("tiny", "ad-one"):
            status, body = await asyncio.to_thread(_http, port, "POST", "/v1/completions",
                                                   _completion(model, n=6))
            assert status == 200, body
            outs[model] = json.loads(body)
        rcs = []
        for p, _ in reversed(procs):
            p.send_signal(signal.SIGTERM)
            rcs.append(await asyncio.wait_for(p.wait(), T))
        return ids, outs, rcs

    try:
        ids, outs, rcs = await asyncio.wait_for(run(), 3 * T)
    finally:
        for p, _ in procs:
            if p.returncode is None:
                p.kill()
                await p.wait()
    assert ids == ["ad-one", "tiny"]
    assert all(o["usage"]["completion_tokens"] == 6 for o in outs.values())
    assert outs["ad-one"]["model"] == "ad-one"
    assert rcs == [0, 0]
