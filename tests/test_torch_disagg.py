"""Disaggregated prefill→decode and the G2 host KV tier of the port, in
process on the CPU at f32 (the counterparts of tests/test_disagg.py and
tests/test_kv_tiers.py).

A prefill engine and a decode engine hold the same tiny params, each served
by serve_worker on its own runtime over the in-process request plane; a
PrefillRouter over the prefill component (from discovery) drives them,
sending the decode continuation to the decode worker over the plane.
Greedy output through the device transfer (a colocated prefill instance),
the chunked host-staged pull and the monolithic pull (through the prefill
worker's kv_fetch endpoint) must equal aggregated serving (and the JAX
engine's) token for token, with no prefill pass on the decode engine. A truncated pull recomputes; an early stop releases
the parked pages. With a host tier, evicted prefix pages come back on a
prefix hit, in one or three layer groups, and the greedy stream equals a
cold prefill's and the JAX engine's with the same tier.
"""

import asyncio
import dataclasses
import gc
import uuid

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
from dynamo_tpu_torch.models.config import get_config
from dynamo_tpu_torch.frontend.protocols import ModelCard
from dynamo_tpu_torch.router.prefill_router import DisaggPolicy, PrefillRouter
from dynamo_tpu_torch.runtime.component import Instance
from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.runtime.discovery import MemDiscovery
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.request_plane import reset_inproc
from dynamo_tpu_torch.worker_common import LOCAL_ENGINES, serve_worker

PS = 4
GEOMETRY = dict(num_pages=64, page_size=PS, max_pages_per_seq=16,
                decode_buckets=(1, 2, 4, 8), prefill_buckets=(8, 16, 32))
_rng = np.random.default_rng(5)
PROMPTS = [_rng.integers(1, 500, size=n).tolist() for n in (20, 33, 9, 28)]
MAX_TOKENS = 6
CARD = ModelCard(name="tiny", context_length=64, kv_block_size=PS)


@pytest.fixture(autouse=True)
def _fresh_registries():
    yield
    MemDiscovery.reset()
    reset_inproc()


def _req(prompt, max_tokens=MAX_TOKENS, **stop):
    return {"token_ids": list(prompt), "sampling": {"temperature": 0.0},
            "stop": {"max_tokens": max_tokens, "stop_ids": [], **stop}}


@pytest.fixture(scope="module")
def jparams():
    return jax.device_get(jllama.init_params(
        jax_get_config("tiny"), jax.random.PRNGKey(7), jnp.float32))


def _engine(jparams, config=None, **kw):
    cfg = config or get_config("tiny")
    runner = ModelRunner(cfg, device="cpu", dtype=torch.float32,
                         params=params_from_numpy(jparams, cfg, "cpu",
                                                  torch.float32), **GEOMETRY)
    return InferenceEngine(runner, max_batch=4, chunk_size=16, **kw)


async def _collect(engine, req, ctx_cls=Context):
    toks, finish, phases = [], None, {}
    async for item in engine.generate(req, ctx_cls()):
        toks.extend(item["token_ids"])
        if item.get("finish_reason"):
            finish = item["finish_reason"]
            phases = item.get("phases") or {}
    return toks, finish, phases


@pytest.fixture(scope="module")
def aggregated(jparams):
    """Aggregated greedy streams of PROMPTS: the port's, checked against
    the JAX engine's."""
    async def serve():
        eng = _engine(jparams)
        jeng = JaxEngine(JaxRunner(jax_get_config("tiny"), params=jparams,
                                   dtype=jnp.float32, **GEOMETRY),
                         max_batch=4, chunk_size=16)
        try:
            port = [(await _collect(eng, _req(p)))[:2] for p in PROMPTS]
            ref = [(await _collect(jeng, _req(p), JaxContext))[:2] for p in PROMPTS]
        finally:
            eng.stop()
            jeng.stop()
        assert port == ref
        return port

    return asyncio.run(serve())


def _runtime(realm):
    return DistributedRuntime(discovery=MemDiscovery(realm=realm),
                              event_transport="inproc", request_plane="inproc")


async def _disagg(jparams, colocated, chunk_pages, min_prefill_tokens=8):
    """A prefill and a decode worker, each on its own in-process runtime;
    a colocated prefill instance is pulled on the device, any other
    through its kv_fetch endpoint. The router runs on a third runtime."""
    prefill, decode = _engine(jparams), _engine(jparams)
    realm = uuid.uuid4().hex
    await serve_worker(_runtime(realm), prefill, CARD, component="prefill",
                       disagg_role="prefill", colocated=colocated)
    await serve_worker(_runtime(realm), decode, CARD, component="decode",
                       disagg_role="decode", disagg_chunk_pages=chunk_pages)
    front = _runtime(realm)
    downstream, pool = front.client("dyn/decode/generate"), front.client("dyn/prefill/generate")
    await downstream.wait_ready()
    await pool.wait_ready()
    router = PrefillRouter(downstream, DisaggPolicy(min_prefill_tokens=min_prefill_tokens))
    router.activate(pool, "dyn/prefill/kv_fetch")
    return prefill, decode, router


def _spy_imports(runner):
    calls = {"device": [], "host": []}
    dev, host = runner.import_pages_device, runner.import_pages

    def on_device(target, *a, **kw):
        calls["device"].append(len(target))
        return dev(target, *a, **kw)

    def on_host(target, *a, **kw):
        calls["host"].append(len(target))
        return host(target, *a, **kw)

    runner.import_pages_device, runner.import_pages = on_device, on_host
    return calls


async def _settle_parked(engine):
    for _ in range(200):
        if not engine._parked:
            return
        await asyncio.sleep(0.01)


@pytest.mark.parametrize("path,chunk_pages", [
    ("device", 16), ("host_chunked", 2), ("host_monolithic", 0)])
async def test_disagg_matches_aggregated(jparams, aggregated, path, chunk_pages):
    prefill, decode, router = await _disagg(jparams, path == "device", chunk_pages)
    calls = _spy_imports(decode.runner)
    try:
        # two alone, then two at once (their transfers overlap)
        got = [(await _collect(router, _req(p)))[:2] for p in PROMPTS[:2]]
        pair = await asyncio.gather(*[_collect(router, _req(p)) for p in PROMPTS[2:]])
        got += [r[:2] for r in pair]
    finally:
        prefill.stop()
        decode.stop()
    assert got == aggregated
    st = decode.runner.stats
    # the decode engine ran no prefill pass: every prompt came with its KV
    assert st["prefill_chunks"] == st["mixed_chunks"] == 0
    exported = sum(-(-len(p) // PS) for p in PROMPTS)
    assert prefill.runner.stats["kv_pages_exported"] == exported
    # import takes ceil((len + 1 - 1) / PS) of the decode prompt (prompt +
    # first token): the same pages
    assert st["kv_pages_imported"] == exported
    pages = [-(-len(p) // PS) for p in PROMPTS]
    if path == "device":  # one gathered buffer per request
        assert sorted(calls["device"]) == sorted(pages) and not calls["host"]
    elif path == "host_chunked":  # chunks of 2 pages, every one imported
        assert not calls["device"] and max(calls["host"]) == 2
        assert len(calls["host"]) == sum(-(-n // 2) for n in pages)
    else:  # one payload per request
        assert sorted(calls["host"]) == sorted(pages) and not calls["device"]
    # every parked page was released back to the prefill engine's pool
    assert not prefill._parked and not prefill.pool.ref


async def test_park_after_fused_chunks(jparams, aggregated, monkeypatch):
    """The prefill engine also decodes an aggregated request, so the
    disagg prompt's chunks ride fused mixed dispatches: its last chunk
    parks through _finish_packed_prefills, and the pull still matches."""
    monkeypatch.setenv("DYN_FUSED_MIXED", "1")
    prefill, decode, router = await _disagg(jparams, True, 16)
    assert prefill.fused_mixed
    try:
        running = asyncio.ensure_future(_collect(prefill, _req(PROMPTS[0], 40)))
        while prefill.runner.stats["decode_steps"] == 0:
            await asyncio.sleep(0.005)
        got = (await _collect(router, _req(PROMPTS[1])))[:2]
        await running
    finally:
        prefill.stop()
        decode.stop()
    assert got == aggregated[1]
    assert prefill.runner.stats["mixed_chunks"] >= 2  # the 33-token prompt
    assert decode.runner.stats["prefill_chunks"] == 0
    assert not prefill._parked and not prefill.pool.ref


async def test_truncated_pull_recomputes(jparams, aggregated, caplog):
    """The parked entry expires after the first chunk: the pull is
    truncated, the decode engine prefills the prompt itself, and the
    output is unchanged."""
    prefill, decode, router = await _disagg(jparams, False, 2)
    export_chunk = prefill._export_chunk

    def expiring(rid, start, n, last):
        if start > 0:  # what _expire_parked does between two chunks
            seq, _ = prefill._parked.pop(rid)
            prefill.scheduler.release_parked(seq)
            return None
        return export_chunk(rid, start, n, last)

    prefill._export_chunk = expiring
    try:
        with caplog.at_level("WARNING"):
            got = (await _collect(router, _req(PROMPTS[1])))[:2]
    finally:
        prefill.stop()
        decode.stop()
    assert got == aggregated[1]
    assert any("truncated" in m for m in caplog.messages)
    assert decode.runner.stats["prefill_chunks"] > 0
    assert decode.runner.stats["kv_pages_imported"] == 0
    assert not prefill.pool.ref


@pytest.mark.parametrize("early", ["stop", "max_tokens_1"])
async def test_early_finish_discards_parked_pages(jparams, aggregated, early):
    first = aggregated[0][0][0]
    if early == "stop":
        req, want = _req(PROMPTS[0], stop_ids=[first]), ([], "stop")
    else:
        req, want = _req(PROMPTS[0], max_tokens=1), ([first], "length")
    prefill, decode, router = await _disagg(jparams, True, 16)
    try:
        got = (await _collect(router, req))[:2]
        await _settle_parked(prefill)
    finally:
        prefill.stop()
        decode.stop()
    assert got == want
    assert not prefill._parked and not prefill.pool.ref
    assert prefill.runner.stats["kv_pages_exported"] == 0
    assert decode.runner.stats["decode_steps"] == 0


async def test_short_prompts_and_failed_hops_serve_aggregated(jparams, aggregated):
    """Below min_prefill_tokens, and when the prefill hop fails, the decode
    engine serves the request itself."""
    prefill, decode, router = await _disagg(jparams, True, 16, min_prefill_tokens=10)
    try:
        short = (await _collect(router, _req(PROMPTS[2])))[:2]  # 9 tokens
        # a prefill pool whose one instance is gone
        pool = router._prefill_client.runtime.client("dyn/gone/generate")
        pool.instances[1] = Instance("dyn", "gone", "generate", 1, address="inproc://gone")
        pool.router.update_instance(1, "inproc://gone")
        router.activate(pool, "dyn/gone/kv_fetch")
        failed = (await _collect(router, _req(PROMPTS[0])))[:2]
    finally:
        prefill.stop()
        decode.stop()
    assert short == aggregated[2] and failed == aggregated[0]
    assert prefill.runner.stats["prefill_chunks"] == 0
    assert decode.runner.stats["prefill_chunks"] > 0
    assert decode.runner.stats["kv_pages_imported"] == 0


def test_local_registry_is_weak(jparams):
    """A served prefill engine that goes away leaves the registry (the
    reference's WeakValueDictionary)."""
    async def serve():
        rt = _runtime(uuid.uuid4().hex)
        eng = _engine(jparams)
        worker = await serve_worker(rt, eng, CARD, component="prefill")
        iid = worker.instance.instance_id
        assert LOCAL_ENGINES[iid] is eng
        await rt.shutdown(drain_timeout=0)
        await worker.stop()
        return iid

    iid = asyncio.run(serve())
    gc.collect()
    assert iid not in LOCAL_ENGINES


# -- G2 host tier ------------------------------------------------------------

TIER_GEOMETRY = dict(GEOMETRY, num_pages=24)


def _tier_requests():
    rng = np.random.default_rng(1)
    a = rng.integers(1, 500, size=40).tolist()
    fillers = [rng.integers(1, 500, size=40).tolist() for _ in range(2)]
    a2 = a[:32] + rng.integers(1, 500, size=5).tolist()
    return a, fillers, a2


@pytest.fixture(scope="module")
def tier_params():
    cfg = dataclasses.replace(jax_get_config("tiny"), n_layers=3)
    return cfg, jax.device_get(
        jllama.init_params(cfg, jax.random.PRNGKey(9), jnp.float32))


async def _serve_tier_sequence(engine, ctx_cls=Context):
    a, fillers, a2 = _tier_requests()
    await _collect(engine, _req(a), ctx_cls)
    for f in fillers:
        await _collect(engine, _req(f), ctx_cls)
    before = engine.scheduler.reused_prefix_tokens
    out = await _collect(engine, _req(a2), ctx_cls)
    return out, engine.scheduler.reused_prefix_tokens - before


@pytest.mark.parametrize("groups", [1, 3])
async def test_host_tier_onboard_matches_cold_and_jax(tier_params, groups):
    jcfg, params = tier_params
    cfg = dataclasses.replace(get_config("tiny"), n_layers=3)

    def port_engine(**kw):
        runner = ModelRunner(cfg, device="cpu", dtype=torch.float32,
                             params=params_from_numpy(params, cfg, "cpu",
                                                      torch.float32),
                             **TIER_GEOMETRY)
        return InferenceEngine(runner, max_batch=4, chunk_size=16, **kw)

    cold = port_engine()
    tiered = port_engine(host_kv_blocks=64, onboard_layer_groups=groups)
    jeng = JaxEngine(JaxRunner(jcfg, params=params, dtype=jnp.float32,
                               **TIER_GEOMETRY),
                     max_batch=4, chunk_size=16, host_kv_blocks=64,
                     onboard_layer_groups=groups)
    try:
        want = (await _collect(cold, _req(_tier_requests()[2])))[:2]
        (toks, finish, phases), reused = await _serve_tier_sequence(tiered)
        (jtoks, jfinish, _), jreused = await _serve_tier_sequence(jeng, JaxContext)
    finally:
        cold.stop()
        tiered.stop()
        jeng.stop()
    assert (toks, finish) == want == (jtoks, jfinish)
    # A's first 8 pages (32 tokens) were evicted to the host pool and came
    # back, on both engines
    assert reused == jreused == 32
    assert tiered.host_pool.stats["offloaded"] > 8
    assert tiered.onboard_stats["onboards"] == 1
    assert tiered.onboard_stats["blocks"] == 8
    assert tiered.runner.stats["kv_layer_group_scatters"] == (
        0 if groups == 1 else groups)
    assert tiered.runner.stats["kv_pages_imported"] == 8
    assert phases["kv_onboard_s"] > 0


def test_host_pool_lru_and_eviction_listeners():
    from dynamo_tpu_torch.kvbm.host_pool import HostKvPool

    pool = HostKvPool(capacity_blocks=2)
    dropped = []
    pool.on_evict(dropped.extend)
    k = torch.arange(2 * 3 * 4, dtype=torch.float32).view(2, 3, 4, 1, 1)
    pool.put([10, 11], [None, 10], k[:, :2], k[:, :2] + 1)
    assert pool.match([10, 11, 12]) == 2
    pool.get([10])  # 10 becomes most recently used
    pool.put([12], [11], k[:, 2:], k[:, 2:])
    assert dropped == [11] and pool.match([10]) == 1 and 12 in pool
    gk, gv = pool.get([10, 12])
    assert torch.equal(gk, k[:, [0, 2]]) and torch.equal(gv[:, :1], k[:, :1] + 1)
    with pytest.raises(KeyError):
        pool.get([11])
    assert pool.stats["evicted"] == 1 and pool.stats["offloaded"] == 3
    assert sorted(pool.clear()) == [10, 12] and len(pool) == 0
