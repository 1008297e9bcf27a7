"""Remote-G2 pulls of the port (the reference's kv_remote_host hint and
kv_host_fetch endpoint), on the CPU at f32.

Two port engines, A and B, each served by serve_worker on its own
runtime over the in-process request plane, behind a KvRouter on a third.
A's prompt is evicted into A's host tier; the router routes the same
prompt to B, and its `kv_remote_host` hint makes B pull A's blocks
through A's `kv_host_fetch`: B runs no prefill for the pulled blocks, no
pull fails, and its greedy stream equals A's. A request naming a peer
that is not there is served by recompute. A payload of the JAX engine's
`_host_export` imports into the port's `_host_import`, and the other way
round.
"""

import asyncio
import dataclasses
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
from dynamo_tpu_torch.engine.engine import InferenceEngine
from dynamo_tpu_torch.engine.model_runner import ModelRunner
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.frontend.protocols import ModelCard
from dynamo_tpu_torch.models.config import get_config
from dynamo_tpu_torch.router.kv_router import KvPushRouter, KvRouter
from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.runtime.discovery import MemDiscovery
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.request_plane import reset_inproc
from dynamo_tpu_torch.tokens.hashing import block_hashes
from dynamo_tpu_torch.worker_common import serve_worker

PS = 4
GEOMETRY = dict(num_pages=24, page_size=PS, max_pages_per_seq=16,
                decode_buckets=(1, 2, 4, 8), prefill_buckets=(8, 16, 32))
CARD = ModelCard(name="tiny", context_length=64, kv_block_size=PS)
T = 60.0


@pytest.fixture(autouse=True)
def _fresh_registries():
    yield
    MemDiscovery.reset()
    reset_inproc()


@pytest.fixture(scope="module")
def params():
    cfg = dataclasses.replace(jax_get_config("tiny"), n_layers=3)
    return cfg, jax.device_get(jllama.init_params(cfg, jax.random.PRNGKey(9),
                                                  jnp.float32))


def _engine(params, **kw):
    cfg = dataclasses.replace(get_config("tiny"), n_layers=3)
    runner = ModelRunner(cfg, device="cpu", dtype=torch.float32,
                         params=params_from_numpy(params, cfg, "cpu", torch.float32),
                         **GEOMETRY)
    return InferenceEngine(runner, max_batch=4, chunk_size=16, **kw)


def _req(prompt, n=6):
    return {"token_ids": list(prompt), "sampling": {"temperature": 0.0},
            "stop": {"max_tokens": n, "stop_ids": []}}


async def _tokens(stream):
    toks = []
    async for item in stream:
        toks.extend(item.get("token_ids") or [])
        assert item.get("finish_reason") != "error", item
    return toks


async def _until(cond, what, bound=T):
    deadline = asyncio.get_running_loop().time() + bound
    while not cond():
        assert asyncio.get_running_loop().time() < deadline, f"timed out on {what}"
        await asyncio.sleep(0.01)


def _prompts():
    rng = np.random.default_rng(1)
    a = rng.integers(1, 500, size=40).tolist()
    fillers = [rng.integers(1, 500, size=40).tolist() for _ in range(2)]
    return a, fillers


async def test_router_hint_pulls_peer_host_blocks(params):
    _, p = params
    realm = uuid.uuid4().hex
    rts = [DistributedRuntime(discovery=MemDiscovery(realm=realm),
                              request_plane="inproc", event_transport="inproc")
           for _ in range(3)]
    eng_a = _engine(p, host_kv_blocks=64)
    eng_b = _engine(p, host_kv_blocks=64)
    wa = await serve_worker(rts[0], eng_a, CARD)
    wb = await serve_worker(rts[1], eng_b, CARD)
    a_id, b_id = wa.instance.instance_id, wb.instance.instance_id
    client = rts[2].client("dyn/tpu-worker/generate")
    router = KvRouter(rts[2], client, block_size=PS)
    push = KvPushRouter(router)
    a, fillers = _prompts()
    hashes = block_hashes(a, PS)
    try:
        await client.wait_ready(timeout=T)
        await _until(lambda: len(client.instances) == 2, "both workers")
        await router.start()
        want = await _tokens(client.direct(_req(a), a_id, Context()))
        for f in fillers:  # evict A's pages into A's host tier
            await _tokens(client.direct(_req(f), a_id, Context()))
        assert eng_a.host_pool.match(hashes) == len(hashes)
        host_index = router.indexer.host_index
        await _until(lambda: host_index.find_matches(hashes).scores.get((a_id, 0))
                     == len(hashes), "A's host events")
        before = eng_b.scheduler.reused_prefix_tokens
        ctx = Context()
        ctx.metadata["target_instance"] = b_id
        got = await _tokens(push.generate(_req(a), ctx))
        reused = eng_b.scheduler.reused_prefix_tokens - before
    finally:
        await router.stop()
        await client.close()
        for rt in rts:
            await rt.shutdown(drain_timeout=1)
        for w in (wa, wb):
            await w.stop()
    assert got == want
    st = eng_b.tier_stats
    assert st["remote_pulls"] == 1 and st["remote_failures"] == 0
    # the suffix A's host holds past B's own run: every full block but the
    # one holding the last prompt token, which is always recomputed
    max_shared = (len(a) - 1) // PS
    assert st["remote_blocks"] == len(hashes)
    assert reused == max_shared * PS
    assert eng_b.onboard_stats["blocks"] == max_shared
    assert eng_b.tier_stats["onboard_misses"] == 0
    assert "remote" in eng_b.kv_onboard_ewma and "host" in eng_b.kv_onboard_ewma


async def test_remote_hint_without_a_peer_is_served_by_recompute(params):
    """A kv_remote_host naming an instance nobody serves: the pull fails,
    the peer is backed off, and the request recomputes."""
    _, p = params
    realm = uuid.uuid4().hex
    rt = DistributedRuntime(discovery=MemDiscovery(realm=realm),
                            request_plane="inproc", event_transport="inproc")
    eng = _engine(p, host_kv_blocks=16)
    w = await serve_worker(rt, eng, CARD)
    a, _ = _prompts()
    hashes = block_hashes(a, PS)
    hint = {"instance": 0xDEAD, "path": "dyn/tpu-worker/kv_host_fetch",
            "hashes": hashes, "parents": [None] + hashes[:-1]}
    cold = _engine(p)
    try:
        req = dict(_req(a), kv_remote_host=hint)
        got = await _tokens(w.handler.generate(req, Context()))
        again = await _tokens(w.handler.generate(dict(_req(a[:20]), kv_remote_host=hint),
                                                 Context()))
        want = await _tokens(cold.generate(_req(a), Context()))
    finally:
        cold.stop()
        await rt.shutdown(drain_timeout=1)
        await w.stop()
    assert got == want and len(again) == 6
    assert eng.tier_stats["remote_failures"] == 1
    assert eng.tier_stats["remote_backoff_skips"] == 1  # the second skipped the peer
    assert eng.tier_stats["remote_pulls"] == 0


def _host_filled(engine, blocks):
    """Put (hashes, parents, k, v) into an engine's host tier."""
    hashes, parents, k, v = blocks
    if isinstance(engine, InferenceEngine):
        k, v = torch.from_numpy(k), torch.from_numpy(v)
    engine.host_pool.put(hashes, parents, k, v)


async def _export(engine, hashes):
    loop = asyncio.get_running_loop()
    fut = loop.create_future()
    if isinstance(engine, InferenceEngine):
        return engine._host_export(hashes)
    engine._host_export(hashes, fut, loop)
    return await fut


@pytest.mark.parametrize("src,dst", [("jax", "port"), ("port", "jax")])
async def test_host_payloads_cross_between_packages(params, src, dst):
    jcfg, p = params

    def make(kind):
        if kind == "port":
            return _engine(p, host_kv_blocks=16)
        return JaxEngine(JaxRunner(jcfg, params=p, dtype=jnp.float32, **GEOMETRY),
                         max_batch=4, chunk_size=16, host_kv_blocks=16)

    a, b = make(src), make(dst)
    L, ps, hk, d = (3, PS, jcfg.n_kv_heads, jcfg.head_dim)
    rng = np.random.default_rng(2)
    hashes = [501, 502, 503]
    parents = [None, 501, 502]
    k = rng.standard_normal((L, 3, ps, hk, d)).astype(np.float32)
    v = rng.standard_normal((L, 3, ps, hk, d)).astype(np.float32)
    _host_filled(a, (hashes, parents, k, v))
    payload = await _export(a, hashes + [999])
    assert payload["n"] == 3
    b._host_import(hashes, parents, payload)
    got_k, got_v = b.host_pool.get(hashes)
    got_k = got_k.numpy() if isinstance(got_k, torch.Tensor) else got_k
    np.testing.assert_array_equal(got_k, k)
    np.testing.assert_array_equal(np.asarray(got_v), v)
    # host store events follow the imported blocks
    ev = b._host_events[-1]
    assert ev.kind == "store" and list(ev.block_hashes) == hashes and ev.tier == "host"
    # a payload of another geometry is refused at ingest
    bad = dict(payload, shape=[L, 3, ps, hk, d * 2])
    before = len(b.host_pool.host)
    b._host_import([777], [None], bad)
    assert 777 not in b.host_pool and len(b.host_pool.host) == before
    # an export of blocks the tiers do not hold is empty
    assert (await _export(a, [999]))["n"] == 0
    for eng in (a, b):
        eng.stop()


@pytest.mark.parametrize("pull_s_per_block,pulled", [(1.0, False), (1e-9, True)])
async def test_remote_pull_weighed_against_prefill(params, pull_s_per_block, pulled):
    """Once a pull and the prefill are both measured, a pull whose seconds
    a block exceed a page of the prefill's is not made (the request
    recomputes, counted as a cost skip); a cheaper one is attempted."""
    _, p = params
    a, fillers = _prompts()
    eng = _engine(p, host_kv_blocks=16)
    calls = []

    async def fetch(hint):
        calls.append(hint)
        raise ConnectionError("no peer")

    eng.remote_kv_fetch = fetch
    cold = _engine(p)
    hashes = block_hashes(a, PS)
    hint = {"instance": 7, "path": "dyn/tpu-worker/kv_host_fetch",
            "hashes": hashes, "parents": [None] + hashes[:-1]}
    try:
        # a prefill measures the engine's seconds a token
        await _tokens(eng.generate(_req(fillers[0]), Context()))
        assert eng._prefill_s_per_token is not None and eng._prefill_s_per_token > 0
        eng.kv_onboard_ewma["remote"] = {"s_per_block": pull_s_per_block, "n": 4}
        got = await _tokens(eng.generate(dict(_req(a), kv_remote_host=hint), Context()))
        want = await _tokens(cold.generate(_req(a), Context()))
    finally:
        cold.stop()
        eng.stop()
    assert got == want
    assert len(calls) == int(pulled)
    assert eng.tier_stats["remote_cost_skips"] == int(not pulled)
    assert eng.tier_stats["remote_failures"] == int(pulled)
