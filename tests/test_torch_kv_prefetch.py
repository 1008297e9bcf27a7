"""The prefetch manager and the KV router's hints of the port against the
reference's (dynamo_tpu/kvbm/prefetch.py, router/kv_router.py), on the CPU.

Twin engines, the port's and the JAX package's, over the same tiny f32
params and the same host / disk blocks (numpy from a seed), take the same
hints on injected clocks: promotion from G2 and from G3, pin and hint
TTL expiry, the bandwidth budget, the in-flight cap, blocks no tier
holds, and the synchronous onboard cancelling a promotion in flight
(`note_sync_onboard`). Stats, device residency, pins and the promoted
pages' bytes must agree. A served request claims the promoted pages with
no synchronous onboard. On the same indexer state `remote_host_hint`,
`prefetch_hint` and `maybe_replicate` return what the reference's do.
"""

import asyncio
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.engine import InferenceEngine as JaxEngine
from dynamo_tpu.engine.model_runner import ModelRunner as JaxRunner
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.models.config import get_config as jax_get_config
from dynamo_tpu.router.kv_router import KvRouter as RefKvRouter
from dynamo_tpu.router.protocols import OverlapScores as RefScores
from dynamo_tpu_torch.engine.engine import InferenceEngine
from dynamo_tpu_torch.engine.model_runner import ModelRunner
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.models.config import get_config
from dynamo_tpu_torch.router.kv_router import KvRouter
from dynamo_tpu_torch.router.protocols import OverlapScores
from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.tokens.hashing import block_hashes

PS = 4
GEOMETRY = dict(num_pages=16, page_size=PS, max_pages_per_seq=8,
                decode_buckets=(1, 2), prefill_buckets=(8, 16, 32))


@pytest.fixture(scope="module")
def params():
    return jax.device_get(jllama.init_params(
        jax_get_config("tiny"), jax.random.PRNGKey(3), jnp.float32))


def _engines(params, tmp_path=None, **kw):
    """(port engine, JAX engine), neither started: the test drives the
    inbox."""
    cfg = get_config("tiny")
    port_kw, ref_kw = dict(kw), dict(kw)
    if "disk_kv_blocks" in kw:
        port_kw["disk_kv_root"] = str(tmp_path / "port")
        ref_kw["disk_kv_root"] = str(tmp_path / "ref")
    port = InferenceEngine(
        ModelRunner(cfg, device="cpu", dtype=torch.float32,
                    params=params_from_numpy(params, cfg, "cpu", torch.float32),
                    **GEOMETRY),
        max_batch=2, chunk_size=32, prefetch=True, **port_kw)
    ref = JaxEngine(JaxRunner(jax_get_config("tiny"), params=params,
                              dtype=jnp.float32, **GEOMETRY),
                    max_batch=2, chunk_size=32, prefetch=True, **ref_kw)
    return port, ref


def _clocks(*engines, start=0.0):
    t = [start]
    for eng in engines:
        eng.prefetch._clock = lambda: t[0]
        eng.prefetch._last_refill = start
    return t


def _blocks(engine, hashes, seed=0):
    """Stacked [L, n, PS, Hk, D] random pages for `hashes`, numpy."""
    L, ps, hk, d = engine.runner.kv_page_shape
    rng = np.random.default_rng(seed)
    shape = (L, len(hashes), ps, hk, d)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _put_host(port, ref, hashes, parents, seed=0):
    k, v = _blocks(port, hashes, seed)
    port.host_pool.put(hashes, parents, torch.from_numpy(k), torch.from_numpy(v))
    ref.host_pool.put(hashes, parents, k, v)


def _state(eng, hashes):
    """What a hint left behind: the stats, residency, pins and the
    promoted pages' bytes."""
    st = {k: v for k, v in eng.prefetch.stats.items() if k != "promote_latency_sum_s"}
    pages = {h: eng.pool.by_hash[h] for h in hashes if h in eng.pool.by_hash}
    data = {}
    for h, p in pages.items():
        k = eng.runner.k_pool[:, p]
        data[h] = (np.asarray(k.numpy() if isinstance(k, torch.Tensor) else k).tobytes())
    return st, sorted(pages), sorted(eng.pool.pinned), data, len(eng.prefetch._jobs)


def _hint(eng, hashes, parents):
    eng._inbox.put(("prefetch", {"hashes": hashes, "parents": parents}))
    eng._drain_inbox()


def test_promotion_from_host_and_pins_match_reference(params):
    port, ref = _engines(params, host_kv_blocks=32)
    hashes, parents = [101, 102, 103], [None, 101, 102]
    _put_host(port, ref, hashes, parents)
    for eng in (port, ref):
        _hint(eng, hashes, parents)
    assert _state(port, hashes) == _state(ref, hashes)
    assert port.prefetch.stats["promoted"] == 3
    assert set(port.pool.pinned) == set(hashes)
    # the promoted pages hold the host tier's blocks
    hk, _ = port.host_pool.get(hashes)
    for i, h in enumerate(hashes):
        assert torch.equal(port.runner.k_pool[:, port.pool.by_hash[h]], hk[:, i])
    # hinting warm blocks again is a no-op
    for eng in (port, ref):
        _hint(eng, hashes, parents)
    assert _state(port, hashes) == _state(ref, hashes)
    assert port.prefetch.stats["hinted_blocks"] == 3


def test_pin_and_hint_ttls_match_reference(params):
    port, ref = _engines(params, host_kv_blocks=32, prefetch_pin_ttl_s=5.0,
                         prefetch_hint_ttl_s=10.0)
    t = _clocks(port, ref)
    hashes, parents = [111, 112], [None, 111]
    _put_host(port, ref, hashes, parents)
    for eng in (port, ref):
        _hint(eng, hashes, parents)
    seen = []
    for now in (4.9, 5.1):
        t[0] = now
        for eng in (port, ref):
            eng._drain_inbox()
        seen.append((_state(port, hashes), _state(ref, hashes)))
    assert all(a == b for a, b in seen)
    assert seen[0][0][2] == hashes and seen[1][0][2] == []  # unpinned at 5.1
    assert port.prefetch.stats["cancelled"] == 2
    # hints starved of budget expire at their TTL
    port2, ref2 = _engines(params, host_kv_blocks=32, prefetch_bandwidth_mbps=1.0,
                           prefetch_hint_ttl_s=10.0)
    t = _clocks(port2, ref2)
    for eng in (port2, ref2):
        eng.prefetch._bps = 0.0  # budget-limited with no refill
        eng.prefetch._budget_bytes = 0.0
    hashes, parents = [121, 122, 123], [None, 121, 122]
    _put_host(port2, ref2, hashes, parents)
    for eng in (port2, ref2):
        _hint(eng, hashes, parents)
    for now in (9.9, 10.1):
        t[0] = now
        for eng in (port2, ref2):
            eng._drain_inbox()
        assert _state(port2, hashes) == _state(ref2, hashes)
    assert port2.prefetch.stats["cancelled"] == 3 and not port2.prefetch._jobs


def test_bandwidth_budget_matches_reference(params):
    port, ref = _engines(params, host_kv_blocks=64, prefetch_bandwidth_mbps=0.05,
                         prefetch_hint_ttl_s=1e9)
    t = _clocks(port, ref)
    for eng in (port, ref):
        eng.prefetch._budget_bytes = 1.0
    hashes = list(range(131, 137))
    parents = [None] + hashes[:-1]
    _put_host(port, ref, hashes, parents)
    seen = []
    for now in (None, None, 0.1, 0.3, 100.0, 200.0):
        if now is not None:
            t[0] = now
        for eng in (port, ref):
            if now is None and not seen:
                _hint(eng, hashes, parents)
            else:
                eng._drain_inbox()
        seen.append(port.prefetch.stats["promoted"])
        assert _state(port, hashes) == _state(ref, hashes)
    assert seen[0] == 1 and seen[1] == 1 and seen[-1] == 6
    assert seen != sorted(set(seen))  # the budget held promotions back


def _wait_promoted(eng, n, timeout=10.0):
    deadline = time.monotonic() + timeout
    while eng.prefetch.stats["promoted"] + eng.prefetch.stats["lost"] < n:
        assert time.monotonic() < deadline, eng.prefetch.stats
        eng._drain_inbox()  # read results arrive through the inbox
        time.sleep(0.005)


def test_disk_promotion_and_inflight_cap_match_reference(params, tmp_path):
    port, ref = _engines(params, tmp_path, host_kv_blocks=32, disk_kv_blocks=64,
                         prefetch_max_inflight=2)
    hashes = list(range(141, 147))
    parents = [None] + hashes[:-1]
    k, v = _blocks(port, hashes, seed=4)
    for i, (h, p) in enumerate(zip(hashes, parents)):
        port.host_pool.disk.put_block(h, p, torch.from_numpy(k[:, i].copy()),
                                      torch.from_numpy(v[:, i].copy()))
        ref.host_pool.disk.put_block(h, p, k[:, i].copy(), v[:, i].copy())
    for eng in (port, ref):
        eng.host_pool.disk.flush()
        _hint(eng, hashes, parents)
        _wait_promoted(eng, len(hashes))
    assert _state(port, hashes) == _state(ref, hashes)
    st = port.prefetch.stats
    assert st["promoted"] == 6 and st["reading_peak"] == 2
    assert st["bytes_promoted_g3"] == 6 * 2 * k[:, 0].nbytes
    # a block no tier holds is dropped as lost
    for eng in (port, ref):
        _hint(eng, [9999], [None])
    assert _state(port, [9999]) == _state(ref, [9999])
    assert port.prefetch.stats["lost"] == 1


def test_sync_onboard_cancels_promotion_in_flight(params, tmp_path):
    """Reads stalled in flight: the synchronous onboard marks each job
    late, in both packages."""
    port, ref = _engines(params, tmp_path, host_kv_blocks=32, disk_kv_blocks=64)
    hashes = [151, 152, 153]
    parents = [None, 151, 152]
    k, v = _blocks(port, hashes, seed=5)
    stalled = {}
    for eng, conv in ((port, torch.from_numpy), (ref, np.asarray)):
        disk = eng.host_pool.disk
        for i, (h, p) in enumerate(zip(hashes, parents)):
            disk.put_block(h, p, conv(k[:, i].copy()), conv(v[:, i].copy()))
        disk.flush()
        stalled[id(eng)] = []
        disk.read_block_async = (lambda h, cb, _s=stalled[id(eng)]:
                                 (_s.append(h), True)[1])
        _hint(eng, hashes, parents)
        eng.prefetch.note_sync_onboard(hashes[:2])
    assert _state(port, hashes) == _state(ref, hashes)
    assert port.prefetch.stats["late"] == 2
    assert stalled[id(port)] == stalled[id(ref)] == hashes


async def _generate(engine, prompt, n=4):
    toks = []
    req = {"token_ids": prompt, "sampling": {"temperature": 0.0},
           "stop": {"max_tokens": n, "stop_ids": []}}
    async for item in engine.generate(req, Context()):
        toks.extend(item["token_ids"])
        if item["finish_reason"]:
            break
    return toks


async def test_hint_promotes_and_request_claims_without_sync_onboard(params):
    port, _ = _engines(params, host_kv_blocks=64)
    port.start()
    try:
        prompt = list(range(30, 46))  # 4 pages
        out = await _generate(port, prompt)
        for i in range(6):  # churn until A's pages are in the host tier
            await _generate(port, [100 + 7 * i + j for j in range(16)])
        hashes = block_hashes(prompt, PS)
        assert port.host_pool.match(hashes) >= 3
        assert await port.prefetch_hint_async(
            {"hashes": hashes, "parents": [None] + hashes[:-1]})
        for _ in range(300):
            if all(h in port.pool.by_hash for h in hashes[:3]):
                break
            await asyncio.sleep(0.02)
        assert port.prefetch.stats["promoted"] >= 3
        onboarded = port.host_pool.stats["onboarded"]
        out2 = await _generate(port, prompt)
    finally:
        port.stop()
    assert out2 == out
    assert port.prefetch.stats["hits"] >= 3
    # the host tier was read only by the promotion, not at admission
    assert port.host_pool.stats["onboarded"] == onboarded
    assert port.onboard_stats["onboards"] == 0
    assert not port.pool.pinned


# -- the router's hints, against the reference's ---------------------------

def _fake_router(cls, scores_cls, *, dev, host, obj=None, metadata):
    """A router object with the indexer state given, bound to `cls`'s
    hint methods (as tests/test_kv_prefetch.py builds the reference's)."""
    r = types.SimpleNamespace(
        prefetch_hints=True, _prefetch_bad=set(),
        client=types.SimpleNamespace(
            path="ns/comp/generate",
            instances={iid: types.SimpleNamespace(metadata=md)
                       for iid, md in metadata.items()}),
        indexer=types.SimpleNamespace(
            index=types.SimpleNamespace(find_matches=lambda h: scores_cls(scores=dict(dev))),
            host_index=types.SimpleNamespace(find_matches=lambda h: scores_cls(scores=dict(host))),
            obj_index=types.SimpleNamespace(find_matches=lambda h: scores_cls(scores=dict(obj or {})))),
        prefix_stats={"replications": 0, "hot_trunks": 0},
        _trunk_pop=__import__("collections").OrderedDict(),
        _trunk_replicated={}, replicate_hot_threshold=3,
        replicate_cooldown_s=30.0, _trunk_cap=4096, emitted=[])
    for name in ("_slice_of", "_link_classes", "remote_host_hint", "prefetch_hint",
                 "note_popularity", "maybe_replicate", "_kv_path", "workers"):
        if hasattr(cls, name):
            setattr(r, name, types.MethodType(getattr(cls, name), r))
    r.emit_prefetch = lambda iid, hint: r.emitted.append((iid, hint))
    return r


def _both(**state):
    return (_fake_router(KvRouter, OverlapScores, **state),
            _fake_router(RefKvRouter, RefScores, **state))


HASHES = [11, 12, 13, 14, 15, 16]
SLICED = {0xA: {"kv_prefetch": True, "kv_slice": "s0"},
          0xB: {"kv_prefetch": True, "kv_slice": "s1"},
          0xC: {"kv_prefetch": True, "kv_slice": "s1"},
          0xD: {"kv_prefetch": True}}


@pytest.mark.parametrize("selected,overlap", [((0xA, 0), 0), ((0xA, 0), 2),
                                              ((0xB, 0), 1), ((0xC, 0), 0),
                                              ((0xD, 0), 0), ((0xB, 0), 5)])
@pytest.mark.parametrize("seed", [None, 777])
def test_remote_and_prefetch_hints_match_reference(selected, overlap, seed):
    state = dict(dev={(0xA, 0): 2, (0xB, 0): 1},
                 host={(0xA, 0): 3, (0xB, 0): 5, (0xD, 0): 4},
                 metadata=SLICED)
    port, ref = _both(**state)
    hint = port.remote_host_hint(HASHES, selected, overlap, seed)
    want = ref.remote_host_hint(HASHES, selected, overlap, seed)
    assert hint == want
    pf = port.prefetch_hint(HASHES, selected, overlap, seed, remote=hint)
    assert pf == ref.prefetch_hint(HASHES, selected, overlap, seed, remote=want)
    workers = [(0xA, 0), (0xB, 0), (0xC, 0), (0xD, 0)]
    assert (port._link_classes(workers, state["host"])
            == ref._link_classes(workers, state["host"]))
    # a worker without a prefetch manager, or marked bad, gets no hint
    for r in (port, ref):
        r._prefetch_bad.add(selected[0])
    assert port.prefetch_hint(HASHES, selected, overlap, seed) is None
    assert ref.prefetch_hint(HASHES, selected, overlap, seed) is None


def test_hot_trunk_replication_matches_reference():
    port, ref = _both(dev={(0xA, 0): 2}, host={(0xA, 0): 4}, metadata=SLICED)
    port.workers = ref.workers = lambda: [(0xA, 0), (0xB, 0), (0xC, 0), (0xD, 0)]
    for _ in range(5):
        port.maybe_replicate(HASHES, None)
        ref.maybe_replicate(HASHES, None)
    assert port.emitted == ref.emitted and len(port.emitted) == 1
    assert port.prefix_stats == ref.prefix_stats == {"replications": 1, "hot_trunks": 1}
    assert port.emitted[0][0] == 0xB  # the first worker on a cold slice
    assert port.emitted[0][1]["remote"]["link"] == "dcn"
    # a trunk no G2 holds is never replicated
    port2, ref2 = _both(dev={}, host={}, metadata=SLICED)
    for _ in range(5):
        port2.maybe_replicate(HASHES, None)
        ref2.maybe_replicate(HASHES, None)
    assert port2.emitted == ref2.emitted == []


def test_bound_tier_costs_are_snapshotted_once_a_second(monkeypatch):
    """bind_tier_costs late-binds the measured-cost source; the router
    reads it at most once a second, and a failing source prices nothing,
    as the reference's."""
    r = types.SimpleNamespace(tier_cost_fn=None, _tier_costs_cache={},
                              _tier_costs_at=0.0)
    for name in ("bind_tier_costs", "_tier_costs"):
        setattr(r, name, types.MethodType(getattr(KvRouter, name), r))
    assert r._tier_costs() == {}
    calls = []
    r.bind_tier_costs(lambda: calls.append(1) or {(1, 0): {"host": 1e-4}})
    now = [100.0]
    monkeypatch.setattr("dynamo_tpu_torch.router.kv_router.time.monotonic", lambda: now[0])
    assert r._tier_costs() == {(1, 0): {"host": 1e-4}}
    now[0] += 0.5
    r._tier_costs()
    assert len(calls) == 1
    now[0] += 1.0
    r.bind_tier_costs(lambda: 1 / 0)
    assert r._tier_costs() == {}
