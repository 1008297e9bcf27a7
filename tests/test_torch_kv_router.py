"""The port's KV router (dynamo_tpu_torch.router: radix_tree, the C++
block index of native/block_index.py, sequences, scheduling, queue,
indexer, kv_router) against the reference's own modules, on the CPU:

- `BlockIndex` in Python and in C++ against the reference's `BlockIndex`
  on seeded random store and remove events and worker removals over 4
  workers: equal `find_matches` scores and block counts after every step
  (exact); the Python index's TTL expiry on a shared fake clock;
- the C++ library is built by g++ from the port's source into
  build/dynamo_tpu_torch/ under a hash of the source, and a failed build
  raises;
- `WorkerSelector.select` against the reference's on seeded workers,
  overlaps, host overlaps and active sequences: the same (worker,
  overlap) at temperature 0 and the same draws at temperature 0.5 under
  one seed (exact);
- the admission queue's reference cases, run against both modules;
- `KvIndexer` in front of a served port worker (TCP event plane): the
  index equals the worker's pool, and a gap in event ids triggers a
  resync over the worker's `kv_state` after which it equals the pool
  again.
"""

import asyncio
import random
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.models import llama as jllama
from dynamo_tpu.models.config import get_config as jax_get_config
from dynamo_tpu.router import queue as ref_queue
from dynamo_tpu.router import radix_tree as ref_radix
from dynamo_tpu.router import scheduling as ref_sched
from dynamo_tpu.router import sequences as ref_seqs
from dynamo_tpu.router.protocols import OverlapScores as RefOverlapScores
from dynamo_tpu.router.protocols import RouterEvent as RefRouterEvent
from dynamo_tpu.runtime.request_plane import RequestPlaneError as RefRequestPlaneError
from dynamo_tpu_torch.engine.engine import InferenceEngine
from dynamo_tpu_torch.engine.model_runner import ModelRunner
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.frontend.protocols import ModelCard
from dynamo_tpu_torch.models.config import get_config
from dynamo_tpu_torch.native import block_index as native
from dynamo_tpu_torch.router import queue as port_queue
from dynamo_tpu_torch.router import radix_tree as port_radix
from dynamo_tpu_torch.router.kv_router import KvRouter
from dynamo_tpu_torch.router.protocols import OverlapScores, RouterEvent
from dynamo_tpu_torch.router.scheduling import KvRouterConfig, WorkerSelector
from dynamo_tpu_torch.router.sequences import ActiveSequences
from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.runtime.discovery import MemDiscovery
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.request_plane import RequestPlaneError
from dynamo_tpu_torch.tokens.hashing import block_hashes
from dynamo_tpu_torch.worker_common import serve_worker

WORKERS = [(11, 0), (22, 0), (33, 0), (44, 1)]
T = 60  # bound on every awaited scenario, seconds


# -- the block index -----------------------------------------------------------


def _random_events(seed: int, n: int = 120):
    """Seeded store / remove / worker-removal steps over WORKERS on a few
    prompt families that share prefixes (chains of 2-12 blocks)."""
    rng = random.Random(seed)
    trunks = [[rng.randrange(1, 60) for _ in range(48)] for _ in range(3)]
    held = {w: [] for w in WORKERS}  # chains a worker stored
    steps, eid = [], {w: 0 for w in WORKERS}
    for _ in range(n):
        w = rng.choice(WORKERS)
        r = rng.random()
        if r < 0.6 or not held[w]:
            trunk = rng.choice(trunks)
            cut = rng.randrange(1, 48)
            tokens = trunk[:cut] + [rng.randrange(1, 60) for _ in range(rng.randrange(0, 20))]
            hs = block_hashes(tokens, 4)
            if not hs:
                continue
            # a store may extend a held chain from its middle
            start = rng.randrange(0, len(hs))
            parent = hs[start - 1] if start else None
            eid[w] += 1
            steps.append(("event", w, eid[w], "store", hs[start:], parent))
            held[w].append(hs)
        elif r < 0.93:
            hs = rng.choice(held[w])
            k = rng.randrange(1, len(hs) + 1)
            victims = rng.sample(hs, k)
            eid[w] += 1
            steps.append(("event", w, eid[w], "remove", victims, None))
        else:
            steps.append(("remove_worker", w))
            held[w] = []
    probes = [block_hashes(t[:c], 4) for t in trunks for c in (4, 17, 33, 48)]
    return steps, probes


def _apply(index, step, event_cls):
    if step[0] == "remove_worker":
        index.remove_worker(step[1])
    else:
        _, w, eid, kind, hs, parent = step
        index.apply_event(event_cls(worker=w, event_id=eid, kind=kind,
                                    block_hashes=list(hs), parent_hash=parent))


@pytest.mark.parametrize("impl", ["python", "cpp"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_block_index_equals_reference(impl, seed):
    """After every step, every probe scores the same per worker, and each
    worker holds the same number of blocks (exact)."""
    steps, probes = _random_events(seed)
    port = port_radix.BlockIndex() if impl == "python" else native.CppBlockIndex()
    ref = ref_radix.BlockIndex()
    for i, step in enumerate(steps):
        _apply(port, step, RouterEvent)
        _apply(ref, step, RefRouterEvent)
        for hs in probes:
            assert port.find_matches(hs).scores == ref.find_matches(hs).scores, (i, step)
        assert [port.worker_block_count(w) for w in WORKERS] == \
            [ref.worker_block_count(w) for w in WORKERS], (i, step)
        if impl == "python":
            assert len(port) == len(ref)


@pytest.mark.parametrize("seed", [0, 1])
def test_python_index_ttl_expiry_equals_reference(seed, monkeypatch):
    """Approximate mode: stores with TTLs on a shared fake clock; scores
    and `expire` counts equal the reference's as the clock passes each
    deadline."""
    clock = [1000.0]
    monkeypatch.setattr(time, "monotonic", lambda: clock[0])
    steps, probes = _random_events(seed, n=60)
    rng = random.Random(seed)
    port, ref = port_radix.BlockIndex(), ref_radix.BlockIndex()
    for step in steps:
        clock[0] += rng.random()
        if step[0] == "remove_worker":
            port.remove_worker(step[1])
            ref.remove_worker(step[1])
            continue
        ttl = rng.choice([2.0, 5.0, 20.0])
        _, w, eid, kind, hs, parent = step
        port.apply_event(RouterEvent(w, eid, kind, list(hs), parent), ttl=ttl)
        ref.apply_event(RefRouterEvent(w, eid, kind, list(hs), parent), ttl=ttl)
        for hs in probes:
            assert port.find_matches(hs).scores == ref.find_matches(hs).scores
    for dt in (1.0, 3.0, 10.0, 30.0):
        now = clock[0] + dt
        for hs in probes:
            assert port.find_matches(hs, now=now).scores == ref.find_matches(hs, now=now).scores
        assert port.expire(now) == ref.expire(now)
        assert len(port) == len(ref)
    assert len(port) == 0


def test_cpp_index_builds_into_build_dir_by_hash():
    path = native.library_path()
    native.load()
    assert path.exists() and path.parent == native.BUILD_DIR
    assert path.parts[-3:-1] == ("build", "dynamo_tpu_torch")
    assert native.SOURCE.parent.name == "native" and native.SOURCE.suffix == ".cpp"


def test_cpp_index_failed_build_raises(tmp_path, monkeypatch):
    broken = tmp_path / "block_index.cpp"
    broken.write_text(native.SOURCE.read_text() + "\nthis is not C++;\n")
    monkeypatch.setattr(native, "SOURCE", broken)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.CppBlockIndex()
    assert not list((tmp_path / "build").glob("*.so"))
    monkeypatch.setattr(native.subprocess, "run",
                        lambda *a, **k: (_ for _ in ()).throw(FileNotFoundError()))
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.make_block_index()
    assert isinstance(native.make_block_index(ttl_mode=True), port_radix.BlockIndex)


# -- selection ------------------------------------------------------------------


def _selector_case(seed: int):
    """Seeded workers, device and host overlaps, and active sequences
    (added, some prefilled, some freed), built the same way in both
    packages."""
    rng = random.Random(seed)
    workers = sorted(rng.sample([(i, r) for i in range(1, 9) for r in range(2)],
                                rng.randrange(2, 7)))
    total = rng.randrange(1, 40)
    dev = {w: rng.randrange(0, total + 1) for w in workers if rng.random() < 0.6}
    host = {w: rng.randrange(0, total + 1) for w in workers if rng.random() < 0.4}
    seq_ops = []
    for i in range(rng.randrange(0, 25)):
        w = rng.choice(workers)
        seq_ops.append(("add", f"r{i}", w, rng.randrange(1, 50), rng.randrange(0, 10)))
        if rng.random() < 0.5:
            seq_ops.append(("prefilled", f"r{i}"))
        if rng.random() < 0.3:
            seq_ops.append(("free", f"r{i}"))
    return workers, total, dev, host, seq_ops


def _sequences(cls, ops):
    s = cls()
    for op in ops:
        if op[0] == "add":
            s.add_request(op[1], op[2], op[3], op[4])
        elif op[0] == "prefilled":
            s.mark_prefill_completed(op[1])
        else:
            s.free(op[1])
    return s


@pytest.mark.parametrize("temperature", [0.0, 0.5])
@pytest.mark.parametrize("seed", range(4))
def test_selector_equals_reference(seed, temperature):
    workers, total, dev, host, ops = _selector_case(seed)
    port = WorkerSelector(KvRouterConfig(temperature=temperature, seed=seed,
                                         overlap_weight=1.0 + 0.25 * seed))
    ref = ref_sched.WorkerSelector(ref_sched.KvRouterConfig(
        temperature=temperature, seed=seed, overlap_weight=1.0 + 0.25 * seed))
    seqs, ref_seqs_ = _sequences(ActiveSequences, ops), _sequences(ref_seqs.ActiveSequences, ops)
    for w in workers:
        assert seqs.prefill_blocks(w) == ref_seqs_.prefill_blocks(w)
        assert seqs.decode_blocks(w) == ref_seqs_.decode_blocks(w)
    for _ in range(20):  # at temperature 0.5, 20 draws of one RNG stream
        got = port.select(workers, total, OverlapScores(dev, total), seqs,
                          host_overlaps=host)
        want = ref.select(workers, total, RefOverlapScores(dev, total), ref_seqs_,
                          host_overlaps=host)
        assert got == want
    with pytest.raises(RuntimeError, match="no workers"):
        port.select([], total, OverlapScores(), seqs)


# -- the admission queue: the reference's cases, against both modules ---------


def _queue(mod, busy=1, depth=8, wait=5.0):
    load = {(1, 0): 5}  # saturated
    q = mod.AdmissionQueue(mod.AdmissionConfig(busy_blocks=busy, max_depth=depth,
                                               max_wait_s=wait),
                           load_fn=lambda w: load.get(w, 0),
                           workers_fn=lambda: [(1, 0)])
    return q, load


QUEUES = {"port": (port_queue, RequestPlaneError), "ref": (ref_queue, RefRequestPlaneError)}


@pytest.mark.parametrize("which", ["port", "ref"])
async def test_admission_queue_priority_order_fifo(which):
    mod, _ = QUEUES[which]
    q, _ = _queue(mod)
    order = []

    async def waiter(tag, pri):
        await q.acquire(pri)
        order.append(tag)

    tasks = [asyncio.create_task(waiter(t, p)) for t, p in
             (("batch-1", 2), ("interactive", 0), ("batch-2", 2), ("default", None))]
    await asyncio.sleep(0.05)
    assert q.depth == 4
    for _ in range(4):
        q.notify(1)
        await asyncio.sleep(0.01)
    await asyncio.wait_for(asyncio.gather(*tasks), 5)
    assert order == ["interactive", "default", "batch-1", "batch-2"]


@pytest.mark.parametrize("which", ["port", "ref"])
async def test_admission_queue_rejections(which):
    """Depth overflow → queue_full; a wait past max_wait_s → queue_timeout
    (its tombstone absorbs no later release); fail_all → no_instances."""
    mod, err = QUEUES[which]
    q, load = _queue(mod, depth=2, wait=0.2)
    t1, t2 = asyncio.create_task(q.acquire()), asyncio.create_task(q.acquire())
    await asyncio.sleep(0.02)
    with pytest.raises(err) as ei:
        await q.acquire()
    assert ei.value.code == "queue_full"
    q.notify(2)
    await asyncio.wait_for(asyncio.gather(t1, t2), 5)
    with pytest.raises(err) as ei:
        await q.acquire()
    assert ei.value.code == "queue_timeout"
    t = asyncio.create_task(q.acquire())
    await asyncio.sleep(0.02)
    q.notify(1)
    await asyncio.wait_for(t, 5)
    t = asyncio.create_task(q.acquire())
    await asyncio.sleep(0.02)
    q.fail_all("workers gone")
    with pytest.raises(err) as ei:
        await t
    assert ei.value.code == "no_instances"
    load[(1, 0)] = 0  # headroom: admitted at once
    await asyncio.wait_for(q.acquire(), 1)


# -- the indexer in front of a served port worker --------------------------------

PS = 4
GEOMETRY = dict(num_pages=64, page_size=PS, max_pages_per_seq=16,
                decode_buckets=(1, 2, 4, 8), prefill_buckets=(8, 16, 32))


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


async def _until(cond, what):
    async def poll():
        while not cond():
            await asyncio.sleep(0.01)
    try:
        await asyncio.wait_for(poll(), T)
    except asyncio.TimeoutError:
        raise AssertionError(f"timed out waiting for {what}") from None


def _held(index, worker, pool):
    """The pool's registered blocks the index credits to `worker`."""
    return {h for h in pool.by_hash if index.find_matches([h]).scores.get(worker)}


async def test_indexer_follows_worker_and_resyncs_after_gap(jparams):
    """A KvRouter over a served port worker: seeded from kv_state, then
    fed by KV events over TCP; after a gap in the event ids (the
    publisher's counter bumped, as lost frames leave it) the resync over
    kv_state leaves the index equal to the worker's pool."""
    async def run():
        realm = "kvidx"
        w_rt = DistributedRuntime(discovery=MemDiscovery(realm=realm))
        f_rt = DistributedRuntime(discovery=MemDiscovery(realm=realm))
        eng = _engine(jparams)
        w = await serve_worker(w_rt, eng, ModelCard(name="tiny", context_length=64,
                                                    kv_block_size=PS))
        worker = (w.instance.instance_id, 0)
        rng = np.random.default_rng(5)
        prompts = [rng.integers(1, 500, size=n).tolist() for n in (21, 30, 13)]
        client = f_rt.client("dyn/tpu-worker/generate")
        await client.start()
        router = KvRouter(f_rt, client, block_size=PS)
        resyncs = []
        orig = router.indexer.resync_worker

        async def counting(wk):
            resyncs.append(wk)
            await orig(wk)

        router.indexer.resync_worker = counting
        try:
            # a request before the router starts: seen only through the seed
            req = {"token_ids": prompts[0], "sampling": {"temperature": 0.0},
                   "stop": {"max_tokens": 3}}
            await client.wait_ready(timeout=T)
            [_ async for _ in client.generate(req, Context())]
            await router.start()
            idx = router.indexer.index
            await _until(lambda: _held(idx, worker, eng.pool) == set(eng.pool.by_hash),
                         "the seed")
            seeded = len(resyncs)
            req1 = dict(req, token_ids=prompts[1])
            [_ async for _ in client.generate(req1, Context())]
            await _until(lambda: _held(idx, worker, eng.pool) == set(eng.pool.by_hash)
                         and idx.worker_block_count(worker) == len(eng.pool.by_hash),
                         "the events")
            assert len(resyncs) == seeded  # events alone, no resync
            w.publisher._event_id += 5  # frames lost on the way
            req2 = dict(req, token_ids=prompts[2])
            [_ async for _ in client.generate(req2, Context())]
            await _until(lambda: len(resyncs) > seeded, "the resync")
            await _until(lambda: not router.indexer._resyncing, "the resync's end")
            await asyncio.sleep(0.1)
            final = (_held(idx, worker, eng.pool), set(eng.pool.by_hash),
                     idx.worker_block_count(worker))
            best = router.find_best_match(prompts[1])
        finally:
            await router.stop()
            await client.close()
            await f_rt.shutdown(drain_timeout=1)
            await w_rt.shutdown(drain_timeout=1)
            await w.stop()
        return final, best, prompts, worker, seeded

    (held, pool, count), best, prompts, worker, seeded = await asyncio.wait_for(run(), T)
    assert seeded >= 1
    assert held == pool and count == len(pool)
    assert best[0] == worker and best[1] == len(prompts[1]) // PS
