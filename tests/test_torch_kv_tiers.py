"""The lower KV tiers of the port against the reference's
(dynamo_tpu/kvbm/host_pool.py, disk_pool.py, object_store.py), on the CPU.

The pools of both packages are driven by the same operations on the same
blocks (numpy from a seed): puts that overflow G2 into G3 and G3 into G4,
reads that touch the LRU, async promotion reads, a byte budget, a
quantized tier; residency, matches, stats, eviction events, G4 store
events and every block's bytes must agree. A G3 directory and a G4 root
written by either package are adopted and read by the other. On the tiny
f32 config the greedy streams of the port's engine with G2+G3, G2+G4 and
the quantized tier equal the JAX engine's with the same tiers, the
onboard is labelled by the deepest tier, and the onboarded pages equal
the tiers' blocks.
"""

import dataclasses
import os
import time
import types

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.engine import InferenceEngine as JaxEngine
from dynamo_tpu.engine.model_runner import ModelRunner as JaxRunner
from dynamo_tpu.kvbm import disk_pool as rdisk
from dynamo_tpu.kvbm import host_pool as rhost
from dynamo_tpu.kvbm import object_store as robj
from dynamo_tpu.kvbm import quant as rq
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.models.config import get_config as jax_get_config
from dynamo_tpu.runtime.context import Context as JaxContext
from dynamo_tpu_torch.engine.engine import InferenceEngine
from dynamo_tpu_torch.engine.model_runner import ModelRunner
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.kvbm import disk_pool as tdisk
from dynamo_tpu_torch.kvbm import host_pool as thost
from dynamo_tpu_torch.kvbm import object_store as tobj
from dynamo_tpu_torch.kvbm import quant as tq
from dynamo_tpu_torch.models.config import get_config
from dynamo_tpu_torch.runtime.context import Context

BF16 = np.dtype(ml_dtypes.bfloat16)
SHAPE = (2, 4, 2, 8)  # one block: [L, PS, Hk, D]

REF = types.SimpleNamespace(host=rhost, disk=rdisk, obj=robj, quant=rq)
PORT = types.SimpleNamespace(host=thost, disk=tdisk, obj=tobj, quant=tq)


def _np_block(seed, dtype):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(SHAPE) * 10.0 ** rng.uniform(-2, 2, SHAPE[:-1] + (1,)))
    return x.astype(np.float32).astype(dtype)


def _as(pkg, x):
    """A numpy block as the package stores it."""
    if pkg is REF:
        return x
    if x.dtype == BF16:
        return torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(x.copy())


def _bytes(x):
    """A block's bytes (dense or quantized) for comparison."""
    if x is None:
        return None
    if isinstance(x, dict):
        return (_bytes(x["q"]), _bytes(x["s"]), x["dt"])
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(x).tobytes()


def _flush(tiered):
    for t in (tiered.disk, tiered.obj):
        if t is not None:
            t.flush()


def _drive(pkg, root, dtype, quantize):
    """One sequence of tier operations; returns what it observed."""
    block_bytes = int(np.prod(SHAPE)) * np.dtype(dtype).itemsize * 2
    host = pkg.host.HostKvPool(capacity_blocks=3, quantize=quantize,
                               capacity_bytes=int(2.5 * block_bytes))
    disk = pkg.disk.DiskKvPool(os.path.join(root, "g3"), capacity_blocks=3,
                               quantize=quantize)
    obj = pkg.obj.ObjectKvPool(pkg.obj.FsBackend(os.path.join(root, "g4")),
                               capacity_blocks=5, quantize=quantize)
    stored = []
    obj.store_listener = lambda h, p: stored.append((h, p))
    tiered = pkg.disk.TieredKv(host, disk, obj)
    events = []
    tiered.on_evict(lambda hs: events.append(list(hs)))
    hashes = [1000 + i for i in range(12)]
    data = {h: (_np_block(h, dtype), _np_block(h + 7, dtype)) for h in hashes}
    obs = []

    def snap(tag):
        _flush(tiered)
        obs.append((tag, tiered.residency(hashes), tiered.match(hashes),
                    tiered.match(hashes[4:]), sorted(tiered.stats.items()),
                    [list(e) for e in events], list(stored)))

    for i, h in enumerate(hashes[:9]):
        k, v = data[h]
        tiered.put([h], [hashes[i - 1] if i else None],
                   _as(pkg, k[None].swapaxes(0, 1)), _as(pkg, v[None].swapaxes(0, 1)))
        snap(f"put{i}")
    # reads from each tier touch its LRU
    for h in (hashes[0], hashes[5], hashes[8]):
        if h in tiered:
            k, v = tiered.get([h])
            obs.append(("get", h, _bytes(k), _bytes(v)))
    snap("gets")
    # raw reads: G3 and G4 keep what they were given (quantized or dense)
    for h in hashes[:9]:
        for t in (disk, obj):
            if h in t:
                k, v = t.get_block(h)
                obs.append(("raw", h, _bytes(k), _bytes(v)))
    # async promotion reads on the writer threads
    got = []
    for t in (disk, obj):
        for h in hashes[:9]:
            if h in t:
                t.pin(h)
                t.read_block_async(h, lambda h_, p, k, v, found: got.append(
                    (h_, p, found, _bytes(k), _bytes(v))))
                t.unpin(h)
    assert not disk.read_block_async(99, None) and not obj.read_block_async(99, None)
    _flush(tiered)
    for _ in range(500):
        if len(got) == sum(1 for t in (disk, obj) for h in hashes[:9] if h in t):
            break
        time.sleep(0.01)
    obs.append(("async", sorted(got)))
    for i, h in enumerate(hashes[9:]):
        k, v = data[h]
        tiered.host.put_block(h, hashes[8 + i], _as(pkg, k), _as(pkg, v))
        snap(f"put_block{i}")
    # a host-tier pin holds a block past the capacity
    host.pin(hashes[9])
    tiered.put([hashes[0]], [None], _as(pkg, data[hashes[0]][0][:, None]),
               _as(pkg, data[hashes[0]][1][:, None]))
    snap("pinned")
    host.unpin(hashes[9])
    obs.append(("lookup", host.lookup_chain(hashes)))
    tiered.clear()
    snap("clear")
    return obs


@pytest.mark.parametrize("dtype,quantize", [("float32", False), ("bfloat16", False),
                                            ("bfloat16", True)])
def test_tier_pools_match_reference(tmp_path, dtype, quantize):
    np_dtype = BF16 if dtype == "bfloat16" else np.float32
    ref = _drive(REF, str(tmp_path / "ref"), np_dtype, quantize)
    got = _drive(PORT, str(tmp_path / "port"), np_dtype, quantize)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g == r, (g[0], r[0])
    # something reached every tier
    assert any("disk" in o[1] for o in ref if o[0].startswith("put"))
    assert any("obj" in o[1] for o in ref if o[0].startswith("put"))


def _write_dir(pkg, root, dtype, quantize):
    disk = pkg.disk.DiskKvPool(os.path.join(root, "g3"), capacity_blocks=8,
                               quantize=quantize)
    obj = pkg.obj.ObjectKvPool(pkg.obj.FsBackend(os.path.join(root, "g4")),
                               quantize=quantize)
    blocks = {}
    for i in range(4):
        h = 2 ** 63 + 17 * i if i % 2 else 31 * i + 5  # unsigned file names too
        k, v = _np_block(i, dtype), _np_block(i + 50, dtype)
        blocks[h] = (i or None, k, v)
        disk.put_block(h, i or None, _as(pkg, k), _as(pkg, v))
        obj.put_block(h, i or None, _as(pkg, k), _as(pkg, v))
    disk.flush()
    obj.flush()
    return blocks


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("writer,reader", [(REF, PORT), (PORT, REF)])
def test_directories_cross_between_packages(tmp_path, writer, reader, quantize):
    root = str(tmp_path)
    blocks = _write_dir(writer, root, BF16, quantize)
    files = sorted(os.listdir(os.path.join(root, "g3")))
    assert files == sorted(os.listdir(os.path.join(root, "g4")))
    disk = reader.disk.DiskKvPool(os.path.join(root, "g3"), capacity_blocks=8)
    obj = reader.obj.ObjectKvPool(reader.obj.FsBackend(os.path.join(root, "g4")))
    assert len(disk) == len(obj) == len(blocks)
    assert disk.stats["quant_blocks"] == (len(blocks) if quantize else 0)
    for h, (parent, k, v) in blocks.items():
        assert h in disk and h in obj
        assert disk._blocks[h] == parent  # adopted with its parent
        for pool in (disk, obj):
            gk, gv = pool.get_block(h)
            want_k = rq.quantize_block(k) if quantize else k
            want_v = rq.quantize_block(v) if quantize else v
            assert _bytes(gk) == _bytes(want_k) and _bytes(gv) == _bytes(want_v)
        # the dense view of a quantized block is the reference's dequantization
        dk, _ = disk.get([h])
        want = rq.dequantize_block(rq.quantize_block(k)) if quantize else k
        assert _bytes(dk[:, 0]) == _bytes(want)
    # a file of another layout is dropped at rescan, by both packages
    name = files[0]
    path = os.path.join(root, "g3", name)
    data = open(path, "rb").read()
    hlen = int.from_bytes(data[:8], "little")
    with open(path, "wb") as f:
        f.write(data[:8] + data[8:8 + hlen].replace(b'"layout": 2', b'"layout": 1')
                + data[8 + hlen:])
    again = reader.disk.DiskKvPool(os.path.join(root, "g3"), capacity_blocks=8)
    assert len(again) == len(blocks) - 1 and not os.path.exists(path)


def test_corrupt_block_is_a_miss_and_quarantined(tmp_path):
    """A truncated G3 file reads as no data (the onboard recomputes) and
    leaves the index, as in the reference."""
    disk = tdisk.DiskKvPool(str(tmp_path), capacity_blocks=4, quantize=True)
    k = _as(PORT, _np_block(1, BF16))
    disk.put_block(5, None, k, k)
    disk.flush()
    path = disk._path(5)
    data = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(data[:-4])
    assert disk.get_block(5) == (None, None)
    assert 5 not in disk and not os.path.exists(path)
    assert disk.stats["stored_bytes"] == 0 and disk.stats["quant_blocks"] == 0


# -- the engine over the tiers, against the JAX engine ----------------------

PS = 4
GEOMETRY = dict(num_pages=24, page_size=PS, max_pages_per_seq=16,
                decode_buckets=(1, 2, 4, 8), prefill_buckets=(8, 16, 32))


def _req(prompt, max_tokens=6):
    return {"token_ids": list(prompt), "sampling": {"temperature": 0.0},
            "stop": {"max_tokens": max_tokens, "stop_ids": []}}


async def _collect(engine, req, ctx_cls=Context):
    toks, finish, phases = [], None, {}
    async for item in engine.generate(req, ctx_cls()):
        toks.extend(item["token_ids"])
        if item.get("finish_reason"):
            finish = item["finish_reason"]
            phases = item.get("phases") or {}
    return toks, finish, phases


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


async def _serve_sequence(engine, ctx_cls=Context):
    a, fillers, a2 = _tier_requests()
    for p in [a] + fillers:
        await _collect(engine, _req(p), ctx_cls)
    lower = [t for t in (engine.host_pool.disk, engine.host_pool.obj) if t is not None]
    for t in lower:
        t.flush()
    before = engine.scheduler.reused_prefix_tokens
    out = await _collect(engine, _req(a2), ctx_cls)
    return out, engine.scheduler.reused_prefix_tokens - before


# case: (the deepest tier, quantized tier, int8 pools)
TIER_ENGINE_CASES = {
    "g3": ("disk", False, False), "g4": ("obj", False, False),
    "g3_quant": ("disk", True, False), "g4_quant": ("obj", True, False),
    # the whole chain in G2: the codec's codes and scales cross to the
    # device, dequantized there into dense pools, stored as they are in
    # int8 pools
    "g2_quant": ("host", True, False), "g2_quant_int8": ("host", True, True),
}


@pytest.mark.parametrize("case", sorted(TIER_ENGINE_CASES))
async def test_engine_tiers_match_cold_and_jax(tmp_path, tier_params, case):
    jcfg, params = tier_params
    cfg = dataclasses.replace(get_config("tiny"), n_layers=3)
    deepest, quant, int8 = TIER_ENGINE_CASES[case]
    kvq = "int8" if int8 else None
    tiers = dict(host_kv_blocks=64 if deepest == "host" else 3,
                 kv_tier_quantize=quant, onboard_layer_groups=3)
    if deepest == "disk":
        tiers.update(disk_kv_blocks=64)

    def roots(tag):
        kw = dict(tiers)
        if deepest == "disk":
            kw["disk_kv_root"] = str(tmp_path / tag / "g3")
        elif deepest == "obj":
            kw["obj_kv_root"] = str(tmp_path / tag / "g4")
        return kw

    def port_engine(**kw):
        runner = ModelRunner(cfg, device="cpu", dtype=torch.float32,
                             params=params_from_numpy(params, cfg, "cpu", torch.float32),
                             kv_quantize=kvq, **GEOMETRY)
        return InferenceEngine(runner, max_batch=4, chunk_size=16, **kw)

    cold = port_engine()
    tiered = port_engine(**roots("port"))
    jeng = JaxEngine(JaxRunner(jcfg, params=params, dtype=jnp.float32,
                               kv_quantize=kvq, **GEOMETRY),
                     max_batch=4, chunk_size=16, **roots("jax"))
    try:
        want = (await _collect(cold, _req(_tier_requests()[2])))[:2]
        (toks, finish, phases), reused = await _serve_sequence(tiered)
        (jtoks, jfinish, _), jreused = await _serve_sequence(jeng, JaxContext)
    finally:
        cold.stop()
        tiered.stop()
        jeng.stop()
    if not quant:
        assert (toks, finish) == want
    # the JAX engine with the same tiers gives the same stream either way
    assert (toks, finish) == (jtoks, jfinish)
    assert reused == jreused == 32
    st = tiered.onboard_stats
    assert st["onboards"] == 1 and st["blocks"] == 8
    assert tiered.tier_stats["onboard_misses"] == 0
    ew = tiered.kv_onboard_ewma
    assert set(ew) == {deepest} and ew[deepest]["n"] == 8
    assert phases["kv_onboard_s"] > 0
    from dynamo_tpu_torch.tokens.hashing import block_hashes

    hashes = block_hashes(_tier_requests()[2], PS)[:8]
    pages = [tiered.pool.by_hash[h] for h in hashes]
    assert tiered.host_pool.residency(hashes).count(deepest) >= 5
    if int8:
        # the pool holds the tier's codes and scales as they are
        for pool, j in ((tiered.runner.k_pool, 0), (tiered.runner.v_pool, 1)):
            raw = [tiered.host_pool.host.get_block_raw(h)[j] for h in hashes]
            assert torch.equal(pool["q"][:, pages], torch.stack([b["q"] for b in raw], 1))
            assert torch.equal(pool["s"][:, pages], torch.stack([b["s"] for b in raw], 1))
        return
    # the onboarded pages hold the tiers' blocks (dequantized by the codec
    # when the tier quantizes)
    hk, hv = tiered.host_pool.get(hashes)
    assert torch.equal(tiered.runner.k_pool[:, pages], hk)
    assert torch.equal(tiered.runner.v_pool[:, pages], hv)
    if quant:
        tp = tiered.host_pool
        lower = {"host": tp.host.get_block_raw, "disk": getattr(tp.disk, "get_block", None),
                 "obj": getattr(tp.obj, "get_block", None)}[deepest]
        raw = [lower(h) for h in hashes if deepest == "host" or h not in tiered.host_pool.host]
        assert raw and all(tq.is_quantized_block(k) for k, _ in raw)


async def test_onboard_tier_label(tmp_path, tier_params):
    """The sequence's onboard_tier names the deepest tier its chain read."""
    _, params = tier_params
    cfg = dataclasses.replace(get_config("tiny"), n_layers=3)
    runner = ModelRunner(cfg, device="cpu", dtype=torch.float32,
                         params=params_from_numpy(params, cfg, "cpu", torch.float32),
                         **GEOMETRY)
    eng = InferenceEngine(runner, max_batch=4, chunk_size=16, host_kv_blocks=3,
                          disk_kv_blocks=64, disk_kv_root=str(tmp_path / "g3"))
    seen = []
    orig = eng._onboard_from_host

    def spy(pages, hashes, seq=None):
        ok = orig(pages, hashes, seq)
        seen.append(seq.onboard_tier)
        return ok

    eng.scheduler.host_onboard = spy
    try:
        await _serve_sequence(eng)
    finally:
        eng.stop()
    assert seen == ["G3"]


def test_tier_warning_without_host(caplog, tier_params):
    _, params = tier_params
    cfg = dataclasses.replace(get_config("tiny"), n_layers=3)
    runner = ModelRunner(cfg, device="cpu", dtype=torch.float32,
                         params=params_from_numpy(params, cfg, "cpu", torch.float32),
                         **GEOMETRY)
    with caplog.at_level("WARNING"):
        eng = InferenceEngine(runner, disk_kv_blocks=8, prefetch=True)
    assert eng.host_pool is None and eng.prefetch is None
    assert "also set host_kv_blocks" in caplog.text
    assert "prefetch requested without a host KV tier" in caplog.text


def test_worker_flags_build_the_tiers(tmp_path):
    """The worker's nine tier flags reach the engine as the reference's
    build_engine passes them."""
    from dynamo_tpu_torch.worker import build_engine, parse_args

    args = parse_args([
        "--model", "tiny", "--device", "cpu", "--num-pages", "16",
        "--host-kv-blocks", "8", "--disk-kv-blocks", "5",
        "--disk-kv-root", str(tmp_path / "g3"), "--obj-kv-root", str(tmp_path / "g4"),
        "--kv-tier-quantize", "--prefetch", "--prefetch-max-inflight", "2",
        "--prefetch-bandwidth-mbps", "3.5", "--prefetch-hint-ttl-s", "7",
        "--prefetch-pin-ttl-s", "2"])
    eng = build_engine(args)
    try:
        tiers = eng.host_pool
        assert tiers.host.capacity == 8 and tiers.host.quantize
        assert tiers.disk.capacity == 5 and tiers.disk.root == str(tmp_path / "g3")
        assert tiers.disk.quantize and tiers.obj.quantize
        assert tiers.obj.backend.root == str(tmp_path / "g4")
        pf = eng.prefetch
        assert (pf.max_inflight, pf._bps, pf.hint_ttl_s, pf.pin_ttl_s) == (2, 3.5e6, 7.0, 2.0)
    finally:
        eng.stop()


def test_host_blocks_pinned_up_to_the_cap(caplog, monkeypatch, tier_params):
    """The runner's host blocks: pinned while fewer than its cap are
    alive, a freed one making room again, pageable past the cap; a
    failed pinning lowers the cap to what is alive (here on the CPU,
    where nothing can be pinned, the pinning is stood in for)."""
    _, params = tier_params
    cfg = dataclasses.replace(get_config("tiny"), n_layers=3)
    runner = ModelRunner(cfg, device="cpu", dtype=torch.float32,
                         params=params_from_numpy(params, cfg, "cpu", torch.float32),
                         **GEOMETRY)
    real_empty = torch.empty
    pins = []

    def empty(*shape, pin_memory=False, **kw):
        pins.append(pin_memory)
        return real_empty(*shape, **kw)

    monkeypatch.setattr(torch, "empty", empty)
    runner.pinned_block_cap = 2
    b1 = runner._host_block((2, 3), torch.float32)
    b2 = runner._host_block((2, 3), torch.float32)
    b3 = runner._host_block((2, 3), torch.float32)
    assert pins == [True, True, False] and runner._pinned_live == [2]
    view = b1[..., None]  # a view keeps its block's memory counted
    del b1
    assert runner._pinned_live == [2]
    del view
    b4 = runner._host_block((2, 3), torch.float32)
    assert pins[-1] is True and runner._pinned_live == [2]
    monkeypatch.undo()
    runner.pinned_block_cap = 3
    with caplog.at_level("WARNING"):
        b5 = runner._host_block((2, 3), torch.float32)
    assert b5.shape == (2, 3) and not b5.is_pinned()
    assert runner.pinned_block_cap == 2 and "pinning a host KV block failed" in caplog.text
    del b2, b3, b4
    assert runner._pinned_live == [0]
