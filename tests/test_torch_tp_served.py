"""Tensor parallelism served: KV pulls between TP 1 and TP 2 workers over
TCP, the TP 2 worker as processes, and a follower's death.

The disaggregated pairs run in this process (rank 0 of a TP 2 runner
here, its follower spawned for the module); the worker tests start
`python -m dynamo_tpu_torch.worker --tensor-parallel 2 --device cpu`,
whose follower it spawns itself. Params are the JAX init trees at f32.
"""

import asyncio
import os
import signal
import sys
import time
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
from dynamo_tpu_torch.frontend.protocols import ModelCard
from dynamo_tpu_torch.models.config import get_config
from dynamo_tpu_torch.parallel.group import (
    MirroredRunner,
    shutdown_followers,
    spawn_followers,
)
from dynamo_tpu_torch.router.prefill_router import DisaggPolicy, PrefillRouter
from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.runtime.discovery import FileDiscovery, MemDiscovery
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.worker_common import serve_worker

ROOT = Path(__file__).resolve().parents[1]
T = 60  # bound on every awaited scenario, seconds
PS = 4
GEOMETRY = dict(num_pages=96, page_size=PS, max_pages_per_seq=16,
                decode_buckets=(1, 2, 4, 8), prefill_buckets=(8, 16, 32))
_rng = np.random.default_rng(7)
PROMPTS = [_rng.integers(1, 500, size=n).tolist() for n in (6, 4, 9, 5, 13)]


@pytest.fixture(scope="module")
def group():
    g, procs = spawn_followers(2, "cpu")
    yield g, procs
    assert shutdown_followers(g, procs) == [0]


@pytest.fixture(autouse=True)
def _fresh_registries():
    yield
    MemDiscovery.reset()


def _jtree(jcfg, seed):
    return jax.device_get(jllama.init_params(jcfg, jax.random.PRNGKey(seed), jnp.float32))


def _tp_runner(group, cfg, jp, **kw):
    g, procs = group
    return MirroredRunner(g, procs, config=cfg, device="cpu", dtype=torch.float32,
                          params=params_from_numpy(jp, cfg, "cpu", torch.float32),
                          **dict(GEOMETRY, **kw))


def _runner(cfg, jp, **kw):
    return ModelRunner(cfg, device="cpu", dtype=torch.float32,
                       params=params_from_numpy(jp, cfg, "cpu", torch.float32),
                       **dict(GEOMETRY, **kw))


# -- the KV wire: TP 1 <-> TP 2 pulls ------------------------------------------------


async def _collect(stream):
    toks, finish = [], None
    async for item in stream:
        toks.extend(item["token_ids"])
        finish = item.get("finish_reason") or finish
    return toks, finish


@pytest.mark.parametrize("prefill_tp,decode_tp", [(1, 2), (2, 1)],
                         ids=["tp1-to-tp2", "tp2-to-tp1"])
async def test_disagg_pull_across_tp_degrees_matches_aggregated(group, prefill_tp,
                                                                decode_tp):
    cfg = get_config("tiny")
    jp = _jtree(jax_get_config("tiny"), 7)
    agg = InferenceEngine(_runner(cfg, jp), max_batch=4, chunk_size=16)
    try:
        want = [await _collect(agg.generate(
            {"token_ids": p, "sampling": {"temperature": 0.0},
             "stop": {"max_tokens": 6, "stop_ids": []}}, Context())) for p in PROMPTS]
    finally:
        agg.stop()
    runners = {}
    for role, tp in (("prefill", prefill_tp), ("decode", decode_tp)):
        runners[role] = _tp_runner(group, cfg, jp) if tp == 2 else _runner(cfg, jp)
    card = ModelCard(name="tiny", context_length=64, kv_block_size=PS)
    realm = f"tpw{prefill_tp}{decode_tp}"

    def rt():
        return DistributedRuntime(discovery=MemDiscovery(realm=realm),
                                  event_transport="inproc")

    async def run():
        pre = InferenceEngine(runners["prefill"], max_batch=4, chunk_size=16)
        dec = InferenceEngine(runners["decode"], max_batch=4, chunk_size=16)
        p_rt, d_rt, front = rt(), rt(), rt()
        p_w = await serve_worker(p_rt, pre, card, component="prefill",
                                 disagg_role="prefill", colocated=False)
        d_w = await serve_worker(d_rt, dec, card, component="decode",
                                 disagg_role="decode", colocated=False)
        down, pool = front.client("dyn/decode/generate"), front.client("dyn/prefill/generate")
        try:
            await down.wait_ready(timeout=T)
            await pool.wait_ready(timeout=T)
            router = PrefillRouter(down, DisaggPolicy(min_prefill_tokens=4))
            router.activate(pool, "dyn/prefill/kv_fetch")
            got = [await _collect(router.generate(
                {"token_ids": p, "sampling": {"temperature": 0.0},
                 "stop": {"max_tokens": 6, "stop_ids": []}}, Context())) for p in PROMPTS]
        finally:
            await down.close()
            await pool.close()
            for r in (front, d_rt, p_rt):
                await r.shutdown(drain_timeout=1)
            await d_w.stop()
            await p_w.stop()
        return got, d_w

    try:
        got, d_w = await asyncio.wait_for(run(), T)
        assert got == want
        assert d_w.handler.fallbacks == 0
        assert runners["decode"].stats["kv_pages_imported"] > 0
        assert runners["decode"].stats["prefill_chunks"] == 0
    finally:
        for r in runners.values():
            if isinstance(r, MirroredRunner):
                r.close()


# -- the worker as processes ---------------------------------------------------------


async def _start_worker(tmp_path, *extra):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = await asyncio.create_subprocess_exec(
        sys.executable, "-m", "dynamo_tpu_torch.worker", "--device", "cpu",
        "--model", "tiny", "--tensor-parallel", "2", "--num-pages", "64",
        "--page-size", "4", "--max-seq-len", "64", "--max-batch", "4",
        "--chunk-size", "16", "--discovery-backend", "file",
        "--discovery-root", str(tmp_path), *extra,
        cwd=ROOT, env=env, stdout=asyncio.subprocess.PIPE,
        stderr=asyncio.subprocess.DEVNULL)
    lines = []
    while not lines or b"worker serving" not in lines[-1]:
        line = await proc.stdout.readline()
        assert line, f"the worker exited before serving: {lines}"
        lines.append(line)
    pids = next(ln for ln in lines if b"follower pids" in ln)
    return proc, lines, [int(x) for x in pids.decode().split("[")[-1].strip(" ]\n").split(",")]


async def test_tp2_worker_serves_and_exits_0_on_sigterm(tmp_path):
    async def run():
        proc, lines, pids = await _start_worker(tmp_path)
        rt = DistributedRuntime(discovery=FileDiscovery(str(tmp_path), poll_interval=0.05),
                                event_transport="inproc")
        try:
            client = rt.client("dyn/tpu-worker/generate")
            await client.wait_ready(timeout=T)
            got = await _collect(client.generate(
                {"token_ids": PROMPTS[0], "sampling": {"temperature": 0.0},
                 "stop": {"max_tokens": 4, "stop_ids": []}}, Context()))
            await client.close()
            proc.send_signal(signal.SIGTERM)
            rc = await proc.wait()
        finally:
            if proc.returncode is None:
                proc.kill()
                await proc.wait()
            await rt.shutdown(drain_timeout=1)
        return got, rc, lines, pids

    (toks, finish), rc, lines, pids = await asyncio.wait_for(run(), 2 * T)
    assert rc == 0 and finish == "length" and len(toks) == 4
    assert any(b"transport gloo" in ln for ln in lines)
    for pid in pids:  # the follower exited with the worker
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)


async def test_tp2_worker_ends_with_an_error_when_a_follower_dies(tmp_path):
    async def run():
        proc, lines, pids = await _start_worker(tmp_path)
        try:
            os.kill(pids[0], signal.SIGKILL)
            t0 = time.monotonic()
            rc = await asyncio.wait_for(proc.wait(), 45)
            return rc, time.monotonic() - t0
        finally:
            if proc.returncode is None:
                proc.kill()
                await proc.wait()

    rc, seconds = await asyncio.wait_for(run(), 2 * T)
    assert rc != 0 and seconds < 45


def test_follower_death_fails_the_next_call():
    g, procs = spawn_followers(2, "cpu")
    try:
        cfg = get_config("tiny")
        trun = MirroredRunner(g, procs, config=cfg, device="cpu", dtype=torch.float32,
                              **GEOMETRY)
        procs[0].kill()
        procs[0].join()
        with pytest.raises(RuntimeError, match="followers gone"):
            trun.prefill([1, 2, 3], 0, [0], 0)
        assert trun.failed == [(1, procs[0].exitcode)]
    finally:
        shutdown_followers(g, procs, join_s=5)


@pytest.mark.parametrize("method", ["import_page_tensors", "prefill"])
def test_a_follower_failing_alone_ends_it_and_fails_the_call(method):
    """The follower alone raises in `method` (its runner's method is made a
    builtin that takes one argument): rank 0 raises naming the follower's
    error and refuses every later call, and the follower exits non-zero,
    which ends a worker (FollowerWatch). In prefill rank 0 first waits in
    the embedding's all-gather for the group's timeout (3 s here)."""
    g, procs = spawn_followers(2, "cpu", timeout_s=3)
    try:
        cfg = get_config("tiny")
        trun = MirroredRunner(g, procs, config=cfg, device="cpu", dtype=torch.float32,
                              **GEOMETRY)
        g.send_call("__set__", (method, abs))  # the follower's runner alone
        assert g.call_status(None) == [None, None]
        L, ps, Hk, D = trun.kv_page_shape
        pages = torch.zeros(L, 1, ps, Hk, D)
        calls = {"import_page_tensors": lambda: trun.import_page_tensors([3], pages, pages),
                 "prefill": lambda: trun.prefill([1, 2, 3], 0, [0], 0)}
        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match="rank 1: TypeError"):
            calls[method]()
        assert time.monotonic() - t0 < 30
        procs[0].join(10)
        assert procs[0].exitcode not in (None, 0)
        with pytest.raises(RuntimeError, match="failed earlier"):
            trun.prefill([1, 2, 3], 0, [0], 0)
    finally:
        shutdown_followers(g, procs, join_s=5)
