"""The port's fused mixed dispatch against the JAX engine and against its
own unfused path.

Both engines serve the same tiny f32 params (the JAX init tree, carried
across by params_from_numpy) at the geometry of tests/test_ragged_mixed.py,
with DYN_FUSED_MIXED=1: a burst of prompts makes mixed plans that pack
several chunks beside live decode rows. Greedy streams must equal the JAX
engine's token for token on the ragged step (DYN_RAGGED_MIXED=1), on the
padded fallback (=0), and when the pack overflows the pack buckets and the
engine sheds chunks to the next iteration. The port's fused and unfused
engines must give identical greedy and seeded-sampled streams: the fused
path draws with the same (seed, step) pairs.
"""

import asyncio

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
from dynamo_tpu_torch.runtime.context import Context

GEOMETRY = dict(num_pages=96, page_size=4, max_pages_per_seq=16,
                decode_buckets=(1, 2, 4, 8), prefill_buckets=(8, 16))
ENGINE = dict(max_batch=6, chunk_size=8, mixed_prefill_tokens=8,
              mixed_prefill_seqs=4, mixed_min_chunk=2)


@pytest.fixture(scope="module")
def jparams():
    cfg = jax_get_config("tiny")
    return jax.device_get(
        jllama.init_params(cfg, jax.random.PRNGKey(3), jnp.float32))


def _prompts():
    rng = np.random.default_rng(7)
    return [rng.integers(1, 500, size=n).tolist() for n in (6, 4, 9, 5, 13)]


def _req(prompt, max_tokens=6, **samp):
    return {"token_ids": list(prompt),
            "sampling": {"temperature": 0.0, **samp},
            "stop": {"max_tokens": max_tokens, "stop_ids": []}}


class _Stepped:
    """Stands in for the engine's step thread: the test steps the engine
    itself, so every run sees the same plans (and the same sampling
    steps) whatever the timing."""

    def join(self, timeout=None):
        pass


async def _serve(engine, reqs, ctx_cls):
    """The first request is prefilled alone; the rest arrive right after,
    so their chunks pack beside a live decode row."""
    engine._thread = _Stepped()

    async def one(req):
        toks = []
        async for item in engine.generate(req, ctx_cls()):
            assert item.get("finish_reason") != "error", item
            toks.extend(item["token_ids"])
            if item["finish_reason"]:
                break
        return toks

    async def settle():
        for _ in range(4):
            await asyncio.sleep(0)

    try:
        tasks = [asyncio.ensure_future(one(reqs[0]))]
        await settle()
        engine._loop_once()
        tasks += [asyncio.ensure_future(one(r)) for r in reqs[1:]]
        while not all(t.done() for t in tasks):
            await settle()
            engine._loop_once()
        return [t.result() for t in tasks]
    finally:
        engine.stop()


def _port_engine(jparams, **kw):
    cfg = get_config("tiny")
    runner = ModelRunner(cfg, device="cpu", dtype=torch.float32,
                         params=params_from_numpy(jparams, cfg, "cpu",
                                                  torch.float32), **GEOMETRY)
    return InferenceEngine(runner, **dict(ENGINE, **kw))


def _count_chunks(runner):
    """Record the chunk count of every fused plan the runner serves."""
    seen = []
    orig = runner.decode_multi_with_prefills

    def counting(*args, **kw):
        seen.append(len(args[6]))
        return orig(*args, **kw)

    runner.decode_multi_with_prefills = counting
    return seen


@pytest.mark.parametrize("mode", ["ragged", "padded", "shed"])
async def test_fused_engine_matches_jax(jparams, monkeypatch, caplog, mode):
    monkeypatch.setenv("DYN_FUSED_MIXED", "1")
    monkeypatch.setenv("DYN_RAGGED_MIXED", "1" if mode == "ragged" else "0")
    reqs = [_req(p, max_tokens=8 if i == 0 else 5)
            for i, p in enumerate(_prompts())]
    jrun = JaxRunner(jax_get_config("tiny"), params=jparams, dtype=jnp.float32,
                     **GEOMETRY)
    teng = _port_engine(jparams)
    if mode == "shed":
        # packs of 3+ chunks overflow: the engine defers the newest ones
        jrun.pack_buckets = (1, 2)
        teng.runner.pack_buckets = (1, 2)
    jres = await _serve(JaxEngine(jrun, **ENGINE), reqs, JaxContext)
    assert teng.fused_mixed
    seen = _count_chunks(teng.runner)
    with caplog.at_level("WARNING"):
        tres = await _serve(teng, reqs, Context)
    assert tres == jres
    assert all(len(t) == r["stop"]["max_tokens"] for t, r in zip(tres, reqs))
    stats = teng.runner.stats
    assert max(seen) >= 2, seen  # packed multi-chunk plans ran
    if mode == "ragged":
        assert stats["ragged_mixed_dispatches"] == len(seen)
        assert stats["padded_prefill_dispatches"] == 0
    else:
        assert stats["ragged_mixed_dispatches"] == 0
        assert stats["padded_prefill_dispatches"] > 0
    shed = sum("deferring chunk" in m for m in caplog.messages)
    assert (shed > 0) == (mode == "shed")


async def test_fused_and_unfused_streams_are_identical(jparams, monkeypatch):
    """Greedy and seeded-sampled rows: the fused engine's streams equal the
    unfused engine's token for token."""
    reqs = [_req(p, max_tokens=7) for p in _prompts()]
    for i in (1, 3):
        reqs[i]["sampling"] = {"temperature": 0.9, "top_p": 0.95,
                               "seed": 100 + i}
    out = {}
    for fused in ("1", "0"):
        monkeypatch.setenv("DYN_FUSED_MIXED", fused)
        eng = _port_engine(jparams)
        assert eng.fused_mixed == (fused == "1")
        seen = _count_chunks(eng.runner)
        out[fused] = await _serve(eng, reqs, Context)
        assert bool(seen) == (fused == "1")
    assert out["1"] == out["0"]
    assert all(len(t) == 7 for t in out["1"])


def test_fused_default_follows_the_device(monkeypatch):
    monkeypatch.delenv("DYN_FUSED_MIXED", raising=False)
    cfg = get_config("tiny")
    runner = ModelRunner(cfg, device="cpu", dtype=torch.float32, **GEOMETRY)
    assert not InferenceEngine(runner).fused_mixed  # CPU: unfused
    # the mixed budget + max batch is a T bucket (a q-block multiple)
    InferenceEngine(runner, max_batch=5, mixed_prefill_tokens=100)
    assert 112 in runner.ragged_buckets
