"""n > 1 branches of the port's engine against the JAX package.

- n = 3 greedy branches equal the JAX engine's choice by choice (every
  branch of a greedy request is the greedy stream), one finish per choice,
  items indexed by choice.
- After the fork the trunk pages are shared by reference count (n owners)
  and every tail page was copied through the runner's `copy_pages`: the
  copy equals its source bit for bit, on f32, bf16 and int8 pools (codes
  and scales, no dequantize round trip), and one prefill served all n.
- A parent abort ends every branch and frees their pages.
- Seeded sampled branches draw with seed + k: distinct streams, equal on
  a second run.
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
from dynamo_tpu_torch.models.toolkit import is_quantized
from dynamo_tpu_torch.runtime.context import Context

PS = 4
GEOMETRY = dict(num_pages=64, page_size=PS, max_pages_per_seq=16,
                decode_buckets=(1, 2, 4, 8), prefill_buckets=(8, 16, 32))
PROMPT = np.random.default_rng(2).integers(1, 500, size=14).tolist()  # 3.5 pages


@pytest.fixture(scope="module")
def jparams():
    return jax.device_get(jllama.init_params(
        jax_get_config("tiny"), jax.random.PRNGKey(9), jnp.float32))


def _engine(jparams, dtype=torch.float32, kv_quantize=None):
    cfg = get_config("tiny")
    runner = ModelRunner(cfg, device="cpu", dtype=dtype, kv_quantize=kv_quantize,
                         params=params_from_numpy(jparams, cfg, "cpu", dtype),
                         **GEOMETRY)
    return InferenceEngine(runner, max_batch=8, chunk_size=16)


def _req(n, max_tokens=6, **samp):
    return {"token_ids": list(PROMPT), "sampling": {"temperature": 0.0, "n": n, **samp},
            "stop": {"max_tokens": max_tokens, "stop_ids": []}}


async def _choices(engine, req, ctx_cls=Context):
    """{choice index: (tokens, finish)} of one branched request."""
    out = {}
    async for item in engine.generate(req, ctx_cls()):
        assert item.get("finish_reason") != "error", item
        k = item.get("index", 0)  # a request of one choice has no index
        toks, finish = out.get(k, ([], None))
        out[k] = (toks + list(item["token_ids"]), item["finish_reason"] or finish)
    return out


async def test_greedy_branches_match_jax(jparams):
    teng = _engine(jparams)
    jeng = JaxEngine(JaxRunner(jax_get_config("tiny"), params=jparams,
                               dtype=jnp.float32, **GEOMETRY),
                     max_batch=8, chunk_size=16)
    try:
        got = await _choices(teng, _req(3))
        want = await _choices(jeng, _req(3), JaxContext)
        single = await _choices(teng, _req(1))
    finally:
        teng.stop()
        jeng.stop()
    assert got == want
    assert sorted(got) == [0, 1, 2]
    assert all(v == single[0] and v[1] == "length" for v in got.values())
    # one prefill pass served every choice of the branched request
    assert teng.runner.stats["prefill_chunks"] == 2
    assert teng.pool.forks == 2


def _parts(pool):
    return [pool["q"], pool["s"]] if is_quantized(pool) else [pool]


@pytest.mark.parametrize("dtype,kvq", [(torch.float32, None), (torch.bfloat16, None),
                                       (torch.bfloat16, "int8")])
async def test_fork_shares_trunk_and_copies_tail(jparams, dtype, kvq):
    eng = _engine(jparams, dtype, kvq)
    runner = eng.runner
    copies = []
    orig = runner.copy_pages

    def spy(src, dst):
        orig(src, dst)
        copies.append((src, dst))
        for pool in (runner.k_pool, runner.v_pool):
            for part in _parts(pool):
                assert torch.equal(part[:, dst], part[:, src])

    eng.pool.copy_hook = spy
    forked = {}
    orig_adopt = eng.scheduler.adopt_branch

    def adopt(branch, parent, pages):
        forked[branch.branch_index] = (list(parent.pages), list(pages))
        return orig_adopt(branch, parent, pages)

    eng.scheduler.adopt_branch = adopt
    try:
        got = await _choices(eng, _req(4, max_tokens=3))
    finally:
        eng.stop()
    assert sorted(got) == [0, 1, 2, 3]
    assert eng.pool.forks == 3 and runner.stats["page_copies"] == len(copies) > 0
    n_full = len(PROMPT) // PS
    for parent_pages, pages in forked.values():
        assert pages[:n_full] == parent_pages[:n_full]  # the trunk, shared
        assert not set(pages[n_full:]) & set(parent_pages)  # the tail, fresh
    # every copy went from one of the parent's tail pages
    tails = {p for pp, _ in forked.values() for p in pp[n_full:]}
    assert {src for src, _ in copies} <= tails
    assert runner.stats["prefill_chunks"] == 1
    # all finished: only the registered prefix pages stay cached
    assert not eng.pool.ref


async def test_parent_abort_ends_every_branch(jparams):
    eng = _engine(jparams)
    try:
        seen = set()
        agen = eng.generate(_req(4, max_tokens=40), Context())
        async for item in agen:
            seen.add(item["index"])
            if len(seen) == 4:
                break
        await agen.aclose()
        for _ in range(200):
            if not eng.scheduler.active and not eng.pool.ref:
                break
            await asyncio.sleep(0.01)
        assert not eng.scheduler.active and not eng.scheduler.waiting
        assert not eng.pool.ref  # every branch's pages were released
    finally:
        eng.stop()


async def test_seeded_branches_deterministic_and_distinct(jparams):
    """A draw is a function of (seed, step): two fresh engines serving the
    same request alone give the same streams."""
    req = _req(4, max_tokens=8, temperature=1.0, seed=5)
    runs = []
    for _ in range(2):
        eng = _engine(jparams)
        try:
            runs.append(await _choices(eng, req))
        finally:
            eng.stop()
    a, b = runs
    assert a == b
    assert sorted(a) == [0, 1, 2, 3]
    assert len({tuple(t) for t, _ in a.values()}) == 4
    assert all(len(t) == 8 for t, _ in a.values())
