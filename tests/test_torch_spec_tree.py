"""The port's tree speculation and device-ring drafting against the JAX
engine.

Tree mode (`spec_branches` > 1) verifies up to that many candidate
continuations a sequence, each extra branch a row on a page table forked
from the owner's, and walks them with `accept_tree`. With the same f32
params the port's greedy streams must equal the JAX engine's and plain
decode's; forks must all come back to the pool (after a run, after a
verify that raises, after an abort); a constructed prompt makes a later
branch win and its fork's table adopted. Linear drafts from the runner's
device ring must give the host scan's streams.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.engine import InferenceEngine as JaxEngine
from dynamo_tpu.engine.model_runner import ModelRunner as JaxRunner
from dynamo_tpu.engine.ngram_draft import accept_tree as jax_accept_tree
from dynamo_tpu.engine.ngram_draft import propose_tree as jax_propose_tree
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.models.config import get_config as jax_get_config
from dynamo_tpu.runtime.context import Context as JaxContext
from dynamo_tpu_torch.engine import ngram_draft
from dynamo_tpu_torch.engine.engine import InferenceEngine
from dynamo_tpu_torch.engine.model_runner import BucketOverflowError, ModelRunner
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.models.config import get_config
from dynamo_tpu_torch.runtime.context import Context

GEOMETRY = dict(num_pages=128, page_size=4, max_pages_per_seq=16,
                decode_buckets=(1, 2, 4, 8), prefill_buckets=(8, 16))
ENGINE = dict(max_batch=6, chunk_size=8, mixed_prefill_tokens=16,
              mixed_prefill_seqs=4, mixed_min_chunk=2)
TREE = dict(spec_ngram=True, spec_k=4, spec_branches=3)
N_OUT = 14
# greedy from this prompt, the tiny model (PRNGKey(4) params) emits
# [377, 377, 461, 377, ...]: at its first verify the most recent match of
# the suffix proposes a branch the model rejects at once and an older
# match proposes the accepted one, so branch 1 wins
SWITCH_PROMPT = [43, 90, 119, 91, 400, 434, 291, 20, 47, 166, 217, 310, 377,
                 111, 324, 362, 461, 377, 377, 377, 144, 362, 98, 283]


@pytest.fixture(scope="module")
def jparams():
    cfg = jax_get_config("tiny")
    return jax.device_get(
        jllama.init_params(cfg, jax.random.PRNGKey(4), jnp.float32))


def _reqs():
    rng = np.random.default_rng(11)
    motif = rng.integers(1, 500, size=5).tolist()
    prompts = [motif * 3, rng.integers(1, 500, size=7).tolist() * 2,
               motif[:3] * 4 + [9], rng.integers(1, 500, size=11).tolist()]
    return [{"token_ids": p, "sampling": {"temperature": 0.0},
             "stop": {"max_tokens": N_OUT, "stop_ids": []}} for p in prompts]


class _Stepped:
    """Stands in for the engine's step thread: the test steps the engine
    itself, so every run sees the same plans whatever the timing."""

    def join(self, timeout=None):
        pass


async def _serve(engine, reqs, ctx_cls, errors=False):
    """The first request is prefilled alone; the rest arrive right after,
    so their chunks pack beside a live decode row."""
    engine._thread = _Stepped()

    async def one(req):
        toks = []
        async for item in engine.generate(req, ctx_cls()):
            if item.get("finish_reason") == "error":
                assert errors, item
                return None
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


@pytest.fixture(scope="module")
def plain(jparams):
    eng = _port_engine(jparams)
    out = asyncio.run(_serve(eng, _reqs(), Context))
    return out, eng.pool.n_free


def _clean(engine, n_free):
    pool = engine.pool
    assert not engine.scheduler.active
    assert not pool.ref, pool.ref  # no page held by a table any more
    assert pool.n_free == n_free


def test_propose_tree_and_accept_tree_match_jax():
    rng = np.random.default_rng(3)
    for _ in range(300):
        toks = rng.integers(0, 5, size=rng.integers(0, 40)).tolist()
        k, br = int(rng.integers(0, 6)), int(rng.integers(0, 5))
        tree = ngram_draft.propose_tree(toks, k, br)
        assert tree == jax_propose_tree(toks, k, br)
        if tree:
            assert tree[0] == ngram_draft.propose(toks, k)
        drafts = [rng.integers(0, 3, size=rng.integers(1, 5)).tolist()
                  for _ in range(rng.integers(0, 4))]
        rows = [rng.integers(0, 3, size=len(d) + 1).tolist() for d in drafts]
        assert ngram_draft.accept_tree(drafts, rows) == jax_accept_tree(drafts, rows)


async def test_tree_engine_matches_jax_and_plain(jparams, plain, monkeypatch):
    """Fused (branch rows and chunks in one ragged dispatch): the port's
    tree streams equal the JAX engine's and plain decode's; branch rows
    were verified; every fork came back to the pool."""
    monkeypatch.setenv("DYN_FUSED_MIXED", "1")
    reqs = _reqs()
    jrun = JaxRunner(jax_get_config("tiny"), params=jparams, dtype=jnp.float32,
                     **GEOMETRY)
    jeng = JaxEngine(jrun, spec_device_draft=False, **TREE, **ENGINE)
    want = await _serve(jeng, reqs, JaxContext)
    eng = _port_engine(jparams, **TREE)
    got = await _serve(eng, reqs, Context)
    assert got == want == plain[0]
    st = eng.spec_stats
    assert st["tree_rows"] > 0 and st["accepted"] > 0, st
    assert st["tree_rows"] == jeng.spec_stats["tree_rows"]
    assert st["tree_switches"] == jeng.spec_stats["tree_switches"]
    assert eng.runner.stats["ragged_verify_dispatches"] == st["verify_iters"] > 0
    _clean(eng, plain[1])


async def test_tree_unfused_and_branch_switch(jparams, plain, monkeypatch):
    """Unfused tree streams equal plain decode's; on the constructed
    prompt branch 1 wins and its forked table is adopted, and the stream
    is still plain decode's."""
    monkeypatch.setenv("DYN_FUSED_MIXED", "0")
    eng = _port_engine(jparams, **TREE)
    assert await _serve(eng, _reqs(), Context) == plain[0]
    _clean(eng, plain[1])
    req = [{"token_ids": SWITCH_PROMPT, "sampling": {"temperature": 0.0},
            "stop": {"max_tokens": 10, "stop_ids": []}}]
    base = _port_engine(jparams)
    want = await _serve(base, req, Context)
    eng = _port_engine(jparams, **TREE)
    assert await _serve(eng, req, Context) == want
    assert eng.spec_stats["tree_switches"] > 0, eng.spec_stats
    _clean(eng, base.pool.n_free)


def _fail_forked_verifies(eng, n, exc):
    """Make the runner's first n verifies that follow a fork raise exc.
    Returns the list of failed calls' fork counts."""
    real = eng.runner.verify_spec
    failed, seen = [], [eng.pool.forks]

    def verify(*a, **kw):
        made, seen[0] = eng.pool.forks - seen[0], eng.pool.forks
        if made and len(failed) < n:
            failed.append(made)
            raise exc
        return real(*a, **kw)

    eng.runner.verify_spec = verify
    return failed


async def test_tree_forks_released_when_verify_fails(jparams, plain, monkeypatch):
    """A verify with branch rows that overflows the buckets drops the
    drafts (the plain path runs; the streams stay plain decode's); one
    that raises errors its sequences. Either way every fork goes back to
    the pool."""
    monkeypatch.setenv("DYN_FUSED_MIXED", "0")
    eng = _port_engine(jparams, **TREE)
    failed = _fail_forked_verifies(eng, 2, BucketOverflowError(999, (1,)))
    assert await _serve(eng, _reqs(), Context) == plain[0]
    assert len(failed) == 2
    _clean(eng, plain[1])
    eng = _port_engine(jparams, **TREE)
    failed = _fail_forked_verifies(eng, 1, RuntimeError("verify failed"))
    out = await _serve(eng, _reqs(), Context, errors=True)
    assert failed and None in out
    _clean(eng, plain[1])


async def test_tree_abort_releases_forks(jparams, plain):
    """A client leaving mid-stream while branch rows are in flight leaks
    no page: the scheduler drains and the pool holds no reference."""
    eng = _port_engine(jparams, **TREE)
    eng._thread = _Stepped()
    req = dict(_reqs()[0], stop={"max_tokens": 40, "stop_ids": []})
    gen = eng.generate(req, Context())
    got = 0
    try:
        while got < 3:
            task = asyncio.ensure_future(gen.__anext__())
            while not task.done():
                await asyncio.sleep(0)
                eng._loop_once()
            got += len(task.result()["token_ids"])
        assert eng.spec_stats["tree_rows"] > 0
        await gen.aclose()
        for _ in range(3):
            eng._loop_once()
        _clean(eng, plain[1])
    finally:
        eng.stop()


async def test_device_ring_streams_equal_host_scan(jparams, plain):
    """Linear drafts from the device ring and from the host scan (the
    default) give plain decode's streams, and the ring proposed every
    draft."""
    ring = _port_engine(jparams, spec_ngram=True, spec_k=4, spec_device_draft=True)
    assert ring._spec_device_draft
    assert await _serve(ring, _reqs(), Context) == plain[0]
    host = _port_engine(jparams, spec_ngram=True, spec_k=4)
    assert not host._spec_device_draft
    assert await _serve(host, _reqs(), Context) == plain[0]
    assert ring.spec_stats == host.spec_stats
    assert ring.runner.stats["draft_ring_steps"] > 0
    assert host.runner.stats["draft_ring_steps"] == 0
