"""The port's linear n-gram speculative decoding against the JAX engine.

Drafts come from each sequence's own history (engine/ngram_draft.py) and
are verified as K+1-token rows of the ragged dispatch. Prompts repeat
n-grams, and the tiny random model's greedy output loops, so drafts are
proposed and accepted. With the same f32 params the port's spec engine
must stream what the JAX engine (spec_ngram, host drafting, linear K)
streams, on the two-dispatch split (verify, then the chunks) and fused
(verify rows and chunks in one dispatch), and what the port streams with
speculation off: greedy acceptance emits the greedy stream.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.engine import InferenceEngine as JaxEngine
from dynamo_tpu.engine.model_runner import ModelRunner as JaxRunner
from dynamo_tpu.engine.ngram_draft import accept_deterministic as jax_accept
from dynamo_tpu.engine.ngram_draft import propose as jax_propose
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.models.config import get_config as jax_get_config
from dynamo_tpu.runtime.context import Context as JaxContext
from dynamo_tpu_torch.engine import ngram_draft
from dynamo_tpu_torch.engine.engine import InferenceEngine
from dynamo_tpu_torch.engine.model_runner import ModelRunner
from dynamo_tpu_torch.engine.scheduler import Scheduler, Sequence, SeqState
from dynamo_tpu_torch.engine.kv_pool import PagePool
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.models.config import get_config
from dynamo_tpu_torch.runtime.context import Context

GEOMETRY = dict(num_pages=128, page_size=4, max_pages_per_seq=16,
                decode_buckets=(1, 2, 4, 8), prefill_buckets=(8, 16))
ENGINE = dict(max_batch=6, chunk_size=8, mixed_prefill_tokens=16,
              mixed_prefill_seqs=4, mixed_min_chunk=2)
N_OUT = 14


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


@pytest.mark.parametrize("fused", ["0", "1"])
async def test_spec_engine_matches_jax_and_plain(jparams, monkeypatch, fused):
    monkeypatch.setenv("DYN_FUSED_MIXED", fused)
    reqs = _reqs()
    jrun = JaxRunner(jax_get_config("tiny"), params=jparams,
                     dtype=jnp.float32, **GEOMETRY)
    jeng = JaxEngine(jrun, spec_ngram=True, spec_k=4, spec_device_draft=False,
                     spec_branches=1, **ENGINE)
    jres = await _serve(jeng, reqs, JaxContext)
    teng = _port_engine(jparams, spec_ngram=True, spec_k=4)
    tres = await _serve(teng, reqs, Context)
    plain = await _serve(_port_engine(jparams), reqs, Context)
    assert tres == jres
    assert tres == plain
    assert all(len(t) == N_OUT for t in tres)
    st = teng.spec_stats
    assert st["drafted"] > 0 and st["accepted"] > 0, st
    assert st["accepted"] + st["rejected"] == st["drafted"]
    stats = teng.runner.stats
    assert stats["ragged_verify_dispatches"] == st["verify_iters"] > 0
    # drafts were accepted: fewer forward passes than emitted tokens
    assert st["spec_emitted"] > st["verify_rows"]


def test_propose_and_accept_match_jax():
    rng = np.random.default_rng(2)
    for _ in range(200):
        toks = rng.integers(0, 6, size=rng.integers(0, 30)).tolist()
        k = int(rng.integers(0, 6))
        assert ngram_draft.propose(toks, k) == jax_propose(toks, k)
        draft = rng.integers(0, 4, size=k).tolist()
        sampled = rng.integers(0, 4, size=k + 1).tolist()
        assert ngram_draft.accept_deterministic(draft, sampled) == \
            jax_accept(draft, sampled)


def _running(pool, n, computed, draft, max_tokens=1 << 30):
    seqs = []
    for i in range(n):
        s = Sequence(request_id=f"s{i}", prompt=[1] * computed, sampling={},
                     stop={"max_tokens": max_tokens})
        s.tokens = [1] * (computed + 1)
        s.n_prompt0 = computed
        s.pages = pool.alloc(-(-(computed + 1) // pool.page_size))
        s.computed_len = computed
        s.state = SeqState.RUNNING
        s.spec_draft = list(draft)
        seqs.append(s)
    return seqs


def test_scheduler_trims_drafts_to_the_budgets():
    """Drafts charge the mixed pool after prefill chunks, the per-step
    cap and the ragged dispatch's sampled rows; a draft never outruns
    max_tokens; a speculating row gets KV slots for its whole draft."""
    pool = PagePool(64, 4)
    sched = Scheduler(pool, max_batch=8, mixed_prefill_tokens=10,
                      spec_seg_budget=6, decode_steps=4)
    seqs = _running(pool, 3, 5, [7, 7, 7, 7])
    sched.active.extend(seqs)
    plan = sched.step_plan()
    # 6 sampled rows - 3 decode rows = 3 draft tokens in all
    assert [len(s.spec_draft) for s in seqs] == [3, 0, 0]
    assert plan.n_steps == 1  # verify rows do not mix with fused steps
    # positions 5..8 of the first row need pages: 9 tokens -> 3 pages
    assert len(seqs[0].pages) >= 3
    for max_tokens, want in ((1 << 30, [2, 0]), (2, [1, 1])):
        # the per-step cap of 2 draft tokens; with max_tokens 2 and one
        # token generated, each request may take only one more
        sched2 = Scheduler(PagePool(64, 4), max_batch=8,
                           mixed_prefill_tokens=10, spec_max_tokens=2)
        seqs2 = _running(sched2.pool, 2, 5, [7, 7, 7], max_tokens=max_tokens)
        sched2.active.extend(seqs2)
        sched2.step_plan()
        assert [len(s.spec_draft) for s in seqs2] == want
    sched2._finish(seqs2[0], "length")
    assert seqs2[0].spec_draft == []
