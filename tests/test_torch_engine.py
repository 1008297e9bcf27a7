"""The port's engine (dynamo_tpu_torch/engine) against the JAX package.

Both InferenceEngines serve the same tiny f32 params (the JAX init tree,
carried across by params_from_numpy) with the same geometry as the
tiny_engine fixture of tests/test_engine.py. Greedy streams must be equal
token for token through chunked prefill, concurrent batched decode and a
prefix-cache hit. Sampled streams cannot match the reference (threefry
keys there, torch generators here), so they are held to per-(seed, step)
determinism and to `filtered_probs` equality with the reference.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import sampling as jsampling
from dynamo_tpu.engine.engine import InferenceEngine as JaxEngine
from dynamo_tpu.engine.model_runner import ModelRunner as JaxRunner
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.models.config import get_config as jax_get_config
from dynamo_tpu.runtime.context import Context as JaxContext
from dynamo_tpu_torch.engine import sampling
from dynamo_tpu_torch.engine.engine import InferenceEngine
from dynamo_tpu_torch.engine.model_runner import ModelRunner
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.models.config import get_config
from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.worker import build_engine, parse_args

GEOMETRY = dict(num_pages=64, page_size=4, max_pages_per_seq=16,
                decode_buckets=(1, 2, 4, 8), prefill_buckets=(8, 16, 32))


@pytest.fixture(scope="module")
def engines():
    cfg = jax_get_config("tiny")
    jparams = jax.device_get(
        jllama.init_params(cfg, jax.random.PRNGKey(0), jnp.float32))
    jrun = JaxRunner(cfg, params=jparams, dtype=jnp.float32, **GEOMETRY)
    trun = ModelRunner(
        get_config("tiny"), device="cpu", dtype=torch.float32,
        params=params_from_numpy(jparams, get_config("tiny"), "cpu",
                                 torch.float32),
        **GEOMETRY)
    jeng = JaxEngine(jrun, max_batch=8, chunk_size=16)
    teng = InferenceEngine(trun, max_batch=8, chunk_size=16)
    yield jeng, teng
    jeng.stop()
    teng.stop()


def _req(prompt, max_tokens=6, **samp):
    return {
        "token_ids": list(prompt),
        "sampling": {"temperature": 0.0, **samp},
        "stop": {"max_tokens": max_tokens, "stop_ids": []},
    }


async def _collect(engine, req, ctx_cls):
    toks, finish = [], None
    async for item in engine.generate(req, ctx_cls()):
        toks.extend(item["token_ids"])
        if item["finish_reason"]:
            finish = item["finish_reason"]
    return toks, finish


async def test_greedy_streams_match_jax(engines):
    jeng, teng = engines
    rng = np.random.default_rng(0)
    shared = rng.integers(1, 500, size=12).tolist()
    prompts = [
        rng.integers(1, 500, size=n).tolist() for n in (3, 17, 40, 9, 33)
    ] + [shared + [7, 8, 9]]
    reqs = [_req(p, max_tokens=5 + i % 3) for i, p in enumerate(prompts)]
    # concurrent: chunked prefill (chunk 16) of the 33/40-token prompts
    # runs while the short ones decode
    jres = await asyncio.gather(*[_collect(jeng, r, JaxContext) for r in reqs])
    tres = await asyncio.gather(*[_collect(teng, r, Context) for r in reqs])
    assert all(f == "length" for _, f in tres)
    assert [len(t) for t, _ in tres] == [r["stop"]["max_tokens"] for r in reqs]
    assert tres == jres
    # prefix-cache hit: the shared 12-token prefix's pages are registered
    hit = _req(shared + [11, 12, 13, 14], max_tokens=6)
    before = teng.scheduler.reused_prefix_tokens
    jt = await _collect(jeng, hit, JaxContext)
    tt = await _collect(teng, hit, Context)
    assert teng.scheduler.reused_prefix_tokens > before
    assert tt == jt


async def test_greedy_streams_match_jax_under_preemption():
    """A pool too small for the batch: both engines preempt (recompute)
    and still stream the same greedy tokens."""
    cfg = jax_get_config("tiny")
    jparams = jax.device_get(
        jllama.init_params(cfg, jax.random.PRNGKey(2), jnp.float32))
    small = dict(GEOMETRY, num_pages=12)
    jeng = JaxEngine(JaxRunner(cfg, params=jparams, dtype=jnp.float32, **small),
                     max_batch=4, chunk_size=16)
    trun = ModelRunner(
        get_config("tiny"), device="cpu", dtype=torch.float32,
        params=params_from_numpy(jparams, get_config("tiny"), "cpu",
                                 torch.float32), **small)
    teng = InferenceEngine(trun, max_batch=4, chunk_size=16)
    preempted = []
    recompute = teng.scheduler._preempt

    def counting_preempt(seq):
        preempted.append(seq.request_id)
        recompute(seq)

    teng.scheduler._preempt = counting_preempt
    rng = np.random.default_rng(4)
    reqs = [_req(rng.integers(1, 500, size=10).tolist(), max_tokens=18)
            for _ in range(4)]
    try:
        jres = await asyncio.gather(*[_collect(jeng, r, JaxContext) for r in reqs])
        tres = await asyncio.gather(*[_collect(teng, r, Context) for r in reqs])
    finally:
        jeng.stop()
        teng.stop()
    # 4 x (10 + 18) tokens need 28 pages of 4; the pool has 12
    assert preempted
    assert tres == jres
    assert all(f == "length" and len(t) == 18 for t, f in tres)


async def test_seeded_sampling_is_deterministic():
    """A sampled row's draws are a function of (seed, step): two fresh
    engines given the same requests stream the same tokens."""
    def fresh():
        args = parse_args(["--model", "tiny", "--device", "cpu",
                           "--num-pages", "64", "--page-size", "4",
                           "--max-seq-len", "64", "--max-batch", "4",
                           "--chunk-size", "16"])
        return build_engine(args)

    reqs = [_req(range(1, 12), max_tokens=8, temperature=0.8, top_p=0.9,
                 seed=s) for s in (7, 7, 8)]
    outs = []
    for _ in range(2):
        eng = fresh()
        try:
            outs.append([await _collect(eng, r, Context) for r in reqs])
        finally:
            eng.stop()
    assert outs[0] == outs[1]
    assert all(f == "length" and len(t) == 8 for t, f in outs[0])


def test_sample_depends_only_on_seed_and_step():
    rng = np.random.default_rng(1)
    logits = torch.from_numpy(rng.standard_normal((3, 200)).astype(np.float32))
    p = sampling.SamplingParams.make([1.0, 0.0, 0.7], [0, 0, 20], [1.0, 1.0, 0.9],
                                     [5, 5, 6])
    a = sampling.sample(logits, p, step=3)
    b = sampling.sample(logits.clone(), p, step=3)
    assert torch.equal(a, b) and a.dtype == torch.int32
    assert int(a[1]) == int(torch.argmax(logits[1]))  # greedy row
    draws = {tuple(sampling.sample(logits, p, step=s).tolist()) for s in range(20)}
    assert len(draws) > 1  # other steps draw other tokens
    # every draw lies in the filtered support
    idx, probs = sampling.filtered_probs(logits, p)
    for s in range(20):
        tok = sampling.sample(logits, p, step=s)
        for i in range(3):
            j = (idx[i] == tok[i]).nonzero()
            assert len(j) == 1 and probs[i, j[0, 0]] > 0


def test_filtered_probs_match_jax():
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((6, 300)).astype(np.float32) * 3
    temp = [0.0, 0.5, 1.0, 0.8, 1.3, 0.7]
    top_k = [0, 5, 0, 70, 3, 0]
    top_p = [1.0, 0.9, 0.5, 1.0, 0.8, 0.95]
    seeds = [0, 1, 2, 3, 4, 5]
    jidx, jprobs = jsampling.filtered_probs(
        jnp.asarray(logits), jsampling.SamplingParams.make(temp, top_k, top_p, seeds))
    tidx, tprobs = sampling.filtered_probs(
        torch.from_numpy(logits),
        sampling.SamplingParams.make(temp, top_k, top_p, seeds))
    assert sampling.MAX_CANDIDATES == jsampling.MAX_CANDIDATES
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(tprobs.numpy(), np.asarray(jprobs), atol=1e-6)


async def test_unsupported_requests_are_refused(engines):
    _, teng = engines
    for req in (dict(_req([1, 2, 3]), guided={"regex": "a"}),  # no "kind"
                dict(_req([1, 2, 3]), mm={"data": b"x"})):
        toks, finish = await _collect(teng, req, Context)
        assert finish == "error" and toks == []
    # an adapter is served now; a runner without LoRA slots answers the
    # reference's error item for a name it does not hold
    items = [it async for it in teng.generate(dict(_req([1, 2, 3]), adapter="lora-a"),
                                              Context())]
    assert [(it["finish_reason"], it["token_ids"], it.get("error")) for it in items] == [
        ("error", [], "unknown LoRA adapter 'lora-a'")]
    # a kv_remote_host hint with no peer to pull from is served by
    # recompute: the same stream as without the hint
    plain = await _collect(teng, _req([1, 2, 3]), Context)
    hinted = await _collect(teng, dict(_req([1, 2, 3]), kv_remote_host={
        "instance": 1, "path": "dyn/tpu-worker/kv_host_fetch", "hashes": [1],
        "parents": [None]}), Context)
    assert hinted == plain and plain[1] != "error"
    # a prompt past the KV capacity (16 pages x 4 tokens) is refused too
    toks, finish = await _collect(teng, _req(range(1, 80)), Context)
    assert finish == "error"


def test_decode_is_one_step_of_decode_multi():
    """`decode` and a one-step `decode_multi` run the same path: the
    same tokens, and the same KV written at the fed position."""
    run = ModelRunner(get_config("tiny"), device="cpu", dtype=torch.float32,
                      **GEOMETRY)
    samp = {"temperature": [0.0, 0.0], "top_k": [0, 0], "top_p": [1.0, 1.0],
            "seeds": [0, 0]}
    args = ([5, 9], [3, 6], [[40, 41], [42, 43]], samp, 1)
    one = run.decode(*args)
    k_after = run.k_pool.clone()
    multi = run.decode_multi(1, *args)
    assert one.shape == (2,) and multi.shape == (2, 1)
    np.testing.assert_array_equal(one, multi[:, 0])
    torch.testing.assert_close(run.k_pool, k_after, atol=0, rtol=0)


def test_entry_points_need_a_card_or_cpu():
    from dynamo_tpu_torch import resolve_device

    assert resolve_device("cpu").type == "cpu"
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device(None)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ModelRunner(get_config("tiny"))
