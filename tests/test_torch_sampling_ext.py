"""The port's sampling extras against the JAX package: penalties, the
logprob report, guided masks and logit bias.

- `apply_penalties`, `top_logprobs`, and `sample` / `filtered_probs` with
  a mask and a bias, against dynamo_tpu/engine/sampling.py on logits from
  a numpy seed (atol 1e-6; greedy picks equal). The reference's
  `filtered_probs` takes no mask or bias: it is given the biased, masked
  logits, and the two distributions are compared per token id (masked
  candidates tie at -1e30, so their order may differ; their mass is 0).
- Engine greedy streams with penalties, logit bias and logprobs equal the
  JAX engine's token for token, fused (DYN_FUSED_MIXED=1: biased rows on
  the ragged step, penalty and logprob rows on the two-dispatch path) and
  unfused (=0); logprob entries equal at atol 1e-4. Both engines are
  stepped by the test, so both see the same plans.
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

B, V = 5, 300
ROWS = dict(temperature=[0.0, 0.7, 1.0, 0.0, 1.3], top_k=[0, 10, 0, 3, 40],
            top_p=[1.0, 0.9, 0.8, 1.0, 1.0], seeds=[1, 2, 3, 4, 5],
            rep_penalty=[1.0, 1.3, 0.8, 2.0, 1.0],
            freq_penalty=[0.0, 0.5, 0.0, 1.5, -0.2],
            presence_penalty=[0.0, 0.25, 0.7, 0.0, 0.3])


def _inputs(seed):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((B, V)) * 3).astype(np.float32)
    counts_all = rng.integers(0, 3, (B, V)).astype(np.float32)
    counts_out = np.minimum(counts_all, rng.integers(0, 2, (B, V))).astype(np.float32)
    mask = rng.random((B, V)) < 0.3
    mask[np.arange(B), rng.integers(0, V, B)] = True  # a token allowed a row
    bias = np.zeros((B, V), np.float32)
    for i in range(B):
        bias[i, rng.integers(0, V, 4)] = rng.choice([-100.0, 100.0, 2.5, -7.0], 4)
    return logits, counts_all, counts_out, mask, bias


def _both(**kw):
    rows = {**ROWS, **kw}
    return (jsampling.SamplingParams.make(**rows),
            sampling.SamplingParams.make(**rows))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_apply_penalties_matches_jax(seed):
    logits, ca, co, _, _ = _inputs(seed)
    jp, tp = _both()
    want = jsampling.apply_penalties(jnp.asarray(logits), jnp.asarray(ca),
                                     jnp.asarray(co), jp)
    got = sampling.apply_penalties(torch.from_numpy(logits), torch.from_numpy(ca),
                                   torch.from_numpy(co), tp)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("k", [0, 1, 5, 20])
def test_top_logprobs_matches_jax(k):
    logits, *_ = _inputs(k)
    sampled = np.random.default_rng(k).integers(0, V, B).astype(np.int32)
    want = jsampling.top_logprobs(jnp.asarray(logits), jnp.asarray(sampled), k)
    got = sampling.top_logprobs(torch.from_numpy(logits), torch.from_numpy(sampled), k)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-6)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), atol=1e-6)
    assert got[1].shape == (B, k) and got[1].dtype == torch.int32


def _dense(idx, probs):
    out = np.zeros((idx.shape[0], V), np.float64)
    np.add.at(out, (np.arange(idx.shape[0])[:, None], np.asarray(idx)),
              np.asarray(probs, np.float64))
    return out


@pytest.mark.parametrize("planes", ["mask", "bias", "mask_bias"])
@pytest.mark.parametrize("seed", [3, 4])
def test_sample_and_filtered_probs_under_mask_and_bias(planes, seed):
    logits, _, _, mask, bias = _inputs(seed)
    m = mask if "mask" in planes else None
    b = bias if "bias" in planes else None
    jp, tp = _both()
    jl = jnp.asarray(logits)
    if b is not None:
        jl = jl + jnp.asarray(b)
    if m is not None:
        jl = jnp.where(jnp.asarray(m), jl, -1e30)
    tm = None if m is None else torch.from_numpy(m)
    tb = None if b is None else torch.from_numpy(b)
    jidx, jprobs = jsampling.filtered_probs(jl, jp)
    tidx, tprobs = sampling.filtered_probs(torch.from_numpy(logits), tp, mask=tm, bias=tb)
    np.testing.assert_allclose(_dense(tidx.numpy(), tprobs.numpy()),
                               _dense(jidx, jprobs), atol=1e-6)
    # greedy rows pick the reference's token; every draw is allowed
    want = np.asarray(jsampling.sample(
        jnp.asarray(logits), jp, jnp.int32(9),
        mask=None if m is None else jnp.asarray(m),
        bias=None if b is None else jnp.asarray(b)))
    for step in (9, 10):
        got = sampling.sample(torch.from_numpy(logits), tp, step, mask=tm, bias=tb).numpy()
        greedy = [i for i, t in enumerate(ROWS["temperature"]) if t <= 0]
        np.testing.assert_array_equal(got[greedy], want[greedy])
        if m is not None:
            assert m[np.arange(B), got].all()
        dense = _dense(tidx.numpy(), tprobs.numpy())
        assert (dense[np.arange(B), got] > 0).all()


def test_sample_is_deterministic_per_seed_and_step():
    logits, _, _, mask, bias = _inputs(5)
    _, tp = _both()
    args = (torch.from_numpy(logits), tp)
    kw = dict(mask=torch.from_numpy(mask), bias=torch.from_numpy(bias))
    a = sampling.sample(*args, 4, **kw)
    assert torch.equal(a, sampling.sample(*args, 4, **kw))
    draws = {tuple(sampling.sample(*args, s, **kw).tolist()) for s in range(4, 12)}
    assert len(draws) > 1


# -- engine streams against the JAX engine ------------------------------------

GEOMETRY = dict(num_pages=96, page_size=4, max_pages_per_seq=16,
                decode_buckets=(1, 2, 4, 8), prefill_buckets=(8, 16))
ENGINE = dict(max_batch=6, chunk_size=8, mixed_prefill_tokens=8,
              mixed_prefill_seqs=4, mixed_min_chunk=2)


@pytest.fixture(scope="module")
def jparams():
    return jax.device_get(jllama.init_params(
        jax_get_config("tiny"), jax.random.PRNGKey(3), jnp.float32))


def _requests():
    rng = np.random.default_rng(11)
    motif = rng.integers(1, 500, size=3).tolist()

    def req(prompt, max_tokens, samp=None, **extra):
        return {"token_ids": prompt, "stop": {"max_tokens": max_tokens, "stop_ids": []},
                "sampling": {"temperature": 0.0, **(samp or {})}, **extra}

    return [
        # biased, and decoding alone first: the next plans fuse its rows
        # with the others' chunks on the ragged step
        req(rng.integers(1, 500, size=5).tolist(), 10, {},
            logit_bias=[[17, 100.0], [301, -100.0], [44, 3.5]]),
        req(motif * 4, 8, {"repetition_penalty": 1.8, "frequency_penalty": 0.6,
                           "presence_penalty": 0.4}),
        req(rng.integers(1, 500, size=9).tolist(), 6, {"logprobs": 3}),
        req(rng.integers(1, 500, size=6).tolist(), 6),
        req(rng.integers(1, 500, size=13).tolist(), 6,
            {"logprobs": 0, "repetition_penalty": 1.3}),
        req(rng.integers(1, 500, size=7).tolist(), 5, {"logprobs": 5},
            logit_bias=[[9, 8.0]]),
    ]


class _Stepped:
    def join(self, timeout=None):
        pass


async def _serve(engine, reqs, ctx_cls):
    """The first request is prefilled alone; the rest arrive right after,
    so their chunks pack beside a live decode row. Returns each request's
    (tokens, logprob entries, finish)."""
    engine._thread = _Stepped()

    async def one(req):
        toks, lps, finish = [], [], None
        async for item in engine.generate(req, ctx_cls()):
            assert item.get("finish_reason") != "error", item
            toks.extend(item["token_ids"])
            lps.extend(item.get("logprobs") or [])
            finish = item["finish_reason"] or finish
        return toks, lps, finish

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


def _close_entries(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["top_ids"] == [int(t) for t in w["top_ids"]]
        np.testing.assert_allclose(g["logprob"], w["logprob"], atol=1e-4)
        np.testing.assert_allclose(g["top_logprobs"], w["top_logprobs"], atol=1e-4)


@pytest.mark.parametrize("fused", ["1", "0"])
async def test_engine_streams_match_jax(jparams, monkeypatch, fused):
    monkeypatch.setenv("DYN_FUSED_MIXED", fused)
    reqs = _requests()
    jrun = JaxRunner(jax_get_config("tiny"), params=jparams, dtype=jnp.float32,
                     **GEOMETRY)
    want = await _serve(JaxEngine(jrun, **ENGINE), reqs, JaxContext)
    cfg = get_config("tiny")
    trun = ModelRunner(cfg, device="cpu", dtype=torch.float32,
                       params=params_from_numpy(jparams, cfg, "cpu", torch.float32),
                       **GEOMETRY)
    teng = InferenceEngine(trun, **ENGINE)
    assert teng.fused_mixed == (fused == "1")
    got = await _serve(teng, reqs, Context)
    for (gt, glp, gf), (wt, wlp, wf), r in zip(got, want, reqs):
        assert gt == wt and gf == wf
        _close_entries(glp, wlp)
        n = r["sampling"].get("logprobs")
        assert len(glp) == (len(gt) if n is not None else 0)
        assert all(len(e["top_ids"]) == n for e in glp)
    # the bias forced token 17 and banned 301
    assert set(got[0][0]) == {17}
    # the extras rode both paths where they were fused
    if fused == "1":
        assert trun.stats["ragged_mixed_dispatches"] > 0
    plain = await _serve(InferenceEngine(trun, **ENGINE),
                         [dict(reqs[1], sampling={"temperature": 0.0})], Context)
    assert plain[0][0] != got[1][0]  # the penalties changed the stream
