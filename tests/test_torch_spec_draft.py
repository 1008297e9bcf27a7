"""The port's draft-model speculative decoding and device draft ring
against the JAX package.

Draft-model speculation: `accept_and_finalize` fed the reference's
uniforms and final draws (equal tokens and counts, residuals at 1e-6),
the port's own draws in bulk (the first token's law is the target's),
one `spec_rounds` round through the runner (tokens, counts, target and
draft pools against the JAX runner's), greedy engine streams with a
perfect and a garbage draft and max_tokens below gamma (equal to the JAX
engine's and to plain decode, on f32 and int8 pools), the draft KV rebuilt
after a host-staged import, and the admission refusals and fallback.
The device ring: `draft_ring_step` bit for bit against the reference's
`_draft_ring_step` under hypothesis, and the runner's ring against the
host scan. Models are tiny and f32, params from a seeded JAX init.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from dynamo_tpu.engine import spec_decode as jspec
from dynamo_tpu.engine.engine import InferenceEngine as JaxEngine
from dynamo_tpu.engine.model_runner import ModelRunner as JaxRunner
from dynamo_tpu.engine.model_runner import _draft_ring_step as jax_ring_step
from dynamo_tpu.engine.ngram_draft import propose as jax_propose
from dynamo_tpu.engine.sampling import SamplingParams as JaxSampling
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.models.config import get_config as jax_get_config
from dynamo_tpu.runtime.context import Context as JaxContext
from dynamo_tpu_torch.engine import spec_decode
from dynamo_tpu_torch.engine.engine import InferenceEngine
from dynamo_tpu_torch.engine.model_runner import ModelRunner, draft_ring_step
from dynamo_tpu_torch.engine.sampling import SamplingParams
from dynamo_tpu_torch.engine.scheduler import Sequence
from dynamo_tpu_torch.engine.weights import params_from_numpy, serving_bytes
from dynamo_tpu_torch.models.config import get_config
from dynamo_tpu_torch.models.llama import param_bytes
from dynamo_tpu_torch.models.toolkit import kv_pool_bytes
from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.worker import build_runner, parse_args

# one decode and one prefill bucket: each shape the JAX runner compiles
# is compiled once (a speculative variant is one (R, gamma) pair)
GEOMETRY = dict(num_pages=96, page_size=4, max_pages_per_seq=24,
                decode_buckets=(4,), prefill_buckets=(16,))
ENGINE = dict(max_batch=4, chunk_size=16, decode_steps=8)
GAMMA = 3


@pytest.fixture(scope="module")
def trees():
    cfg = jax_get_config("tiny")
    return {name: jax.device_get(jllama.init_params(cfg, jax.random.PRNGKey(seed),
                                                    jnp.float32))
            for name, seed in (("target", 7), ("garbage", 99))}


def _port_runner(trees, draft=None, kv=None):
    cfg = get_config("tiny")
    kw = {}
    if draft is not None:
        kw = dict(draft_config=cfg, spec_gamma=GAMMA,
                  draft_params=params_from_numpy(trees[draft], cfg, "cpu",
                                                 torch.float32))
    return ModelRunner(cfg, device="cpu", dtype=torch.float32, kv_quantize=kv,
                       params=params_from_numpy(trees["target"], cfg, "cpu",
                                                torch.float32),
                       **GEOMETRY, **kw)


def _jax_runner(trees, draft=None, kv=None):
    cfg = jax_get_config("tiny")
    kw = {}
    if draft is not None:
        kw = dict(draft_config=cfg, draft_params=trees[draft], spec_gamma=GAMMA)
    return JaxRunner(cfg, params=trees["target"], dtype=jnp.float32,
                     kv_quantize=kv, **GEOMETRY, **kw)


# -- accept / resample math ----------------------------------------------


def _accept_inputs(rng, B, g, K, V=40):
    t_idx = np.stack([np.stack([rng.permutation(V)[:K] for _ in range(g + 1)])
                      for _ in range(B)]).astype(np.int32)
    t_probs = rng.dirichlet(np.full(K, 0.5), size=(B, g + 1)).astype(np.float32)
    t_probs[::3] = 0.0
    t_probs[::3, :, 0] = 1.0  # greedy rows: one-hot
    d_idx = np.array([[rng.permutation(V)[:K] for _ in range(g)]
                      for _ in range(B)], np.int32).reshape(B, g, K)
    d_probs = rng.dirichlet(np.full(K, 0.5), size=(B, g)).astype(np.float32)
    # half the drafts taken from the target's candidates, half from the
    # draft's own (often outside the target's: a certain rejection)
    pick = rng.integers(0, K, size=(B, g))
    drafts = np.where(rng.random((B, g)) < 0.5,
                      np.take_along_axis(t_idx[:, :g], pick[..., None], 2)[..., 0],
                      np.take_along_axis(d_idx, pick[..., None], 2)[..., 0]
                      ).astype(np.int32)
    q_d = rng.uniform(0.05, 1.0, size=(B, g)).astype(np.float32)
    pair = t_idx[:, :g, :, None] == d_idx[:, :, None, :]
    q_on_t = np.where(pair, d_probs[:, :, None, :], 0.0).sum(-1).astype(np.float32)
    return drafts, q_d, q_on_t, t_idx, t_probs


@pytest.mark.parametrize("g", [0, 1, 3])
def test_accept_and_finalize_matches_jax_on_its_draws(g):
    """Given the reference's uniforms and its final categorical draw on
    the port's residual, the port accepts the same prefixes and emits the
    same tokens; its residuals equal norm(max(p - q, 0)) (p if empty)."""
    rng = np.random.default_rng(g)
    B, K, step = 12, 6, 5
    arrs = _accept_inputs(rng, B, g, K)
    seeds = rng.integers(0, 1 << 31, B).tolist()
    samp = JaxSampling.make(temperature=[1.0] * B, top_k=[0] * B,
                            top_p=[1.0] * B, seeds=seeds)
    want_out, want_n = jspec.accept_and_finalize(*map(jnp.asarray, arrs), samp,
                                                 jnp.int32(step))
    keys = samp.key
    u = jax.vmap(lambda kd: jax.random.uniform(
        jspec._per_row_key(kd, step, jspec._TAG_ACCEPT), (max(g, 1),)))(keys)[:, :g]
    seen = {}

    def draw(resid):
        seen["resid"] = resid.numpy()
        lr = jnp.log(jnp.asarray(resid.numpy()))
        j = jax.vmap(lambda kd, row: jax.random.categorical(
            jspec._per_row_key(kd, step, jspec._TAG_FINAL), row))(keys, lr)
        return torch.tensor(np.asarray(j))

    got_out, got_n = spec_decode.accept_and_finalize(
        *map(torch.tensor, arrs), torch.tensor(np.asarray(u)), draw)
    want_n = np.asarray(want_n)
    np.testing.assert_array_equal(got_n.numpy(), want_n)
    got_out, want_out = got_out.numpy(), np.asarray(want_out)
    for i in range(B):
        np.testing.assert_array_equal(got_out[i, :want_n[i]], want_out[i, :want_n[i]])
    # the residual at each row's first rejected position, in numpy
    drafts, q_d, q_on_t, t_idx, t_probs = arrs
    r = want_n - 1
    p_r = t_probs[np.arange(B), r]
    q_r = np.concatenate([q_on_t, np.zeros((B, 1, K), np.float32)], 1)[np.arange(B), r]
    res = np.maximum(p_r - q_r, 0.0)
    rs = res.sum(-1, keepdims=True)
    res = np.where(rs > 1e-12, res / np.maximum(rs, 1e-30), p_r)
    np.testing.assert_allclose(seen["resid"], res, atol=1e-6)


def test_accept_math_preserves_target_distribution():
    """The port's own draws: the first emitted token follows the target
    distribution p whatever the draft's q (tests/test_spec_decode.py's
    bulk check of the reference)."""
    rng = np.random.default_rng(0)
    B, g, K = 40000, 2, 4
    p = np.asarray([0.55, 0.25, 0.15, 0.05], np.float32)
    q = np.asarray([0.10, 0.20, 0.30, 0.40], np.float32)  # deliberately bad
    drafts = rng.choice(K, size=(B, g), p=q).astype(np.int32)
    samp = SamplingParams.make(temperature=[1.0] * B, top_k=[0] * B,
                               top_p=[1.0] * B,
                               seeds=rng.integers(0, 1 << 31, B).tolist())
    out, counts = spec_decode.accept_rows(
        torch.tensor(drafts), torch.tensor(q[drafts]),
        torch.tensor(np.broadcast_to(q, (B, g, K)).copy()),
        torch.arange(K, dtype=torch.int32).expand(B, g + 1, K),
        torch.tensor(np.broadcast_to(p, (B, g + 1, K)).copy()), samp, 0)
    assert counts.min() >= 1 and counts.max() <= g + 1
    emp = np.bincount(out[:, 0].numpy(), minlength=K) / B
    assert np.abs(emp - p).sum() < 0.02, (emp, p)


# -- spec rounds through the runner ----------------------------------------


def _pool_np(pool):
    if isinstance(pool, dict):
        return {k: np.asarray(v, np.float32) for k, v in pool.items()}
    return np.asarray(pool, np.float32)


def _close_pools(got, want, pages, atol=1e-4):
    if isinstance(want, dict):
        for k in want:
            _close_pools(got[k], want[k], pages, atol)
        return
    g = got.float().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(g[:, pages], np.asarray(want, np.float32)[:, pages],
                               atol=atol)


def test_spec_round_matches_jax(trees):
    """draft_prefill, then one spec_decode_multi round of gamma 3 on two
    greedy rows: the draft pools after the prefill, and the tokens,
    counts and both pool pairs after the round equal the JAX runner's."""
    port, ref = _port_runner(trees, "garbage"), _jax_runner(trees, "garbage")
    prompts = [[3, 1, 4, 1, 5, 9, 2, 6, 5, 3], [2, 7, 1, 8, 2, 8, 1]]
    tables = [[0, 1, 2, 3, 4], [5, 6, 7, 8]]
    for p, t in zip(prompts, tables):
        for r in (port, ref):
            r.prefill(p, 0, t, prior_len=0)
            r.draft_prefill(p, 0, t, prior_len=0)
    pages = sorted(sum(tables, []))
    _close_pools(port.draft_k_pool, ref.draft_k_pool, pages)
    _close_pools(port.draft_v_pool, ref.draft_v_pool, pages)
    samp = {"temperature": [0.0, 0.0], "top_k": [0, 0], "top_p": [1.0, 1.0],
            "seeds": [1, 2]}
    args = (1, [11, 12], [len(p) for p in prompts], tables, samp, 3)
    got_t, got_c = port.spec_decode_multi(*args)
    want_t, want_c = ref.spec_decode_multi(*args)
    np.testing.assert_array_equal(got_c[:2], want_c[:2])
    for i in range(2):
        n = int(want_c[i, 0])
        np.testing.assert_array_equal(got_t[i, 0, :n], want_t[i, 0, :n])
    for a, b in ((port.k_pool, ref.k_pool), (port.v_pool, ref.v_pool),
                 (port.draft_k_pool, ref.draft_k_pool),
                 (port.draft_v_pool, ref.draft_v_pool)):
        _close_pools(a, b, pages)
    assert port.stats["spec_verify_passes"] == 1
    assert port.stats["draft_steps"] == GAMMA + 1
    assert port.stats["draft_prefill_chunks"] == 2


# -- engine streams ----------------------------------------------------------


class _Stepped:
    """Stands in for the engine's step thread: the test steps the engine,
    so every run sees the same plans whatever the timing."""

    def join(self, timeout=None):
        pass


def _reqs():
    prompts = [[3, 1, 4, 1, 5, 9, 2, 6], [2, 7, 1, 8, 2, 8, 1, 8] * 2,
               [5, 5, 5, 5]]
    n_out = [12, 14, 2]  # the last below gamma
    return [{"token_ids": p, "sampling": {"temperature": 0.0},
             "stop": {"max_tokens": n, "stop_ids": []}}
            for p, n in zip(prompts, n_out)]


async def _serve(engine, reqs, ctx_cls, want_error=False):
    engine._thread = _Stepped()

    async def one(req):
        items = []
        async for item in engine.generate(req, ctx_cls()):
            items.append(item)
            if item["finish_reason"]:
                break
        return items

    async def settle():
        for _ in range(4):
            await asyncio.sleep(0)

    try:
        tasks = [asyncio.ensure_future(one(r)) for r in reqs]
        await settle()
        while not all(t.done() for t in tasks):
            engine._loop_once()
            await settle()
        out = [t.result() for t in tasks]
    finally:
        engine.stop()
    if not want_error:
        for items in out:
            assert items[-1]["finish_reason"] in ("length", "stop"), items[-1]
    return out


def _tokens(results):
    return [[t for it in items for t in it["token_ids"]] for items in results]


@pytest.fixture(scope="module")
def jax_runners(trees):
    """One JAX draft runner a pool type, its draft params swapped a test:
    a new engine over it pages from scratch, so the compiled variants are
    shared."""
    return {kv: _jax_runner(trees, "garbage", kv) for kv in (None, "int8")}


@pytest.fixture(scope="module")
def plain_streams(trees):
    return {kv: _tokens(asyncio.run(_serve(
        InferenceEngine(_port_runner(trees, kv=kv), **ENGINE), _reqs(), Context)))
        for kv in (None, "int8")}


@pytest.mark.parametrize("kv", [None, "int8"])
@pytest.mark.parametrize("draft", ["target", "garbage"])
async def test_draft_engine_matches_jax_and_plain(trees, jax_runners, plain_streams,
                                                  kv, draft):
    """A perfect draft (the target's own params) and a garbage one: the
    port's greedy streams equal the JAX engine's and plain decode's; the
    perfect draft is accepted, and every decode went through rounds."""
    reqs = _reqs()
    eng = InferenceEngine(_port_runner(trees, draft, kv), **ENGINE)
    got = _tokens(await _serve(eng, reqs, Context))
    jrun = jax_runners[kv]
    jrun.draft_params = jax.device_put(trees[draft])
    jeng = JaxEngine(jrun, **ENGINE)
    want = _tokens(await _serve(jeng, reqs, JaxContext))
    assert got == want
    assert got == plain_streams[kv]
    assert [len(t) for t in got] == [12, 14, 2]
    st = eng.runner.stats
    assert not eng.fused_mixed
    assert st["spec_verify_passes"] > 0 and st["draft_steps"] > 0
    assert st["draft_prefill_chunks"] == st["prefill_chunks"]
    assert st["ragged_verify_dispatches"] == st["ragged_mixed_dispatches"] == 0
    if draft == "target":
        # all accepted: fewer verify passes than emitted decode tokens
        assert st["spec_verify_passes"] < sum(len(t) for t in got) - len(got)


async def test_draft_engine_sampled_is_deterministic(trees):
    """Sampled rows through the rounds: max_tokens honored, the same
    stream on a second run (draws are functions of seed, step, tag)."""
    req = {"token_ids": [1, 2, 3, 4], "sampling": {"temperature": 0.9, "seed": 11},
           "stop": {"max_tokens": 10, "stop_ids": []}}
    runs = [_tokens(await _serve(InferenceEngine(_port_runner(trees, "garbage"),
                                                 **ENGINE), [req], Context))
            for _ in range(2)]
    assert runs[0] == runs[1] and len(runs[0][0]) == 10


def test_draft_kv_rebuilt_after_host_import(trees):
    """A disaggregated decode admission imports the target's pages from a
    host-staged payload and rebuilds the draft's KV by draft prefill: its
    draft pages equal a colocated prefill's (chunk 16, so two chunks)."""
    prompt = list(range(20, 43))  # 23 tokens; the decode prompt adds one
    src = _port_runner(trees, "garbage")
    table = list(range(6))
    src.prefill(prompt[:16], 0, table, prior_len=0)
    src.prefill(prompt[16:], 16, table, prior_len=16)
    for start in (0, 16):
        src.draft_prefill(prompt[start:start + 16], start, table, prior_len=start)
    payload = src.export_pages(table)
    eng = InferenceEngine(_port_runner(trees, "garbage"), **ENGINE)
    seq = Sequence(request_id="d", prompt=prompt + [7], sampling={},
                   stop={"max_tokens": 4}, kv_import=payload, disagg="decode")
    eng._admit_one_kv(seq, [])
    dst = eng.runner
    assert dst.stats["draft_prefill_chunks"] == 2
    for a, b in ((dst.draft_k_pool, src.draft_k_pool),
                 (dst.draft_v_pool, src.draft_v_pool)):
        np.testing.assert_allclose(a[:, seq.pages[:6]].numpy(), b[:, table].numpy(),
                                   atol=1e-6)
    eng.stop()


async def test_draft_admission_refusals_and_logprobs_fallback(trees):
    """guided and logit_bias requests get the reference's error items on a
    draft worker; a logprobs request decodes plainly (equal to the plain
    engine's tokens and report)."""
    base = {"token_ids": [3, 1, 4, 1, 5], "stop": {"max_tokens": 6, "stop_ids": []}}
    bad = [dict(base, sampling={"temperature": 0.0},
                guided={"kind": "regex", "pattern": "a+"}),
           dict(base, sampling={"temperature": 0.0}, logit_bias=[[5, 10.0]])]
    eng = InferenceEngine(_port_runner(trees, "garbage"), **ENGINE)
    out = await _serve(eng, bad, Context, want_error=True)
    assert out[0] == [{"token_ids": [], "finish_reason": "error", "error":
                       "guided decoding is unsupported on a speculative-decoding worker"}]
    assert out[1] == [{"token_ids": [], "finish_reason": "error",
                       "error": "logit_bias is unsupported on this worker"}]
    lp = [dict(base, sampling={"temperature": 0.0, "logprobs": 2})]
    eng = InferenceEngine(_port_runner(trees, "garbage"), **ENGINE)
    got = await _serve(eng, lp, Context)
    assert eng.runner.stats["spec_verify_passes"] == 0
    plain = await _serve(InferenceEngine(_port_runner(trees), **ENGINE), lp, Context)
    strip = [[{k: v for k, v in it.items() if k != "phases"} for it in r] for r in got]
    assert strip == [[{k: v for k, v in it.items() if k != "phases"} for it in r]
                     for r in plain]


# -- the device draft ring ---------------------------------------------------

SLOTS, W, D, K = 3, 16, 6, 4
_jax_ring = jax.jit(jax_ring_step, static_argnums=(4,))


@settings(max_examples=60, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(st.data())
def test_draft_ring_step_matches_jax(data):
    """Bit for bit against `_draft_ring_step`: random histories (a small
    alphabet, so matches abound), lengths, and deltas that overflow the
    window."""
    hist = np.full((SLOTS, W), -1, np.int32)
    lens = np.zeros(SLOTS, np.int32)
    upd = np.full((SLOTS, D), -1, np.int32)
    n = np.zeros(SLOTS, np.int32)
    for s in range(SLOTS):
        ln = data.draw(st.integers(0, W))
        hist[s, :ln] = data.draw(st.lists(st.integers(0, 4), min_size=ln, max_size=ln))
        lens[s] = ln
        m = data.draw(st.integers(0, D))
        n[s] = m
        upd[s, :m] = data.draw(st.lists(st.integers(0, 4), min_size=m, max_size=m))
    want = _jax_ring(jnp.asarray(hist), jnp.asarray(lens), jnp.asarray(upd),
                     jnp.asarray(n), K)
    got = draft_ring_step(*map(torch.tensor, (hist, lens, upd, n)), K)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_runner_draft_ring_matches_host_propose(trees):
    """The runner's ring (resets, chained deltas, one readback a step)
    proposes what the host scan does within the window."""
    runner = _port_runner(trees)
    cap = runner.ensure_draft_ring(3, 4)
    rng = np.random.default_rng(5)
    hists = [rng.integers(16, 30, size=int(rng.integers(2, 60))).tolist()
             for _ in range(3)]
    for s, h in enumerate(hists):
        runner.draft_ring_reset(s, h)
    drafts, n_prop = runner.draft_step([], 4)
    for _ in range(6):
        for s, h in enumerate(hists):
            assert drafts[s][:int(n_prop[s])].tolist() == jax_propose(h, 4), (s, h)
        upd = []
        for s in range(3):
            d = rng.integers(16, 30, size=int(rng.integers(0, cap + 1))).tolist()
            hists[s].extend(d)
            if d:
                upd.append((s, d))
        drafts, n_prop = runner.draft_step(upd, 4)


# -- worker flags and the fit check -------------------------------------------


def test_worker_flags_and_draft_bytes():
    args = parse_args(["--model", "tiny", "--device", "cpu", "--spec-draft-model",
                       "tiny", "--spec-gamma", "2", "--num-pages", "16"])
    assert args.spec_draft_model == "tiny" and args.spec_gamma == 2
    runner, _ = build_runner(args)
    assert runner.has_draft and runner.spec_gamma == 2
    assert runner.draft_k_pool.shape[1] == 17  # the spare page too
    assert parse_args(["--draft-model", "tiny"]).draft_model == "tiny"
    cfg = get_config("tiny")
    plain = serving_bytes(cfg, 16, 4)
    pools = kv_pool_bytes(cfg, 17, 4, torch.bfloat16)
    assert serving_bytes(cfg, 16, 4, draft_config=cfg) == \
        plain + pools + param_bytes(cfg)
    # a shared draft tree places no params of its own
    assert serving_bytes(cfg, 16, 4, draft_config=cfg, draft_params={}) == plain + pools
    with pytest.raises(ValueError, match="vocabulary"):
        ModelRunner(cfg, device="cpu", num_pages=8, page_size=4,
                    draft_config=cfg.with_(vocab_size=cfg.vocab_size + 1))
