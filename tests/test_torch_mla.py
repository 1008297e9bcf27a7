"""The port's MLA path (DeepSeek multi-head latent attention) against the
JAX package.

Inputs are numpy arrays from a seed. Held to the reference, in f32:
- yarn RoPE (inverse frequencies, cos/sin magnitude) and the attention
  score scale at DeepSeek-V3's rope fields and at fields whose mscale is
  not 1 (atol 1e-6: the same f32 products, cos/sin of angles under 64);
- the latent pool's shapes;
- the plain decode and prefill MLA ops against the Pallas kernels in
  interpret mode (atol/rtol 1e-5), padding rows and empty rows included;
- `llama.forward` logits (atol 1e-4, a 64-wide residual stream) and the
  written latent pool (atol 1e-5) on tiny-mla, tiny-mla-q and a yarn
  variant, on both attention paths, against forward(attn_impl="jnp");
- greedy engine streams with the fused mixed dispatch on (the padded
  fallback: MLA has no ragged path), token for token;
- the wire format (v2) both ways with a JAX runner, bf16 and f32, and the
  device transfer between two of the port's runners.
MoE configs and `ragged=` on MLA raise NotImplementedError. The CUDA
kernels are held against the plain ops on the card by chip_smoke.py.
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
from dynamo_tpu.models import toolkit as jtk
from dynamo_tpu.models.config import get_config as jax_get_config
from dynamo_tpu.ops import mla_attention as jmla
from dynamo_tpu.runtime.context import Context as JaxContext
from dynamo_tpu_torch.engine.engine import InferenceEngine
from dynamo_tpu_torch.engine.model_runner import ModelRunner
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.models import llama
from dynamo_tpu_torch.models import toolkit as tk
from dynamo_tpu_torch.models.config import get_config
from dynamo_tpu_torch.ops import block_copy as bc
from dynamo_tpu_torch.ops import mla_attention as mla
from dynamo_tpu_torch.runtime.context import Context

# yarn fields where both magnitudes differ from 1: cos/sin scale by
# mscale(4, 1) / mscale(4, 0.5) and the score scale by mscale(4, 0.5)^2
YARN = dict(rope_scaling="yarn", rope_factor=4.0, rope_orig_max_seq=64,
            rope_beta_fast=32.0, rope_beta_slow=1.0, rope_mscale=1.0,
            rope_mscale_all_dim=0.5)
CONFIGS = {"tiny-mla": {}, "tiny-mla-q": {}, "tiny-mla-yarn": YARN}


def _configs(name):
    base = "tiny-mla" if name == "tiny-mla-yarn" else name
    return (jax_get_config(base).with_(**CONFIGS[name]),
            get_config(base).with_(**CONFIGS[name]))


@pytest.fixture(scope="module")
def jparams():
    """The JAX init tree of each config in f32, as numpy."""
    return {name: jax.device_get(jllama.init_params(
        _configs(name)[0], jax.random.PRNGKey(5), jnp.float32))
        for name in CONFIGS}


# -- (a) yarn rope and the score scale ---------------------------------------
@pytest.mark.parametrize("fields", [
    "deepseek-v3", dict(YARN, rope_theta=10000.0), dict(YARN, rope_mscale=0.0)])
def test_yarn_rope_matches_jax(fields):
    if fields == "deepseek-v3":
        jcfg, cfg = jax_get_config(fields), get_config(fields)
    else:
        jcfg = jax_get_config("tiny-mla").with_(**fields)
        cfg = get_config("tiny-mla").with_(**fields)
    hd = 64
    np.testing.assert_array_equal(
        tk.rope_inv_freq_np(cfg, hd, cfg.rope_theta),
        np.asarray(jtk.rope_inv_freq(jcfg, hd, jcfg.rope_theta)))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 3, hd)).astype(np.float32)
    pos = rng.integers(0, 64, size=(2, 5)).astype(np.int32)
    want = np.asarray(jtk.rope(jnp.asarray(x), jnp.asarray(pos),
                               jcfg.rope_theta, config=jcfg))
    got = tk.rope(torch.from_numpy(x), torch.from_numpy(pos), cfg.rope_theta,
                  config=cfg).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    for qk in (192, 48):
        assert tk.attn_score_scale(cfg, qk) == jtk.attn_score_scale(jcfg, qk)
    m = tk.rope_mscale(cfg)
    if fields == "deepseek-v3":
        # mscale(40, 1) / mscale(40, 1); the score scale carries mscale^2
        assert m == 1.0
        want_scale = 192 ** -0.5 * (0.1 * np.log(40.0) + 1.0) ** 2
        assert tk.attn_score_scale(cfg, 192) == pytest.approx(want_scale, rel=1e-12)
    else:
        assert m != 1.0


# -- (b) the latent pool -----------------------------------------------------
@pytest.mark.parametrize("name", ["tiny-mla", "deepseek-v3"])
def test_make_kv_pool_shapes(name):
    cfg, jcfg = get_config(name).with_(n_layers=2), jax_get_config(name).with_(n_layers=2)
    jk, jv = jtk.make_kv_pool(jcfg, 8, 4, jnp.float32)
    k, v = tk.make_kv_pool(cfg, 9, 4, torch.float32, "cpu")  # + the spare page
    assert k.shape == (2, 9, 4, 1, cfg.mla_cache_dim)
    assert v.shape == (2, 9, 4, 1, 1)
    assert (k.shape[0],) + k.shape[2:] == (jk.shape[0],) + jk.shape[2:]
    assert (v.shape[0],) + v.shape[2:] == (jv.shape[0],) + jv.shape[2:]


# -- (c, d) the plain ops against the Pallas kernels -------------------------
def _mla_setup(B=3, H=4, dc=32, dr=16, NP=32, PS=4, MP=6, seed=3):
    rng = np.random.default_rng(seed)
    Dl = dc + dr
    q = rng.standard_normal((B, H, Dl)).astype(np.float32)
    lat = rng.standard_normal((NP, PS, 1, Dl)).astype(np.float32)
    pt = rng.permutation(NP)[: B * MP].reshape(B, MP).astype(np.int32)
    return q, lat, pt


@pytest.mark.parametrize("kv_lens", [[1, 9, 24], [4, 4, 4], [24, 1, 13],
                                     [0, 7, 24]])
def test_decode_mla_ref_matches_pallas(kv_lens):
    dc, dr = 32, 16
    q, lat, pt = _mla_setup(dc=dc, dr=dr)
    kv = np.asarray(kv_lens, np.int32)
    scale = (24 + dr) ** -0.5  # distinct from Dl ** -0.5: must be honoured
    want = np.asarray(jmla.decode_mla_attention(
        jnp.asarray(q), jnp.asarray(lat), jnp.asarray(pt), jnp.asarray(kv),
        dc=dc, scale=scale, interpret=True))
    t = torch.from_numpy
    got = mla.decode_mla_attention(t(q), t(lat), t(pt), t(kv), dc=dc, scale=scale)
    assert got.shape == (3, 4, dc)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    for b, n in enumerate(kv_lens):
        if n == 0:
            assert not got[b].any()


@pytest.mark.parametrize(
    "q_start,q_len,kv_extra",
    [([0, 0], [8, 5], [0, 0]),        # fresh prefill, one padded row
     ([12, 4], [8, 8], [0, 0]),       # chunked prefill (prior context)
     ([0, 16], [8, 8], [0, 3]),       # prior context + kv past the chunk
     ([5, 0], [3, 0], [0, 0])],       # an all-padding row
)
def test_prefill_mla_ref_matches_pallas(q_start, q_len, kv_extra):
    rng = np.random.default_rng(7)
    B, S, H, dc, dr, NP, PS, MP = 2, 8, 4, 32, 16, 32, 4, 8
    Dl = dc + dr
    q = rng.standard_normal((B, S, H, Dl)).astype(np.float32)
    lat = rng.standard_normal((NP, PS, 1, Dl)).astype(np.float32)
    pt = rng.permutation(NP)[: B * MP].reshape(B, MP).astype(np.int32)
    qs, ql = np.asarray(q_start, np.int32), np.asarray(q_len, np.int32)
    kv = qs + ql + np.asarray(kv_extra, np.int32)
    scale = 0.13
    want = np.asarray(jmla.prefill_mla_attention(
        jnp.asarray(q), jnp.asarray(lat), jnp.asarray(pt), jnp.asarray(qs),
        jnp.asarray(ql), jnp.asarray(kv), dc=dc, scale=scale, q_block=4,
        interpret=True))
    t = torch.from_numpy
    got = mla.prefill_mla_attention(t(q), t(lat), t(pt), t(qs), t(ql), t(kv),
                                    dc=dc, scale=scale).numpy()
    assert got.shape == (B, S, H, dc)
    for b in range(B):
        np.testing.assert_allclose(got[b, :ql[b]], want[b, :ql[b]],
                                   atol=1e-5, rtol=1e-5)
        assert np.all(got[b, ql[b]:] == 0.0)
        assert np.all(want[b, ql[b]:] == 0.0)


def test_kernel_operand_checks():
    """What the wrappers refuse before a launch (the same checks run on
    CUDA tensors)."""
    q = torch.zeros(2, 16, 576, dtype=torch.bfloat16)
    lat = torch.zeros(5, 16, 1, 576, dtype=torch.bfloat16)
    ints = (torch.zeros(2, 4, dtype=torch.int32), torch.zeros(2, dtype=torch.int32))
    assert mla._check(q, lat, ints, 512) == 64
    with pytest.raises(ValueError, match="no MLA kernel"):
        mla._check(q[..., :560], lat[..., :560], ints, 512)  # d_rh 48
    with pytest.raises(ValueError, match="no MLA kernel"):
        mla._check(q[:, :8].contiguous(), lat, ints, 512)  # 8 heads
    with pytest.raises(ValueError, match="latent pool"):
        mla._check(q, lat[..., :512], ints, 512)
    with pytest.raises(TypeError):
        mla._check(q.float(), lat, ints, 512)
    with pytest.raises(TypeError):
        mla._check(q, lat, (ints[0].long(), ints[1]), 512)
    with pytest.raises(ValueError, match="batch"):
        mla._check(q, lat, (ints[0][:1], ints[1]), 512)
    with pytest.raises(ValueError, match="batch"):
        mla._check(q, lat, (ints[0], ints[1], ints[1][:1]), 512)
    with pytest.raises(ValueError, match="contiguous"):
        mla._check(q.transpose(0, 1).contiguous().transpose(0, 1), lat, ints, 512)


# -- (e) the forward ---------------------------------------------------------
NP, PS, MP = 16, 4, 8
PAGES = np.array([[3, 7, 1, 12, 9, 0, 0, 0],
                  [5, 2, 14, 8, 11, 6, 4, 0],
                  [0, 0, 0, 0, 0, 0, 0, 0]], np.int32)


def _steps(rng, V):
    """A two-sequence prefill (one padded), a second chunk over that prior
    context with per-row last positions, and two decode steps with a
    padding row: (tokens, positions, page rows, kv_lens, last_index)."""
    steps = []
    pos = np.full((2, 16), -1, np.int32)
    pos[0, :10] = np.arange(10)
    pos[1, :16] = np.arange(16)
    steps.append((pos, [0, 1], [10, 16], None))
    pos = np.full((2, 8), -1, np.int32)
    pos[0, :5] = np.arange(10, 15)
    pos[1, :8] = np.arange(16, 24)
    steps.append((pos, [0, 1], [15, 24], np.array([4, 7], np.int32)))
    for t in range(2):
        pos = np.array([[15 + t], [24 + t], [-1]], np.int32)
        steps.append((pos, [0, 1, 2], [16 + t, 25 + t, 0], None))
    out = []
    for pos, rows, kvl, last in steps:
        tok = rng.integers(0, V, size=pos.shape).astype(np.int32)
        out.append((tok, pos, PAGES[rows], np.asarray(kvl, np.int32), last))
    return out


@pytest.mark.parametrize("attn_impl", ["kernel", "ref"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_forward_matches_jax(jparams, name, attn_impl):
    jcfg, cfg = _configs(name)
    tparams = params_from_numpy(jparams[name], cfg, "cpu", torch.float32)
    jk, jv = jllama.make_kv_pool(jcfg, NP, PS, jnp.float32)
    tk_, tv_ = tk.make_kv_pool(cfg, NP + 1, PS, torch.float32, "cpu")
    t = torch.from_numpy
    for tok, pos, pt, kvl, last in _steps(np.random.default_rng(0), cfg.vocab_size):
        jl, jk, jv = jllama.forward(
            jcfg, jparams[name], jnp.asarray(tok), jnp.asarray(pos), jk, jv,
            jnp.asarray(pt), jnp.asarray(kvl),
            None if last is None else jnp.asarray(last), attn_impl="jnp")
        tl = llama.forward(cfg, tparams, t(tok), t(pos), tk_, tv_, t(pt), t(kvl),
                           None if last is None else t(last), attn_impl=attn_impl)
        jl, tl = np.asarray(jl), tl.numpy()
        assert tl.shape == jl.shape and tl.dtype == np.float32
        # padding rows differ by design (the reference's gather path
        # attends them to position 0, the port's prefill op zeroes them)
        real = pos >= 0 if last is None else np.ones((pos.shape[0], 1), bool)
        if pos.shape[1] == 1:
            real = np.ones_like(real)
        np.testing.assert_allclose(tl[real], jl[real], atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(tk_[:, :NP].numpy(), np.asarray(jk), atol=1e-5, rtol=1e-5)
    assert tk_[:, :NP].abs().sum() > 0, "the steps must have written latents"
    assert not tv_.any() and not np.asarray(jv).any()  # the stub stays 0


# -- (f) the engine ----------------------------------------------------------
GEOMETRY = dict(num_pages=96, page_size=4, max_pages_per_seq=16,
                decode_buckets=(1, 2, 4, 8), prefill_buckets=(8, 16))
ENGINE = dict(max_batch=6, chunk_size=8, mixed_prefill_tokens=8,
              mixed_prefill_seqs=4, mixed_min_chunk=2)


class _Stepped:
    """Stands in for the engine's step thread: the test steps the engine
    itself, so both engines see the same plans whatever the timing."""

    def join(self, timeout=None):
        pass


async def _serve(engine, reqs, ctx_cls):
    """The first request is prefilled alone; the rest arrive right after,
    so their chunks pack beside a live decode row; then a request that
    shares the first prompt's first 12 tokens (a prefix-cache hit)."""
    engine._thread = _Stepped()

    async def one(req):
        toks = []
        async for item in engine.generate(req, ctx_cls()):
            assert item.get("finish_reason") != "error", item
            toks.extend(item["token_ids"])
            if item["finish_reason"]:
                break
        return toks

    async def run(batch):
        tasks = [asyncio.ensure_future(one(batch[0]))]
        for _ in range(4):
            await asyncio.sleep(0)
        engine._loop_once()
        tasks += [asyncio.ensure_future(one(r)) for r in batch[1:]]
        while not all(t.done() for t in tasks):
            for _ in range(4):
                await asyncio.sleep(0)
            engine._loop_once()
        return [t.result() for t in tasks]

    try:
        out = await run(reqs[:-1])
        before = engine.scheduler.reused_prefix_tokens
        out += await run(reqs[-1:])
        return out, engine.scheduler.reused_prefix_tokens - before
    finally:
        engine.stop()


async def test_fused_engine_matches_jax(jparams, monkeypatch):
    monkeypatch.setenv("DYN_FUSED_MIXED", "1")
    jcfg, cfg = _configs("tiny-mla")
    rng = np.random.default_rng(9)
    prompts = [rng.integers(1, 500, size=n).tolist() for n in (6, 19, 9, 5, 13)]
    prompts.append(prompts[1][:12] + [3, 1, 4])
    reqs = [{"token_ids": p, "sampling": {"temperature": 0.0},
             "stop": {"max_tokens": 8 if i == 0 else 5, "stop_ids": []}}
            for i, p in enumerate(prompts)]
    jrun = JaxRunner(jcfg, params=jparams["tiny-mla"], dtype=jnp.float32, **GEOMETRY)
    trun = ModelRunner(cfg, device="cpu", dtype=torch.float32,
                       params=params_from_numpy(jparams["tiny-mla"], cfg, "cpu",
                                                torch.float32), **GEOMETRY)
    assert not trun.ragged_mixed and not jrun.ragged_mixed
    jres, jhit = await _serve(JaxEngine(jrun, **ENGINE), reqs, JaxContext)
    teng = InferenceEngine(trun, **ENGINE)
    assert teng.fused_mixed
    tres, thit = await _serve(teng, reqs, Context)
    assert tres == jres
    assert [len(t) for t in tres] == [r["stop"]["max_tokens"] for r in reqs]
    assert thit == jhit >= 12
    st = trun.stats
    assert st["padded_prefill_dispatches"] > 0 and st["ragged_mixed_dispatches"] == 0
    assert st["mixed_chunks"] > st["padded_prefill_dispatches"]  # packed plans
    assert st["prefill_chunks"] > 0 and st["decode_steps"] > 0


def test_runner_turns_ragged_off_for_mla(monkeypatch):
    monkeypatch.setenv("DYN_RAGGED_MIXED", "1")
    run = ModelRunner(get_config("tiny-mla"), device="cpu", dtype=torch.float32,
                      **GEOMETRY)
    assert not run.ragged_mixed
    assert run.kv_page_shape == (2, 4, 1, 48)
    assert run.v_pool.shape == (2, GEOMETRY["num_pages"] + 1, 4, 1, 1)
    assert ModelRunner(get_config("tiny"), device="cpu", dtype=torch.float32,
                       **GEOMETRY).ragged_mixed


# -- (g) what is refused -----------------------------------------------------
def test_moe_and_ragged_mla_are_refused():
    moe = get_config("tiny-mla-moe")
    with pytest.raises(NotImplementedError, match="A.9"):
        llama.init_params(moe, 0, torch.float32, "cpu")
    with pytest.raises(NotImplementedError, match="A.9"):
        llama.init_params(get_config("deepseek-v3"), 0, torch.float32, "cpu")
    cfg = get_config("tiny-mla")
    params = llama.init_params(cfg, 0, torch.float32, "cpu")
    k, v = tk.make_kv_pool(cfg, 9, 4, torch.float32, "cpu")
    tok = torch.zeros(1, 4, dtype=torch.int32)
    pos = torch.arange(4, dtype=torch.int32)[None]
    with pytest.raises(NotImplementedError, match="A.9"):
        llama.forward(moe, params, tok, pos, k, v, torch.zeros(1, 2, dtype=torch.int32),
                      torch.tensor([4], dtype=torch.int32))
    ragged = (torch.zeros(1, 2, dtype=torch.int32), torch.tensor([4], dtype=torch.int32),
              torch.zeros(5, 1, dtype=torch.int32))
    with pytest.raises(NotImplementedError, match="MLA"):
        llama.forward(cfg, params, tok, pos, k, v, ragged=ragged)


def test_init_params_tree_matches_jax():
    for name in ("tiny-mla", "tiny-mla-q"):
        jtree = jax.eval_shape(lambda: jllama.init_params(
            jax_get_config(name), jax.random.PRNGKey(0), jnp.float32))
        tree = llama.init_params(get_config(name), 0, torch.float32, "cpu")
        assert sorted(tree) == sorted(jtree)
        assert sorted(tree["layers"]) == sorted(jtree["layers"])
        for key, leaf in tree["layers"].items():
            assert tuple(leaf.shape) == jtree["layers"][key].shape, key
        assert tree["layers"]["kv_norm"].dtype == torch.float32


# -- satellite: MLA pages on the wire and through the copy ops ---------------
WIRE = dict(num_pages=32, page_size=4, max_pages_per_seq=16,
            decode_buckets=(1, 2, 4), prefill_buckets=(8, 16, 32))
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
PROMPT = list(np.random.default_rng(0).integers(1, 500, size=14))
SRC, DST = [3, 7, 1, 9], [5, 0, 2, 8]


def _wire_runners(name):
    jdt, tdt = DTYPES[name]
    cfg, jcfg = get_config("tiny-mla"), jax_get_config("tiny-mla")
    jp = jax.device_get(jllama.init_params(jcfg, jax.random.PRNGKey(0), jdt))
    jrun = JaxRunner(jcfg, params=jp, dtype=jdt, **WIRE)
    trun = ModelRunner(cfg, device="cpu", dtype=tdt,
                       params=params_from_numpy(jp, cfg, "cpu", tdt), **WIRE)
    return jrun, trun


def _pages(pool, pages):
    if isinstance(pool, torch.Tensor):
        return pool[:, pages].float().numpy()
    return np.asarray(jax.device_get(pool))[:, pages].astype(np.float32)


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_mla_wire_interop_both_ways(name):
    jrun, trun = _wire_runners(name)
    ids = [int(t) for t in PROMPT]
    # JAX -> port
    jrun.prefill(ids, 0, SRC, 0)
    payload = jrun.export_pages(SRC)
    assert payload["shape"][-1] == 48 and payload["v_shape"][-1] == 1
    assert payload["dtype"] == name
    trun.import_pages(DST, 0, payload)
    want = _pages(jrun.k_pool, SRC)
    assert np.abs(want).sum() > 0
    np.testing.assert_array_equal(_pages(trun.k_pool, DST), want)
    np.testing.assert_array_equal(_pages(trun.v_pool, DST), _pages(jrun.v_pool, SRC))
    # port -> JAX: the port's own prefill, exported and imported there; the
    # JAX runner's export of what it imported is the same payload
    _, trun2 = _wire_runners(name)
    trun2.prefill(ids, 0, SRC, 0)
    out = trun2.export_pages(SRC)
    jrun.import_pages([20, 21, 22, 23], 0, out)
    np.testing.assert_array_equal(_pages(jrun.k_pool, [20, 21, 22, 23]),
                                  _pages(trun2.k_pool, SRC))
    back = jrun.export_pages([20, 21, 22, 23])
    assert {k: v for k, v in back.items() if k not in ("k", "v")} == \
        {k: v for k, v in out.items() if k not in ("k", "v")}
    assert back["k"] == out["k"] and back["v"] == out["v"]
    # layer-streamed import of the same payload lands the same bytes
    trun.import_pages([10, 11, 12, 13], 0, out, layer_groups=2)
    assert torch.equal(trun.k_pool[:, [10, 11, 12, 13]], trun2.k_pool[:, SRC])
    assert trun.stats["kv_layer_group_scatters"] == 2


def test_mla_device_transfer_between_runners():
    _, p = _wire_runners("bfloat16")
    _, d = _wire_runners("bfloat16")
    p.prefill([int(t) for t in PROMPT], 0, SRC, 0)
    k, v = p.export_pages_device(SRC)
    assert k.shape == (2, 4, 4, 1, 48) and v.shape == (2, 4, 4, 1, 1)
    d.import_pages_device([30, 31, 0], 1, k, v)
    assert torch.equal(d.k_pool[:, [30, 31, 0]], p.k_pool[:, SRC[1:]])
    assert torch.equal(d.v_pool[:, [30, 31, 0]], p.v_pool[:, SRC[1:]])


def test_copy_checks_take_mla_pages():
    """The stub pool's 2-byte rows pass where the copy moves whole pages
    (a 32-byte page) and are refused where it would split rows; the
    latent's 1152-byte rows pass everywhere."""
    idx = torch.tensor([1, 3], dtype=torch.int32)
    stub = torch.zeros(2, 5, 16, 1, 1, dtype=torch.bfloat16)
    bc._check(stub, idx, whole_pages=True)
    with pytest.raises(ValueError, match="16-byte"):
        bc._check(stub, idx)
    with pytest.raises(ValueError, match="pages of"):
        bc._check(torch.zeros(2, 5, 3, 1, 1, dtype=torch.bfloat16), idx,
                  whole_pages=True)  # a 6-byte page
    bc._check(torch.zeros(2, 5, 16, 1, 576, dtype=torch.bfloat16), idx)
    # the plain copies carry the stub and the latent unchanged
    lat = torch.randn(2, 5, 16, 1, 576).bfloat16()
    for pool in (stub.normal_(), lat):
        for head_major in (False, True):
            got = bc.gather_pages(pool, idx, head_major=head_major)
            assert torch.equal(got.reshape(2, 2, -1), pool[:, [1, 3]].reshape(2, 2, -1))
