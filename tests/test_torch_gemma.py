"""Gemma-2 in the port against the JAX package: the window, soft-cap and
scale bodies of the three GQA attention ops, the tiny-gemma2 forward and
the engine's greedy streams.

Inputs are made with numpy from a seed and handed to both sides. The JAX
side runs the Pallas kernels in interpret mode on the CPU, as
tests/test_ops.py does; the port's wrappers, given CPU tensors, run their
plain PyTorch versions (the CUDA kernels run only on the card, where
chip_smoke.py holds them against these same plain versions). The ops are
f32 at atol = rtol = 1e-5 (the same f32 math summed in another order);
the forward's logits at 1e-4 and its KV pools at 1e-5, as
tests/test_torch_model.py. Contexts run past the windows: 7 and 9 tokens
over 4-token pages for the ops, 8 tokens for tiny-gemma2.
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
from dynamo_tpu.ops import ragged_paged_attention as jrag
from dynamo_tpu.ops.flash_prefill import prefill_paged_attention as jax_prefill
from dynamo_tpu.ops.paged_attention import decode_paged_attention as jax_decode
from dynamo_tpu.runtime.context import Context as JaxContext
from dynamo_tpu_torch.engine.engine import InferenceEngine
from dynamo_tpu_torch.engine.model_runner import ModelRunner
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.models import llama
from dynamo_tpu_torch.models.config import get_config
from dynamo_tpu_torch.models.toolkit import (
    NEG_INF,
    gqa_score_scale,
    layer_window,
    make_kv_pool,
    rms_norm,
)
from dynamo_tpu_torch.ops import paged_attention as pa
from dynamo_tpu_torch.ops import ragged_paged_attention as rag
from dynamo_tpu_torch.ops.flash_prefill import prefill_paged_attention
from dynamo_tpu_torch.runtime.context import Context

TOL = dict(atol=1e-5, rtol=1e-5)

# (softcap, window, scale): tests/test_ops.py's Gemma-2 decode cases, and a
# scale override alone
VARIANTS = {
    "softcap": (50.0, None, None),
    "window": (0.0, 7, None),
    "gemma2": (30.0, 9, 0.35 ** -0.5),
    "window_0": (0.0, 0, None),
    "scale": (0.0, None, 0.2),
}


def _jwin(window):
    return None if window is None else jnp.int32(window)


def _q(rng, shape):
    """Queries whose scores q . k have the spread of the D 16 cases at every
    D (std 4 over unit keys): at D 256 unit queries give scores of std 16,
    27 after the gemma2 case's scale, where the f32 sums' rounding, not the
    arithmetic under test, passes 1e-5 after the exponential."""
    return (rng.standard_normal(shape) * (16 / shape[-1]) ** 0.5).astype(np.float32)


def _pools(rng, NP, PS, Hk, D):
    return (rng.standard_normal((NP, PS, Hk, D)).astype(np.float32),
            rng.standard_normal((NP, PS, Hk, D)).astype(np.float32))


def _table(rng, B, MP):
    NP = B * MP + 1
    return NP, rng.permutation(NP)[: B * MP].reshape(B, MP).astype(np.int32)


# -- decode ------------------------------------------------------------------


def _decode_case(D, seed, kv, PS=4, MP=6):
    rng = np.random.default_rng(seed)
    kv = np.asarray(kv, np.int32)
    B, Hk, G = len(kv), 2, 2
    NP, pt = _table(rng, B, MP)
    q = _q(rng, (B, Hk, G, D))
    kp, vp = _pools(rng, NP, PS, Hk, D)
    return q, kp, vp, pt, kv


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("D", [16, 256])
def test_decode_variants_match_jax(variant, D):
    softcap, window, scale = VARIANTS[variant]
    # rows: past the window across pages, at it, inside it, empty
    args = _decode_case(D, 1, [17, 9, 5, 0, 24])
    ref = np.asarray(jax_decode(*map(jnp.asarray, args), _jwin(window),
                                scale=scale, softcap=softcap, interpret=True))
    t = [torch.from_numpy(a) for a in args]
    before = pa.decode_paged_attention.launches
    out = pa.decode_paged_attention(*t, window, scale=scale, softcap=softcap)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    assert np.all(out[3].numpy() == 0.0)  # kv_len 0: exactly 0
    assert pa.decode_paged_attention.launches == before  # plain on the CPU
    # the kernel's split arithmetic: 8-token splits, so the window crosses
    # split edges and the first splits of the long rows lie wholly below it
    m, l, o = pa.decode_split_partials_ref(*t, scale, 8, softcap=softcap,
                                           window=window)
    np.testing.assert_allclose(pa.merge_split_partials_ref(m, l, o).numpy(),
                               ref, **TOL)
    if window:
        # row 0 (kv 17, window 7 or 9) sees nothing in split 0 (0..7)
        assert torch.all(m[0, 0] == NEG_INF) and torch.all(l[0, 0] == 0)
        assert torch.all(o[0, 0] == 0)


def test_decode_window_rule():
    """The query at kv_len - 1 sees exactly [kv_len - w, kv_len): a V pool
    that is 1 at the window's positions and 100 below it gives 1."""
    q, kp, vp, pt, kv = _decode_case(16, 2, [17, 7, 3], PS=4, MP=6)
    w = 7
    v = np.full_like(vp, 100.0)
    for b, n in enumerate(kv):
        for c in range(max(n - w, 0), n):
            v[pt[b, c // 4], c % 4] = 1.0
    t = torch.from_numpy
    out = pa.decode_paged_attention(t(q), t(kp), t(v), t(pt), t(kv), w)
    np.testing.assert_allclose(out.numpy(), 1.0, atol=1e-6)


# -- prefill -----------------------------------------------------------------


def _prefill_case(D, seed, PS=4, MP=8):
    rng = np.random.default_rng(seed)
    B, S, Hk, G = 2, 16, 2, 2
    NP, pt = _table(rng, B, MP)
    q = _q(rng, (B, S, Hk, G, D))
    kp, vp = _pools(rng, NP, PS, Hk, D)
    # row 0: a chunk over 13 prior tokens (rows run past the window);
    # row 1: a fresh 11-token prefill, padding after
    q_start = np.asarray([13, 0], np.int32)
    q_len = np.asarray([16, 11], np.int32)
    kv = q_start + q_len
    return q, kp, vp, pt, q_start, q_len, kv


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("D", [16, 256])
def test_prefill_variants_match_jax(variant, D):
    softcap, window, scale = VARIANTS[variant]
    args = _prefill_case(D, 3)
    ref = np.asarray(jax_prefill(*map(jnp.asarray, args), _jwin(window),
                                 scale=scale, softcap=softcap, interpret=True))
    t = [torch.from_numpy(a) for a in args]
    out = prefill_paged_attention(*t, window, scale=scale,
                                  softcap=softcap).numpy()
    np.testing.assert_allclose(out[0], ref[0], **TOL)
    np.testing.assert_allclose(out[1, :11], ref[1, :11], **TOL)
    assert np.all(out[1, 11:] == 0.0)  # padding rows


# -- ragged ------------------------------------------------------------------

# (q_lens, q_starts, kv_lens, t_bucket) over 4-token pages: decode rows
# past the window, a chunk over prior context, a fresh chunk, a tail
RAGGED_SMALL = ([1, 1, 9, 6], [16, 3, 12, 0], [17, 4, 21, 6], 24)
# over 64-token pages: rows whose window lies wholly in the last of the
# kernel's SPLIT_TOKENS splits, a chunk straddling a split edge
L_S = rag.SPLIT_TOKENS
RAGGED_SPLITS = ([1, 8, 1], [2 * L_S + 40, L_S - 3, 300],
                 [2 * L_S + 41, L_S + 5, 301], 16)


def _ragged_case(layout, D, seed, PS, MP):
    q_lens, q_starts, kv_lens, tb = layout
    rng = np.random.default_rng(seed)
    NP = len(q_lens) * MP + 1
    perm = rng.permutation(NP)
    rows = [perm[i * MP:(i + 1) * MP].astype(np.int32).tolist()
            for i in range(len(q_lens))]
    md = rag.build_ragged_metadata(q_lens, q_starts, kv_lens, rows, tb,
                                   max_pages=MP)
    Hk, G = 2, 2
    q = _q(rng, (tb, Hk, G, D))
    kp, vp = _pools(rng, NP, PS, Hk, D)
    ops = [md[k] for k in ("seg_page_table", "seg_kv_lens", "meta")]
    return (q, kp, vp, *ops), sum(q_lens)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("layout,D,PS,MP", [
    ("small", 16, 4, 6), ("small", 256, 4, 6), ("splits", 16, 64, 18)])
def test_ragged_variants_match_jax(variant, layout, D, PS, MP):
    softcap, window, scale = VARIANTS[variant]
    if layout == "splits" and window:
        window = 4 * window  # 28 or 36 tokens
    lay = RAGGED_SMALL if layout == "small" else RAGGED_SPLITS
    args, n = _ragged_case(lay, D, 4, PS, MP)
    ref = np.asarray(jrag.ragged_paged_attention(
        *map(jnp.asarray, args), _jwin(window), scale=scale, softcap=softcap,
        interpret=True))
    t = [torch.from_numpy(a) for a in args]
    kw = dict(scale=scale, softcap=softcap)
    out = rag.ragged_paged_attention(*t, window, **kw).numpy()
    np.testing.assert_allclose(out, ref, **TOL)
    assert np.all(out[n:] == 0.0)  # tail rows
    m, l, o = rag.ragged_split_partials_ref(*t, window, **kw)
    np.testing.assert_allclose(rag.merge_split_partials_ref(m, l, o).numpy(),
                               ref, **TOL)
    if layout == "splits" and window:
        # the first decode row (position 2 L_S + 40) sees nothing in
        # splits 0 and 1: their partials are empty
        assert torch.all(m[:2, 0] == NEG_INF) and torch.all(l[:2, 0] == 0)
        assert torch.all(l[2, 0] > 0)


def test_wrappers_take_only_a_python_int_window():
    args = [torch.from_numpy(a) for a in _decode_case(16, 5, [3])]
    with pytest.raises(TypeError, match="window"):
        pa.decode_paged_attention(*args, torch.tensor(4))
    # a negative window is global, as in the reference
    a = pa.decode_paged_attention(*args, -3)
    b = pa.decode_paged_attention(*args)
    torch.testing.assert_close(a, b, atol=0, rtol=0)


# -- model -------------------------------------------------------------------

NP, PS, MP = 32, 4, 10
# three sequences' page rows: 40 tokens each, on distinct pages
WIN_PAGES = np.random.default_rng(0).permutation(NP)[:3 * MP].reshape(
    3, MP).astype(np.int32)


def test_layer_window_and_scale():
    c = get_config("gemma-2-9b")
    assert [layer_window(c, l) for l in range(4)] == [4096, 0, 4096, 0]
    assert layer_window(c.with_(sw_period=1), 1) == 4096  # Mistral
    assert layer_window(get_config("llama-3.2-3b"), 0) == 0
    assert gqa_score_scale(c) == 256.0 ** -0.5
    assert gqa_score_scale(get_config("tiny")) is None
    assert c.head_dim == 256 and c.n_heads // c.n_kv_heads == 2


def test_zero_centered_norm():
    x = torch.randn(3, 8)
    w = torch.randn(8)
    torch.testing.assert_close(rms_norm(x, w, 1e-6, zero_centered=True),
                               rms_norm(x, w + 1.0, 1e-6))


def _model_steps(rng, V):
    """Chunked prefill past the window of 8, a second chunk over prior
    context with padding rows, and decode steps past the window."""
    steps = []
    pos = np.full((2, 16), -1, np.int32)
    pos[0, :12] = np.arange(12)
    pos[1, :16] = np.arange(16)
    steps.append((pos, [0, 1], [12, 16], None))
    pos = np.full((2, 16), -1, np.int32)
    pos[0, :9] = np.arange(12, 21)
    pos[1, :16] = np.arange(16, 32)
    steps.append((pos, [0, 1], [21, 32], np.array([8, 15], np.int32)))
    for t in range(2):
        pos = np.array([[21 + t], [32 + t], [-1]], np.int32)
        steps.append((pos, [0, 1, 2], [22 + t, 33 + t, 0], None))
    out = []
    for pos, rows, kvl, last in steps:
        tok = rng.integers(0, V, size=pos.shape).astype(np.int32)
        out.append((tok, pos, WIN_PAGES[rows], np.asarray(kvl, np.int32), last))
    return out


def _gemma_pair(overrides, seed):
    jcfg = jax_get_config("tiny-gemma2").with_(**overrides)
    cfg = get_config("tiny-gemma2").with_(**overrides)
    jparams = jax.device_get(jllama.init_params(jcfg, jax.random.PRNGKey(seed),
                                                jnp.float32))
    # the init puts the zero-centred norms at 0: give them values, so
    # that (1 + w) is held to the reference
    rng = np.random.default_rng(seed)
    jparams = dict(jparams, layers=dict(jparams["layers"]))
    for name in ("attn_norm", "mlp_norm", "post_attn_norm", "post_mlp_norm"):
        arr = jparams["layers"][name]
        jparams["layers"][name] = (0.3 * rng.standard_normal(arr.shape)
                                   ).astype(np.float32)
    jparams["norm_f"] = (0.3 * rng.standard_normal(jparams["norm_f"].shape)
                         ).astype(np.float32)
    return jcfg, cfg, jparams, params_from_numpy(jparams, cfg, "cpu",
                                                 torch.float32)


@pytest.mark.parametrize("attn_impl", ["kernel", "ref"])
@pytest.mark.parametrize("overrides", [{}, {"sw_period": 1}],
                         ids=["gemma2", "every_layer"])
def test_gemma_forward_matches_jax(attn_impl, overrides):
    jcfg, cfg, jparams, tparams = _gemma_pair(overrides, 0)
    assert "post_attn_norm" in tparams["layers"] and "lm_head" not in tparams
    jk, jv = jllama.make_kv_pool(jcfg, NP, PS, jnp.float32)
    tk, tv = make_kv_pool(cfg, NP + 1, PS, torch.float32, "cpu")
    t = torch.from_numpy
    for tok, pos, pt, kvl, last in _model_steps(np.random.default_rng(1),
                                                cfg.vocab_size):
        jl, jk, jv = jllama.forward(
            jcfg, jparams, jnp.asarray(tok), jnp.asarray(pos), jk, jv,
            jnp.asarray(pt), jnp.asarray(kvl),
            None if last is None else jnp.asarray(last), attn_impl="jnp")
        tl = llama.forward(
            cfg, tparams, t(tok), t(pos), tk, tv, t(pt), t(kvl),
            None if last is None else t(last), attn_impl=attn_impl).numpy()
        jl = np.asarray(jl)
        real = pos >= 0 if last is None else np.ones((pos.shape[0], 1), bool)
        if pos.shape[1] == 1:
            real = np.ones_like(real)
        np.testing.assert_allclose(tl[real], jl[real], atol=1e-4, rtol=1e-4)
        # the final-logit soft cap holds
        assert np.abs(tl).max() < cfg.final_logit_softcap
    np.testing.assert_allclose(tk[:, :NP].numpy(), np.asarray(jk), **TOL)
    np.testing.assert_allclose(tv[:, :NP].numpy(), np.asarray(jv), **TOL)


@pytest.mark.parametrize("overrides", [{}, {"sw_period": 1}],
                         ids=["gemma2", "every_layer"])
def test_gemma_ragged_forward_matches_jax(overrides):
    """Ragged steps whose decode rows and chunks lie past the window."""
    jcfg, cfg, jparams, tparams = _gemma_pair(overrides, 2)
    jk, jv = jllama.make_kv_pool(jcfg, NP, PS, jnp.float32)
    tk, tv = make_kv_pool(cfg, NP + 1, PS, torch.float32, "cpu")
    rng = np.random.default_rng(6)
    rows = WIN_PAGES.tolist()
    steps = [
        # (q_lens, q_starts, segment rows, t_bucket)
        ([12, 10], [0, 0], [0, 1], 24),
        ([1, 1, 9], [12, 10, 0], [0, 1, 2], 16),
        ([1, 11], [13, 11], [0, 1], 16),
        ([1, 1, 7], [14, 22, 9], [0, 1, 2], 16),
    ]
    t = torch.from_numpy
    for q_lens, q_starts, segs, tb in steps:
        kv_lens = [s + n for s, n in zip(q_starts, q_lens)]
        md = rag.build_ragged_metadata(q_lens, q_starts, kv_lens,
                                       [rows[s] for s in segs], tb, max_pages=MP)
        seg_cap = md["seg_page_table"].shape[0]
        gather = np.zeros(seg_cap, np.int32)
        gather[:len(q_lens)] = md["last_index"]
        tok = np.zeros((1, tb), np.int32)
        tok[0, :sum(q_lens)] = rng.integers(0, cfg.vocab_size, sum(q_lens))
        pos = md["tok_positions"][None]
        ragged = [md[k] for k in ("seg_page_table", "seg_kv_lens", "meta")]
        jl, jk, jv = jllama.forward(
            jcfg, jparams, jnp.asarray(tok), jnp.asarray(pos), jk, jv,
            jnp.asarray(md["tok_page_table"]), jnp.asarray(md["tok_kv_lens"]),
            jnp.asarray(gather), attn_impl="jnp",
            ragged=tuple(map(jnp.asarray, ragged)))
        for impl in ("kernel", "ref"):
            pools = (tk, tv) if impl == "kernel" else (tk.clone(), tv.clone())
            tl = llama.forward(cfg, tparams, t(tok), t(pos), *pools,
                               last_index=t(gather), attn_impl=impl,
                               ragged=tuple(map(t, ragged)))
            n = len(q_lens)
            np.testing.assert_allclose(tl[0, :n].numpy(), np.asarray(jl)[0, :n],
                                       atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(tk[:, :NP].numpy(), np.asarray(jk), **TOL)
    np.testing.assert_allclose(tv[:, :NP].numpy(), np.asarray(jv), **TOL)


def test_gemma_params_round_trip():
    """The JAX tiny-gemma2 tree carries across unchanged, post norms and
    tied embeddings included; the port's own init builds the same tree."""
    jcfg, cfg, jparams, tparams = _gemma_pair({}, 3)
    for name, arr in jparams["layers"].items():
        np.testing.assert_array_equal(tparams["layers"][name].numpy(), arr)
    own = llama.init_params(cfg, 0, torch.float32, "cpu")
    assert sorted(own["layers"]) == sorted(tparams["layers"])
    assert sorted(own) == sorted(tparams)
    assert torch.all(own["layers"]["post_mlp_norm"] == 0)  # zero-centred
    for name, x in own["layers"].items():
        assert tuple(x.shape) == tuple(tparams["layers"][name].shape), name


# -- engine ------------------------------------------------------------------

GEOMETRY = dict(num_pages=64, page_size=4, max_pages_per_seq=16,
                decode_buckets=(1, 2, 4, 8), prefill_buckets=(8, 16, 32))


async def _collect(engine, req, ctx_cls):
    toks, finish = [], None
    async for item in engine.generate(req, ctx_cls()):
        toks.extend(item["token_ids"])
        if item["finish_reason"]:
            finish = item["finish_reason"]
    return toks, finish


async def test_gemma_greedy_streams_match_jax():
    """tiny-gemma2 through both engines: prompts of 3 to 40 tokens (most
    past the window of 8, chunked at 16) decoding concurrently."""
    jcfg, cfg, jparams, tparams = _gemma_pair({}, 4)
    jeng = JaxEngine(JaxRunner(jcfg, params=jparams, dtype=jnp.float32,
                               **GEOMETRY), max_batch=8, chunk_size=16)
    teng = InferenceEngine(ModelRunner(cfg, device="cpu", dtype=torch.float32,
                                       params=tparams, **GEOMETRY),
                           max_batch=8, chunk_size=16)
    try:
        rng = np.random.default_rng(7)
        reqs = [{"token_ids": rng.integers(1, 500, size=n).tolist(),
                 "sampling": {"temperature": 0.0},
                 "stop": {"max_tokens": 12, "stop_ids": []}}
                for n in (3, 17, 40, 9, 33)]
        jres = await asyncio.gather(*[_collect(jeng, r, JaxContext) for r in reqs])
        tres = await asyncio.gather(*[_collect(teng, r, Context) for r in reqs])
    finally:
        jeng.stop()
        teng.stop()
    assert all(f == "length" and len(tk) == 12 for tk, f in tres)
    assert tres == jres
