"""The port's int8 KV cache against the JAX package: the quantizer, the
plain int8 versions of the three GQA attention ops and of MLA decode
against the Pallas int8 bodies, the forward over int8 pools, the engine's
greedy streams and the transfer boundary (pages cross dequantized).

Inputs are made with numpy from a seed and handed to both sides. The JAX
side runs the Pallas kernels in interpret mode on the CPU, as
tests/test_ops.py does; the port's wrappers, given CPU tensors, run their
plain PyTorch versions (the CUDA kernels run only on the card, where
chip_smoke.py holds them against these plain versions). Codes are random
int8 and both scales are drawn log-uniform in [0.004, 0.02], far from 1
and 5x apart from token to token, so that a scale folded in the wrong
place (or a row sum taken after the value scale) shows; dequantized K and
V then have a std of 0.3 to 1.5, the spread of the bf16 cases of
tests/test_torch_gemma.py. The ops are f32 at atol = rtol = 1e-5, the
forward's logits at 1e-4 (the same f32 math summed in another order).
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
from dynamo_tpu.models import quant as jquant
from dynamo_tpu.models.config import get_config as jax_get_config
from dynamo_tpu.ops import ragged_paged_attention as jrag
from dynamo_tpu.ops.flash_prefill import prefill_paged_attention as jax_prefill
from dynamo_tpu.ops.mla_attention import decode_mla_attention as jax_mla_decode
from dynamo_tpu.ops.paged_attention import decode_paged_attention as jax_decode
from dynamo_tpu.runtime.context import Context as JaxContext
from dynamo_tpu_torch.engine import model_runner as tmr
from dynamo_tpu_torch.engine.engine import InferenceEngine
from dynamo_tpu_torch.engine.model_runner import ModelRunner
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.models import llama
from dynamo_tpu_torch.models import quant
from dynamo_tpu_torch.models.config import get_config
from dynamo_tpu_torch.models.toolkit import make_kv_pool
from dynamo_tpu_torch.ops import _build
from dynamo_tpu_torch.ops import flash_prefill as fp
from dynamo_tpu_torch.ops import mla_attention as mla
from dynamo_tpu_torch.ops import paged_attention as pa
from dynamo_tpu_torch.ops import ragged_paged_attention as rag
from dynamo_tpu_torch.runtime.context import Context

TOL = dict(atol=1e-5, rtol=1e-5)

# (softcap, window, scale): the plain int8 body, and the window + cap +
# scale body (Gemma-2's)
VARIANTS = {"plain": (0.0, None, None), "gemma2": (30.0, 9, 0.35 ** -0.5)}


# -- the quantizer -----------------------------------------------------------


def test_kv_quantize_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 2, 16)).astype(np.float32) * 3.0
    x[0, 0, 0] = 0.0  # an all-zero vector: s = 1e-8 / 127, q = 0
    # ties: amax 127 gives s = 1, so x.5 rounds half to even
    x[1, 0, 0] = [127.0, 2.5, -3.5, 0.5, -0.5, 1.5, 126.5, -126.5] * 2
    want = jax.device_get(jquant.kv_quantize(jnp.asarray(x)))
    got = quant.kv_quantize(torch.from_numpy(x))
    assert got["q"].dtype == torch.int8 and got["s"].dtype == torch.float32
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
    np.testing.assert_allclose(got["s"].numpy(), np.asarray(want["s"]), rtol=1e-6)
    assert got["q"][1, 0, 0, 1:5].tolist() == [2, -4, 0, 0]
    # dequantize: the product in f32, then the dtype
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        back = quant.kv_dequantize(got, tdt)
        jback = jquant.kv_dequantize({"q": jnp.asarray(got["q"].numpy()),
                                      "s": jnp.asarray(got["s"].numpy())}, jdt)
        np.testing.assert_array_equal(back.float().numpy(),
                                      np.asarray(jback).astype(np.float32))
    pool = quant.kv_pool_quantize(torch.from_numpy(x))
    assert torch.equal(pool["q"], got["q"]) and torch.equal(pool["s"], got["s"])


@pytest.mark.parametrize("name", ["tiny", "tiny-mla"])
def test_make_kv_pool_int8(name):
    cfg = get_config(name)
    k, v = make_kv_pool(cfg, 9, 4, torch.bfloat16, "cpu", kv_quantize="int8")
    jk, jv = jllama.make_kv_pool(jax_get_config(name), 9, 4, jnp.bfloat16,
                                 kv_quantize="int8")
    for t, j in ((k, jk), (v, jv)):
        assert sorted(t) == ["q", "s"]
        assert tuple(t["q"].shape) == j["q"].shape and t["q"].dtype == torch.int8
        assert tuple(t["s"].shape) == j["s"].shape and t["s"].dtype == torch.float32
    with pytest.raises(ValueError, match="kv_quantize"):
        make_kv_pool(cfg, 9, 4, torch.bfloat16, "cpu", kv_quantize="int4")


# -- the ops -----------------------------------------------------------------


def _scales(rng, shape):
    return np.exp(rng.uniform(np.log(0.004), np.log(0.02), shape)).astype(np.float32)


def _int8_pool(rng, NP, PS, Hk, D):
    return {"q": rng.integers(-127, 128, (NP, PS, Hk, D)).astype(np.int8),
            "s": _scales(rng, (NP, PS, Hk))}


def _q(rng, shape):
    """Queries whose scores keep the D 16 cases' spread at every D."""
    return (rng.standard_normal(shape) * (16 / shape[-1]) ** 0.5).astype(np.float32)


def _table(rng, B, MP):
    NP = B * MP + 1
    return NP, rng.permutation(NP)[: B * MP].reshape(B, MP).astype(np.int32)


def _jax(x):
    return ({k: jnp.asarray(v) for k, v in x.items()} if isinstance(x, dict)
            else jnp.asarray(x))


def _torch(x):
    return ({k: torch.from_numpy(v) for k, v in x.items()} if isinstance(x, dict)
            else torch.from_numpy(x))


def _jwin(window):
    return None if window is None else jnp.int32(window)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("D", [128, 256])
def test_decode_int8_matches_jax(variant, D):
    softcap, window, scale = VARIANTS[variant]
    rng = np.random.default_rng(1)
    kv = np.asarray([17, 9, 5, 0, 24], np.int32)
    B, Hk, G, PS, MP = len(kv), 2, 2, 4, 6
    NP, pt = _table(rng, B, MP)
    args = (_q(rng, (B, Hk, G, D)), _int8_pool(rng, NP, PS, Hk, D),
            _int8_pool(rng, NP, PS, Hk, D), pt, kv)
    ref = np.asarray(jax_decode(*map(_jax, args), _jwin(window), scale=scale,
                                softcap=softcap, interpret=True))
    t = [_torch(a) for a in args]
    before = pa.decode_paged_attention.launches
    out = pa.decode_paged_attention(*t, window, scale=scale, softcap=softcap)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    assert np.all(out[3].numpy() == 0.0)  # kv_len 0: exactly 0
    assert pa.decode_paged_attention.launches == before  # plain on the CPU
    # the kernel's split arithmetic (8-token splits), scales folded per split
    m, l, o = pa.decode_split_partials_ref(*t, scale, 8, softcap=softcap,
                                           window=window)
    np.testing.assert_allclose(pa.merge_split_partials_ref(m, l, o).numpy(),
                               ref, **TOL)


def test_int8_fold_order_matters():
    """The row sum takes p before the value scale: a version that sums
    after it (or dequantizes nothing) is far from the reference."""
    rng = np.random.default_rng(2)
    kv = np.asarray([13, 7], np.int32)
    NP, pt = _table(rng, 2, 4)
    q = _q(rng, (2, 2, 2, 16))
    kp, vp = _int8_pool(rng, NP, 4, 2, 16), _int8_pool(rng, NP, 4, 2, 16)
    good = pa.decode_paged_attention(*map(_torch, (q, kp, vp, pt, kv)))
    unit = dict(vp, s=np.ones_like(vp["s"]))
    wrong = pa.decode_paged_attention(*map(_torch, (q, kp, unit, pt, kv)))
    rescaled = wrong * float(np.median(vp["s"]))
    assert (good - rescaled).abs().max() > 0.05 * good.abs().max()


def _prefill_args(rng, D):
    B, S, Hk, G, PS, MP = 2, 16, 2, 2, 4, 8
    NP, pt = _table(rng, B, MP)
    q_start = np.asarray([13, 0], np.int32)
    q_len = np.asarray([16, 11], np.int32)
    return (_q(rng, (B, S, Hk, G, D)), _int8_pool(rng, NP, PS, Hk, D),
            _int8_pool(rng, NP, PS, Hk, D), pt, q_start, q_len, q_start + q_len)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("D", [64, 96, 128, 256])
def test_prefill_int8_matches_jax(variant, D):
    softcap, window, scale = VARIANTS[variant]
    args = _prefill_args(np.random.default_rng(3), D)
    ref = np.asarray(jax_prefill(*map(_jax, args), _jwin(window), scale=scale,
                                 softcap=softcap, interpret=True))
    out = fp.prefill_paged_attention(*map(_torch, args), window, scale=scale,
                                     softcap=softcap).numpy()
    np.testing.assert_allclose(out[0], ref[0], **TOL)
    np.testing.assert_allclose(out[1, :11], ref[1, :11], **TOL)
    assert np.all(out[1, 11:] == 0.0)  # padding rows


# (q_lens, q_starts, kv_lens, t_bucket, PS, MP): decode rows, a chunk over
# prior context, a fresh chunk and a tail over 4-token pages; and over
# 64-token pages, rows and a chunk across the kernel's SPLIT_TOKENS splits
L_S = rag.SPLIT_TOKENS
RAGGED = {
    "small": ([1, 1, 9, 6], [16, 3, 12, 0], [17, 4, 21, 6], 24, 4, 6),
    "splits": ([1, 8, 1], [2 * L_S + 40, L_S - 3, 300],
               [2 * L_S + 41, L_S + 5, 301], 16, 64, 18),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("layout,D", [("small", 64), ("small", 96), ("small", 128),
                                      ("small", 256), ("splits", 128)])
def test_ragged_int8_matches_jax(variant, layout, D):
    softcap, window, scale = VARIANTS[variant]
    q_lens, q_starts, kv_lens, tb, PS, MP = RAGGED[layout]
    if layout == "splits" and window:
        window = 4 * window
    rng = np.random.default_rng(4)
    NP = len(q_lens) * MP + 1
    perm = rng.permutation(NP)
    rows = [perm[i * MP:(i + 1) * MP].astype(np.int32).tolist()
            for i in range(len(q_lens))]
    md = rag.build_ragged_metadata(q_lens, q_starts, kv_lens, rows, tb,
                                   max_pages=MP)
    Hk, G = 2, 2
    args = (_q(rng, (tb, Hk, G, D)), _int8_pool(rng, NP, PS, Hk, D),
            _int8_pool(rng, NP, PS, Hk, D),
            *[md[k] for k in ("seg_page_table", "seg_kv_lens", "meta")])
    ref = np.asarray(jrag.ragged_paged_attention(
        *map(_jax, args), _jwin(window), scale=scale, softcap=softcap,
        interpret=True))
    t = [_torch(a) for a in args]
    kw = dict(scale=scale, softcap=softcap)
    out = rag.ragged_paged_attention(*t, window, **kw).numpy()
    np.testing.assert_allclose(out, ref, **TOL)
    assert np.all(out[sum(q_lens):] == 0.0)  # tail rows
    m, l, o = rag.ragged_split_partials_ref(*t, window, **kw)
    np.testing.assert_allclose(rag.merge_split_partials_ref(m, l, o).numpy(),
                               ref, **TOL)


@pytest.mark.parametrize("kv_lens", [[1, 9, 24], [24, 1, 13]])
def test_mla_decode_int8_matches_jax(kv_lens):
    rng = np.random.default_rng(5)
    B, H, dc, dr, PS, MP = 3, 4, 32, 16, 4, 6
    NP, pt = _table(rng, B, MP)
    q = (rng.standard_normal((B, H, dc + dr)) * (16 / (dc + dr)) ** 0.5
         ).astype(np.float32)
    lat = {"q": rng.integers(-127, 128, (NP, PS, 1, dc + dr)).astype(np.int8),
           "s": _scales(rng, (NP, PS, 1))}
    kv = np.asarray(kv_lens, np.int32)
    scale = (dc + dr) ** -0.5
    ref = np.asarray(jax_mla_decode(_jax(q), _jax(lat), jnp.asarray(pt),
                                    jnp.asarray(kv), dc=dc, scale=scale,
                                    interpret=True))
    t = [_torch(a) for a in (q, lat, pt, kv)]
    out = mla.decode_mla_attention(*t, dc=dc, scale=scale)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    m, l, o = mla.decode_mla_split_partials_ref(*t, dc=dc, scale=scale, split=8)
    np.testing.assert_allclose(pa.merge_split_partials_ref(m, l, o).numpy(),
                               ref, **TOL)
    with pytest.raises(TypeError, match="prefill"):
        mla.prefill_mla_attention(t[0][:, None], t[1], t[2], t[3], t[3], t[3],
                                  dc=dc, scale=scale)


def _int8_call(op, device, k_pool, v_pool):
    bf = dict(dtype=torch.bfloat16, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    if op == "decode":
        return pa.decode_paged_attention(
            torch.zeros(2, 2, 2, 128, **bf), k_pool, v_pool,
            torch.zeros(2, 4, **i32), torch.full((2,), 9, **i32))
    if op == "prefill":
        ints = [torch.full((1,), n, **i32) for n in (3, 8, 11)]
        return fp.prefill_paged_attention(
            torch.zeros(1, 8, 2, 2, 128, **bf), k_pool, v_pool,
            torch.zeros(1, 4, **i32), *ints)
    md = rag.build_ragged_metadata([1, 5], [9, 0], [10, 5], [[1, 2, 3], [4, 5]],
                                   8, max_pages=4)
    ops = [torch.from_numpy(md[k]).to(device)
           for k in ("seg_page_table", "seg_kv_lens", "meta")]
    return rag.ragged_paged_attention(torch.zeros(8, 2, 2, 128, **bf), k_pool,
                                      v_pool, *ops)


@pytest.mark.parametrize("op", ["decode", "prefill", "ragged"])
def test_int8_wrappers_launch_or_raise(op, monkeypatch):
    """On tensors that are not on the CPU (the meta device, where the CUDA
    toolkit is missing) an int8 dict pool reaches the kernel's build and
    raises there: it never dequantizes to the bf16 kernels or runs the
    plain version, and counts no launch. Operands the int8 bodies do not
    take are refused by name first."""
    fn = {"decode": pa.decode_paged_attention,
          "prefill": fp.prefill_paged_attention,
          "ragged": rag.ragged_paged_attention}[op]
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda p: False)
    monkeypatch.setattr(_build, "_libs", {})
    before = dict(fn.bodies), fn.launches

    def pool(device, q_dtype=torch.int8, s_dtype=torch.float32):
        return {"q": torch.zeros(9, 4, 2, 128, dtype=q_dtype, device=device),
                "s": torch.zeros(9, 4, 2, dtype=s_dtype, device=device)}

    with pytest.raises(RuntimeError, match="nvcc not found"):
        _int8_call(op, "meta", pool("meta"), pool("meta"))
    with pytest.raises(TypeError, match="one of each"):
        _int8_call(op, "meta", pool("meta"),
                   torch.zeros(9, 4, 2, 128, dtype=torch.bfloat16, device="meta"))
    with pytest.raises(TypeError, match=r"v_pool\['s'\]"):
        _int8_call(op, "meta", pool("meta"), pool("meta", s_dtype=torch.float16))
    with pytest.raises(TypeError, match=r"k_pool\['q'\]"):
        _int8_call(op, "meta", pool("meta", q_dtype=torch.uint8), pool("meta"))
    out = _int8_call(op, "cpu", pool("cpu"), pool("cpu"))
    assert torch.isfinite(out.float()).all()
    assert (dict(fn.bodies), fn.launches) == before


def test_count_launch_names_int8_bodies():
    class Fn:
        launches = 0
        bodies = {}
    pa.count_launch(Fn, 128, 0, 0.0, True)
    pa.count_launch(Fn, 256, 4096, 50.0, True)
    pa.count_launch(Fn, 256, 4096, 50.0)
    assert Fn.bodies == {"D128_int8": 1, "D256_int8_window_softcap": 1,
                         "D256_window_softcap": 1}
    assert Fn.launches == 3


# -- the forward -------------------------------------------------------------

NP, PS, MP = 32, 4, 10
PAGES = np.random.default_rng(0).permutation(NP)[:3 * MP].reshape(3, MP).astype(np.int32)


def _steps(rng, V):
    """Chunked prefill (past tiny-gemma2's window of 8), a second chunk
    over prior context with padding rows, and decode steps with a padding
    row: (tokens, positions, page rows, kv_lens, last_index)."""
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
        out.append((tok, pos, PAGES[rows], np.asarray(kvl, np.int32), last))
    return out


def _jparams(name, seed):
    """The JAX init tree; zero-centred norms (Gemma) get values, so that
    (1 + w) is held too."""
    jcfg = jax_get_config(name)
    jp = jax.device_get(jllama.init_params(jcfg, jax.random.PRNGKey(seed),
                                           jnp.float32))
    if jcfg.norm_zero_centered:
        rng = np.random.default_rng(seed)
        jp = dict(jp, layers=dict(jp["layers"]))
        for k in ("attn_norm", "mlp_norm", "post_attn_norm", "post_mlp_norm"):
            arr = jp["layers"][k]
            jp["layers"][k] = (0.3 * rng.standard_normal(arr.shape)).astype(np.float32)
        jp["norm_f"] = (0.3 * rng.standard_normal(jp["norm_f"].shape)).astype(np.float32)
    return jcfg, jp


def _assert_pools_match(tpool, jpool):
    """The written codes equal the reference's but for rounding ties (the
    two frameworks' projections differ in the last bits): at most 0.01% of
    entries, each off by 1. The scales, amax / 127 of those projections,
    within 1e-5: the tolerance tests/test_torch_model.py holds a bf16
    pool's values to (past layer 0 the projections differ by up to ~2e-6
    relative, so 1e-6 would hold the matmuls' summation order, not the
    quantizer, which test_kv_quantize_matches_jax holds exactly)."""
    tq = tpool["q"][:, :NP].numpy().astype(np.int32)
    jq = np.asarray(jpool["q"]).astype(np.int32)
    diff = np.abs(tq - jq)
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-4, (diff > 0).sum()
    np.testing.assert_allclose(tpool["s"][:, :NP].numpy(), np.asarray(jpool["s"]),
                               rtol=1e-5)


@pytest.mark.parametrize("attn_impl", ["kernel", "ref"])
@pytest.mark.parametrize("name", ["tiny", "tiny-gemma2", "tiny-mla"])
def test_forward_int8_pools_match_jax(name, attn_impl):
    jcfg, jp = _jparams(name, 0)
    cfg = get_config(name)
    tparams = params_from_numpy(jp, cfg, "cpu", torch.float32)
    jk, jv = jllama.make_kv_pool(jcfg, NP, PS, jnp.float32, kv_quantize="int8")
    tk, tv = make_kv_pool(cfg, NP + 1, PS, torch.float32, "cpu", kv_quantize="int8")
    t = torch.from_numpy
    for tok, pos, pt, kvl, last in _steps(np.random.default_rng(1), cfg.vocab_size):
        jl, jk, jv = jllama.forward(
            jcfg, jp, jnp.asarray(tok), jnp.asarray(pos), jk, jv,
            jnp.asarray(pt), jnp.asarray(kvl),
            None if last is None else jnp.asarray(last), attn_impl="jnp")
        tl = llama.forward(cfg, tparams, t(tok), t(pos), tk, tv, t(pt), t(kvl),
                           None if last is None else t(last),
                           attn_impl=attn_impl).numpy()
        jl = np.asarray(jl)
        real = pos >= 0 if last is None else np.ones((pos.shape[0], 1), bool)
        if pos.shape[1] == 1:
            real = np.ones_like(real)
        np.testing.assert_allclose(tl[real], jl[real], atol=1e-4, rtol=1e-4)
    _assert_pools_match(tk, jk)
    assert tk["q"][:, :NP].abs().sum() > 0, "the steps must have written codes"
    if cfg.is_mla:
        assert not tv["q"].any() and not tv["s"].any()  # the stub stays 0
    else:
        _assert_pools_match(tv, jv)


def test_ragged_forward_int8_matches_padded():
    """The flat ragged step over int8 pools gives the padded steps'
    logits and writes the same codes."""
    cfg = get_config("tiny")
    params = llama.init_params(cfg, 0, torch.float32, "cpu")
    rows = PAGES.tolist()
    pad_k, pad_v = make_kv_pool(cfg, NP + 1, PS, torch.float32, "cpu", "int8")
    rag_k, rag_v = make_kv_pool(cfg, NP + 1, PS, torch.float32, "cpu", "int8")
    rng = np.random.default_rng(6)
    t = torch.from_numpy
    # a 12-token prefill of sequence 0, then a ragged step: its decode row
    # and a 9-token chunk of sequence 1
    tok0 = rng.integers(0, cfg.vocab_size, (1, 12)).astype(np.int32)
    for k, v in ((pad_k, pad_v), (rag_k, rag_v)):
        llama.forward(cfg, params, t(tok0), t(np.arange(12, dtype=np.int32)[None]),
                      k, v, t(PAGES[:1]), t(np.array([12], np.int32)))
    dec = rng.integers(0, cfg.vocab_size, 1).astype(np.int32)
    chunk = rng.integers(0, cfg.vocab_size, 9).astype(np.int32)
    md = rag.build_ragged_metadata([1, 9], [12, 0], [13, 9], rows[:2], 16,
                                   max_pages=MP)
    flat = np.zeros((1, 16), np.int32)
    flat[0, 0], flat[0, 1:10] = dec[0], chunk
    gather = np.zeros(md["seg_page_table"].shape[0], np.int32)
    gather[:2] = md["last_index"]
    lr = llama.forward(cfg, params, t(flat), t(md["tok_positions"][None]),
                       rag_k, rag_v, last_index=t(gather),
                       ragged=tuple(t(md[k]) for k in
                                    ("seg_page_table", "seg_kv_lens", "meta")))
    ld = llama.forward(cfg, params, t(dec[None]), t(np.array([[12]], np.int32)),
                       pad_k, pad_v, t(PAGES[:1]), t(np.array([13], np.int32)))
    lp = llama.forward(cfg, params, t(chunk[None]), t(np.arange(9, dtype=np.int32)[None]),
                       pad_k, pad_v, t(PAGES[1:2]), t(np.array([9], np.int32)), 8)
    np.testing.assert_allclose(lr[0, 0].numpy(), ld[0, 0].numpy(), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(lr[0, 1].numpy(), lp[0, 0].numpy(), atol=1e-4, rtol=1e-4)
    for a, b in ((rag_k, pad_k), (rag_v, pad_v)):
        assert torch.equal(a["q"][:, :NP], b["q"][:, :NP])
        torch.testing.assert_close(a["s"][:, :NP], b["s"][:, :NP], rtol=1e-6, atol=0)


# -- the engine --------------------------------------------------------------

GEOMETRY = dict(num_pages=96, page_size=4, max_pages_per_seq=16,
                decode_buckets=(1, 2, 4, 8), prefill_buckets=(8, 16))
ENGINE = dict(max_batch=6, chunk_size=8, mixed_prefill_tokens=8,
              mixed_prefill_seqs=4, mixed_min_chunk=2)


class _Stepped:
    """Stands in for the engine's step thread: the test steps the engine,
    so both engines see the same plans whatever the timing."""

    def join(self, timeout=None):
        pass


async def _serve(engine, reqs):
    engine._thread = _Stepped()
    ctx_cls = JaxContext if isinstance(engine, JaxEngine) else Context

    async def one(req):
        toks, finish = [], None
        async for item in engine.generate(req, ctx_cls()):
            assert item.get("finish_reason") != "error", item
            toks.extend(item["token_ids"])
            finish = item["finish_reason"] or finish
            if item["finish_reason"]:
                break
        return toks, finish

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


@pytest.mark.parametrize("fused", ["1", "0"], ids=["fused", "unfused"])
async def test_int8_greedy_streams_match_jax(monkeypatch, fused):
    monkeypatch.setenv("DYN_FUSED_MIXED", fused)
    monkeypatch.setenv("DYN_RAGGED_MIXED", "1")
    jcfg, jp = _jparams("tiny", 3)
    cfg = get_config("tiny")
    rng = np.random.default_rng(7)
    reqs = [{"token_ids": rng.integers(1, 500, size=n).tolist(),
             "sampling": {"temperature": 0.0},
             "stop": {"max_tokens": 8 if i == 0 else 6, "stop_ids": []}}
            for i, n in enumerate((6, 4, 9, 5, 13))]
    jeng = JaxEngine(JaxRunner(jcfg, params=jp, dtype=jnp.float32,
                               kv_quantize="int8", **GEOMETRY), **ENGINE)
    runner = ModelRunner(cfg, device="cpu", dtype=torch.float32,
                         params=params_from_numpy(jp, cfg, "cpu", torch.float32),
                         kv_quantize="int8", **GEOMETRY)
    teng = InferenceEngine(runner, **ENGINE)
    assert teng.fused_mixed == (fused == "1")
    jres = await _serve(jeng, reqs)
    tres = await _serve(teng, reqs)
    assert tres == jres
    assert all(f == "length" for _, f in tres)
    assert runner.stats["ragged_mixed_dispatches"] > 0 or fused == "0"


# -- the transfer boundary -----------------------------------------------------

WIRE = dict(num_pages=32, page_size=4, max_pages_per_seq=16,
            decode_buckets=(1, 2, 4), prefill_buckets=(8, 16, 32))
PROMPT = [int(x) for x in np.random.default_rng(0).integers(1, 500, size=14)]
SRC, DST = [3, 7, 1, 9], [5, 0, 2, 8]  # 14 tokens = 4 pages of 4


def _wire_runners(kv_quantize):
    """A bf16 JAX runner and the port's, same params, the given pools."""
    jcfg, jp = _jparams("tiny", 0)
    jp = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)), jp)
    jrun = JaxRunner(jcfg, params=jp, dtype=jnp.bfloat16, kv_quantize=kv_quantize,
                     **WIRE)
    cfg = get_config("tiny")
    trun = ModelRunner(cfg, device="cpu", dtype=torch.bfloat16,
                       params=params_from_numpy(jp, cfg, "cpu", torch.bfloat16),
                       kv_quantize=kv_quantize, **WIRE)
    return jrun, trun


def _jdict(pool, pages):
    return {k: jnp.asarray(v[:, pages].numpy()) for k, v in pool.items()}


def _wire(payload):
    k, v = tmr.kv_payload_to_arrays(payload)
    return k.float().numpy(), v.float().numpy()


def test_int8_export_is_the_reference_dequantization():
    """An int8 runner exports its pages dense in bf16 (wire v2): the
    reference's kv_pool_dequantize of the same codes, bit for bit, and a
    JAX bf16 runner imports them."""
    _, trun = _wire_runners("int8")
    assert trun.kv_wire_dtype == "bfloat16" and trun.kv_page_shape == (2, 4, 2, 16)
    trun.prefill(PROMPT, 0, SRC, 0)
    payload = trun.export_pages(SRC)
    assert payload["dtype"] == "bfloat16" and payload["layout"] == 2
    k, v = _wire(payload)
    for got, pool in ((k, trun.k_pool), (v, trun.v_pool)):
        want = jquant.kv_pool_dequantize(_jdict(pool, SRC), jnp.bfloat16)
        np.testing.assert_array_equal(got, np.asarray(want).astype(np.float32))
        assert np.abs(got).sum() > 0
    jbf, _ = _wire_runners(None)
    jbf.import_pages(DST, 0, payload)
    np.testing.assert_array_equal(
        np.asarray(jax.device_get(jbf.k_pool))[:, DST].astype(np.float32), k)


@pytest.mark.parametrize("groups", [1, 2])
def test_bf16_pages_into_int8_runner_and_back(groups):
    """A bf16 runner's pages import into an int8 runner (quantized as the
    reference quantizes them, also layer group by layer group) and come
    back dequantized within half an int8 step; a JAX int8 runner importing
    the same payload holds the same codes, and the same scales within
    1e-6 (XLA may divide by 127 as a product with its reciprocal: an ulp)."""
    jrun, _ = _wire_runners("int8")
    _, src = _wire_runners(None)
    _, dst = _wire_runners("int8")
    src.prefill(PROMPT, 0, SRC, 0)
    payload = src.export_pages(SRC)
    dst.import_pages(DST, 0, payload, layer_groups=groups)
    jrun.import_pages(DST, 0, payload)
    dense = src.k_pool[:, SRC]
    want = jax.device_get(jquant.kv_pool_quantize(
        jnp.asarray(dense.float().numpy()).astype(jnp.bfloat16)))
    for pool, jpool in ((dst.k_pool, jrun.k_pool), (dst.v_pool, jrun.v_pool)):
        jd = jax.device_get(jpool)
        np.testing.assert_array_equal(pool["q"][:, DST].numpy(),
                                      np.asarray(jd["q"])[:, DST])
        np.testing.assert_allclose(pool["s"][:, DST].numpy(),
                                   np.asarray(jd["s"])[:, DST], rtol=1e-6)
    np.testing.assert_array_equal(dst.k_pool["q"][:, DST].numpy(), np.asarray(want["q"]))
    np.testing.assert_allclose(dst.k_pool["s"][:, DST].numpy(), np.asarray(want["s"]),
                               rtol=1e-6)
    back, _ = _wire(dst.export_pages(DST))
    step = dst.k_pool["s"][:, DST].numpy()[..., None]
    orig = dense.float().numpy()
    assert np.all(np.abs(back - orig) <= 0.5 * step + 1e-2 * np.abs(orig))
    assert dst.stats["kv_pages_imported"] == 4


def test_int8_device_transfer_between_runners():
    """export_pages_device / import_pages_device between two int8 runners:
    dense bf16 pages in, codes within one step of the source's out (the
    bf16 rounding of a dequantized vector moves its amax a little), and an
    all-zero vector (the pages' unwritten slots) gets the reference's
    scale 1e-8 / 127."""
    _, p = _wire_runners("int8")
    _, d = _wire_runners("int8")
    p.prefill(PROMPT, 0, SRC, 0)
    k, v = p.export_pages_device(SRC)
    assert k.dtype == torch.bfloat16 and k.shape == (2, 4, 4, 2, 16)
    d.import_pages_device([30, 31, 0], 1, k, v)
    for a, b in ((d.k_pool, p.k_pool), (d.v_pool, p.v_pool)):
        dq = a["q"][:, [30, 31, 0]].int()
        assert (dq - b["q"][:, SRC[1:]].int()).abs().max() <= 1
        torch.testing.assert_close(a["s"][:, [30, 31, 0]], b["s"][:, SRC[1:]],
                                   rtol=1e-2, atol=1e-10)


async def _collect(engine, req, ctx_cls):
    toks, finish = [], None
    async for item in engine.generate(req, ctx_cls()):
        toks.extend(item["token_ids"])
        finish = item["finish_reason"] or finish
    return toks, finish


@pytest.mark.parametrize("groups", [1, 3])
async def test_int8_host_tier_onboard_matches_jax(groups):
    """The G2 host tier over int8 pools: a prefix's pages offload
    dequantized, come back quantized (in 1 or 3 layer groups), and the
    request that reuses them streams what the JAX int8 engine streams."""
    jcfg, jp = _jparams("tiny", 9)
    cfg = get_config("tiny")
    geo = dict(GEOMETRY, num_pages=24)
    rng = np.random.default_rng(1)
    a = rng.integers(1, 500, size=40).tolist()
    fillers = [rng.integers(1, 500, size=40).tolist() for _ in range(2)]
    a2 = a[:32] + rng.integers(1, 500, size=5).tolist()

    def req(p):
        return {"token_ids": p, "sampling": {"temperature": 0.0},
                "stop": {"max_tokens": 6, "stop_ids": []}}

    async def sequence(engine, ctx_cls):
        for p in [a] + fillers:
            await _collect(engine, req(p), ctx_cls)
        before = engine.scheduler.reused_prefix_tokens
        out = await _collect(engine, req(a2), ctx_cls)
        return out, engine.scheduler.reused_prefix_tokens - before

    runner = ModelRunner(cfg, device="cpu", dtype=torch.float32,
                         params=params_from_numpy(jp, cfg, "cpu", torch.float32),
                         kv_quantize="int8", **geo)
    teng = InferenceEngine(runner, max_batch=4, chunk_size=16, host_kv_blocks=64,
                           onboard_layer_groups=groups)
    jeng = JaxEngine(JaxRunner(jcfg, params=jp, dtype=jnp.float32,
                               kv_quantize="int8", **geo),
                     max_batch=4, chunk_size=16, host_kv_blocks=64,
                     onboard_layer_groups=groups)
    try:
        (toks, finish), reused = await sequence(teng, Context)
        (jtoks, jfinish), jreused = await sequence(jeng, JaxContext)
    finally:
        teng.stop()
        jeng.stop()
    assert (toks, finish) == (jtoks, jfinish) and finish == "length"
    assert reused == jreused == 32
    assert teng.onboard_stats["onboards"] == 1 and teng.onboard_stats["blocks"] == 8
    assert runner.stats["kv_pages_imported"] == 8
