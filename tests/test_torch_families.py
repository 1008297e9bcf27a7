"""The dense model families in the port against the JAX package: the
three GQA ops at the head shapes qwen2.5-7b (G 7) and phi-3-mini-4k (D 96)
give them, the family branches of the forward (Qwen2 biases, Qwen3 and
OLMo-2 qk-norms, OLMo-2's post norms only, Granite's multipliers, Gemma-1
and Gemma-3, Phi-3's every-layer window), the engine's greedy streams,
the presets and the params tree.

Inputs are made with numpy from a seed and handed to both sides. The JAX
side runs the Pallas kernels in interpret mode on the CPU, as
tests/test_ops.py does; the port's wrappers, given CPU tensors, run their
plain PyTorch versions (the CUDA kernels run only on the card, where
chip_smoke.py holds them against these same plain versions). The ops are
f32 at atol = rtol = 1e-5, over f32 pools and int8 dict pools (random
codes, scales far from 1); the forward's logits at 1e-4 and its KV pools
at 1e-5, as tests/test_torch_model.py. Every norm weight and bias is
drawn away from its init (1, or 0 where zero-centred; biases 0), so that
a norm or bias applied in the wrong place shows.
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
from dynamo_tpu_torch.models.config import PRESETS, ModelConfig, get_config
from dynamo_tpu_torch.models.toolkit import (
    gqa_score_scale,
    layer_rope,
    layer_window,
    make_kv_pool,
)
from dynamo_tpu_torch.ops import flash_prefill as fp
from dynamo_tpu_torch.ops import paged_attention as pa
from dynamo_tpu_torch.ops import ragged_paged_attention as rag
from dynamo_tpu_torch.runtime.context import Context

TOL = dict(atol=1e-5, rtol=1e-5)
# the reference's ops and forward compile without XLA's backend
# optimisations: compiling is most of a tiny call's time, and f32 results
# do not move by them beyond TOL
CHEAP = {"xla_backend_optimization_level": 0}

# (Hk, G, D): qwen2.5-7b's group at D 128, phi-3's MHA at D 96, and both
HEADS = {"G7_D128": (2, 7, 128), "G1_D96": (2, 1, 96), "G7_D96": (1, 7, 96)}


def _q(rng, shape):
    """Queries whose scores keep the D 16 cases' spread at every D."""
    return (rng.standard_normal(shape) * (16 / shape[-1]) ** 0.5).astype(np.float32)


def _pool(rng, kind, NP, PS, Hk, D):
    if kind == "int8":  # scales log-uniform in [0.004, 0.02]
        s = np.exp(rng.uniform(np.log(0.004), np.log(0.02), (NP, PS, Hk)))
        return {"q": rng.integers(-127, 128, (NP, PS, Hk, D)).astype(np.int8),
                "s": s.astype(np.float32)}
    return rng.standard_normal((NP, PS, Hk, D)).astype(np.float32)


def _jax(x):
    return ({k: jnp.asarray(v) for k, v in x.items()} if isinstance(x, dict)
            else jnp.asarray(x))


def _torch(x):
    return ({k: torch.from_numpy(v) for k, v in x.items()} if isinstance(x, dict)
            else torch.from_numpy(x))


def _table(rng, B, MP):
    NP = B * MP + 1
    return NP, rng.permutation(NP)[: B * MP].reshape(B, MP).astype(np.int32)


def _op_case(op, Hk, G, D, kind, rng):
    """(args, rows to compare, rows that must be 0) of one op over
    4-token pages: contexts of up to 24 tokens, so a 5-token window
    starts mid-page."""
    PS = 4
    if op == "decode":
        kv = np.asarray([17, 9, 5, 0, 24], np.int32)
        NP, pt = _table(rng, len(kv), 6)
        args = (_q(rng, (len(kv), Hk, G, D)), _pool(rng, kind, NP, PS, Hk, D),
                _pool(rng, kind, NP, PS, Hk, D), pt, kv)
        return args, [0, 1, 2, 4], [3]
    if op == "prefill":
        NP, pt = _table(rng, 2, 8)
        q_start = np.asarray([13, 0], np.int32)
        q_len = np.asarray([16, 11], np.int32)
        args = (_q(rng, (2, 16, Hk, G, D)), _pool(rng, kind, NP, PS, Hk, D),
                _pool(rng, kind, NP, PS, Hk, D), pt, q_start, q_len,
                q_start + q_len)
        return args, (np.s_[0], np.s_[1, :11]), [np.s_[1, 11:]]
    # decode rows past the window, a chunk over prior context, a fresh
    # chunk and a tail
    q_lens, q_starts, kv_lens, tb, MP = [1, 1, 9, 6], [16, 3, 12, 0], [17, 4, 21, 6], 24, 6
    NP = len(q_lens) * MP + 1
    perm = rng.permutation(NP)
    rows = [perm[i * MP:(i + 1) * MP].astype(np.int32).tolist()
            for i in range(len(q_lens))]
    md = rag.build_ragged_metadata(q_lens, q_starts, kv_lens, rows, tb, max_pages=MP)
    args = (_q(rng, (tb, Hk, G, D)), _pool(rng, kind, NP, PS, Hk, D),
            _pool(rng, kind, NP, PS, Hk, D),
            *[md[k] for k in ("seg_page_table", "seg_kv_lens", "meta")])
    return args, [np.s_[:sum(q_lens)]], [np.s_[sum(q_lens):]]


@pytest.mark.parametrize("window,kind", [(None, "float"), (5, "float"), (5, "int8")])
@pytest.mark.parametrize("heads", sorted(HEADS))
@pytest.mark.parametrize("op", ["decode", "prefill", "ragged"])
def test_head_shape_ops_match_jax(op, heads, window, kind):
    Hk, G, D = HEADS[heads]
    args, compare, zero = _op_case(op, Hk, G, D, kind, np.random.default_rng(1))
    jfn, tfn = {"decode": (jax_decode, pa.decode_paged_attention),
                "prefill": (jax_prefill, fp.prefill_paged_attention),
                "ragged": (jrag.ragged_paged_attention,
                           rag.ragged_paged_attention)}[op]
    jwin = None if window is None else jnp.int32(window)
    ref = np.asarray(jax.jit(lambda *a: jfn(*a, jwin, interpret=True),
                             compiler_options=CHEAP)(*map(_jax, args)))
    before = tfn.launches
    out = tfn(*map(_torch, args), window).numpy()
    assert tfn.launches == before  # plain on the CPU
    for rows in compare:
        np.testing.assert_allclose(out[rows], ref[rows], **TOL)
    for rows in zero:
        assert np.all(out[rows] == 0.0)


def test_wrapper_gates_take_the_new_shapes():
    assert 96 in pa.KERNEL_HEAD_DIMS and pa.DECODE_MAX_G == 8

    class Fn:
        launches = 0
        bodies = {}
    pa.count_launch(Fn, 96, 2047, 0.0)
    pa.count_launch(Fn, 96, 2047, 0.0, True)
    pa.count_launch(Fn, 128, 0, 0.0)
    assert Fn.bodies == {"D96_window": 1, "D96_int8_window": 1, "D128": 1}


# -- the forward -------------------------------------------------------------

# the config of each branch: a preset name and the overrides both
# packages apply to it
BRANCHES = {
    "qwen2": ("tiny-qwen2", {}),
    "qwen2_G7_D96": ("tiny-qwen2", dict(n_heads=7, n_kv_heads=1,
                                        head_dim_override=96)),
    "qwen3": ("tiny-qwen3", {}),
    "gemma3": ("tiny-gemma3", {}),
    "olmo2": ("tiny", dict(pre_norms=False, post_norms=True, qk_norm=True,
                           qk_norm_wide=True, norm_eps=1e-6)),
    "granite": ("tiny", dict(tie_embeddings=True, embed_multiplier=12.0,
                             residual_multiplier=0.22, attn_scale=0.125,
                             logits_divider=16.0)),
    "gemma1": ("tiny", dict(tie_embeddings=True, act="gelu_tanh",
                            embed_scale=True, norm_zero_centered=True,
                            head_dim_override=32, n_kv_heads=4,
                            rope_theta=10000.0)),
    # phi-3's shape: MHA at head dim 96, a window on every layer shorter
    # than the contexts
    "phi3": ("tiny", dict(dim=192, n_heads=2, n_kv_heads=2, sliding_window=6,
                          sw_period=1, sw_global_residue=1, rope_theta=10000.0)),
}
NORM_LEAVES = ("attn_norm", "mlp_norm", "post_attn_norm", "post_mlp_norm",
               "q_norm", "k_norm")


def _pair(branch, seed):
    """Both packages' configs and a params tree of the reference's init's
    leaves and shapes (jax.eval_shape: nothing of it runs), drawn with numpy
    at the init's scales, every norm and bias away from its init: as numpy
    and as the port's params (f32)."""
    name, kw = BRANCHES[branch]
    jcfg = jax_get_config(name).with_(**kw)
    cfg = get_config(name).with_(**kw)
    tree = jax.eval_shape(lambda: jllama.init_params(jcfg, jax.random.PRNGKey(seed),
                                                     jnp.float32))
    rng = np.random.default_rng(seed)
    base = 0.0 if cfg.norm_zero_centered else 1.0

    def draw(leaf, shape):
        x = rng.standard_normal(shape)
        if leaf in NORM_LEAVES or leaf == "norm_f":
            x = base + 0.3 * x
        elif leaf in ("bq", "bk", "bv"):
            x = 0.5 * x
        else:  # weights: the init's fan_in^-0.5 (embed [V, dim], others [.., in, out])
            x = x * shape[-1 if leaf == "embed" else -2] ** -0.5
        return x.astype(np.float32)

    jp = {k: draw(k, v.shape) for k, v in tree.items() if k != "layers"}
    jp["layers"] = {k: draw(k, v.shape) for k, v in tree["layers"].items()}
    return jcfg, cfg, jp, params_from_numpy(jp, cfg, "cpu", torch.float32)


NP, PS, MP = 32, 4, 10
# the reference's forward, compiled once per config and shape: steps of
# one shape (the two decode steps, the two ragged steps) trace it once
JAX_FORWARD = jax.jit(jllama.forward, static_argnames=("config", "attn_impl"),
                      compiler_options=CHEAP)
PAGES = np.random.default_rng(0).permutation(NP)[:3 * MP].reshape(3, MP).astype(np.int32)


def _padded_steps(rng, V):
    """Chunked prefill of two sequences, a second chunk over that prior
    context with padding rows, and two decode steps with a padding row:
    (tokens, positions, page rows, kv_lens, last_index)."""
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


# ragged steps after the padded ones: (q_lens, q_starts, segment rows,
# t_bucket): decode rows of both sequences beside a chunk of the third
RAGGED_STEPS = [([1, 1, 9], [23, 34, 0], [0, 1, 2], 16),
                ([1, 1, 7], [24, 35, 9], [0, 1, 2], 16)]


@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_family_forward_matches_jax(branch):
    """Padded prefill and decode steps, then ragged steps, through the
    reference's forward(attn_impl="jnp") and both of the port's attention
    paths, each on its own pools."""
    jcfg, cfg, jp, tparams = _pair(branch, 0)
    jk, jv = jllama.make_kv_pool(jcfg, NP, PS, jnp.float32)
    pools = {impl: make_kv_pool(cfg, NP + 1, PS, torch.float32, "cpu")
             for impl in ("kernel", "ref")}
    rng = np.random.default_rng(1)
    t = torch.from_numpy
    for tok, pos, pt, kvl, last in _padded_steps(rng, cfg.vocab_size):
        jl, jk, jv = JAX_FORWARD(
            jcfg, jp, jnp.asarray(tok), jnp.asarray(pos), jk, jv,
            jnp.asarray(pt), jnp.asarray(kvl),
            None if last is None else jnp.asarray(last), attn_impl="jnp")
        jl = np.asarray(jl)
        real = pos >= 0 if last is None else np.ones((pos.shape[0], 1), bool)
        if pos.shape[1] == 1:
            real = np.ones_like(real)
        for impl, (tk, tv) in pools.items():
            tl = llama.forward(cfg, tparams, t(tok), t(pos), tk, tv, t(pt),
                               t(kvl), None if last is None else t(last),
                               attn_impl=impl).numpy()
            np.testing.assert_allclose(tl[real], jl[real], atol=1e-4, rtol=1e-4)
    rows = PAGES.tolist()
    for q_lens, q_starts, segs, tb in RAGGED_STEPS:
        kv_lens = [s + n for s, n in zip(q_starts, q_lens)]
        md = rag.build_ragged_metadata(q_lens, q_starts, kv_lens,
                                       [rows[s] for s in segs], tb, max_pages=MP)
        gather = np.zeros(md["seg_page_table"].shape[0], np.int32)
        gather[:len(q_lens)] = md["last_index"]
        tok = np.zeros((1, tb), np.int32)
        tok[0, :sum(q_lens)] = rng.integers(0, cfg.vocab_size, sum(q_lens))
        pos = md["tok_positions"][None]
        ragged = [md[k] for k in ("seg_page_table", "seg_kv_lens", "meta")]
        jl, jk, jv = JAX_FORWARD(
            jcfg, jp, jnp.asarray(tok), jnp.asarray(pos), jk, jv,
            jnp.asarray(md["tok_page_table"]), jnp.asarray(md["tok_kv_lens"]),
            jnp.asarray(gather), attn_impl="jnp",
            ragged=tuple(map(jnp.asarray, ragged)))
        n = len(q_lens)
        for impl, (tk, tv) in pools.items():
            tl = llama.forward(cfg, tparams, t(tok), t(pos), tk, tv,
                               last_index=t(gather), attn_impl=impl,
                               ragged=tuple(map(t, ragged)))
            np.testing.assert_allclose(tl[0, :n].numpy(), np.asarray(jl)[0, :n],
                                       atol=1e-4, rtol=1e-4)
    for tk, tv in pools.values():
        np.testing.assert_allclose(tk[:, :NP].numpy(), np.asarray(jk), **TOL)
        np.testing.assert_allclose(tv[:, :NP].numpy(), np.asarray(jv), **TOL)


@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_family_init_tree_matches_jax(branch):
    """The port's init draws the reference's tree: the same leaves and
    shapes, biases 0 and norms at their init."""
    jcfg, cfg, jp, tparams = _pair(branch, 2)
    own = llama.init_params(cfg, 0, torch.float32, "cpu")
    assert sorted(own) == sorted(jp)
    assert sorted(own["layers"]) == sorted(jp["layers"])
    for name, x in own["layers"].items():
        assert tuple(x.shape) == jp["layers"][name].shape, name
        if name in ("bq", "bk", "bv"):
            assert torch.all(x == 0)
        if name in NORM_LEAVES:
            assert torch.all(x == (0.0 if cfg.norm_zero_centered else 1.0))
    assert ("attn_norm" in own["layers"]) == cfg.pre_norms


def test_layer_picks():
    g3 = get_config("tiny-gemma3")
    assert [layer_window(g3, l) for l in range(3)] == [8, 8, 0]
    assert [layer_rope(g3, l) for l in range(3)] == [1, 1, 0]
    assert [layer_rope(get_config("gemma-2-9b"), l) for l in range(2)] == [0, 0]
    phi = get_config("phi-3-mini-4k")
    assert {layer_window(phi, l) for l in range(phi.n_layers)} == {2047}
    assert phi.head_dim == 96 and phi.n_heads == phi.n_kv_heads
    q = get_config("qwen2.5-7b")
    assert q.n_heads // q.n_kv_heads == 7 and q.head_dim == 128
    # Granite's scale wins over query_pre_attn_scalar
    gr = get_config("granite-3.1-8b")
    assert gqa_score_scale(gr) == 0.0078125
    assert gqa_score_scale(gr.with_(query_pre_attn_scalar=256.0)) == 0.0078125


def test_pre_norms_needs_post_norms():
    with pytest.raises(ValueError, match="post_norms"):
        ModelConfig(pre_norms=False)


# -- presets and weights -----------------------------------------------------

ADDED = ("tiny-qwen2", "tiny-qwen3", "tiny-gemma3", "qwen2.5-7b", "qwen3-8b",
         "granite-3.1-8b", "olmo-2-7b", "phi-3-mini-4k", "mistral-7b", "gemma-7b")


@pytest.mark.parametrize("name", ADDED)
def test_added_preset_matches_jax(name):
    cfg, ref = PRESETS[name], jax_get_config(name)
    for f in cfg.__dataclass_fields__:
        assert getattr(cfg, f) == getattr(ref, f), (name, f)
    assert cfg.head_dim == ref.head_dim and not cfg.is_moe


@pytest.mark.parametrize("leaf", ["bq", "bv", "q_norm", "k_norm", "extra_bq",
                                  "extra_q_norm"])
def test_params_from_numpy_refuses_a_missing_or_extra_leaf(leaf):
    """A tree without a bias or qk-norm the config runs raises; so does a
    tree with one the config does not run (Qwen2's biases into Llama,
    Qwen3's norms into Qwen2)."""
    if leaf.startswith("extra_"):
        src = "qwen2" if leaf == "extra_bq" else "qwen3"
        _, _, jp, _ = _pair(src, 3)
        cfg = get_config("tiny" if src == "qwen2" else "tiny-qwen3").with_(
            qk_norm=False)
        with pytest.raises(KeyError, match=leaf[len("extra_"):]):
            params_from_numpy(jp, cfg, "cpu", torch.float32)
        return
    _, cfg, jp, _ = _pair("qwen2" if leaf.startswith("b") else "qwen3", 3)
    jp["layers"].pop(leaf)
    with pytest.raises(KeyError, match=leaf):
        params_from_numpy(jp, cfg, "cpu", torch.float32)


def test_biases_stay_in_the_params_dtype():
    _, cfg, jp, _ = _pair("qwen2", 4)
    p = params_from_numpy(jp, cfg, "cpu", torch.bfloat16)
    assert p["layers"]["bq"].dtype == torch.bfloat16
    _, cfg, jp, _ = _pair("qwen3", 4)
    p = params_from_numpy(jp, cfg, "cpu", torch.bfloat16)
    assert p["layers"]["q_norm"].dtype == torch.float32


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


# the reference engine's greedy streams of each branch, served once (fused
# mixed plans on the ragged path) and held against both of the port's modes
JAX_STREAMS = {}


@pytest.mark.parametrize("fused", ["1", "0"], ids=["fused", "unfused"])
@pytest.mark.parametrize("branch", ["qwen2_G7_D96", "phi3"])
async def test_family_greedy_streams_match_jax(monkeypatch, branch, fused):
    """Prompts of 4 to 13 tokens (past phi-3's window of 6) decoding
    concurrently, chunked at 8, through both engines."""
    monkeypatch.setenv("DYN_RAGGED_MIXED", "1")
    jcfg, cfg, jp, tparams = _pair(branch, 5)
    rng = np.random.default_rng(7)
    reqs = [{"token_ids": rng.integers(1, 500, size=n).tolist(),
             "sampling": {"temperature": 0.0},
             "stop": {"max_tokens": 8 if i == 0 else 6, "stop_ids": []}}
            for i, n in enumerate((6, 4, 9, 5, 13))]
    if branch not in JAX_STREAMS:
        monkeypatch.setenv("DYN_FUSED_MIXED", "1")
        jeng = JaxEngine(JaxRunner(jcfg, params=jp, dtype=jnp.float32, **GEOMETRY),
                         **ENGINE)
        JAX_STREAMS[branch] = await _serve(jeng, reqs)
    monkeypatch.setenv("DYN_FUSED_MIXED", fused)
    runner = ModelRunner(cfg, device="cpu", dtype=torch.float32, params=tparams,
                         **GEOMETRY)
    teng = InferenceEngine(runner, **ENGINE)
    assert teng.fused_mixed == (fused == "1")
    tres = await _serve(teng, reqs)
    assert tres == JAX_STREAMS[branch]
    assert all(f == "length" for _, f in tres)
    assert runner.stats["ragged_mixed_dispatches"] > 0 or fused == "0"
