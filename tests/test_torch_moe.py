"""The port's MoE path against the JAX package: the router in every
branch, the routing layout of the grouped GEMM, the plain grouped GEMM,
the MoE block, the forward over MoE layers (DeepSeek's leading dense
layers included), greedy engine streams, and the params tree.

Inputs are made with numpy from a seed and handed to both sides. The
reference computes every expert on every token (dynamo_tpu/models/moe.py,
no Pallas kernel); the port routes the tokens and, given CPU tensors, runs
the grouped GEMM's plain version (a loop of torch.matmul over each
expert's rows), which chip_smoke.py holds the CUDA kernel against on the
card. Tolerances: the router atol 1e-6 (the same f32 operations; logits
are continuous draws, so no two tie); the MoE block and the plain grouped
GEMM atol = rtol = 1e-5 in f32 (the routed sum adds the same products in
another order); the forward's logits atol 1e-4 and its pools 1e-5, as
tests/test_torch_model.py.
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
from dynamo_tpu.models.moe import _moe_block
from dynamo_tpu.ops import moe_dispatch as jmd
from dynamo_tpu.runtime.context import Context as JaxContext
from dynamo_tpu_torch.engine.engine import InferenceEngine
from dynamo_tpu_torch.engine.model_runner import ModelRunner
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.models import llama
from dynamo_tpu_torch.models.config import PRESETS, get_config
from dynamo_tpu_torch.models.moe import moe_block
from dynamo_tpu_torch.models.toolkit import make_kv_pool
from dynamo_tpu_torch.ops import _build
from dynamo_tpu_torch.ops import moe_dispatch as md
from dynamo_tpu_torch.ops import ragged_paged_attention as rag
from dynamo_tpu_torch.runtime.context import Context

TOL = dict(atol=1e-5, rtol=1e-5)
CHEAP = {"xla_backend_optimization_level": 0}

# -- the router ----------------------------------------------------------------

# (n_experts, k, router_topk keyword arguments)
ROUTER_CASES = {
    "softmax": (8, 2, dict(scoring="softmax")),
    "softmax_all": (8, 2, dict(scoring="softmax", norm_topk=False)),
    "sigmoid": (8, 3, dict(scoring="sigmoid")),
    "sigmoid_unnormed": (8, 3, dict(scoring="sigmoid", norm_topk=False)),
    "sigmoid_bias": (8, 3, dict(scoring="sigmoid", bias=True)),
    "groups": (64, 8, dict(scoring="sigmoid", bias=True, n_groups=8,
                           topk_groups=4)),
    "groups_no_bias": (64, 8, dict(scoring="sigmoid", n_groups=8, topk_groups=4)),
    "scale": (64, 8, dict(scoring="sigmoid", bias=True, n_groups=8,
                          topk_groups=4, routed_scale=2.5)),
    "softmax_scale": (8, 2, dict(scoring="softmax", routed_scale=2.5)),
}


@pytest.mark.parametrize("case", sorted(ROUTER_CASES))
def test_router_topk_matches_jax(case):
    n, k, kw = ROUTER_CASES[case]
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((3, 7, n)) * 2).astype(np.float32)
    bias = (rng.standard_normal(n) * 0.5).astype(np.float32) if kw.get("bias") else None
    args = dict(kw, bias=None)
    jw, js = jmd.router_topk(jnp.asarray(logits), k, **{
        **args, "bias": None if bias is None else jnp.asarray(bias)})
    tw, ts = md.router_topk(torch.from_numpy(logits), k, **{
        **args, "bias": None if bias is None else torch.from_numpy(bias)})
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-6, rtol=0)
    if case.startswith("groups") or case == "scale":
        # the chosen experts lie in at most topk_groups groups of 8
        assert max(len({e // 8 for e in r}) for r in ts.reshape(-1, k).tolist()) <= 4


# -- the routing layout ----------------------------------------------------------

# (T, k, n_experts, how the pairs are routed), tiles of md.MOE_BM (64) rows
LAYOUTS = {
    "uniform": (37, 8, 16, "uniform"),  # T k = 296: not a multiple of 64
    "small_tiles": (13, 3, 8, "uniform"),  # T k = 39: one partial tile an expert
    "empty_experts": (200, 2, 32, "few"),  # 29 experts get no row, 3 get 2-3 tiles
    "skewed": (64, 8, 16, "skewed"),  # half the pairs on one expert: one full tile
    "hot_expert": (300, 4, 16, "skewed"),  # 300 rows on expert 0: 4 full tiles + 44
    "one_token": (1, 8, 128, "uniform"),  # a decode row
}


def _sel(T, k, n, how, rng):
    """[T, k] distinct experts a token (as top-k gives)."""
    if how == "uniform":
        return np.stack([rng.permutation(n)[:k] for _ in range(T)])
    if how == "few":  # experts 3, 5, 11 only
        return np.stack([rng.permutation([3, 5, 11])[:k] for _ in range(T)])
    # skewed: expert 0 first for every token, the rest from 1..k+1
    return np.stack([[0, *rng.permutation(np.arange(1, k + 2))[:k - 1]]
                     for _ in range(T)])


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_route_layout_invariants(layout):
    T, k, n, how = LAYOUTS[layout]
    bm = md.MOE_BM
    sel = torch.from_numpy(_sel(T, k, n, how, np.random.default_rng(1)))
    r = md.route(sel, n)
    P = T * k
    flat = sel.reshape(-1)
    # each pair lands once, sorted by expert, stable within an expert
    assert sorted(r.order.tolist()) == list(range(P))
    experts = flat[r.order]
    assert torch.all(experts[1:] >= experts[:-1])
    for e in range(n):
        rows = r.order[experts == e]
        assert torch.all(rows[1:] > rows[:-1])
    assert torch.equal(r.tok.long(), r.order // k) and r.tok.dtype == torch.int32
    # the tile map: the grid's bound, live tiles first, covering every row
    # once, each inside one expert and at most bm rows
    assert r.tiles.shape == (md.tile_count(P, n), 3)
    tiles = r.tiles.tolist()
    live = [t for t in tiles if t[0] >= 0]
    assert tiles[:len(live)] == live
    assert all(t == [-1, 0, 0] for t in tiles[len(live):])
    covered = []
    for e, r0, r1 in live:
        assert 0 < r1 - r0 <= bm
        assert torch.all(experts[r0:r1] == e)
        covered += range(r0, r1)
    assert covered == list(range(P))
    counts = torch.bincount(flat, minlength=n)
    assert {t[0] for t in live} == {e for e in range(n) if counts[e] > 0}
    assert len(live) == sum(-(-c // bm) for c in counts.tolist())
    assert [(e, lo, hi) for e, lo, hi in md.expert_rows(r.tiles)] == [
        (e, int(counts[:e].sum()), int(counts[:e + 1].sum()))
        for e in range(n) if counts[e] > 0]


# -- the grouped GEMM and the block ----------------------------------------------

def _experts(rng, n, E, F):
    return {"w_router": rng.standard_normal((E, n)) * E ** -0.5,
            "we_gate": rng.standard_normal((n, E, F)) * E ** -0.5,
            "we_up": rng.standard_normal((n, E, F)) * E ** -0.5,
            "we_down": rng.standard_normal((n, F, E)) * F ** -0.5}


@pytest.mark.parametrize("scoring,norm_topk", [("softmax", True), ("softmax", False),
                                               ("sigmoid", True)])
@pytest.mark.parametrize("T,n,k", [(19, 8, 2), (70, 16, 4), (1, 16, 4)])
def test_plain_grouped_gemm_matches_dense_reference(T, n, k, scoring, norm_topk):
    """route -> moe_gate_up -> moe_down -> combine on CPU tensors (the
    plain grouped GEMM: no launch) against moe_dense_reference."""
    rng = np.random.default_rng(2)
    E, F = 64, 96
    w = {k_: v.astype(np.float32) for k_, v in _experts(rng, n, E, F).items()}
    x = rng.standard_normal((T, E)).astype(np.float32)
    ref = np.asarray(jmd.moe_dense_reference(
        jnp.asarray(x), *(jnp.asarray(w[k_]) for k_ in ("w_router", "we_gate", "we_up",
                                                       "we_down")),
        k, scoring, norm_topk))
    t = {k_: torch.from_numpy(v) for k_, v in w.items()}
    xt = torch.from_numpy(x)
    weights, sel = md.router_topk((xt @ t["w_router"]).float(), k, scoring, norm_topk)
    r = md.route(sel, n)
    launches = md.moe_gate_up.launches, md.moe_down.launches
    h = md.moe_gate_up(xt, r.tok, t["we_gate"], t["we_up"], r.tiles)
    y = md.combine(md.moe_down(h, t["we_down"], r.tiles), r.order, weights)
    assert (md.moe_gate_up.launches, md.moe_down.launches) == launches
    np.testing.assert_allclose(y.numpy(), ref, **TOL)
    dense = md.moe_dense_reference(xt, t["w_router"], t["we_gate"], t["we_up"],
                                   t["we_down"], k, scoring, norm_topk)
    np.testing.assert_allclose(dense.numpy(), ref, **TOL)


def _raise_without_nvcc(monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda p: False)
    monkeypatch.setattr(_build, "_libs", {})


def test_grouped_gemm_wrappers_raise_unless_on_the_cpu(monkeypatch):
    """Tensors that are not on the CPU (the meta device, on a machine
    without the CUDA toolkit) reach the kernel's build and raise: no plain
    fallback, no launch counted. Shapes the kernel does not take raise
    before the build."""
    _raise_without_nvcc(monkeypatch)
    bf = dict(dtype=torch.bfloat16, device="meta")
    tok = torch.zeros(16, dtype=torch.int32, device="meta")
    tiles = torch.zeros(md.tile_count(16, 4), 3, dtype=torch.int32, device="meta")
    x, wg = torch.zeros(8, 64, **bf), torch.zeros(4, 64, 96, **bf)
    h, wd = torch.zeros(16, 96, **bf), torch.zeros(4, 96, 64, **bf)
    before = md.moe_gate_up.launches, md.moe_down.launches
    with pytest.raises(RuntimeError, match="nvcc not found"):
        md.moe_gate_up(x, tok, wg, wg.clone(), tiles)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        md.moe_down(h, wd, tiles)
    with pytest.raises(ValueError, match="no kernel for"):
        md.moe_down(torch.zeros(16, 72, **bf), torch.zeros(4, 72, 64, **bf), tiles)
    with pytest.raises(TypeError, match="bf16"):
        md.moe_gate_up(x.float(), tok, wg, wg.clone(), tiles)
    with pytest.raises(TypeError, match="int32"):
        md.moe_down(h, wd, tiles.long())
    assert (md.moe_gate_up.launches, md.moe_down.launches) == before


# the MoE configs of the forward and engine tests
MOE_CONFIGS = ("tiny-moe", "tiny-moe-shared", "tiny-mla-moe")
NORM_LEAVES = ("attn_norm", "mlp_norm", "kv_norm", "q_lat_norm", "norm_f")


def _pair(name, seed, **kw):
    """Both packages' configs and a params tree of the reference's init's
    leaves and shapes (jax.eval_shape: nothing of it runs), drawn with
    numpy at the init's scales, norms away from 1 and the router bias away
    from 0: as numpy and as the port's params (f32)."""
    jcfg = jax_get_config(name).with_(**kw)
    cfg = get_config(name).with_(**kw)
    tree = jax.eval_shape(lambda: jllama.init_params(jcfg, jax.random.PRNGKey(seed),
                                                     jnp.float32))
    rng = np.random.default_rng(seed)

    def draw(leaf, shape):
        x = rng.standard_normal(shape)
        if leaf in NORM_LEAVES:
            x = 1.0 + 0.3 * x
        elif leaf == "router_bias":
            x = 0.5 * x
        else:  # weights: fan_in^-0.5 (embed [V, dim], others [.., in, out])
            x = x * shape[-1 if leaf == "embed" else -2] ** -0.5
        return x.astype(np.float32)

    jp = {}
    for key, v in tree.items():
        jp[key] = ({k: draw(k, s.shape) for k, s in v.items()}
                   if isinstance(v, dict) else draw(key, v.shape))
    return jcfg, cfg, jp, params_from_numpy(jp, cfg, "cpu", torch.float32)


@pytest.mark.parametrize("impl", ["kernel", "ref"])
@pytest.mark.parametrize("name", MOE_CONFIGS + ("gatectl",))
def test_moe_block_matches_jax(name, impl):
    """One MoE layer of each config (the last: tiny-mla-moe's first layer
    is dense) through the reference's _moe_block(mesh=None) and the port's
    moe_block; "gatectl" adds Qwen2-MoE's sigmoid gate on the shared expert."""
    base = "tiny-moe-shared" if name == "gatectl" else name
    jcfg, cfg, jp, tp = _pair(base, 3)
    lj = {k: v[-1] for k, v in jp["layers"].items()}
    rng = np.random.default_rng(4)
    if name == "gatectl":
        lj["ws_gatectl"] = (rng.standard_normal((cfg.dim, 1)) * cfg.dim ** -0.5
                            ).astype(np.float32)
    x = rng.standard_normal((2, 5, cfg.dim)).astype(np.float32)
    ref = np.asarray(_moe_block(jcfg, {k: jnp.asarray(v) for k, v in lj.items()},
                                jnp.asarray(x), mesh=None))
    before = md.moe_gate_up.launches
    out = moe_block(cfg, {k: torch.from_numpy(v) for k, v in lj.items()},
                    torch.from_numpy(x), impl)
    assert md.moe_gate_up.launches == before
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


# -- the forward -------------------------------------------------------------------

NP, PS, MP = 32, 4, 10
JAX_FORWARD = jax.jit(jllama.forward, static_argnames=("config", "attn_impl"),
                      compiler_options=CHEAP)
PAGES = np.random.default_rng(0).permutation(NP)[:3 * MP].reshape(3, MP).astype(np.int32)


def _padded_steps(rng, V):
    """A prefill chunk of two sequences, a second chunk over that prior
    context with padding rows, and a decode step with a padding row."""
    steps = []
    pos = np.full((2, 12), -1, np.int32)
    pos[0, :9] = np.arange(9)
    pos[1, :12] = np.arange(12)
    steps.append((pos, [0, 1], [9, 12], None))
    pos = np.full((2, 12), -1, np.int32)
    pos[0, :5] = np.arange(9, 14)
    pos[1, :12] = np.arange(12, 24)
    steps.append((pos, [0, 1], [14, 24], np.array([4, 11], np.int32)))
    pos = np.array([[14], [24], [-1]], np.int32)
    steps.append((pos, [0, 1, 2], [15, 25, 0], None))
    out = []
    for pos, rows, kvl, last in steps:
        tok = rng.integers(0, V, size=pos.shape).astype(np.int32)
        out.append((tok, pos, PAGES[rows], np.asarray(kvl, np.int32), last))
    return out


@pytest.mark.parametrize("name", MOE_CONFIGS)
def test_moe_forward_matches_jax(name):
    """Padded prefill and decode steps (then, for GQA, a ragged step of
    two decode rows and a chunk, padding tokens routed too) through the
    reference's forward(attn_impl="jnp") and both of the port's paths,
    each on its own pools."""
    jcfg, cfg, jp, tparams = _pair(name, 0)
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
    if not cfg.is_mla:
        q_lens, q_starts, tb = [1, 1, 7], [15, 25, 0], 16
        kv_lens = [s + n for s, n in zip(q_starts, q_lens)]
        mdata = rag.build_ragged_metadata(q_lens, q_starts, kv_lens, PAGES.tolist(),
                                          tb, max_pages=MP)
        gather = np.zeros(mdata["seg_page_table"].shape[0], np.int32)
        gather[:3] = mdata["last_index"]
        tok = np.zeros((1, tb), np.int32)
        tok[0, :9] = rng.integers(0, cfg.vocab_size, 9)
        pos = mdata["tok_positions"][None]
        ragged = [mdata[k] for k in ("seg_page_table", "seg_kv_lens", "meta")]
        jl, jk, jv = JAX_FORWARD(
            jcfg, jp, jnp.asarray(tok), jnp.asarray(pos), jk, jv,
            jnp.asarray(mdata["tok_page_table"]), jnp.asarray(mdata["tok_kv_lens"]),
            jnp.asarray(gather), attn_impl="jnp",
            ragged=tuple(map(jnp.asarray, ragged)))
        for impl, (tk, tv) in pools.items():
            tl = llama.forward(cfg, tparams, t(tok), t(pos), tk, tv,
                               last_index=t(gather), attn_impl=impl,
                               ragged=tuple(map(t, ragged)))
            np.testing.assert_allclose(tl[0, :3].numpy(), np.asarray(jl)[0, :3],
                                       atol=1e-4, rtol=1e-4)
    for tk, tv in pools.values():
        np.testing.assert_allclose(tk[:, :NP].numpy(), np.asarray(jk), **TOL)
        np.testing.assert_allclose(tv[:, :NP].numpy(), np.asarray(jv), **TOL)


# -- the engine --------------------------------------------------------------------

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


JAX_STREAMS = {}


@pytest.mark.parametrize("name,fused", [("tiny-moe", "1"), ("tiny-moe", "0"),
                                        ("tiny-mla-moe", "1")],
                         ids=["tiny-moe-fused", "tiny-moe-unfused", "tiny-mla-moe"])
async def test_moe_greedy_streams_match_jax(monkeypatch, name, fused):
    """Prompts of 4 to 13 tokens decoding concurrently, chunked at 8,
    through both engines (tiny-mla-moe: the padded fallback); moe_block
    runs once a pass and MoE layer (what chip_smoke holds the grouped
    GEMM's launches to)."""
    monkeypatch.setenv("DYN_RAGGED_MIXED", "1")
    jcfg, cfg, jp, tparams = _pair(name, 5)
    rng = np.random.default_rng(7)
    reqs = [{"token_ids": rng.integers(1, 500, size=n).tolist(),
             "sampling": {"temperature": 0.0},
             "stop": {"max_tokens": 8 if i == 0 else 6, "stop_ids": []}}
            for i, n in enumerate((6, 4, 9, 5, 13))]
    if name not in JAX_STREAMS:
        monkeypatch.setenv("DYN_FUSED_MIXED", "1")
        jeng = JaxEngine(JaxRunner(jcfg, params=jp, dtype=jnp.float32, **GEOMETRY),
                         **ENGINE)
        JAX_STREAMS[name] = await _serve(jeng, reqs)
    monkeypatch.setenv("DYN_FUSED_MIXED", fused)
    runner = ModelRunner(cfg, device="cpu", dtype=torch.float32, params=tparams,
                         **GEOMETRY)
    teng = InferenceEngine(runner, **ENGINE)
    assert teng.fused_mixed == (fused == "1")
    blocks = []
    monkeypatch.setattr(llama, "moe_block",
                        lambda *a, _f=llama.moe_block: blocks.append(1) or _f(*a))
    tres = await _serve(teng, reqs)
    assert tres == JAX_STREAMS[name]
    assert all(f == "length" for _, f in tres)
    st = runner.stats
    passes = (st["prefill_chunks"] + st["padded_prefill_dispatches"] + st["decode_steps"]
              + st["ragged_mixed_dispatches"] + st["ragged_verify_dispatches"])
    assert runner.moe_layers == cfg.n_layers - cfg.n_dense_layers
    assert passes > 0 and len(blocks) == passes * runner.moe_layers


# -- presets and the params tree ------------------------------------------------

ADDED = ("tiny-moe", "tiny-moe-shared", "qwen3-30b-a3b", "mixtral-8x7b",
         "deepseek-v3", "tiny-mla-moe")


@pytest.mark.parametrize("name", ADDED)
def test_moe_preset_matches_jax(name):
    cfg, ref = PRESETS[name], jax_get_config(name)
    for f in cfg.__dataclass_fields__:
        assert getattr(cfg, f) == getattr(ref, f), (name, f)
    assert cfg.shared_ffn_dim == ref.shared_ffn_dim and cfg.is_moe == ref.is_moe


@pytest.mark.parametrize("name,kw", [("qwen3-30b-a3b", {}), ("deepseek-v3", {}),
                                     ("deepseek-v3", dict(n_layers=4)),
                                     ("mixtral-8x7b", {})])
def test_param_shapes_match_jax_tree(name, kw):
    """The shapes of the reference's tree (jax.eval_shape: nothing is
    allocated), layers_dense included; ws_gatectl is the one leaf a
    checkpoint may add."""
    jcfg = jax_get_config(name).with_(**kw)
    tree = jax.eval_shape(lambda: jllama.init_params(jcfg, jax.random.PRNGKey(0)))
    want = llama.param_shapes(get_config(name).with_(**kw))
    assert sorted(want) == sorted(tree)
    for key, v in tree.items():
        if isinstance(v, dict):
            got = {k: s for k, s in want[key].items() if k != "ws_gatectl"}
            assert got == {k: x.shape for k, x in v.items()}, key
        else:
            assert want[key] == v.shape, key
    leaves = jax.tree_util.tree_leaves(tree)
    assert llama.param_bytes(get_config(name).with_(**kw)) == sum(
        x.size * x.dtype.itemsize for x in leaves)


@pytest.mark.parametrize("name", MOE_CONFIGS)
def test_params_from_numpy_takes_moe_trees(name):
    """The numpy tree of each MoE config (tiny-mla-moe: with layers_dense)
    comes across leaf for leaf, f32 where the reference keeps f32; a
    missing stack or leaf raises; ws_gatectl is taken when present."""
    jcfg, cfg, jp, tp = _pair(name, 6)
    assert sorted(tp) == sorted(jp)
    for key, v in jp.items():
        if isinstance(v, dict):
            assert sorted(tp[key]) == sorted(v)
            for leaf, arr in v.items():
                np.testing.assert_array_equal(tp[key][leaf].numpy(), arr)
        else:
            np.testing.assert_array_equal(tp[key].numpy(), v)
    bf = params_from_numpy(jp, cfg, "cpu", torch.bfloat16)
    assert bf["layers"]["we_gate"].dtype == torch.bfloat16
    if cfg.moe_router_bias:
        assert bf["layers"]["router_bias"].dtype == torch.float32
    if "layers_dense" in jp:
        assert sorted(jp["layers_dense"]) != sorted(jp["layers"])
        broken = {k: v for k, v in jp.items() if k != "layers_dense"}
        with pytest.raises(KeyError, match="layers_dense"):
            params_from_numpy(broken, cfg, "cpu", torch.float32)
    broken = dict(jp, layers={k: v for k, v in jp["layers"].items() if k != "we_up"})
    with pytest.raises(KeyError, match="we_up"):
        params_from_numpy(broken, cfg, "cpu", torch.float32)
    if cfg.n_shared_experts:
        gated = dict(jp, layers=dict(jp["layers"], ws_gatectl=np.zeros(
            (jp["layers"]["ws_gate"].shape[0], cfg.dim, 1), np.float32)))
        assert "ws_gatectl" in params_from_numpy(gated, cfg, "cpu")["layers"]


@pytest.mark.parametrize("name", MOE_CONFIGS)
def test_moe_init_tree_matches_jax(name):
    """The port's init draws the reference's tree: the same stacks, leaves
    and shapes, the router bias 0 and norms 1."""
    jcfg, cfg, jp, _ = _pair(name, 2)
    own = llama.init_params(cfg, 0, torch.float32, "cpu")
    assert sorted(own) == sorted(jp)
    for key, v in jp.items():
        if not isinstance(v, dict):
            assert tuple(own[key].shape) == v.shape
            continue
        assert sorted(own[key]) == sorted(v)
        for leaf, arr in v.items():
            assert tuple(own[key][leaf].shape) == arr.shape, leaf
        if "router_bias" in v:
            assert torch.all(own[key]["router_bias"] == 0)
    assert llama.moe_layer_count(cfg) == len(own["layers"]["we_gate"])
