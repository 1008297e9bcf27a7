"""The port's weight-only quantization against the JAX package: the
quantizers, the plain versions of the quantized products (`mm`,
`tied_logits`, `embed_lookup`, the grouped GEMM's quantized entries and
the every-expert MoE block), the forward over quantized trees carried
across by params_from_numpy, the engine's greedy streams with
`quantize=`, the quantized init, the bytes, the worker's flag and the
wrappers' C interfaces.

Inputs are made with numpy from a seed and handed to both sides. The
quantizers and `embed_lookup` agree bit for bit (fp8 codes compared as
their bytes). The products run the same f32 arithmetic in another
summation order: atol = rtol = 1e-5 for one product, the forward's logits
atol 1e-4 and its pools 1e-5, as tests/test_torch_model.py. The CUDA
kernels (ops/csrc/quant_gemm.cu, the grouped GEMM's quantized bodies) run
only on the card, where chip_smoke.py holds them against these plain
versions.
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
from dynamo_tpu.models.moe import _moe_block
from dynamo_tpu.runtime.context import Context as JaxContext
from dynamo_tpu_torch import worker
from dynamo_tpu_torch.engine.engine import InferenceEngine
from dynamo_tpu_torch.engine.model_runner import ModelRunner
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.models import llama
from dynamo_tpu_torch.models import quant
from dynamo_tpu_torch.models.config import get_config
from dynamo_tpu_torch.models.moe import moe_block
from dynamo_tpu_torch.models.toolkit import make_kv_pool
from dynamo_tpu_torch.ops import _build
from dynamo_tpu_torch.ops import moe_dispatch as md
from dynamo_tpu_torch.ops import quant_gemm as qg
from dynamo_tpu_torch.runtime.context import Context

TOL = dict(atol=1e-5, rtol=1e-5)
CHEAP = {"xla_backend_optimization_level": 0}
MODES = ("int8", "fp8")
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _bytes(q):
    """Codes as comparable integers: int8 as they are, e4m3 as its bytes."""
    if isinstance(q, torch.Tensor):
        return (q.view(torch.uint8) if q.dtype == torch.float8_e4m3fn else q).numpy()
    q = np.asarray(q)
    return q.view(np.uint8) if q.dtype.name == "float8_e4m3fn" else q


def _weights(rng, shape):
    """Columns whose scales spread over ten decades, an all-zero column, and
    a row of values at halves of the largest (ties when s rounds to 1)."""
    w = rng.standard_normal(shape) * np.exp(rng.uniform(-11.5, 11.5, (*shape[:-2], 1, shape[-1])))
    w[..., :, 1] = 0.0
    w[..., 0, 2] = 127.0
    w[..., 1:9, 2] = [2.5, -3.5, 0.5, -0.5, 1.5, 126.5, -126.5, 64.5]
    return w.astype(np.float32)


def _assert_quantized_equal(got, want):
    assert sorted(got) == sorted(want)
    np.testing.assert_array_equal(_bytes(got["q"]), _bytes(want["q"]))
    np.testing.assert_array_equal(got["s"].numpy(), np.asarray(want["s"]))
    assert got["s"].dtype == torch.float32
    if "dt" in want:
        assert got["dt"].numel() == 0


# -- the quantizers ---------------------------------------------------------------


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", [(40, 24), (2, 3, 16, 24)], ids=["matrix", "stacked"])
def test_quantize_weight_matches_jax(mode, dtype, shape):
    """Stacked [L, n_exp, K, N] leaves too: one scale a column of each matrix."""
    jdt, tdt = DTYPES[dtype]
    w = _weights(np.random.default_rng(0), shape)
    want = jax.device_get(jquant.quantize_weight(jnp.asarray(w, jdt), mode))
    tw = torch.from_numpy(w).to(tdt)
    got = quant.quantize_weight(tw, mode)
    assert got["q"].dtype == quant.CODE_DTYPES[mode]
    assert tuple(got["s"].shape) == (*shape[:-2], 1, shape[-1])
    _assert_quantized_equal(got, want)
    assert torch.equal(tw, torch.from_numpy(w).to(tdt))  # the input is left as it is
    assert not got["q"][..., 1].float().any()  # the all-zero column: codes 0


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("mode", MODES)
def test_quantize_embed_matches_jax(mode, dtype):
    jdt, tdt = DTYPES[dtype]
    w = _weights(np.random.default_rng(1), (24, 40))[0:24].T.copy()  # rows spread
    want = jax.device_get(jquant.quantize_embed(jnp.asarray(w, jdt), mode))
    got = quant.quantize_embed(torch.from_numpy(w).to(tdt), mode)
    _assert_quantized_equal(got, want)
    assert tuple(got["s"].shape) == (40, 1) and got["dt"].dtype == tdt


def test_a_true_division_would_give_other_scales():
    """The reference's scales are amax times the f32 reciprocal (XLA's
    rewrite of the division by the constant); a true division differs on
    some of these columns, so the test above holds the product."""
    w = _weights(np.random.default_rng(2), (2, 3, 16, 24))
    want = np.asarray(jquant.quantize_weight(jnp.asarray(w), "fp8")["s"])
    amax = np.maximum(np.abs(w).max(-2, keepdims=True), np.float32(1e-8))
    assert (amax / np.float32(448.0) != want).any()
    np.testing.assert_array_equal(amax * np.float32(1 / 448.0), want)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", ["tiny", "tiny-moe-shared", "tiny-mla", "tiny-gemma2"])
def test_quantize_params_matches_jax(name, mode):
    """Every leaf of DEFAULT_QUANT_NAMES quantized (the embedding per row,
    its "dt" the table's dtype), the rest the same tensors."""
    jp = jax.device_get(jllama.init_params(jax_get_config(name), jax.random.PRNGKey(0),
                                           jnp.float32))
    want = jax.device_get(jquant.quantize_params(jp, mode=mode))
    tree = params_from_numpy(jp, get_config(name), "cpu", torch.float32)
    got = quant.quantize_params(tree, mode=mode)
    for key, v in want.items():
        if key in ("layers", "layers_dense"):
            for leaf, w in v.items():
                if quant.is_quantized_weight(w):
                    _assert_quantized_equal(got[key][leaf], w)
                else:
                    assert got[key][leaf] is tree[key][leaf]
                    assert not quant.is_quantized_weight(tree[key][leaf])
        elif quant.is_quantized_weight(v):
            _assert_quantized_equal(got[key], v)
        else:
            assert got[key] is tree[key]
    assert quant.is_quantized_weight(got["embed"]) and got["embed"]["dt"].dtype == torch.float32


# -- the plain versions --------------------------------------------------------------


def _to_jax(w):
    """A port's quantized leaf as the reference's: the same code bytes (e4m3
    as ml_dtypes' float8_e4m3fn) and scales."""
    q = _bytes(w["q"])
    out = {"q": jnp.asarray(q.view(jnp.float8_e4m3fn) if q.dtype == np.uint8 else q),
           "s": jnp.asarray(w["s"].numpy())}
    if "dt" in w:
        out["dt"] = jnp.zeros((0,), jnp.float32)
    return out


@pytest.mark.parametrize("mode", MODES)
def test_mm_and_tied_logits_match_jax(mode):
    """mm over a matrix and over a stack of them, tied_logits over a row-
    quantized table, embed_lookup (exact), in f32; and the plain version's
    two roundings in bf16 (the product, then the scale in x's dtype)."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 40)).astype(np.float32)
    w = quant.quantize_weight(torch.from_numpy(_weights(rng, (40, 24))), mode)
    stack = quant.quantize_weight(torch.from_numpy(_weights(rng, (3, 40, 24))), mode)
    table = quant.quantize_embed(torch.from_numpy(rng.standard_normal((30, 40)).astype(
        np.float32)), mode)
    jw, jstack, jtable = _to_jax(w), _to_jax(stack), _to_jax(table)
    tx = torch.from_numpy(x)
    for impl in ("kernel", "ref"):
        np.testing.assert_allclose(quant.mm(tx, w, impl).numpy(),
                                   np.asarray(jquant.mm(jnp.asarray(x), jw)), **TOL)
        np.testing.assert_allclose(
            quant.tied_logits(tx, table, impl).numpy(),
            np.asarray(jquant.tied_logits(jnp.asarray(x), jtable)), **TOL)
    np.testing.assert_allclose(quant.mm(tx[0], stack).numpy(),
                               np.asarray(jquant.mm(jnp.asarray(x[0]), jstack)), **TOL)
    tok = rng.integers(0, 30, (2, 7)).astype(np.int32)
    np.testing.assert_array_equal(
        quant.embed_lookup(table, torch.from_numpy(tok)).numpy(),
        np.asarray(jquant.embed_lookup(jtable, jnp.asarray(tok))))
    xb = tx.bfloat16()
    want = (xb @ w["q"].to(torch.bfloat16)) * w["s"].to(torch.bfloat16)
    assert torch.equal(qg.quant_matmul_ref(xb, w["q"], w["s"]), want)
    want = (xb @ table["q"].T.to(torch.bfloat16)) * table["s"][:, 0].to(torch.bfloat16)
    assert torch.equal(qg.quant_matmul_ref(xb, table["q"], table["s"], nk=True), want)


def _moe_layer(name, mode, seed):
    """One MoE layer's leaves of `name` (f32), drawn at the init's scales,
    the reference's quantization applied: (JAX leaves, the port's)."""
    jcfg, cfg = jax_get_config(name), get_config(name)
    jp = jax.device_get(jllama.init_params(jcfg, jax.random.PRNGKey(seed), jnp.float32))
    jp = jax.device_get(jquant.quantize_params(jp, mode=mode))
    tp = params_from_numpy(jp, cfg, "cpu", torch.float32)
    lj = {k: jax.tree.map(lambda a: jnp.asarray(a[-1]), v) for k, v in jp["layers"].items()}
    lt = {k: ({kk: vv[-1] for kk, vv in v.items()} if isinstance(v, dict) else v[-1])
          for k, v in tp["layers"].items()}
    return jcfg, cfg, lj, lt


@pytest.mark.parametrize("impl", ["kernel", "ref"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", ["tiny-moe", "tiny-moe-shared"])
def test_quantized_moe_block_matches_jax(name, mode, impl):
    """The reference's every-expert _moe_block on quantized experts (and
    quantized shared experts) against the port's routed plain grouped GEMM
    (impl kernel) and its every-expert form (ref)."""
    jcfg, cfg, lj, lt = _moe_layer(name, mode, 4)
    assert quant.is_quantized_weight(lt["we_gate"]) and not quant.is_quantized_weight(lt["w_router"])
    x = np.random.default_rng(5).standard_normal((2, 5, cfg.dim)).astype(np.float32)
    ref = np.asarray(_moe_block(jcfg, lj, jnp.asarray(x), mesh=None))
    before = md.moe_gate_up.launches
    out = moe_block(cfg, lt, torch.from_numpy(x), impl)
    assert md.moe_gate_up.launches == before
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


@pytest.mark.parametrize("mode", MODES)
def test_quantized_grouped_gemm_plain_versions(mode):
    """moe_gate_up_ref / moe_down_ref on quantized experts equal, row by
    row, the reference's `mm` on each row's expert (bf16: the same
    roundings, exactly)."""
    rng = np.random.default_rng(6)
    n, E, F_, T, k = 4, 64, 128, 6, 2
    wg, wu = (quant.quantize_weight(torch.from_numpy(_weights(rng, (n, E, F_))), mode)
              for _ in range(2))
    wd = quant.quantize_weight(torch.from_numpy(_weights(rng, (n, F_, E))), mode)
    x = torch.from_numpy(rng.standard_normal((T, E)).astype(np.float32)).bfloat16()
    sel = torch.from_numpy(rng.permutation(n * T).reshape(T, n)[:, :k] % n)
    r = md.route(sel, n)
    h = md.moe_gate_up(x, r.tok, wg, wu, r.tiles)
    y = md.moe_down(h, wd, r.tiles)
    for e, r0, r1 in md.expert_rows(r.tiles):
        xr = x[r.tok[r0:r1].long()]
        one = {"q": wg["q"][e], "s": wg["s"][e]}
        up = {"q": wu["q"][e], "s": wu["s"][e]}
        want = torch.nn.functional.silu(quant.mm(xr, one, "ref")) * quant.mm(xr, up, "ref")
        assert torch.equal(h[r0:r1], want)
        assert torch.equal(y[r0:r1], quant.mm(h[r0:r1], {"q": wd["q"][e], "s": wd["s"][e]},
                                              "ref"))


# -- the forward ----------------------------------------------------------------------

NP, PS, MP = 32, 4, 10
PAGES = np.random.default_rng(0).permutation(NP)[:3 * MP].reshape(3, MP).astype(np.int32)
JAX_FORWARD = jax.jit(jllama.forward, static_argnames=("config", "attn_impl"),
                      compiler_options=CHEAP)


def _steps(rng, V):
    """Chunked prefill (past tiny-gemma2's window of 8) with padding rows,
    a second chunk over prior context, and two decode steps with a padding
    row: (tokens, positions, page rows, kv_lens, last_index)."""
    steps = []
    pos = np.full((2, 12), -1, np.int32)
    pos[0, :9] = np.arange(9)
    pos[1, :12] = np.arange(12)
    steps.append((pos, [0, 1], [9, 12], None))
    pos = np.full((2, 12), -1, np.int32)
    pos[0, :5] = np.arange(9, 14)
    pos[1, :12] = np.arange(12, 24)
    steps.append((pos, [0, 1], [14, 24], np.array([4, 11], np.int32)))
    for t in range(2):
        pos = np.array([[14 + t], [24 + t], [-1]], np.int32)
        steps.append((pos, [0, 1, 2], [15 + t, 25 + t, 0], None))
    out = []
    for pos, rows, kvl, last in steps:
        tok = rng.integers(0, V, size=pos.shape).astype(np.int32)
        out.append((tok, pos, PAGES[rows], np.asarray(kvl, np.int32), last))
    return out


def _jparams(name, seed, mode):
    """The JAX init tree (zero-centred norms given values, so that (1 + w)
    is held too) and the reference's quantization of it."""
    jcfg = jax_get_config(name)
    jp = jax.device_get(jllama.init_params(jcfg, jax.random.PRNGKey(seed), jnp.float32))
    if jcfg.norm_zero_centered:
        rng = np.random.default_rng(seed)
        jp = dict(jp, layers=dict(jp["layers"]))
        for k in ("attn_norm", "mlp_norm", "post_attn_norm", "post_mlp_norm"):
            arr = jp["layers"][k]
            jp["layers"][k] = (0.3 * rng.standard_normal(arr.shape)).astype(np.float32)
        jp["norm_f"] = (0.3 * rng.standard_normal(jp["norm_f"].shape)).astype(np.float32)
    return jcfg, jax.device_get(jquant.quantize_params(jp, mode=mode))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", ["tiny", "tiny-moe", "tiny-mla", "tiny-gemma2"])
def test_quantized_forward_matches_jax(name, mode):
    """The reference's forward(attn_impl="jnp") on its quantized tree
    against both of the port's paths on that tree carried across by
    params_from_numpy (tiny-gemma2: the tied, scaled embedding through
    embed_lookup and tied_logits), logits and written pools."""
    jcfg, jp = _jparams(name, 0, mode)
    cfg = get_config(name)
    tparams = params_from_numpy(jp, cfg, "cpu", torch.float32)
    assert quant.is_quantized_weight(tparams["embed"]) and cfg.tie_embeddings == (
        "lm_head" not in tparams)
    jk, jv = jllama.make_kv_pool(jcfg, NP, PS, jnp.float32)
    pools = {impl: make_kv_pool(cfg, NP + 1, PS, torch.float32, "cpu")
             for impl in ("kernel", "ref")}
    t = torch.from_numpy
    for tok, pos, pt, kvl, last in _steps(np.random.default_rng(1), cfg.vocab_size):
        jl, jk, jv = JAX_FORWARD(
            jcfg, jp, jnp.asarray(tok), jnp.asarray(pos), jk, jv,
            jnp.asarray(pt), jnp.asarray(kvl),
            None if last is None else jnp.asarray(last), attn_impl="jnp")
        jl = np.asarray(jl)
        real = pos >= 0 if last is None else np.ones((pos.shape[0], 1), bool)
        if pos.shape[1] == 1:
            real = np.ones_like(real)
        for impl, (tk, tv) in pools.items():
            tl = llama.forward(cfg, tparams, t(tok), t(pos), tk, tv, t(pt), t(kvl),
                               None if last is None else t(last), attn_impl=impl).numpy()
            np.testing.assert_allclose(tl[real], jl[real], atol=1e-4, rtol=1e-4)
    for tk, tv in pools.values():
        np.testing.assert_allclose(tk[:, :NP].numpy(), np.asarray(jk), **TOL)
        np.testing.assert_allclose(tv[:, :NP].numpy(), np.asarray(jv), **TOL)


# -- the engine ------------------------------------------------------------------------

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


@pytest.mark.parametrize("fused", ["1", "0"], ids=["fused", "unfused"])
@pytest.mark.parametrize("mode", MODES)
async def test_quantized_greedy_streams_match_jax(monkeypatch, mode, fused):
    """Prompts of 4 to 13 tokens decoding concurrently, chunked at 8: the
    JAX engine's ModelRunner(quantize=mode) and the port's on the same f32
    params, each quantizing them itself; the caller's tree is left as it
    is."""
    monkeypatch.setenv("DYN_RAGGED_MIXED", "1")
    jcfg = jax_get_config("tiny")
    jp = jax.device_get(jllama.init_params(jcfg, jax.random.PRNGKey(3), jnp.float32))
    cfg = get_config("tiny")
    rng = np.random.default_rng(7)
    reqs = [{"token_ids": rng.integers(1, 500, size=n).tolist(),
             "sampling": {"temperature": 0.0},
             "stop": {"max_tokens": 8 if i == 0 else 6, "stop_ids": []}}
            for i, n in enumerate((6, 4, 9, 5, 13))]
    if mode not in JAX_STREAMS:
        monkeypatch.setenv("DYN_FUSED_MIXED", "1")
        jeng = JaxEngine(JaxRunner(jcfg, params=jp, dtype=jnp.float32, quantize=mode,
                                   **GEOMETRY), **ENGINE)
        JAX_STREAMS[mode] = await _serve(jeng, reqs)
    monkeypatch.setenv("DYN_FUSED_MIXED", fused)
    plain = params_from_numpy(jp, cfg, "cpu", torch.float32)
    wq = plain["layers"]["wq"]
    runner = ModelRunner(cfg, device="cpu", dtype=torch.float32, params=plain,
                         quantize=mode, **GEOMETRY)
    assert plain["layers"]["wq"] is wq and not quant.is_quantized_weight(plain["embed"])
    assert runner.quantize == mode
    assert runner.params["layers"]["wq"]["q"].dtype == quant.CODE_DTYPES[mode]
    teng = InferenceEngine(runner, **ENGINE)
    assert teng.fused_mixed == (fused == "1")
    tres = await _serve(teng, reqs)
    assert tres == JAX_STREAMS[mode]
    assert all(f == "length" for _, f in tres)
    assert runner.stats["ragged_mixed_dispatches"] > 0 or fused == "0"


# -- init, bytes, the worker -------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", ["tiny", "tiny-moe-shared", "tiny-mla-moe", "tiny-gemma2"])
def test_init_params_quantized_as_drawn(name, mode):
    """init_params(quantize=) equals quantize_params(init_params()) bit for
    bit, in bf16 (each matrix rounded to bf16 as drawn, then quantized)."""
    cfg = get_config(name)
    got = llama.init_params(cfg, 3, torch.bfloat16, "cpu", quantize=mode)
    want = quant.quantize_params(llama.init_params(cfg, 3, torch.bfloat16, "cpu"),
                                 mode=mode)

    def same(a, b):
        if isinstance(b, dict):
            assert sorted(a) == sorted(b)
            for k in b:
                same(a[k], b[k])
        else:
            assert a.dtype == b.dtype and a.shape == b.shape
            assert torch.equal(a.view(torch.uint8) if a.dtype == torch.float8_e4m3fn else a,
                               b.view(torch.uint8) if b.dtype == torch.float8_e4m3fn else b)

    same(got, want)
    with pytest.raises(ValueError, match="quantize mode"):
        llama.init_params(cfg, 3, torch.bfloat16, "cpu", quantize="int4")


def _tree_bytes(tree):
    if isinstance(tree, (dict, list)):
        return sum(map(_tree_bytes, tree.values() if isinstance(tree, dict) else tree))
    return tree.numel() * tree.element_size()


@pytest.mark.parametrize("mode", [None, "int8", "fp8"])
@pytest.mark.parametrize("name", ["tiny", "tiny-moe-shared", "tiny-mla-moe", "tiny-gemma2"])
def test_param_bytes_counts_codes_and_scales(name, mode):
    cfg = get_config(name)
    tree = llama.init_params(cfg, 0, torch.bfloat16, "cpu", quantize=mode)
    assert llama.param_bytes(cfg, torch.bfloat16, mode) == _tree_bytes(tree)


@pytest.mark.parametrize("mode", MODES)
def test_param_bytes_of_some_leaves(mode):
    """`only`: the bytes of just those leaves (what a runner adds when it
    quantizes the plain leaves of a caller's tree, which stays)."""
    cfg = get_config("tiny-moe-shared")
    tree = llama.init_params(cfg, 0, torch.bfloat16, "cpu", quantize=mode)
    only = {"wq", "we_down", "embed"}
    want = _tree_bytes([tree["embed"], tree["layers"]["wq"], tree["layers"]["we_down"]])
    assert llama.param_bytes(cfg, torch.bfloat16, mode, only=only) == want
    assert llama.param_bytes(cfg, torch.bfloat16, only=set()) == 0


def test_mixtral_fits_one_card_in_int8():
    """mixtral-8x7b: 93.4 GB of bf16 weights, 46-48 GB as int8 codes and
    f32 scales (45.1 GB of expert codes), which one 80 GB card holds."""
    cfg = get_config("mixtral-8x7b")
    assert 93e9 < llama.param_bytes(cfg) < 94e9
    for mode in MODES:
        assert 46e9 < llama.param_bytes(cfg, quantize=mode) < 48e9


def test_worker_quantize_flag():
    args = worker.parse_args(["--model", "tiny", "--device", "cpu", "--quantize", "fp8"])
    assert args.quantize == "fp8"
    assert worker.parse_args(["--model", "tiny"]).quantize is None
    runner, _ = worker.build_runner(args)
    assert runner.quantize == "fp8" and quant.is_quantized_weight(runner.params["embed"])
    assert runner.params["layers"]["w_up"]["q"].dtype == torch.float8_e4m3fn
    with pytest.raises(SystemExit):
        worker.parse_args(["--model", "tiny", "--quantize", "int4"])
    with pytest.raises(ValueError, match="unknown quantize mode"):
        ModelRunner(get_config("tiny"), device="cpu", quantize="int4", num_pages=8)


# -- params carried across --------------------------------------------------------------


def test_params_from_numpy_keeps_fp8_codes_and_refuses_bad_leaves():
    """fp8 codes (ml_dtypes arrays from JAX, or their uint8 view) arrive as
    the same bytes; scales of the wrong shape, a quantized leaf outside
    DEFAULT_QUANT_NAMES and an extra key in a quantized leaf are refused."""
    cfg = get_config("tiny")
    _, jp = _jparams("tiny", 0, "fp8")
    tp = params_from_numpy(jp, cfg, "cpu", torch.bfloat16)
    np.testing.assert_array_equal(_bytes(tp["layers"]["wq"]["q"]),
                                  _bytes(jp["layers"]["wq"]["q"]))
    assert tp["embed"]["dt"].dtype == torch.bfloat16
    assert tp["layers"]["attn_norm"].dtype == torch.float32
    as_bytes = dict(jp, layers=dict(jp["layers"], wq=dict(
        jp["layers"]["wq"], q=np.asarray(jp["layers"]["wq"]["q"]).view(np.uint8))))
    again = params_from_numpy(as_bytes, cfg, "cpu", torch.bfloat16)
    assert torch.equal(again["layers"]["wq"]["q"].view(torch.uint8),
                       tp["layers"]["wq"]["q"].view(torch.uint8))
    bad = dict(jp, layers=dict(jp["layers"], wk=dict(
        jp["layers"]["wk"], s=np.asarray(jp["layers"]["wk"]["s"])[..., :1])))
    with pytest.raises(ValueError, match="scales"):
        params_from_numpy(bad, cfg, "cpu", torch.bfloat16)
    bad = dict(jp, layers=dict(jp["layers"], attn_norm={"q": np.zeros(1), "s": np.zeros(1)}))
    with pytest.raises(ValueError, match="quantizes only"):
        params_from_numpy(bad, cfg, "cpu", torch.bfloat16)
    bad = dict(jp, layers=dict(jp["layers"], wv=dict(jp["layers"]["wv"], z=np.zeros(1))))
    with pytest.raises(KeyError, match="quantized leaf"):
        params_from_numpy(bad, cfg, "cpu", torch.bfloat16)


# -- the wrappers' C interfaces -----------------------------------------------------------


def _raise_without_nvcc(monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda p: False)
    monkeypatch.setattr(_build, "_libs", {})


def _meta(shape, dtype, offset=0):
    n = int(np.prod(shape))
    return torch.zeros(n + offset, dtype=dtype, device="meta")[offset:].view(*shape)


def test_quant_matmul_raises_unless_on_the_cpu(monkeypatch):
    """Tensors off the CPU reach the kernel's build and raise (no plain
    fallback, no launch counted); x that the kernel does not take raises
    before the build, and so does a weight that `check_weight` (run once
    where a tree is built) refuses."""
    _raise_without_nvcc(monkeypatch)
    x = _meta((3, 128), torch.bfloat16)
    q, s = _meta((128, 64), torch.int8), _meta((1, 64), torch.float32)
    before = qg.quant_matmul.launches
    with pytest.raises(RuntimeError, match="nvcc not found"):
        qg.quant_matmul(x, q, s)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        qg.quant_matmul(x, _meta((64, 128), torch.float8_e4m3fn),
                        _meta((64, 1), torch.float32), nk=True)
    for args, exc, match in [
        ((x.float(), q, s), TypeError, "bf16 x"),
        ((_meta((3, 96), torch.bfloat16), q, s), ValueError, "x \\(3, 96\\)"),
        ((x, _meta((2, 128, 64), torch.int8), _meta((2, 1, 64), torch.float32)),
         ValueError, "not a matrix"),
    ]:
        with pytest.raises(exc, match=match):
            qg.quant_matmul(*args)
    qg.check_weight(q, s)
    qg.check_weight(_meta((2, 128, 64), torch.int8), _meta((2, 1, 64), torch.float32))
    refused = [
        ((q.to(torch.uint8), s), TypeError, "codes"),
        ((q, s.bfloat16()), TypeError, "f32 scales"),
        ((q, _meta((64, 1), torch.float32)), ValueError, "scales"),
        ((_meta((96, 64), torch.int8), s), ValueError, "no kernel for"),
        ((_meta((128, 48), torch.int8), _meta((1, 48), torch.float32)), ValueError,
         "no kernel for"),
        ((_meta((128, 64), torch.int8, offset=8), s), ValueError, "16-byte aligned"),
        ((_meta((64, 128), torch.int8).T, s), ValueError, "contiguous"),
        ((_meta((2, 128, 64), torch.int8), s), ValueError, "scales"),
        ((_meta((2, 64, 128), torch.int8), _meta((64, 1), torch.float32), True),
         ValueError, "not a matrix"),
    ]
    for args, exc, match in refused:
        with pytest.raises(exc, match=match):
            qg.check_weight(*args)
    assert qg.quant_matmul.launches == before


def test_mm_on_a_device_launches_or_raises(monkeypatch):
    """`mm` off the CPU goes to the kernel for every quantized weight: a
    stack of them, which the kernel does not take, raises instead of
    running the plain version; impl="ref" runs the plain version."""
    _raise_without_nvcc(monkeypatch)
    x = _meta((3, 128), torch.bfloat16)
    stack = {"q": _meta((2, 128, 64), torch.int8), "s": _meta((2, 1, 64), torch.float32)}
    with pytest.raises(ValueError, match="not a matrix"):
        quant.mm(x, stack)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        quant.mm(x, qg.weight_at(stack, 1))
    assert quant.mm(x, stack, impl="ref").shape == (2, 3, 64)


def _meta_tree(V, N, tied):
    q8 = dict(dtype=torch.int8)
    return {"embed": {"q": _meta((V, 128), **q8), "s": _meta((V, 1), torch.float32),
                      "dt": _meta((0,), torch.bfloat16)},
            "norm_f": _meta((128,), torch.float32),
            "layers": {"wq": {"q": _meta((2, 128, N), **q8),
                              "s": _meta((2, 1, N), torch.float32)},
                       "attn_norm": _meta((2, 128), torch.float32)},
            "lm_head": None if tied else {"q": _meta((128, V), **q8),
                                          "s": _meta((1, V), torch.float32)}}


def test_check_tree_holds_leaves_off_the_cpu_to_the_kernels():
    """A tree's quantized leaves off the CPU must suit the kernel (the tied
    table in the NK layout, an untied one only gathered); CPU leaves of
    any shape pass (the plain versions take them)."""
    quant.check_tree(_meta_tree(V=256, N=64, tied=True))
    quant.check_tree(_meta_tree(V=96, N=64, tied=True))
    with pytest.raises(ValueError, match="no kernel for K=128, N=48"):
        quant.check_tree(_meta_tree(V=256, N=48, tied=True))
    with pytest.raises(ValueError, match="no kernel for K=128, N=100"):
        quant.check_tree(_meta_tree(V=100, N=64, tied=True))
    with pytest.raises(ValueError, match="no kernel for K=128, N=100"):
        quant.check_tree(_meta_tree(V=100, N=64, tied=False))
    for tied in (True, False):
        tree = _meta_tree(V=256, N=64, tied=tied)
        tree["embed"]["q"] = _meta((256, 128), torch.int8, offset=8)
        if tied:
            with pytest.raises(ValueError, match="16-byte aligned"):
                quant.check_tree(tree)
        else:
            quant.check_tree(tree)
    cfg = get_config("tiny")
    quant.check_tree(llama.init_params(cfg, 0, torch.float32, "cpu", quantize="int8"))


class _FakeLibrary:
    """Stands in for the built libraries: records each entry's arguments."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


@pytest.fixture
def fake_lib(monkeypatch):
    fake = _FakeLibrary()
    monkeypatch.setattr(_build, "load", lambda: {"quant_gemm": fake,
                                                 "moe_grouped_gemm": fake})
    for mod in (qg, md):
        monkeypatch.setattr(mod.torch.cuda, "current_stream",
                            lambda device=None: type("S", (), {"cuda_stream": 7})())
    return fake


@pytest.mark.parametrize("mode", MODES)
def test_quant_matmul_passes_the_kernel_its_arguments(fake_lib, mode):
    """Pointers x, codes, scales, y; then M (the rows of x's leading dims),
    N, K, the layout (1: NK), the code type (1: e4m3) and the stream; each
    launch counted by layout and code type."""
    dt = quant.CODE_DTYPES[mode]
    x = _meta((2, 3, 128), torch.bfloat16)
    q, s = _meta((128, 64), dt), _meta((1, 64), torch.float32)
    launches, bodies = qg.quant_matmul.launches, dict(qg.quant_matmul.bodies)
    y = qg.quant_matmul(x, q, s)
    z = qg.quant_matmul(x, _meta((96, 128), dt), _meta((96, 1), torch.float32), nk=True)
    assert y.shape == (2, 3, 64) and z.shape == (2, 3, 96) and y.dtype == torch.bfloat16
    (n0, a0), (n1, a1) = fake_lib.calls
    assert n0 == n1 == "quant_gemm"
    fp8 = int(mode == "fp8")
    assert a0[1:3] == (q.data_ptr(), s.data_ptr())
    assert a0[4:] == (6, 64, 128, 0, fp8, 7) and a1[4:] == (6, 96, 128, 1, fp8, 7)
    assert qg.quant_matmul.launches == launches + 2
    for body in (f"kn_{mode}", f"nk_{mode}"):
        assert qg.quant_matmul.bodies[body] == bodies.get(body, 0) + 1


@pytest.mark.parametrize("mode", MODES)
def test_quantized_grouped_gemm_passes_the_kernel_its_arguments(fake_lib, mode):
    """The quantized entries: codes and scales pointers, then the pairs P,
    n_experts, the tile map's rows, K, N, the code type (1 int8, 2 e4m3)
    and the stream; launches counted by code type."""
    dt = quant.CODE_DTYPES[mode]
    n, k, E, F_, T = 8, 2, 128, 192, 8
    P = T * k
    tok = _meta((P,), torch.int32)
    tiles = _meta((md.tile_count(P, n), 3), torch.int32)
    x = _meta((T, E), torch.bfloat16)
    wg = {"q": _meta((n, E, F_), dt), "s": _meta((n, 1, F_), torch.float32)}
    wu = {"q": _meta((n, E, F_), dt), "s": _meta((n, 1, F_), torch.float32)}
    wd = {"q": _meta((n, F_, E), dt), "s": _meta((n, 1, E), torch.float32)}
    before = dict(md.moe_gate_up.bodies), dict(md.moe_down.bodies)
    h = md.moe_gate_up(x, tok, wg, wu, tiles)
    y = md.moe_down(h, wd, tiles)
    assert h.shape == (P, F_) and y.shape == (P, E)
    (ng, g), (nd, d) = fake_lib.calls
    assert (ng, nd) == ("moe_gate_up_codes", "moe_down_codes")
    code = 1 if mode == "int8" else 2
    assert g[2:6] == (wg["q"].data_ptr(), wu["q"].data_ptr(), wg["s"].data_ptr(),
                      wu["s"].data_ptr())
    assert g[8:] == (P, n, tiles.shape[0], E, F_, code, 7)
    assert d[1:3] == (wd["q"].data_ptr(), wd["s"].data_ptr())
    assert d[5:] == (P, n, tiles.shape[0], F_, E, code, 7)
    assert md.moe_gate_up.bodies[mode] == before[0].get(mode, 0) + 1
    assert md.moe_down.bodies[mode] == before[1].get(mode, 0) + 1
    with pytest.raises(TypeError, match="partly quantized"):
        md.moe_gate_up(x, tok, wg, _meta((n, E, F_), torch.bfloat16), tiles)
    with pytest.raises(ValueError, match="moe_down"):
        md.moe_down(h, dict(wd, s=_meta((n, 1, F_), torch.float32)), tiles)
