"""The port's multi-LoRA (dynamo_tpu_torch/models/lora.py, the forward's
adapter delta, the runner's slots and the engine's adapter requests)
against the JAX package, on the CPU at the tiny config in f32.

- `random_adapter` draws the reference's factors and `load_peft_adapter`
  reads the reference's factors from PEFT files written here through
  safetensors.numpy, f32 and bf16, bit for bit (the port reads them with
  its own engine/st_io.py); a missing layer raises as the reference does;
- `forward(lora=, adapter_idx=[0, 1, 2, 1])` over the default targets and
  all seven, on plain and int8-quantized weights, against the
  reference's forward(attn_impl="jnp"): logits atol 1e-4, the written
  pools atol 1e-5 (tests/test_torch_model.py's tolerances); slot-0 rows
  bit for bit the LoRA-less forward's; the flat ragged row with a slot a
  token against the same forward with a slot a row;
- engine greedy streams (the reference's `lora_engine` fixture: two
  adapters, scale 2.0) against the JAX engine stepped through the same
  plans: slot 0 against a base engine, a mixed batch against solo runs,
  chunked prefill, the padded mixed fallback (plain and int8 weights),
  prefix isolation, the unknown-adapter error item, n-gram speculation
  (its ragged verify carries a slot a token; the reference's ragged
  verify drops the adapters, so the port's speculative streams are held
  to the JAX engine's plain ones), draft-model speculation (held to the
  JAX engine's plain and draft-model streams) and n > 1 branches;
- MLA and n_dense_layers configs refuse adapters as the reference does;
- the worker's `_lora_kwargs` (rank padding, target union, duplicate
  names) equals the reference's.
"""

import argparse
import asyncio
import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file

from dynamo_tpu import worker as jworker
from dynamo_tpu.engine.engine import InferenceEngine as JaxEngine
from dynamo_tpu.engine.model_runner import ModelRunner as JaxRunner
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.models import lora as jlora
from dynamo_tpu.models import quant as jquant
from dynamo_tpu.models.config import get_config as jax_get_config
from dynamo_tpu.runtime.context import Context as JaxContext
from dynamo_tpu_torch import worker
from dynamo_tpu_torch.engine import st_io
from dynamo_tpu_torch.engine.engine import InferenceEngine
from dynamo_tpu_torch.engine.model_runner import ModelRunner
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.models import llama
from dynamo_tpu_torch.models import lora
from dynamo_tpu_torch.models.config import get_config
from dynamo_tpu_torch.models.toolkit import make_kv_pool
from dynamo_tpu_torch.runtime.context import Context

CFG = get_config("tiny")
JCFG = jax_get_config("tiny")
ALL_TARGETS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
GEOMETRY = dict(num_pages=96, page_size=4, max_pages_per_seq=16,
                decode_buckets=(1, 2, 4, 8), prefill_buckets=(8, 16))
ENGINE = dict(max_batch=4, chunk_size=16)
# chunks of 8 beside live decode rows: mixed plans
MIXED = dict(max_batch=6, chunk_size=8, mixed_prefill_tokens=8,
             mixed_prefill_seqs=4, mixed_min_chunk=2)


@pytest.fixture(scope="module")
def jparams():
    return jax.device_get(jllama.init_params(JCFG, jax.random.PRNGKey(7), jnp.float32))


def _adapters(targets=lora.DEFAULT_TARGETS, rank=8):
    return {"ad-one": lora.random_adapter(CFG, rank, targets, seed=1, scale=2.0),
            "ad-two": lora.random_adapter(CFG, rank, targets, seed=2, scale=2.0)}


# -- the factors -------------------------------------------------------------


@pytest.mark.parametrize("targets", [lora.DEFAULT_TARGETS, ALL_TARGETS],
                         ids=["default", "all7"])
def test_random_adapter_matches_reference(targets):
    for rank, seed, scale in ((8, 0, 1.0), (4, 3, 2.0), (16, 100, 0.5)):
        got = lora.random_adapter(CFG, rank, targets, seed=seed, scale=scale)
        want = jlora.random_adapter(JCFG, rank, targets, seed=seed, scale=scale)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype == np.float32
            np.testing.assert_array_equal(got[k], want[k])
    assert lora._target_dims(CFG) == jlora._target_dims(JCFG)
    moe = get_config("tiny-moe")
    assert lora._target_dims(moe) == jlora._target_dims(jax_get_config("tiny-moe"))
    assert "w_gate" not in lora._target_dims(moe)


def _peft_dir(path, dtype, rank=4, alpha=8.0, projs=("q_proj", "v_proj", "gate_proj",
                                                      "down_proj"), drop=None, seed=0):
    """A PEFT checkpoint: lora_A [r, in], lora_B [out, r] per layer and
    projection, in `dtype`; `drop` leaves one (layer, proj) out."""
    rng = np.random.default_rng(seed)
    hd = CFG.head_dim
    dims = {"q_proj": (CFG.dim, CFG.n_heads * hd), "k_proj": (CFG.dim, CFG.n_kv_heads * hd),
            "v_proj": (CFG.dim, CFG.n_kv_heads * hd), "o_proj": (CFG.n_heads * hd, CFG.dim),
            "gate_proj": (CFG.dim, CFG.ffn_dim), "up_proj": (CFG.dim, CFG.ffn_dim),
            "down_proj": (CFG.ffn_dim, CFG.dim)}
    tensors = {}
    for layer in range(CFG.n_layers):
        for proj in projs:
            if drop == (layer, proj):
                continue
            din, dout = dims[proj]
            sub = "mlp" if proj.endswith(("gate_proj", "up_proj", "down_proj")) else "self_attn"
            pre = f"base_model.model.model.layers.{layer}.{sub}.{proj}"
            tensors[f"{pre}.lora_A.weight"] = rng.standard_normal((rank, din)).astype(dtype)
            tensors[f"{pre}.lora_B.weight"] = rng.standard_normal((dout, rank)).astype(dtype)
    tensors["base_model.model.lm_head.marker"] = np.zeros(3, np.float32)  # skipped
    path.mkdir(parents=True, exist_ok=True)
    save_file(tensors, str(path / "adapter_model.safetensors"))
    (path / "adapter_config.json").write_text(json.dumps({"r": rank, "lora_alpha": alpha}))
    return tensors


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16], ids=["f32", "bf16"])
def test_load_peft_adapter_matches_reference(tmp_path, dtype):
    tensors = _peft_dir(tmp_path, dtype)
    got = lora.load_peft_adapter(str(tmp_path), CFG)
    want = jlora.load_peft_adapter(str(tmp_path), JCFG)
    assert sorted(got) == sorted(want) == ["w_down_a", "w_down_b", "w_gate_a",
                                           "w_gate_b", "wq_a", "wq_b", "wv_a", "wv_b"]
    for k in want:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k])
    a0 = tensors["base_model.model.model.layers.0.self_attn.q_proj.lora_A.weight"]
    np.testing.assert_array_equal(got["wq_a"][0], a0.astype(np.float32).T)
    b0 = tensors["base_model.model.model.layers.0.self_attn.q_proj.lora_B.weight"]
    np.testing.assert_array_equal(got["wq_b"][0], b0.astype(np.float32).T * 2.0)


def test_load_peft_adapter_refuses_a_missing_layer(tmp_path):
    _peft_dir(tmp_path, np.float32, drop=(1, "v_proj"))
    with pytest.raises(ValueError, match="missing layers for wv_"):
        jlora.load_peft_adapter(str(tmp_path), JCFG)
    with pytest.raises(ValueError, match="missing layers for wv_"):
        lora.load_peft_adapter(str(tmp_path), CFG)
    with pytest.raises(FileNotFoundError):
        lora.load_peft_adapter(str(tmp_path / "none"), CFG)


def test_st_io_reads_what_safetensors_writes(tmp_path):
    rng = np.random.default_rng(5)
    tensors = {
        "f32": rng.standard_normal((3, 5)).astype(np.float32),
        "f16": rng.standard_normal((4,)).astype(np.float16),
        "bf16": rng.standard_normal((2, 3, 2)).astype(ml_dtypes.bfloat16),
        "i8": rng.integers(-128, 127, (7,)).astype(np.int8),
        "i32": rng.integers(-9, 9, (2, 2)).astype(np.int32),
        "empty": np.zeros((0, 4), np.float32),
    }
    save_file(tensors, str(tmp_path / "x.safetensors"), metadata={"format": "pt"})
    got = st_io.load_file(tmp_path / "x.safetensors")
    assert sorted(got) == sorted(tensors)
    for k, want in tensors.items():
        t = got[k]
        assert tuple(t.shape) == want.shape
        if k == "bf16":
            assert t.dtype == torch.bfloat16
            np.testing.assert_array_equal(t.view(torch.int16).numpy(), want.view(np.int16))
        else:
            np.testing.assert_array_equal(t.numpy(), want)
    t = got["f32"]
    t += 1  # the reader's own tensor: the file keeps its bytes
    np.testing.assert_array_equal(st_io.load_file(tmp_path / "x.safetensors")["f32"].numpy(),
                                  tensors["f32"])
    (tmp_path / "bad.safetensors").write_bytes(b"\x01")
    with pytest.raises(ValueError):
        st_io.load_file(tmp_path / "bad.safetensors")


def test_stacked_tree_and_slots():
    tree = lora.init_lora_params(CFG, 3, 8, ALL_TARGETS, torch.float32, "cpu")
    jtree = jlora.init_lora_params(JCFG, 3, 8, ALL_TARGETS, jnp.float32)
    for name, ad in _adapters(ALL_TARGETS).items():
        slot = 1 if name == "ad-one" else 2
        lora.set_adapter_slot(tree, slot, ad)
        jtree = jlora.set_adapter_slot(jtree, slot, ad)
    assert sorted(tree["layers"]) == sorted(jtree["layers"])
    for k, v in jtree["layers"].items():
        np.testing.assert_array_equal(tree["layers"][k].numpy(), np.asarray(v))
    assert not tree["layers"]["wq_a"][:, 0].any()
    carried = lora.lora_from_numpy(jax.device_get(jtree), CFG, "cpu", torch.float32)
    for k, v in carried["layers"].items():
        assert torch.equal(v, tree["layers"][k])
    with pytest.raises(ValueError, match="not built for"):
        lora.set_adapter_slot(lora.init_lora_params(CFG, 2, 8, device="cpu"), 1,
                              _adapters(ALL_TARGETS)["ad-one"])
    with pytest.raises(ValueError, match="shape"):
        lora.set_adapter_slot(tree, 1, _adapters(rank=4)["ad-one"])
    with pytest.raises(ValueError, match="not projections"):
        lora.init_lora_params(get_config("tiny-moe"), 2, 8, ALL_TARGETS, device="cpu")
    assert lora.lora_bytes(CFG, 3, 8, ALL_TARGETS, torch.float32) == sum(
        v.numel() * 4 for v in tree["layers"].values())


# -- the forward ---------------------------------------------------------------

NP, PS = 24, 4
PAGES = np.random.default_rng(3).permutation(NP)[:4 * 5].reshape(4, 5).astype(np.int32)
ADAPTER_IDX = np.array([0, 1, 2, 1], np.int32)
JAX_FORWARD = jax.jit(jllama.forward, static_argnames=("config", "attn_impl"),
                      compiler_options={"xla_backend_optimization_level": 0})


def _lora_steps(rng, V):
    """Four sequences: a prefill (rows padded), a second chunk with per-row
    last positions, two decode steps."""
    out = []
    pos = np.full((4, 8), -1, np.int32)
    for i, n in enumerate((8, 5, 7, 3)):
        pos[i, :n] = np.arange(n)
    out.append((pos, [8, 5, 7, 3], None))
    pos = np.full((4, 4), -1, np.int32)
    for i, (s, n) in enumerate(((8, 4), (5, 2), (7, 4), (3, 1))):
        pos[i, :n] = np.arange(s, s + n)
    out.append((pos, [12, 7, 11, 4], np.array([3, 1, 3, 0], np.int32)))
    for t in range(2):
        pos = np.array([[12 + t], [7 + t], [11 + t], [4 + t]], np.int32)
        out.append((pos, [13 + t, 8 + t, 12 + t, 5 + t], None))
    return [(rng.integers(0, V, size=p.shape).astype(np.int32), p,
             np.asarray(k, np.int32), last) for p, k, last in out]


@pytest.mark.parametrize("quantize", [None, "int8"])
@pytest.mark.parametrize("targets", [lora.DEFAULT_TARGETS, ALL_TARGETS],
                         ids=["default", "all7"])
def test_forward_with_adapters_matches_jax(jparams, targets, quantize):
    jp = jax.device_get(jquant.quantize_params(jparams, mode=quantize)) if quantize else jparams
    tparams = params_from_numpy(jp, CFG, "cpu", torch.float32)
    jtree = jlora.init_lora_params(JCFG, 3, 8, targets, jnp.float32)
    for slot, ad in enumerate(_adapters(targets).values(), 1):
        jtree = jlora.set_adapter_slot(jtree, slot, ad)
    tree = lora.lora_from_numpy(jax.device_get(jtree), CFG, "cpu", torch.float32)
    jk, jv = jllama.make_kv_pool(JCFG, NP, PS, jnp.float32)
    pools = {impl: make_kv_pool(CFG, NP + 1, PS, torch.float32, "cpu")
             for impl in ("kernel", "ref")}
    bk, bv = make_kv_pool(CFG, NP + 1, PS, torch.float32, "cpu")  # LoRA-less
    t = torch.from_numpy
    pt = t(PAGES)
    idx = t(ADAPTER_IDX)
    for tok, pos, kvl, last in _lora_steps(np.random.default_rng(1), CFG.vocab_size):
        jl, jk, jv = JAX_FORWARD(
            JCFG, jp, jnp.asarray(tok), jnp.asarray(pos), jk, jv, jnp.asarray(PAGES),
            jnp.asarray(kvl), None if last is None else jnp.asarray(last),
            attn_impl="jnp", lora=jtree, adapter_idx=jnp.asarray(ADAPTER_IDX))
        jl = np.asarray(jl)
        real = pos >= 0 if last is None else np.ones((4, 1), bool)
        if pos.shape[1] == 1:
            real = np.ones_like(real)
        la = None if last is None else t(last)
        for impl, (tk, tv) in pools.items():
            tl = llama.forward(CFG, tparams, t(tok), t(pos), tk, tv, pt, t(kvl), la,
                               attn_impl=impl, lora=tree, adapter_idx=idx)
            np.testing.assert_allclose(tl.numpy()[real], jl[real], atol=1e-4, rtol=1e-4)
            if impl == "kernel":
                base = llama.forward(CFG, tparams, t(tok), t(pos), bk, bv, pt, t(kvl), la)
                # the base row (slot 0) exactly; the adapter rows differ
                assert torch.equal(tl[0], base[0])
                assert not torch.allclose(tl[1], base[1], atol=1e-3)
    for tk, tv in pools.values():
        np.testing.assert_allclose(tk[:, :NP].numpy(), np.asarray(jk), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(tv[:, :NP].numpy(), np.asarray(jv), atol=1e-5, rtol=1e-5)


def test_ragged_forward_with_token_slots_matches_jax(jparams):
    """The flat ragged row with a slot a token (four segments under slots
    0, 1, 2, 1, as a LoRA runner's verify feeds it): every real token's
    logits and the written pools equal the JAX padded forward with a slot
    a row (attn_impl "jnp"), on the kernel and the plain ragged path."""
    from dynamo_tpu_torch.ops.ragged_paged_attention import build_ragged_metadata

    tparams = params_from_numpy(jparams, CFG, "cpu", torch.float32)
    jtree = jlora.init_lora_params(JCFG, 3, 8, ALL_TARGETS, jnp.float32)
    for slot, ad in enumerate(_adapters(ALL_TARGETS).values(), 1):
        jtree = jlora.set_adapter_slot(jtree, slot, ad)
    tree = lora.lora_from_numpy(jax.device_get(jtree), CFG, "cpu", torch.float32)
    tok, pos, kvl, _ = _lora_steps(np.random.default_rng(1), CFG.vocab_size)[0]
    jl, jk, jv = JAX_FORWARD(
        JCFG, jparams, jnp.asarray(tok), jnp.asarray(pos),
        *jllama.make_kv_pool(JCFG, NP, PS, jnp.float32), jnp.asarray(PAGES),
        jnp.asarray(kvl), None, attn_impl="jnp", lora=jtree,
        adapter_idx=jnp.asarray(ADAPTER_IDX))
    real = pos >= 0
    q_lens = real.sum(1).tolist()
    T = 32
    md = build_ragged_metadata(q_lens, [0] * 4, q_lens, PAGES.tolist(), T,
                               max_pages=PAGES.shape[1])
    flat = np.zeros((1, T), np.int32)
    flat[0, :sum(q_lens)] = tok[real]
    slots = np.zeros(T, np.int32)
    slots[:sum(q_lens)] = np.repeat(ADAPTER_IDX, q_lens)
    t = torch.from_numpy
    ragged = tuple(t(md[k]) for k in ("seg_page_table", "seg_kv_lens", "meta"))
    for impl in ("kernel", "ref"):
        tk, tv = make_kv_pool(CFG, NP + 1, PS, torch.float32, "cpu")
        tl = llama.forward(CFG, tparams, t(flat), t(md["tok_positions"][None]), tk, tv,
                           last_index=torch.arange(sum(q_lens)), attn_impl=impl,
                           ragged=ragged, lora=tree, adapter_idx=t(slots))
        np.testing.assert_allclose(tl[0].numpy(), np.asarray(jl)[real], atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(tk[:, :NP].numpy(), np.asarray(jk), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(tv[:, :NP].numpy(), np.asarray(jv), atol=1e-5, rtol=1e-5)


def test_mla_and_dense_layer_models_refuse_adapters():
    for name, extra, what in (("tiny-mla", {}, "MLA models"),
                              ("tiny-moe", {"n_dense_layers": 1}, "n_dense_layers")):
        jcfg = jax_get_config(name).with_(**extra)
        cfg = get_config(name).with_(**extra)
        jp = jax.device_get(jllama.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32))
        jtree = jax.device_get(jlora.init_lora_params(jcfg, 2, 4, dtype=jnp.float32))
        tree = lora.init_lora_params(cfg, 2, 4, dtype=torch.float32, device="cpu")
        jk, jv = jllama.make_kv_pool(jcfg, NP, PS, jnp.float32)
        tk, tv = make_kv_pool(cfg, NP + 1, PS, torch.float32, "cpu")
        pos = np.arange(4, dtype=np.int32)[None]
        tok = np.ones((1, 4), np.int32)
        with pytest.raises(NotImplementedError, match=what):
            jllama.forward(jcfg, jp, jnp.asarray(tok), jnp.asarray(pos), jk, jv,
                           jnp.asarray(PAGES[:1]), jnp.asarray([4]), lora=jtree,
                           adapter_idx=jnp.asarray([1]))
        t = torch.from_numpy
        with pytest.raises(NotImplementedError, match=what):
            llama.forward(cfg, params_from_numpy(jp, cfg, "cpu", torch.float32), t(tok),
                          t(pos), tk, tv, t(PAGES[:1]), torch.tensor([4], dtype=torch.int32),
                          lora=tree, adapter_idx=torch.tensor([1]))
        with pytest.raises(NotImplementedError, match=what):
            ModelRunner(cfg, device="cpu", dtype=torch.float32, lora_slots=1, **GEOMETRY)


# -- the engine ---------------------------------------------------------------------


class _Stepped:
    """Stands in for the engine's step thread: the test steps the engine,
    so both engines see the same plans whatever the timing."""

    def join(self, timeout=None):
        pass


def _req(prompt, adapter=None, n_out=6, **samp):
    r = {"token_ids": list(prompt), "sampling": {"temperature": 0.0, **samp},
         "stop": {"max_tokens": n_out, "stop_ids": []}}
    if adapter:
        r["adapter"] = adapter
    return r


async def _serve(engine, reqs, stepped=True):
    """Streams of `reqs` (each a list of its items' tokens, by choice when
    n > 1): the first admitted alone, the rest right after. `stepped`
    steps the engine from here."""
    if stepped:
        engine._thread = _Stepped()
    ctx_cls = JaxContext if isinstance(engine, JaxEngine) else Context

    async def one(req):
        by_choice = {}
        async for item in engine.generate(req, ctx_cls()):
            if item.get("finish_reason") == "error":
                return ("error", item.get("error"))
            by_choice.setdefault(item.get("index", 0), []).extend(item["token_ids"])
        return by_choice[0] if len(by_choice) == 1 else [by_choice[k] for k in
                                                         sorted(by_choice)]

    async def settle():
        for _ in range(4):
            await asyncio.sleep(0)

    if not stepped:
        return [await one(r) for r in reqs]
    tasks = [asyncio.ensure_future(one(reqs[0]))]
    await settle()
    engine._loop_once()
    tasks += [asyncio.ensure_future(one(r)) for r in reqs[1:]]
    while not all(t.done() for t in tasks):
        await settle()
        engine._loop_once()
    return [t.result() for t in tasks]


def _jax_engine(jparams, quantize=None, engine=ENGINE, **kw):
    run = JaxRunner(JCFG, params=jparams, dtype=jnp.float32, quantize=quantize,
                    lora_slots=2, **GEOMETRY)
    for name, ad in _adapters().items():
        run.register_adapter(name, ad)
    return JaxEngine(run, **engine, **kw)


def _port_runner(jparams, lora_slots=2, quantize=None, adapters=None, **kw):
    run = ModelRunner(CFG, device="cpu", dtype=torch.float32, quantize=quantize,
                      params=params_from_numpy(jparams, CFG, "cpu", torch.float32),
                      lora_slots=lora_slots, **GEOMETRY, **kw)
    if lora_slots:
        for name, ad in (_adapters() if adapters is None else adapters).items():
            run.register_adapter(name, ad)
    return run


def _prompts():
    rng = np.random.default_rng(11)
    shared = rng.integers(1, 500, size=9).tolist()
    return {"base": shared, "one": shared, "two": rng.integers(1, 500, size=6).tolist(),
            "long": rng.integers(1, 500, size=37).tolist()}


async def test_engine_streams_match_jax(jparams):
    """Slot 0 against a LoRA-less engine, a mixed batch (base, ad-one and
    ad-two on one prompt and another) against solo runs, and a 37-token
    prompt chunked at 16 under ad-two: the JAX engine's streams."""
    p = _prompts()
    reqs = [_req(p["base"]), _req(p["one"], "ad-one"), _req(p["two"], "ad-two"),
            _req(p["long"], "ad-two"), _req(p["one"], "ad-two")]
    jeng = _jax_engine(jparams)
    try:
        jres = await _serve(jeng, reqs)
    finally:
        jeng.stop()
    teng = InferenceEngine(_port_runner(jparams), **ENGINE)
    try:
        tres = await _serve(teng, reqs)
        solo = [(await _serve(teng, [r]))[0] for r in reqs]
    finally:
        teng.stop()
    assert tres == jres == solo
    assert all(len(t) == 6 for t in tres)
    assert tres[1] != tres[0] and tres[4] != tres[1] and tres[4] != tres[0]
    base = InferenceEngine(_port_runner(jparams, lora_slots=0), **ENGINE)
    try:
        assert (await _serve(base, [reqs[0]]))[0] == tres[0]
    finally:
        base.stop()


@pytest.mark.parametrize("quantize", [None, "int8"])
async def test_padded_mixed_fallback_matches_jax(jparams, monkeypatch, quantize):
    """Fused mixed plans of a LoRA runner take the padded fallback (the
    ragged step is off, as in the reference): chunks of three adapters
    beside live decode rows, on plain and int8 weights."""
    monkeypatch.setenv("DYN_FUSED_MIXED", "1")
    rng = np.random.default_rng(5)
    reqs = [_req(rng.integers(1, 500, size=n).tolist(), ad, n_out=8)
            for n, ad in ((6, "ad-one"), (13, None), (9, "ad-two"), (11, "ad-one"))]
    jeng = _jax_engine(jparams, quantize, engine=MIXED)
    try:
        jres = await _serve(jeng, reqs)
    finally:
        jeng.stop()
    run = _port_runner(jparams, quantize=quantize)
    assert not run.ragged_mixed
    teng = InferenceEngine(run, **MIXED)
    try:
        tres = await _serve(teng, reqs)
    finally:
        teng.stop()
    assert tres == jres and all(len(t) == 8 for t in tres)
    st = run.stats
    assert st["padded_prefill_dispatches"] > 0 and st["mixed_chunks"] > 0, st
    assert st["ragged_mixed_dispatches"] == st["ragged_verify_dispatches"] == 0


async def test_prefix_cache_never_crosses_adapters(jparams):
    prompt = list(range(40, 56))  # 4 full pages
    teng = InferenceEngine(_port_runner(jparams), **ENGINE)
    try:
        sch = teng.scheduler
        await _serve(teng, [_req(prompt)])
        before = sch.reused_prefix_tokens
        first = (await _serve(teng, [_req(prompt, "ad-one")]))[0]
        assert sch.reused_prefix_tokens == before  # nothing from the base run
        again = (await _serve(teng, [_req(prompt, "ad-one")]))[0]
        assert sch.reused_prefix_tokens > before  # its own lineage hits
        other = (await _serve(teng, [_req(prompt, "ad-two")]))[0]
        assert sch.reused_prefix_tokens - before == 12  # ad-two reused nothing
        assert first == again and other != first
    finally:
        teng.stop()
    fresh = InferenceEngine(_port_runner(jparams), **ENGINE)
    try:
        assert (await _serve(fresh, [_req(prompt, "ad-one")]))[0] == first
    finally:
        fresh.stop()


async def test_unknown_adapter_and_unsupported_requests(jparams):
    teng = InferenceEngine(_port_runner(jparams), **ENGINE)
    plain = InferenceEngine(_port_runner(jparams, lora_slots=0), **ENGINE)
    try:
        assert (await _serve(teng, [_req([1, 2, 3], "nope")]))[0] == (
            "error", "unknown LoRA adapter 'nope'")
        assert (await _serve(plain, [_req([1, 2, 3], "ad-one")]))[0] == (
            "error", "unknown LoRA adapter 'ad-one'")
        kind, msg = (await _serve(teng, [dict(_req([1, 2, 3]), mm={"data": b"x"})]))[0]
        assert kind == "error" and "mm" in msg
        teng.paused = True
        assert (await _serve(teng, [_req([1, 2, 3])]))[0][0] == "error"
        teng.paused = False
        assert len((await _serve(teng, [_req([1, 2, 3], "ad-one")]))[0]) == 6
    finally:
        teng.stop()
        plain.stop()


def _spec_reqs():
    rng = np.random.default_rng(11)
    motif = rng.integers(1, 500, size=5).tolist()
    prompts = [motif * 3, rng.integers(1, 500, size=7).tolist() * 2, motif[:3] * 4 + [9]]
    return [_req(p, ad, n_out=14) for p, ad in zip(prompts, ("ad-one", None, "ad-two"))]


async def test_ngram_spec_applies_adapters(jparams, monkeypatch):
    """N-gram speculation on a LoRA runner verifies on the ragged step,
    each flat token carrying its row's slot: its greedy streams equal the
    JAX engine's plain (speculation-off) streams. (The reference's own
    speculative streams are no yardstick: its ragged verify has no
    adapters.)"""
    monkeypatch.setenv("DYN_FUSED_MIXED", "1")
    reqs = _spec_reqs()
    engine = dict(ENGINE, mixed_prefill_tokens=16)
    jeng = _jax_engine(jparams, engine=engine)
    try:
        jplain = await _serve(jeng, reqs)
    finally:
        jeng.stop()
    run = _port_runner(jparams)
    teng = InferenceEngine(run, spec_ngram=True, spec_k=4, **engine)
    try:
        tspec = await _serve(teng, reqs)
    finally:
        teng.stop()
    assert tspec == jplain and all(len(t) == 14 for t in tspec)
    st = teng.spec_stats
    assert st["drafted"] > 0 and st["accepted"] > 0, st
    assert run.stats["ragged_verify_dispatches"] == st["verify_iters"] > 0
    assert run.stats["ragged_mixed_dispatches"] == 0
    assert st["spec_emitted"] > st["verify_rows"]


async def test_draft_model_spec_applies_adapters_to_the_target(jparams):
    """A draft-model runner with adapters: the draft proposes base-only,
    the target's verify applies each row's adapter, so greedy streams are
    the JAX engine's plain LoRA streams, and its draft-model streams."""
    reqs = _spec_reqs()
    jeng = _jax_engine(jparams)
    try:
        jplain = await _serve(jeng, reqs)
    finally:
        jeng.stop()
    # a self-draft: the base row's drafts are accepted, the adapter rows'
    # mostly not (the draft has no adapters)
    jrun = JaxRunner(JCFG, params=jparams, dtype=jnp.float32, lora_slots=2,
                     draft_config=JCFG, draft_params=jparams, **GEOMETRY)
    for name, ad in _adapters().items():
        jrun.register_adapter(name, ad)
    jeng = JaxEngine(jrun, decode_steps=10, **ENGINE)
    try:
        jspec = await _serve(jeng, reqs)
    finally:
        jeng.stop()
    run = _port_runner(jparams, draft_config=CFG,
                       draft_params=params_from_numpy(jparams, CFG, "cpu", torch.float32))
    teng = InferenceEngine(run, decode_steps=10, **ENGINE)
    try:
        got = await _serve(teng, reqs)
    finally:
        teng.stop()
    assert got == jplain == jspec and all(len(t) == 14 for t in got)
    assert run.stats["spec_verify_passes"] > 0 and teng.spec_stats["accepted"] > 0


async def test_branches_under_an_adapter(jparams):
    """n = 2 greedy choices under ad-one: each the n = 1 stream, which is
    the JAX engine's."""
    prompt = _prompts()["two"]
    jeng = _jax_engine(jparams)
    try:
        want = (await _serve(jeng, [_req(prompt, "ad-one")]))[0]
    finally:
        jeng.stop()
    teng = InferenceEngine(_port_runner(jparams), **ENGINE)
    try:
        got = (await _serve(teng, [_req(prompt, "ad-one", n=2)]))[0]
        base = (await _serve(teng, [_req(prompt)]))[0]
    finally:
        teng.stop()
    assert got == [want, want] and base != want


# -- the worker's flags -------------------------------------------------------------


def _args(lora_specs, rank=8, slots=0):
    return argparse.Namespace(lora=list(lora_specs), lora_rank=rank, lora_slots=slots)


def test_lora_kwargs_match_reference(tmp_path):
    _peft_dir(tmp_path / "p", np.float32, rank=16, projs=("q_proj", "up_proj"))
    specs = ["ad-one", f"peft={tmp_path / 'p'}", "ad-two"]
    got_args, want_args = _args(specs, slots=1), _args(specs, slots=1)
    got = worker._lora_kwargs(got_args, CFG)
    want = jworker._lora_kwargs(want_args, JCFG)
    assert got == want == {"lora_slots": 4, "lora_rank": 16,
                           "lora_targets": ("w_up", "wk", "wo", "wq", "wv")}
    assert [n for n, _ in got_args._lora_factors] == ["ad-one", "peft", "ad-two"]
    for (gn, gf), (wn, wf) in zip(got_args._lora_factors, want_args._lora_factors):
        assert gn == wn and sorted(gf) == sorted(wf)
        for k in wf:
            np.testing.assert_array_equal(gf[k], wf[k])
    # ad-one: rank 8 zero-padded to 16
    a = got_args._lora_factors[0][1]["wq_a"]
    assert a.shape[-1] == 16 and not a[..., 8:].any() and a[..., :8].any()
    for mod, cfg in ((worker, CFG), (jworker, JCFG)):
        with pytest.raises(SystemExit, match="duplicate"):
            mod._lora_kwargs(_args(["x", "y", "x=/nowhere"]), cfg)
        assert mod._lora_kwargs(_args([], slots=2), cfg) == {"lora_slots": 2, "lora_rank": 8}
        assert mod._lora_kwargs(_args([]), cfg) == {}
    with pytest.raises(ValueError, match="exceeds"):
        worker.pad_rank("wq_a", np.zeros((2, 4, 16), np.float32), 8)


def test_worker_flags_build_a_lora_runner():
    args = worker.parse_args(["--model", "tiny", "--device", "cpu", "--num-pages", "32",
                              "--lora", "ad-one", "--lora", "ad-two", "--lora-slots", "1"])
    runner, cfg = worker.build_runner(args)
    assert runner.adapter_names == ["ad-one", "ad-two"]
    assert runner.adapter_slot("ad-two") == 2 and runner.adapter_slot(None) == 0
    assert sorted(runner.lora["layers"]) == sorted(
        t + x for t in lora.DEFAULT_TARGETS for x in ("_a", "_b"))
    assert runner.lora["layers"]["wq_a"].shape[1:] == (4, CFG.dim, 8)
    assert not runner.ragged_mixed
    card = worker.model_card(args, cfg, runner.adapter_names)
    assert card.adapters == ["ad-one", "ad-two"]
    want = lora.random_adapter(cfg, 8, seed=101)  # the second spec's seed
    np.testing.assert_allclose(runner.lora["layers"]["wv_b"][:, 2].float().numpy(),
                               want["wv_b"].astype(np.float32), rtol=1e-2, atol=1e-2)
    with pytest.raises(RuntimeError, match="slots in use"):
        runner.register_adapter("x", want)
        runner.register_adapter("y", want)
    plain, _ = worker.build_runner(worker.parse_args(
        ["--model", "tiny", "--device", "cpu", "--num-pages", "32"]))
    assert plain.lora is None and plain.adapter_names == []
    with pytest.raises(RuntimeError, match="without lora_slots"):
        plain.register_adapter("x", want)
