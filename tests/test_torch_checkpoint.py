"""HF checkpoints in the port (engine/weights.py, engine/st_io.py) against
the JAX package.

Safetensors directories are written here by `safetensors.numpy` from
seeded numpy tensors, in f32 and in bf16, under HF's names for each family
the loader maps (dense, both MoE layouts, MLA with its interleaved RoPE
columns), and read by both loaders: the port's tree must equal the
reference's carried across by params_from_numpy bit for bit, and the f32
forward of a loaded tree the reference's (atol 1e-4); a quantized load
must equal quantize_params of the plain one. `config_from_hf` is
held to the reference's field by field on every model_type branch (with
`transformers` hidden: the card's machine has none), the port's
safetensors writer against the `safetensors` package both ways, and the
RoPE "linear" scaling the fault repair adds against the reference's.
"""

import dataclasses
import json
import sys

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file as st_load
from safetensors.numpy import save_file as st_save

from dynamo_tpu.engine import weights as jweights
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.models.config import get_config as jax_get_config
from dynamo_tpu.models.toolkit import rope_inv_freq as jax_rope_inv_freq
from dynamo_tpu_torch.engine import st_io
from dynamo_tpu_torch.engine import weights
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.models import llama
from dynamo_tpu_torch.models.config import ModelConfig, get_config
from dynamo_tpu_torch.models.quant import quantize_params
from dynamo_tpu_torch.models.toolkit import make_kv_pool, rope_inv_freq_np

BF16 = np.dtype(ml_dtypes.bfloat16)
NP, PS = 16, 4

# Phi-3's window on every layer, OLMo-2's norm order
PHI3 = dict(sliding_window=8, sw_period=1, sw_global_residue=1)
OLMO2 = dict(post_norms=True, pre_norms=False, qk_norm=True, qk_norm_wide=True)

# (preset, config changes, checkpoint layout)
CASES = {
    "tiny": ("tiny", {}, ""),
    "qwen2": ("tiny-qwen2", {}, ""),
    "qwen3": ("tiny-qwen3", {}, ""),
    "gemma2": ("tiny-gemma2", {}, ""),
    "gemma3": ("tiny-gemma3", {}, ""),
    "gemma3_wrapped": ("tiny-gemma3", {}, "language_model"),
    "olmo2": ("tiny", OLMO2, ""),
    "phi3_fused": ("tiny", PHI3, "fused"),
    "phi3_split": ("tiny", PHI3, ""),
    "moe_qwen": ("tiny-moe", {}, ""),
    "moe_mixtral": ("tiny-moe", {}, "mixtral"),
    "moe_shared_gate": ("tiny-moe-shared", {}, "shared_gate"),
    "mla": ("tiny-mla", {}, ""),
    "mla_q": ("tiny-mla-q", {}, ""),
    "mla_moe": ("tiny-mla-moe", {}, ""),
}


def _configs(case):
    name, kw, _ = CASES[case]
    return jax_get_config(name).with_(**kw), get_config(name).with_(**kw)


def _hf_shapes(c, layout):
    """HF name -> shape of a checkpoint of config `c` ([out, in] matrices)."""
    E, hd, V = c.dim, c.head_dim, c.vocab_size
    H, Hk = c.n_heads, c.n_kv_heads
    s = {"model.embed_tokens.weight": (V, E), "model.norm.weight": (E,)}
    if not c.tie_embeddings:
        s["lm_head.weight"] = (V, E)
    kD = c.n_dense_layers if c.is_moe else 0
    for i in range(c.n_layers):
        p = f"model.layers.{i}."
        a = p + "self_attn."
        m = p + "mlp."
        if c.is_mla:
            dn, dr, dv, dc = (c.qk_nope_head_dim, c.qk_rope_head_dim,
                              c.v_head_dim, c.kv_lora_rank)
            s.update({p + "input_layernorm.weight": (E,),
                      p + "post_attention_layernorm.weight": (E,),
                      a + "kv_a_proj_with_mqa.weight": (dc + dr, E),
                      a + "kv_a_layernorm.weight": (dc,),
                      a + "kv_b_proj.weight": (H * (dn + dv), dc),
                      a + "o_proj.weight": (E, H * dv)})
            if c.q_lora_rank:
                s.update({a + "q_a_proj.weight": (c.q_lora_rank, E),
                          a + "q_a_layernorm.weight": (c.q_lora_rank,),
                          a + "q_b_proj.weight": (H * (dn + dr), c.q_lora_rank)})
            else:
                s[a + "q_proj.weight"] = (H * (dn + dr), E)
        else:
            if layout == "fused":
                s[a + "qkv_proj.weight"] = ((H + 2 * Hk) * hd, E)
            else:
                s.update({a + "q_proj.weight": (H * hd, E),
                          a + "k_proj.weight": (Hk * hd, E),
                          a + "v_proj.weight": (Hk * hd, E)})
            s[a + "o_proj.weight"] = (E, H * hd)
            if c.attn_bias:
                s.update({a + "q_proj.bias": (H * hd,), a + "k_proj.bias": (Hk * hd,),
                          a + "v_proj.bias": (Hk * hd,)})
            if c.qk_norm:
                s[a + "q_norm.weight"] = (H * hd if c.qk_norm_wide else hd,)
                s[a + "k_norm.weight"] = (Hk * hd if c.qk_norm_wide else hd,)
            if c.pre_norms:
                s[p + "input_layernorm.weight"] = (E,)
            s[p + "post_attention_layernorm.weight"] = (E,)
            if c.post_norms:
                s[p + "post_feedforward_layernorm.weight"] = (E,)
                if c.pre_norms:
                    s[p + "pre_feedforward_layernorm.weight"] = (E,)
        if c.is_moe and i >= kD:
            n, F_ = c.n_experts, c.moe_ffn_dim
            base = p + ("block_sparse_moe." if layout == "mixtral" else "mlp.")
            names = (("w1", "w3", "w2") if layout == "mixtral"
                     else ("gate_proj", "up_proj", "down_proj"))
            s[base + "gate.weight"] = (n, E)
            for e in range(n):
                s[f"{base}experts.{e}.{names[0]}.weight"] = (F_, E)
                s[f"{base}experts.{e}.{names[1]}.weight"] = (F_, E)
                s[f"{base}experts.{e}.{names[2]}.weight"] = (E, F_)
            if c.moe_router_bias:
                s[m + "gate.e_score_correction_bias"] = (n,)
            if c.n_shared_experts:
                sh = m + ("shared_experts." if c.is_mla else "shared_expert.")
                sf = c.shared_ffn_dim
                s.update({sh + "gate_proj.weight": (sf, E), sh + "up_proj.weight": (sf, E),
                          sh + "down_proj.weight": (E, sf)})
                if layout == "shared_gate":
                    s[m + "shared_expert_gate.weight"] = (1, E)
        elif layout == "fused":
            s[m + "gate_up_proj.weight"] = (2 * c.ffn_dim, E)
            s[m + "down_proj.weight"] = (E, c.ffn_dim)
        else:
            s.update({m + "gate_proj.weight": (c.ffn_dim, E),
                      m + "up_proj.weight": (c.ffn_dim, E),
                      m + "down_proj.weight": (E, c.ffn_dim)})
    if layout == "language_model":
        s = {"language_model." + k: v for k, v in s.items()}
    return s


def _write(tmp_path, case, dtype, seed=0):
    """A checkpoint directory of `case` in `dtype` (np.float32 or BF16):
    matrices ~ N(0, 1/in), norms 1 + N(0, 0.1^2), biases N(0, 0.1^2)."""
    _, cfg = _configs(case)
    rng = np.random.default_rng(seed)
    tensors = {}
    for name, shape in _hf_shapes(cfg, CASES[case][2]).items():
        if len(shape) == 2:
            x = rng.standard_normal(shape) / np.sqrt(shape[1])
        elif "norm" in name:
            x = 1.0 + 0.1 * rng.standard_normal(shape)
        else:
            x = 0.1 * rng.standard_normal(shape)
        tensors[name] = x.astype(np.float32).astype(dtype)
    tmp_path.mkdir(parents=True, exist_ok=True)
    names = sorted(tensors)
    half = len(names) // 2  # two shards: the multi-file path
    st_save({k: tensors[k] for k in names[:half]}, str(tmp_path / "model-00001.safetensors"))
    st_save({k: tensors[k] for k in names[half:]}, str(tmp_path / "model-00002.safetensors"))
    return tensors


def _assert_trees_equal(got, want, prefix=""):
    assert sorted(got) == sorted(want), prefix
    for k in want:
        if isinstance(want[k], dict):
            _assert_trees_equal(got[k], want[k], f"{prefix}{k}/")
            continue
        assert got[k].dtype == want[k].dtype, prefix + k
        assert torch.equal(got[k], want[k]), prefix + k


@pytest.mark.parametrize("file_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_load_hf_checkpoint_matches_jax(tmp_path, case, file_dtype):
    jcfg, cfg = _configs(case)
    _write(tmp_path, case, np.float32 if file_dtype == "f32" else BF16)
    ref = jweights.load_hf_checkpoint(str(tmp_path), jcfg, dtype="bfloat16")
    want = params_from_numpy(ref, cfg, "cpu", torch.bfloat16)
    stats = {}
    got = weights.load_hf_checkpoint(str(tmp_path), cfg, "cpu", torch.bfloat16, stats=stats)
    _assert_trees_equal(got, want)
    assert stats["bytes"] > 0 and stats["seconds"] >= stats["read_s"] >= 0


@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("case", ["tiny", "gemma3_wrapped", "phi3_fused", "moe_mixtral",
                                  "moe_shared_gate", "mla_moe"])
def test_quantized_load_is_quantize_params_of_the_load(tmp_path, monkeypatch, case, mode):
    """Under `quantize` the loader quantizes a row range at a time (the
    embedding EMBED_ROWS rows, cut here so that several ranges and a short
    last one run): the tree equals quantize_params of the unquantized
    load bit for bit, and a snapshot written as a sink of the load holds
    the unquantized tree."""
    monkeypatch.setattr(weights, "EMBED_ROWS", 96)
    _, cfg = _configs(case)
    _write(tmp_path / "ckpt", case, BF16)
    plain = weights.load_hf_checkpoint(str(tmp_path / "ckpt"), cfg, "cpu")
    snap = weights.SnapshotWriter(str(tmp_path / "snap"), cfg)
    got = weights.load_hf_checkpoint(str(tmp_path / "ckpt"), cfg, "cpu", quantize=mode,
                                     sinks=[snap])
    snap.commit()
    _assert_trees_equal(got, quantize_params(plain, mode))
    _assert_trees_equal(weights.load_snapshot(str(tmp_path / "snap"), cfg, "cpu"), plain)


def test_mla_rope_columns_are_deinterleaved(tmp_path):
    """The loader's MLA permutation, directly: the k_pe block of wkv_a and
    each head's rope block of wq come out as all x, then all y."""
    _, cfg = _configs("mla")
    raw = _write(tmp_path, "mla", np.float32)
    got = weights.load_hf_checkpoint(str(tmp_path), cfg, "cpu", torch.float32)
    dc, dr, dn = cfg.kv_lora_rank, cfg.qk_rope_head_dim, cfg.qk_nope_head_dim
    perm = np.concatenate([np.arange(0, dr, 2), np.arange(1, dr, 2)])
    wkv_a = raw["model.layers.1.self_attn.kv_a_proj_with_mqa.weight"].T
    np.testing.assert_array_equal(got["layers"]["wkv_a"][1, :, dc:].numpy(),
                                  wkv_a[:, dc:][:, perm])
    np.testing.assert_array_equal(got["layers"]["wkv_a"][1, :, :dc].numpy(), wkv_a[:, :dc])
    wq = raw["model.layers.0.self_attn.q_proj.weight"].T.reshape(cfg.dim, cfg.n_heads, dn + dr)
    np.testing.assert_array_equal(
        got["layers"]["wq"][0].numpy().reshape(cfg.dim, cfg.n_heads, dn + dr)[:, :, dn:],
        wq[:, :, dn:][:, :, perm])


@pytest.mark.parametrize("case", ["tiny", "mla"])
def test_mismatched_config_raises(tmp_path, case):
    _, cfg = _configs(case)
    _write(tmp_path, case, BF16)
    bad = (cfg.with_(dim=128, n_heads=8) if case == "tiny"
           else cfg.with_(kv_lora_rank=48))
    with pytest.raises(ValueError):
        weights.load_hf_checkpoint(str(tmp_path), bad, "cpu")


def test_missing_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        weights.load_hf_checkpoint(str(tmp_path), get_config("tiny"), "cpu")


@pytest.mark.parametrize("case", ["tiny", "mla"])
def test_loaded_forward_matches_jax(tmp_path, case):
    jcfg, cfg = _configs(case)
    _write(tmp_path, case, np.float32)
    jparams = jweights.load_hf_checkpoint(str(tmp_path), jcfg, dtype="float32")
    tparams = weights.load_hf_checkpoint(str(tmp_path), cfg, "cpu", torch.float32)
    _forward_pair(jcfg, cfg, jparams, tparams)


def _forward_pair(jcfg, cfg, jparams, tparams):
    """A two-sequence prefill (10 and 16 tokens) and a decode step
    through both forwards: logits within atol 1e-4."""
    rng = np.random.default_rng(1)
    pages = np.array([[3, 7, 1, 12], [5, 2, 14, 8]], np.int32)
    jk, jv = jllama.make_kv_pool(jcfg, NP, PS, jnp.float32)
    tk, tv = make_kv_pool(cfg, NP + 1, PS, torch.float32, "cpu")
    pos = np.full((2, 16), -1, np.int32)
    pos[0, :10] = np.arange(10)
    pos[1] = np.arange(16)
    steps = [(pos, np.array([10, 16], np.int32)),
             (np.array([[10], [16]], np.int32), np.array([11, 17], np.int32))]
    t = torch.from_numpy
    jp = jax.tree_util.tree_map(jnp.asarray, jparams)
    for pos, kvl in steps:
        tok = rng.integers(0, cfg.vocab_size, size=pos.shape).astype(np.int32)
        jl, jk, jv = jllama.forward(jcfg, jp, jnp.asarray(tok), jnp.asarray(pos), jk, jv,
                                    jnp.asarray(pages), jnp.asarray(kvl), attn_impl="jnp")
        tl = llama.forward(cfg, tparams, t(tok), t(pos), tk, tv, t(pages), t(kvl))
        real = pos >= 0
        np.testing.assert_allclose(tl.numpy()[real], np.asarray(jl)[real],
                                   atol=1e-4, rtol=1e-4)


def test_hf_state_dict_round_trip(tmp_path):
    """The dense families' writer (what chip_smoke writes its checkpoint
    with): a loaded tree written back through the port's save_file loads
    to the same tree."""
    _, cfg = _configs("qwen3")
    _write(tmp_path / "a", "qwen3", BF16)
    tree = weights.load_hf_checkpoint(str(tmp_path / "a"), cfg, "cpu")
    (tmp_path / "b").mkdir()
    st_io.save_file(weights.hf_state_dict(tree, cfg), tmp_path / "b" / "model.safetensors")
    _assert_trees_equal(weights.load_hf_checkpoint(str(tmp_path / "b"), cfg, "cpu"), tree)


# -- config_from_hf ---------------------------------------------------------

BASE = {"vocab_size": 512, "hidden_size": 64, "num_hidden_layers": 2,
        "num_attention_heads": 4, "num_key_value_heads": 2, "intermediate_size": 128,
        "max_position_embeddings": 2048, "rms_norm_eps": 1e-5, "rope_theta": 500000.0}
LLAMA3_ROPE = {"rope_type": "llama3", "factor": 32.0, "low_freq_factor": 1.0,
               "high_freq_factor": 4.0, "original_max_position_embeddings": 8192}
HF_CONFIGS = {
    "llama": {**BASE, "model_type": "llama", "rope_scaling": LLAMA3_ROPE,
              "tie_word_embeddings": True},
    "llama_linear": {**BASE, "model_type": "llama",
                     "rope_scaling": {"type": "linear", "factor": 8.0}},
    "llama_default_rope": {**BASE, "model_type": "llama",
                           "rope_scaling": {"rope_type": "default"}},
    "mistral": {**BASE, "model_type": "mistral", "sliding_window": 4096},
    "mixtral": {**BASE, "model_type": "mixtral", "num_local_experts": 8,
                "num_experts_per_tok": 2, "sliding_window": None},
    "phi3": {**BASE, "model_type": "phi3", "sliding_window": 2047},
    "qwen2": {**BASE, "model_type": "qwen2", "rope_theta": 1e6},
    "qwen2_moe": {**BASE, "model_type": "qwen2_moe", "num_experts": 60,
                  "num_experts_per_tok": 4, "moe_intermediate_size": 32,
                  "shared_expert_intermediate_size": 256, "norm_topk_prob": False},
    "qwen3": {**BASE, "model_type": "qwen3", "head_dim": 32, "attention_bias": False},
    "qwen3_moe": {**BASE, "model_type": "qwen3_moe", "num_experts": 128,
                  "num_experts_per_tok": 8, "moe_intermediate_size": 48},
    "granite": {**BASE, "model_type": "granite", "embedding_multiplier": 12.0,
                "residual_multiplier": 0.22, "attention_multiplier": 0.0078125,
                "logits_scaling": 16.0},
    "olmo2": {**BASE, "model_type": "olmo2"},
    "gemma": {**BASE, "model_type": "gemma", "head_dim": 256},
    "gemma2": {**BASE, "model_type": "gemma2", "head_dim": 256,
               "attn_logit_softcapping": 50.0, "final_logit_softcapping": 30.0,
               "query_pre_attn_scalar": 256, "sliding_window": 4096},
    "gemma3_text": {**BASE, "model_type": "gemma3_text", "num_hidden_layers": 12,
                    "sliding_window": 1024, "rope_local_base_freq": 10000.0,
                    "layer_types": (["sliding_attention"] * 5 + ["full_attention"]) * 2,
                    "rope_scaling": {"rope_type": "linear", "factor": 8.0}},
    "gemma3_wrapper": {"model_type": "gemma3", "text_config": {
        "vocab_size": 262208, "hidden_size": 2560, "num_hidden_layers": 34,
        "num_attention_heads": 8, "num_key_value_heads": 4, "intermediate_size": 10240,
        "rope_scaling": {"rope_type": "linear", "factor": 8.0}}},
    "deepseek_v3": {**BASE, "model_type": "deepseek_v3", "kv_lora_rank": 32,
                    "q_lora_rank": 48, "qk_rope_head_dim": 16, "qk_nope_head_dim": 32,
                    "v_head_dim": 32, "n_routed_experts": 8, "num_experts_per_tok": 2,
                    "moe_intermediate_size": 96, "n_shared_experts": 1,
                    "scoring_func": "sigmoid", "topk_method": "noaux_tc",
                    "routed_scaling_factor": 2.5, "first_k_dense_replace": 1,
                    "n_group": 4, "topk_group": 2, "rope_scaling": {
                        "type": "yarn", "factor": 40.0, "beta_fast": 32, "beta_slow": 1,
                        "mscale": 1.0, "mscale_all_dim": 1.0,
                        "original_max_position_embeddings": 4096}},
}


def _hf_dir(tmp_path, cfg):
    tmp_path.mkdir(parents=True, exist_ok=True)
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    return str(tmp_path)


@pytest.mark.parametrize("kind", sorted(HF_CONFIGS))
def test_config_from_hf_matches_jax(tmp_path, monkeypatch, kind):
    # the reference reads Gemma-3 defaults from transformers when it can;
    # the card's machine has none, so both take the pinned defaults
    monkeypatch.setitem(sys.modules, "transformers", None)
    d = _hf_dir(tmp_path, HF_CONFIGS[kind])
    got = weights.config_from_hf(d, name="m")
    want = jweights.config_from_hf(d, name="m")
    for f in dataclasses.fields(ModelConfig):
        assert getattr(got, f.name) == getattr(want, f.name), (kind, f.name)
    assert got.head_dim == want.head_dim


@pytest.mark.parametrize("bad", ["layer_types", "rope_scaling"])
def test_config_from_hf_refuses_what_the_reference_refuses(tmp_path, monkeypatch, bad):
    monkeypatch.setitem(sys.modules, "transformers", None)
    cfg = dict(HF_CONFIGS["gemma3_text"])
    if bad == "layer_types":
        # a global layer off the 5:1 period
        cfg["layer_types"] = (["sliding_attention"] * 5 + ["full_attention"]
                              + ["sliding_attention"] * 3 + ["full_attention"]
                              + ["sliding_attention"] * 2)
    else:
        cfg["rope_scaling"] = {"rope_type": "dynamic", "factor": 2.0}
    d = _hf_dir(tmp_path, cfg)
    with pytest.raises(ValueError):
        jweights.config_from_hf(d)
    with pytest.raises(ValueError):
        weights.config_from_hf(d)


# -- the safetensors writer -------------------------------------------------

def _np_tensors(rng):
    return {
        "f32": rng.standard_normal((3, 5)).astype(np.float32),
        "f16": rng.standard_normal((4,)).astype(np.float16),
        "bf16": rng.standard_normal((6, 3, 2)).astype(BF16),
        "i8": rng.integers(-128, 127, (7,)).astype(np.int8),
        "i32": rng.integers(-9, 9, (2, 2)).astype(np.int32),
        "u8": rng.integers(0, 255, (5,)).astype(np.uint8),
        "e4m3": rng.standard_normal((3, 4)).astype(ml_dtypes.float8_e4m3fn),
        "empty": np.zeros((0, 4), np.float32),
    }


def _as_torch(a):
    if a.dtype == BF16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    if a.dtype == np.dtype(ml_dtypes.float8_e4m3fn):
        return torch.from_numpy(a.view(np.uint8).copy()).view(torch.float8_e4m3fn)
    return torch.from_numpy(a.copy())


def _bits(x):
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy() if x.numel() else np.zeros(0)
    return x.view(np.uint8) if x.size else np.zeros(0)


def test_save_file_loads_in_safetensors(tmp_path):
    want = _np_tensors(np.random.default_rng(2))
    st_io.save_file({k: _as_torch(v) for k, v in want.items()}, tmp_path / "x.safetensors",
                    metadata={"format": "pt"})
    # safetensors.numpy reads no F8 tensor: e4m3 comes back through the
    # port's reader
    e4m3 = st_io.load_file(tmp_path / "x.safetensors")["e4m3"]
    np.testing.assert_array_equal(_bits(e4m3), _bits(want.pop("e4m3")))
    st_io.save_file({k: _as_torch(v) for k, v in want.items()}, tmp_path / "x.safetensors",
                    metadata={"format": "pt"})
    got = st_load(str(tmp_path / "x.safetensors"))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].shape == v.shape and got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(_bits(got[k]), _bits(v))
    raw = (tmp_path / "x.safetensors").read_bytes()
    n = int.from_bytes(raw[:8], "little")
    assert n % 8 == 0 and json.loads(raw[8:8 + n])["__metadata__"] == {"format": "pt"}


def test_safetensors_file_reads_rows_of_what_safetensors_writes(tmp_path):
    want = _np_tensors(np.random.default_rng(3))
    del want["e4m3"]  # safetensors.numpy writes no F8 tensor
    st_save(want, str(tmp_path / "x.safetensors"))
    bounce = st_io.HostBounce("cpu")
    with st_io.SafetensorsFile(tmp_path / "x.safetensors") as f:
        for k, v in want.items():
            t = torch.empty(v.shape, dtype=f.dtype(k))
            np.testing.assert_array_equal(_bits(f.read(k, t, bounce)), _bits(v))
        rows = f.read("bf16", torch.empty((3, 3, 2), dtype=torch.bfloat16), bounce, (2, 5))
        np.testing.assert_array_equal(_bits(rows), _bits(want["bf16"][2:5]))
        with pytest.raises(ValueError):  # another shape than the file's
            f.read("f32", torch.empty((5, 3)), bounce)
    loaded = st_io.load_file(tmp_path / "x.safetensors")
    for k, v in want.items():
        np.testing.assert_array_equal(_bits(loaded[k]), _bits(v))


# -- RoPE "linear" (the fault this slice repairs) ---------------------------

@pytest.mark.parametrize("factor", [1.0, 8.0, 32.0])
def test_rope_linear_inv_freq_matches_jax(factor):
    cfg = get_config("tiny").with_(rope_scaling="linear", rope_factor=factor)
    ref = jax_get_config("tiny").with_(rope_scaling="linear", rope_factor=factor)
    np.testing.assert_array_equal(
        rope_inv_freq_np(cfg, cfg.head_dim, cfg.rope_theta),
        np.asarray(jax_rope_inv_freq(ref, ref.head_dim, ref.rope_theta)))


def test_rope_linear_forward_matches_jax():
    jcfg = jax_get_config("tiny").with_(rope_scaling="linear", rope_factor=8.0)
    cfg = get_config("tiny").with_(rope_scaling="linear", rope_factor=8.0)
    jparams = jax.device_get(jllama.init_params(jcfg, jax.random.PRNGKey(4), jnp.float32))
    _forward_pair(jcfg, cfg, jparams, params_from_numpy(jparams, cfg, "cpu", torch.float32))
