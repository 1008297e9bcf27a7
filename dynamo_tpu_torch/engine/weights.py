"""Carry a parameter tree into the port.

The reference's params are a stacked numpy-convertible tree
({"embed", "norm_f", "lm_head"?, "layers": {"wq": [L, in, out], ...}};
MLA layers hold wkv_a, kv_norm, wkv_b, wo and wq or wq_lat, q_lat_norm,
wq_up; the dense families' branches add bq, bk, bv (Qwen2), q_norm and
k_norm (per head [L, hd], or OLMo-2's full width [L, H * hd]) and
post_attn_norm, post_mlp_norm (Gemma-2, OLMo-2; OLMo-2 has no
attn_norm or mlp_norm); MoE layers hold w_router, we_gate, we_up,
we_down [L, n_experts, ...] in place of w_gate, w_up, w_down, with
router_bias (f32, DeepSeek-V3), the shared experts' ws_gate, ws_up,
ws_down and, from Qwen2-MoE checkpoints, ws_gatectl; a config with
n_dense_layers keeps its leading dense-FFN layers in a second stack
"layers_dense") in x @ W layout; the port's forward reads exactly that
layout, so this is a checked copy onto the device, against the tree
models/llama.py `param_shapes` describes. Norm weights and the router
bias stay f32, as in the reference; matrices and biases take `dtype`.

A weight-only quantized tree (the reference's quantize_params) holds
{"q", "s"} leaves in place of the matrices of quant.DEFAULT_QUANT_NAMES
and {"q", "s", "dt"} for the embedding (models/quant.py). Their codes
cross exactly: int8 as int8, and e4m3 (numpy has no fp8 type: the
reference's arrays are ml_dtypes.float8_e4m3fn, which the port does not
import) through a uint8 view of their bytes, viewed as
torch.float8_e4m3fn on this side. Scales stay f32; "dt" takes `dtype`,
the type every plain matrix of the tree takes here. On a CUDA device the
quantized leaves are held to what the kernels take (quant.check_tree).

Checkpoints (port of dynamo_tpu/engine/weights.py): `config_from_hf`
derives a ModelConfig from a HuggingFace config.json, every model_type
branch of the reference's; `load_hf_checkpoint` reads an HF safetensors
directory (dense families, both MoE layouts, DeepSeek's MLA) straight
onto the device: each stacked leaf is allocated once there, each
layer's [out, in] tensor crosses as it is stored (engine/st_io.py, a
pinned chunk at a time) and is transposed and cast into its slot on the
device, so no host copy of the tree is made. `hf_state_dict` is the
inverse for the dense families (HF names, [out, in]). The params
snapshot (`save_snapshot` / `load_snapshot` / `read_snapshot_into`) is
one safetensors file of the unquantized tree under leaf keys such as
"layers/wq", in place of the reference's orbax directory (the card's
machine has no orbax).

Every load (a checkpoint, a snapshot, a shm stage) fills a tree
allocated once on the device a row range at a time (`fill_tree`: a
layer of a stack, 8192 rows of the embedding, any other leaf whole).
Under `quantize` a matrix's range is read into a temporary and
quantized into its codes and scales, so the unquantized tree is never
whole on the device (mixtral-8x7b's is 93 GB, its int8 codes 46.7 GB).
Each range can also go to sinks (`SnapshotWriter`, the shm stage's
`StageWriter`): a cold load writes the warm tiers, which hold the
unquantized tree, as it reads.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import tempfile
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from dynamo_tpu_torch import resolve_device
from dynamo_tpu_torch.engine.st_io import Entry, HostBounce, SafetensorsFile, Writer
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.models.llama import (
    F32_LEAVES,
    OPTIONAL_LEAVES,
    param_bytes,
    param_shapes,
)
from dynamo_tpu_torch.models.quant import (
    CODE_DTYPES,
    DEFAULT_QUANT_NAMES,
    QUANT_MODES,
    check_tree,
    is_quantized_weight,
    quantize_embed,
    quantize_weight,
)
from dynamo_tpu_torch.models.toolkit import kv_pool_bytes
from dynamo_tpu_torch.parallel.mesh import cut, local_param_shapes, param_cut

log = logging.getLogger("dynamo_tpu_torch.engine.weights")


def _codes(name: str, arr) -> torch.Tensor:
    """A quantized leaf's codes, exactly: int8, or e4m3 bytes (ml_dtypes'
    float8_e4m3fn or its uint8 view) as torch.float8_e4m3fn."""
    arr = np.asarray(arr)
    if arr.dtype == np.int8:
        return torch.tensor(arr)
    if arr.dtype.name == "float8_e4m3fn" or arr.dtype == np.uint8:
        return torch.tensor(arr.view(np.uint8)).view(torch.float8_e4m3fn)
    raise TypeError(f"{name}: codes of type {arr.dtype} (int8 or float8_e4m3fn)")

def params_from_numpy(tree: Mapping[str, Any], config: ModelConfig,
                      device, dtype=torch.bfloat16, rank: int = 0,
                      tp: int = 1) -> Dict[str, Any]:
    """numpy (or array-like) tree -> the port's params dict on `device`.
    Raises on a missing or an extra leaf (a branch the config does not
    run) or a shape that does not match `config`. `tp` > 1: the whole
    tree's rank `rank` slices (parallel/mesh.py's rule; quantized trees
    are refused)."""
    want = param_shapes(config)
    stacks = [k for k, v in want.items() if isinstance(v, dict)]
    extra = sorted(set(tree) - set(want))
    if extra:
        raise KeyError(f"param tree has leaves {config.name} does not use: {extra}")

    def quantized(leaf, name, shape):
        if name not in DEFAULT_QUANT_NAMES:
            raise ValueError(f"{name}: the port quantizes only {DEFAULT_QUANT_NAMES}")
        embed = name == "embed"
        want = {"q", "s", "dt"} if embed else {"q", "s"}
        if set(leaf) - want or not {"q", "s"} <= set(leaf):
            raise KeyError(f"{name}: quantized leaf with {sorted(leaf)}, wants "
                           f"{sorted(want)}")
        q = _codes(name, leaf["q"])
        sc = torch.tensor(np.asarray(leaf["s"], dtype=np.float32))
        s_shape = (shape[0], 1) if embed else (*shape[:-2], 1, shape[-1])
        if tuple(q.shape) != shape or tuple(sc.shape) != s_shape:
            raise ValueError(f"{name}: codes {tuple(q.shape)} and scales "
                             f"{tuple(sc.shape)}, config wants {shape} and {s_shape}")
        out = {"q": q.to(device), "s": sc.to(device)}
        if embed:
            out["dt"] = torch.zeros((0,), dtype=dtype, device=device)
        return out

    def conv(where, name, shape):
        if isinstance(where[name], Mapping):
            if tp > 1:
                raise NotImplementedError(
                    "quantized weights under tensor parallelism: ROADMAP A.14 "
                    "(second half)")
            return quantized(where[name], name, shape)
        arr = np.asarray(where[name], dtype=np.float32)
        if arr.shape != shape:
            raise ValueError(f"{name}: shape {arr.shape}, config wants {shape}")
        t = cut(torch.tensor(arr), param_cut(name), rank, tp)  # a copy: the
        #   source may be read-only
        return t.to(device=device,
                    dtype=torch.float32 if name in F32_LEAVES else dtype)

    def convert(where, shapes, prefix=""):
        extra = sorted(set(where) - set(shapes))
        if extra:
            raise KeyError(f"param tree has leaves {config.name} does not use: "
                           f"{[prefix + e for e in extra]}")
        out = {}
        for name, shape in shapes.items():
            if name in where:
                out[name] = conv(where, name, shape)
            elif name not in OPTIONAL_LEAVES:
                raise KeyError(f"param tree lacks {prefix + name!r}")
        return out

    out = convert({k: v for k, v in tree.items() if k not in stacks},
                  {k: v for k, v in want.items() if k not in stacks})
    for st in stacks:
        if st not in tree:
            raise KeyError(f"param tree lacks {st!r}")
        out[st] = convert(tree[st], want[st], f"{st}.")
    check_tree(out)
    return out


def serving_bytes(config: ModelConfig, num_pages: int, page_size: int,
                  dtype=torch.bfloat16, kv_quantize=None, quantize=None,
                  params=None, draft_config: ModelConfig = None,
                  draft_params=None, tp: int = 1) -> int:
    """Device bytes a ModelRunner places: its KV pools (`num_pages` + 1
    pages: the spare page takes the padding rows' writes), its params when
    it draws them (`params` None) or, given a tree under `quantize`, the
    codes and scales quantize_params adds beside it; with a draft model,
    the draft's pools (the same pages) and its params when drawn. Draft
    params are never quantized. `tp`: one of tp ranks' bytes (tensor
    parallelism: its params slice and its pools' heads)."""
    need = kv_pool_bytes(config, num_pages + 1, page_size, dtype, kv_quantize, tp)
    if params is None:
        need += param_bytes(config, dtype, quantize, tp=tp)
    elif quantize:
        # the caller's tree stays (another runner may serve it)
        held = [params] + [params[st] for st in ("layers", "layers_dense")
                           if st in params]
        plain = {n for tree in held for n, w in tree.items()
                 if n in DEFAULT_QUANT_NAMES and torch.is_tensor(w)}
        need += param_bytes(config, dtype, quantize, only=plain)
    if draft_config is not None:
        need += kv_pool_bytes(draft_config, num_pages + 1, page_size, dtype,
                              kv_quantize)
        if draft_params is None:
            need += param_bytes(draft_config, dtype)
    return need


def check_fits(name: str, need: int, free: int, ranks: int = 1, tp: int = 1) -> None:
    """Raise MemoryError, before anything is drawn or copied, when `need`
    bytes of params and pools exceed the `free` bytes of the device. Under
    tensor parallelism `need` is one of `tp` ranks' bytes and `ranks` of
    them share the device."""
    if tp > 1:
        total = need * ranks
        if total > free:
            raise MemoryError(
                f"{name} over {tp} tensor-parallel ranks: {ranks} rank(s) on "
                f"this device, {need / 1e9:.1f} GB each of params slices and KV "
                f"pools, {total / 1e9:.1f} GB in all, and the device has "
                f"{free / 1e9:.1f} GB free; spread the ranks over more cards, "
                "serve fewer layers or fewer pages")
        return
    if need > free:
        raise MemoryError(
            f"{name}: its params and KV pools take {need / 1e9:.1f} GB and the "
            f"device has {free / 1e9:.1f} GB free; serve fewer layers "
            "(config.with_(n_layers=...)), fewer pages, or nothing else on "
            "the device")


# -- HF configs ----------------------------------------------------------------

# upstream Gemma3TextConfig defaults for the fields config_from_hf reads: HF
# writes a nested text_config as a diff against them (the reference takes
# them from transformers when it is installed; the card's machine has none)
GEMMA3_TEXT_DEFAULTS = {
    "rope_theta": 1_000_000.0, "rope_local_base_freq": 10_000.0,
    "sliding_window": 4096, "query_pre_attn_scalar": 256.0,
    "head_dim": 256, "rms_norm_eps": 1e-6,
    "max_position_embeddings": 131072,
    "tie_word_embeddings": True,
}


def config_from_hf(checkpoint_dir: str, name: Optional[str] = None) -> ModelConfig:
    """A ModelConfig from a HF config.json: llama, mistral, mixtral, phi3,
    qwen2 / qwen2_moe / qwen3 / qwen3_moe, granite, olmo2, gemma /
    gemma2 / gemma3 (a multimodal wrapper's text_config unwrapped over
    GEMMA3_TEXT_DEFAULTS) and deepseek model types, field for field as
    the reference derives them."""
    cfg = json.loads((Path(checkpoint_dir) / "config.json").read_text())
    mt = cfg.get("model_type", "llama")
    if mt == "gemma3" and isinstance(cfg.get("text_config"), dict):
        # the LM (its rope_scaling too) lives under text_config: unwrap
        # before any field is read
        cfg = {**GEMMA3_TEXT_DEFAULTS, **cfg["text_config"], "model_type": "gemma3_text"}
        mt = "gemma3_text"
    rope_kw = _rope_scaling_from_hf(cfg)
    if mt.startswith("deepseek"):
        return ModelConfig(
            **rope_kw,
            n_expert_groups=int(cfg.get("n_group") or 0),
            topk_groups=int(cfg.get("topk_group") or 0),
            name=name or cfg.get("_name_or_path", "deepseek-hf"),
            vocab_size=cfg["vocab_size"],
            dim=cfg["hidden_size"],
            n_layers=cfg["num_hidden_layers"],
            n_heads=cfg["num_attention_heads"],
            n_kv_heads=cfg.get("num_key_value_heads", cfg["num_attention_heads"]),
            ffn_dim=cfg["intermediate_size"],
            max_seq_len=cfg.get("max_position_embeddings", 8192),
            rope_theta=float(cfg.get("rope_theta", 10000.0)),
            norm_eps=float(cfg.get("rms_norm_eps", 1e-6)),
            tie_embeddings=bool(cfg.get("tie_word_embeddings", False)),
            attn_type="mla",
            kv_lora_rank=int(cfg["kv_lora_rank"]),
            q_lora_rank=int(cfg.get("q_lora_rank") or 0),
            qk_rope_head_dim=int(cfg["qk_rope_head_dim"]),
            qk_nope_head_dim=int(cfg["qk_nope_head_dim"]),
            v_head_dim=int(cfg["v_head_dim"]),
            n_experts=int(cfg.get("n_routed_experts") or 0),
            n_experts_active=int(cfg.get("num_experts_per_tok") or 0),
            moe_ffn_dim=int(cfg.get("moe_intermediate_size") or 0),
            n_shared_experts=int(cfg.get("n_shared_experts") or 0),
            moe_scoring="sigmoid" if cfg.get("scoring_func") == "sigmoid" else "softmax",
            moe_norm_topk=bool(cfg.get("norm_topk_prob", True)),
            # V3's aux-loss-free balancing ships the correction bias
            moe_router_bias=cfg.get("topk_method") == "noaux_tc",
            moe_routed_scale=float(cfg.get("routed_scaling_factor") or 1.0),
            n_dense_layers=int(cfg.get("first_k_dense_replace") or 0),
        )
    n_experts = int(cfg.get("num_experts") or cfg.get("n_routed_experts")
                    or cfg.get("num_local_experts") or 0)  # Mixtral's name
    gemma3 = mt.startswith("gemma3")
    kw: Dict[str, Any] = {}
    if mt == "granite":
        # Llama's layout and four multipliers; logits_scaling divides the
        # logits, and an omitted attention_multiplier is a scale of 1
        kw.update(
            embed_multiplier=float(cfg.get("embedding_multiplier") or 0.0),
            residual_multiplier=float(cfg.get("residual_multiplier") or 1.0),
            attn_scale=float(cfg.get("attention_multiplier", 1.0) or 1.0),
            logits_divider=float(cfg.get("logits_scaling") or 1.0),
        )
    if mt == "olmo2":
        # no pre-norms: the post norms norm the branch outputs, and the
        # qk-norm spans the full projection width
        kw.update(post_norms=True, pre_norms=False, qk_norm_wide=True)
    if mt == "gemma":
        kw.update(act="gelu_tanh", embed_scale=True, norm_zero_centered=True)
    if mt in ("mistral", "mixtral", "phi3") and cfg.get("sliding_window"):
        # the window slides on every layer: period 1, a global residue
        # no layer has
        kw.update(sliding_window=int(cfg["sliding_window"]), sw_period=1,
                  sw_global_residue=1)
    if mt == "gemma2" or gemma3:
        kw = dict(
            act="gelu_tanh",
            embed_scale=True,
            norm_zero_centered=True,
            post_norms=True,
            attn_logit_softcap=float(cfg.get("attn_logit_softcapping") or 0.0),
            final_logit_softcap=float(cfg.get("final_logit_softcapping") or 0.0),
            query_pre_attn_scalar=float(cfg.get("query_pre_attn_scalar") or 0.0),
            sliding_window=int(cfg.get("sliding_window") or 0),
        )
    if gemma3:
        # 5 local : 1 global, from layer_types when given, which must be
        # that periodic pattern (a mis-phased window schedule would give
        # wrong logits with no error)
        layer_types = cfg.get("layer_types")
        period = int(cfg.get("sliding_window_pattern") or 6)
        if layer_types:
            globals_ = [i for i, t in enumerate(layer_types) if t == "full_attention"]
            if globals_:
                period = globals_[0] + 1
            expect = ["full_attention" if (i % period) == period - 1
                      else "sliding_attention" for i in range(len(layer_types))]
            if layer_types != expect:
                raise ValueError(
                    "gemma3 layer_types is not the canonical "
                    f"{period - 1}:1 local/global pattern; refusing to "
                    "mis-phase the sliding schedule")
        kw.update(
            sw_period=period,
            sw_global_residue=period - 1,
            rope_local_theta=float(cfg.get("rope_local_base_freq", 10000.0) or 10000.0),
        )
    return ModelConfig(
        **rope_kw,
        **kw,
        name=name or cfg.get("_name_or_path", "hf-model"),
        vocab_size=cfg["vocab_size"],
        dim=cfg["hidden_size"],
        n_layers=cfg["num_hidden_layers"],
        n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg.get("num_key_value_heads", cfg["num_attention_heads"]),
        ffn_dim=cfg["intermediate_size"],
        max_seq_len=cfg.get("max_position_embeddings", 8192),
        rope_theta=float(cfg.get("rope_theta", 500000.0)),
        norm_eps=float(cfg.get("rms_norm_eps", 1e-5)),
        tie_embeddings=bool(cfg.get("tie_word_embeddings", False)),
        # Qwen2 ships biases by default; others say so explicitly
        attn_bias=bool(cfg.get("attention_bias", mt in ("qwen2", "qwen2_moe"))),
        qk_norm=mt in ("qwen3", "qwen3_moe", "olmo2") or gemma3,
        head_dim_override=int(cfg.get("head_dim") or 0),
        n_experts=n_experts,
        n_experts_active=int(cfg.get("num_experts_per_tok") or 0),
        # Mixtral's experts take the dense width; other MoE types must say
        # theirs (a missing one fails on shapes rather than guess)
        moe_ffn_dim=int(cfg.get("moe_intermediate_size")
                        or (cfg.get("intermediate_size") if mt == "mixtral" else 0)
                        or 0),
        n_shared_experts=int(cfg.get("n_shared_experts")
                             or (1 if cfg.get("shared_expert_intermediate_size") else 0)),
        shared_expert_ffn_dim=int(cfg.get("shared_expert_intermediate_size") or 0),
        moe_scoring="sigmoid" if cfg.get("scoring_func") == "sigmoid" else "softmax",
        # Qwen2-MoE's norm_topk_prob false keeps the softmax over all
        moe_norm_topk=bool(cfg.get("norm_topk_prob", True)),
    )


def _rope_scaling_from_hf(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """HF rope_scaling -> the config's rope_* fields; an unknown type
    raises (ignoring one would give wrong long-context attention)."""
    rs = cfg.get("rope_scaling")
    if not rs:
        return {}
    kind = rs.get("rope_type") or rs.get("type") or ""
    if kind == "llama3":
        return {
            "rope_scaling": "llama3",
            "rope_factor": float(rs.get("factor", 8.0)),
            "rope_orig_max_seq": int(rs.get("original_max_position_embeddings") or 8192),
            "rope_low_freq_factor": float(rs.get("low_freq_factor", 1.0)),
            "rope_high_freq_factor": float(rs.get("high_freq_factor", 4.0)),
        }
    if kind in ("linear", "default"):
        # uniform position interpolation (Gemma-3's global RoPE, factor 8);
        # "default" is HF's explicit no-op
        f = float(rs.get("factor", 1.0))
        if f == 1.0 or kind == "default":
            return {}
        return {"rope_scaling": "linear", "rope_factor": f}
    if kind == "yarn":
        return {
            "rope_scaling": "yarn",
            "rope_factor": float(rs.get("factor", 1.0)),
            "rope_orig_max_seq": int(rs.get("original_max_position_embeddings") or 4096),
            "rope_beta_fast": float(rs.get("beta_fast", 32.0)),
            "rope_beta_slow": float(rs.get("beta_slow", 1.0)),
            "rope_mscale": float(rs.get("mscale", 1.0)),
            "rope_mscale_all_dim": float(rs.get("mscale_all_dim", 0.0)),
        }
    raise ValueError(f"unsupported rope_scaling type {kind!r} (supported: llama3, yarn)")


def weights_fingerprint(config: ModelConfig) -> Dict[str, Any]:
    """What a shm stage and a params snapshot record of the model they
    hold (the reference worker's stage meta)."""
    return {"model": config.name, "vocab": config.vocab_size, "dim": config.dim,
            "n_layers": config.n_layers, "n_heads": config.n_heads,
            "n_kv_heads": config.n_kv_heads}


# -- HF checkpoints ------------------------------------------------------------


def _rope_deinterleave(d: int) -> torch.Tensor:
    """The column permutation from HF DeepSeek's interleaved RoPE layout
    (x0, y0, x1, y1, ...) to the half-rotation one (all x, then all y)
    models/toolkit.py's rope rotates: folded into the weights once at
    load, as the reference does."""
    return torch.cat([torch.arange(0, d, 2), torch.arange(1, d, 2)])


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _Checkpoint:
    """The safetensors files of an HF directory, by tensor name ("language_
    model." aliased away for Gemma-3's multimodal wrappers), read onto
    `device` a tensor (or a row range) at a time."""

    def __init__(self, files, config: ModelConfig, device: torch.device):
        self.config = config
        self.device = device
        self.files: List[SafetensorsFile] = []
        try:
            for f in files:
                self.files.append(SafetensorsFile(f))
        except BaseException:
            self.close()
            raise
        self.where: Dict[str, Tuple[SafetensorsFile, str]] = {}
        for f in self.files:
            for key in f.keys():
                if key.startswith("language_model."):
                    self.where[key[len("language_model."):]] = (f, key)
                self.where[key] = (f, key)
        self.bounce = HostBounce(device)
        self.device_s = 0.0  # transposes, casts and permutations on the device

    def close(self) -> None:
        for f in self.files:
            f.close()

    def __contains__(self, name: str) -> bool:
        return name in self.where

    def _locate(self, name: str) -> Tuple[SafetensorsFile, str, Optional[Tuple[int, int]]]:
        """(file, key, rows): Phi-3's fused qkv_proj ([q; k; v] rows) and
        gate_up_proj ([gate; up]) serve the split names as row ranges."""
        if name in self.where:
            f, key = self.where[name]
            return f, key, None
        parts = name.split(".")
        proj = parts[-2] if len(parts) >= 2 else ""
        c = self.config
        if proj in ("q_proj", "k_proj", "v_proj"):
            fused = ".".join(parts[:-2] + ["qkv_proj", parts[-1]])
            if fused in self.where:
                q, kv = c.n_heads * c.head_dim, c.n_kv_heads * c.head_dim
                lo = {"q_proj": 0, "k_proj": q, "v_proj": q + kv}[proj]
                f, key = self.where[fused]
                return f, key, (lo, lo + (q if proj == "q_proj" else kv))
        if proj in ("gate_proj", "up_proj"):
            fused = ".".join(parts[:-2] + ["gate_up_proj", parts[-1]])
            if fused in self.where:
                F_ = c.ffn_dim
                lo = 0 if proj == "gate_proj" else F_
                f, key = self.where[fused]
                return f, key, (lo, lo + F_)
        raise KeyError(f"checkpoint has no tensor {name!r}")

    def shape(self, name: str) -> Tuple[int, ...]:
        f, key, rows = self._locate(name)
        shape = f.shape(key)
        return shape if rows is None else (rows[1] - rows[0],) + tuple(shape[1:])

    def read(self, name: str, shape: Tuple[int, ...],
             rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        """Tensor `name` as stored (its [out, in] layout and dtype), or its
        rows [r0, r1), on the device; a shape other than `shape` raises
        ValueError."""
        f, key, fused = self._locate(name)
        if rows is not None:
            base = fused[0] if fused else 0
            fused = (base + rows[0], base + rows[1])
        out = torch.empty(shape, dtype=f.dtype(key), device=self.device)
        return f.read(key, out, self.bounce, fused)


def _stack_sources(c: ModelConfig, ckpt: _Checkpoint, L0: int, moe: bool
                   ) -> Dict[str, Tuple[str, str]]:
    """leaf -> (HF name template over {i} and, for experts, {e}; the
    fix applied after the transpose: "" or MLA's "kv_a" / "q") for the
    stack whose first layer is L0."""
    a = "model.layers.{i}.self_attn."
    m = "model.layers.{i}.mlp."
    src: Dict[str, Tuple[str, str]] = {}
    if c.is_mla:
        src.update({
            "attn_norm": ("model.layers.{i}.input_layernorm.weight", ""),
            "mlp_norm": ("model.layers.{i}.post_attention_layernorm.weight", ""),
            "wkv_a": (a + "kv_a_proj_with_mqa.weight", "kv_a"),
            "kv_norm": (a + "kv_a_layernorm.weight", ""),
            "wkv_b": (a + "kv_b_proj.weight", ""),
            "wo": (a + "o_proj.weight", ""),
            "wq_lat": (a + "q_a_proj.weight", ""),
            "q_lat_norm": (a + "q_a_layernorm.weight", ""),
            "wq_up": (a + "q_b_proj.weight", "q"),
            "wq": (a + "q_proj.weight", "q"),
        })
    else:
        src.update({
            "wq": (a + "q_proj.weight", ""), "wk": (a + "k_proj.weight", ""),
            "wv": (a + "v_proj.weight", ""), "wo": (a + "o_proj.weight", ""),
            "bq": (a + "q_proj.bias", ""), "bk": (a + "k_proj.bias", ""),
            "bv": (a + "v_proj.bias", ""),
            "q_norm": (a + "q_norm.weight", ""), "k_norm": (a + "k_norm.weight", ""),
            "attn_norm": ("model.layers.{i}.input_layernorm.weight", ""),
            # Gemma-2 and OLMo-2: post_attention_layernorm is the norm after
            # attention; the pre-FFN norm is pre_feedforward_layernorm
            "mlp_norm": ("model.layers.{i}." + ("pre_feedforward_layernorm"
                                                if c.post_norms else
                                                "post_attention_layernorm") + ".weight", ""),
            "post_attn_norm": ("model.layers.{i}.post_attention_layernorm.weight", ""),
            "post_mlp_norm": ("model.layers.{i}.post_feedforward_layernorm.weight", ""),
        })
    if not moe:
        src.update({"w_gate": (m + "gate_proj.weight", ""),
                    "w_up": (m + "up_proj.weight", ""),
                    "w_down": (m + "down_proj.weight", "")})
        return src
    # two MoE layouts: Qwen / DeepSeek mlp.gate + mlp.experts.N.{gate,up,
    # down}_proj, and Mixtral's block_sparse_moe.gate + experts.N.{w1, w3,
    # w2} (w1 the gate, w3 the up, w2 the down projection)
    mixtral = f"model.layers.{L0}.block_sparse_moe.gate.weight" in ckpt
    base = "model.layers.{i}." + ("block_sparse_moe." if mixtral else "mlp.")
    parts = (("w1", "w3", "w2") if mixtral else ("gate_proj", "up_proj", "down_proj"))
    shared = m + ("shared_experts." if f"model.layers.{L0}.mlp.shared_experts.gate_proj.weight"
                  in ckpt else "shared_expert.")
    src.update({
        "w_router": (base + "gate.weight", ""),
        "we_gate": (base + "experts.{e}." + parts[0] + ".weight", ""),
        "we_up": (base + "experts.{e}." + parts[1] + ".weight", ""),
        "we_down": (base + "experts.{e}." + parts[2] + ".weight", ""),
        "router_bias": (m + "gate.e_score_correction_bias", ""),
        "ws_gate": (shared + "gate_proj.weight", ""),
        "ws_up": (shared + "up_proj.weight", ""),
        "ws_down": (shared + "down_proj.weight", ""),
        "ws_gatectl": (m + "shared_expert_gate.weight", ""),
    })
    return src


def load_hf_checkpoint(checkpoint_dir: str, config: ModelConfig, device=None,
                       dtype=torch.bfloat16, stats: Optional[Dict[str, float]] = None,
                       quantize: Optional[str] = None, sinks: Sequence[Any] = (),
                       rank: int = 0, tp: int = 1) -> Dict[str, Any]:
    """An HF safetensors directory -> the port's params on `device` (CUDA
    unless "cpu"), in x @ W layout, the tree `param_shapes(config)`
    describes: matrices in `dtype`, norms and the router bias in f32, bit
    for bit what the reference's loader gives through params_from_numpy;
    under `quantize`, what quantize_params gives of that tree, quantized a
    row range at a time (`fill_tree`). Each range of the unquantized tree
    also goes to `sinks`. A checkpoint whose first query projection does
    not match `config` raises ValueError, one that does not fit the card
    MemoryError, both before any tensor is copied. `stats` (a dict) gets
    the seconds of the file reads, host-to-device copies and device
    transposes, and the bytes read. `tp` > 1 reads rank `rank`'s slice of
    every leaf (parallel/mesh.py): a leaf cut along the stored tensor's
    rows (a column-parallel projection, its bias, an untied head) reads
    only those rows; one cut along its columns (wo, w_down, the
    embedding) is read a layer or a row range at a time and cut on the
    device. Under tensor parallelism the caller checks the fit (every
    rank sharing the card), and quantized or sinked loads are refused."""
    d = Path(checkpoint_dir)
    files = sorted(d.glob("*.safetensors"))
    if not files:
        raise FileNotFoundError(f"no .safetensors files under {checkpoint_dir}")
    device = resolve_device(device)
    c = config
    if tp > 1 and (quantize or sinks):
        raise NotImplementedError("quantized loads and warm-tier sinks under "
                                  "tensor parallelism: ROADMAP A.14 (second half)")
    t_start = time.monotonic()
    ckpt = _Checkpoint(files, c, device)
    try:
        if not c.is_mla:
            q = ckpt.shape("model.layers.0.self_attn.q_proj.weight")
            if tuple(q) != (c.n_heads * c.head_dim, c.dim):
                raise ValueError(
                    f"checkpoint shape {tuple(q[::-1])} does not match config "
                    f"{c.name} ({c.dim}, {c.n_heads * c.head_dim})")
        if device.type == "cuda" and tp == 1:
            check_fits(c.name, param_bytes(c, dtype, quantize),
                       torch.cuda.mem_get_info(device)[0])
        entries, read = _checkpoint_reader(ckpt, c, dtype, rank, tp)
        params = alloc_tree(entries, device, quantize)
        for s in sinks:
            s.begin(entries)
        fill_tree(params, entries, read, quantize, sinks)
    finally:
        ckpt.close()
    check_tree(params)
    if stats is not None:
        stats.update(ckpt.bounce.stats)
        stats["device_s"] = ckpt.device_s
        stats["seconds"] = time.monotonic() - t_start
    log.info("loaded HF checkpoint %s (%d files, %.2f GB) in %.1fs", checkpoint_dir,
             len(files), ckpt.bounce.stats["bytes"] / 1e9, time.monotonic() - t_start)
    return params


def _checkpoint_reader(ckpt: _Checkpoint, c: ModelConfig, dtype, rank: int = 0,
                       tp: int = 1):
    """The unquantized tree the checkpoint gives, as fill_tree's entries
    (sorted by key) and reader: a leaf's rows come from each layer's [out,
    in] tensor, read as stored and transposed, cast and (MLA) permuted
    into place on the device. `tp` > 1: rank `rank`'s slices."""
    dc, dr = c.kv_lora_rank, c.qk_rope_head_dim
    rp = _rope_deinterleave(dr).to(ckpt.device) if c.is_mla else None

    def fill(dst: torch.Tensor, name: str, transpose: bool, fix: str = "",
             rows: Optional[Tuple[int, int]] = None, cut_dim: Optional[int] = None) -> None:
        """Read `name` ([out, in] for a matrix), or its rows, and copy it,
        transposed and cast, into `dst`; then MLA's RoPE fix. `cut_dim`:
        dst is rank `rank`'s slice of that dim of the leaf."""
        whole = list(dst.shape)
        sdim = None
        if cut_dim is not None and tp > 1:
            whole[cut_dim] *= tp
            sdim = cut_dim % dst.dim()
            if transpose:
                sdim = dst.dim() - 1 - sdim
        stored = tuple(whole[::-1]) if transpose else tuple(whole)
        if sdim == 0 and rows is None:  # the stored tensor's rows: read only them
            w = stored[0] // tp
            src = ckpt.read(name, (w,) + stored[1:], (rank * w, (rank + 1) * w))
        else:
            src = ckpt.read(name, stored, rows)
            if sdim is not None:
                w = stored[sdim] // tp
                src = src.narrow(sdim, rank * w, w)
        t0 = time.monotonic()
        dst.copy_(src.t() if transpose else src)
        if fix == "kv_a":  # the k_pe block: the last dr columns
            dst[:, dc:] = dst[:, dc:][:, rp]
        elif fix == "q":  # each head's rope block [dn:dn + dr]
            w3 = dst.view(dst.shape[0], c.n_heads, c.qk_nope_head_dim + dr)
            w3[:, :, c.qk_nope_head_dim:] = w3[:, :, c.qk_nope_head_dim:][:, :, rp]
        _sync(ckpt.device)
        ckpt.device_s += time.monotonic() - t0

    want = local_param_shapes(param_shapes(c), tp)
    kind = lambda leaf: torch.float32 if leaf in F32_LEAVES else dtype  # noqa: E731
    entries: List[Entry] = [("embed", kind("embed"), want["embed"]),
                            ("norm_f", kind("norm_f"), want["norm_f"])]
    if "lm_head" in want:
        entries.append(("lm_head", kind("lm_head"), want["lm_head"]))
    srcs: Dict[str, Tuple[str, str, int]] = {}
    kD = c.n_dense_layers if (c.is_moe and "layers_dense" in want) else 0
    for stack, L0, moe in (("layers_dense", 0, False), ("layers", kD, c.is_moe)):
        if stack not in want:
            continue
        src = _stack_sources(c, ckpt, L0, moe)
        for leaf, shape in want[stack].items():
            tmpl, fix = src[leaf]
            if leaf in OPTIONAL_LEAVES and tmpl.format(i=L0) not in ckpt:
                continue
            srcs[f"{stack}/{leaf}"] = (tmpl, fix, L0)
            entries.append((f"{stack}/{leaf}", kind(leaf), shape))

    def read(key: str, rows: Optional[Tuple[int, int]], out: torch.Tensor) -> None:
        if key not in srcs:  # embed [V, dim] and norm_f as stored; the head transposed
            name = {"embed": "model.embed_tokens.weight", "norm_f": "model.norm.weight",
                    "lm_head": "lm_head.weight"}[key]
            fill(out, name, key == "lm_head", rows=rows, cut_dim=param_cut(key))
            return
        tmpl, fix, L0 = srcs[key]
        r0 = 0 if rows is None else rows[0]
        for j, w in enumerate(out, start=r0):
            if key.endswith(("/we_gate", "/we_up", "/we_down")):
                for e in range(c.n_experts):
                    fill(w[e], tmpl.format(i=L0 + j, e=e), True)
            else:
                fill(w, tmpl.format(i=L0 + j), w.dim() == 2, fix,
                     cut_dim=param_cut(key))

    return sorted(entries), read


def hf_state_dict(params: Mapping[str, Any], config: ModelConfig) -> Dict[str, torch.Tensor]:
    """A dense family's unquantized params as HF tensors (the names
    load_hf_checkpoint reads, matrices back in [out, in], contiguous, on
    the params' device): the inverse of the loader, for writing a
    checkpoint with st_io.save_file."""
    c = config
    if c.is_mla or c.is_moe:
        raise NotImplementedError("hf_state_dict writes the dense families only")
    out: Dict[str, torch.Tensor] = {"model.embed_tokens.weight": params["embed"]}
    src = _stack_sources(c, {}, 0, False)
    for leaf, w in params["layers"].items():
        tmpl, _ = src[leaf]
        for i in range(w.shape[0]):
            out[tmpl.format(i=i)] = w[i].t().contiguous() if w.dim() == 3 else w[i]
    out["model.norm.weight"] = params["norm_f"]
    if "lm_head" in params:
        out["lm_head.weight"] = params["lm_head"].t().contiguous()
    return out


# -- the params snapshot -------------------------------------------------------

SNAPSHOT_FORMAT = "dynamo_tpu_torch.params_snapshot.v1"
SNAPSHOT_FILE = "params.safetensors"


def flatten(tree: Mapping[str, Any], prefix: str = "") -> List[Tuple[str, Any]]:
    """[(key, leaf)] in sorted key order, nested keys joined by "/" (the
    shm stage's keys: "embed", "layers/wq", ...)."""
    out: List[Tuple[str, Any]] = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, Mapping):
            out.extend(flatten(v, f"{prefix}{k}/"))
        else:
            out.append((prefix + k, v))
    return out


def unflatten(entries: Mapping[str, Any]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, leaf in entries.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    return tree


# rows of the embedding a load moves (and quantizes) at a time
EMBED_ROWS = 8192
Reader = Callable[[str, Optional[Tuple[int, int]], torch.Tensor], None]


def _row_steps(key: str, shape: Tuple[int, ...]) -> List[Optional[Tuple[int, int]]]:
    """The row ranges a leaf moves in (None: whole): a layer at a time for
    a stack's leaves, EMBED_ROWS rows of the embedding, any other leaf
    whole (an untied head's scales span all its rows)."""
    if "/" in key and shape:
        return [(j, j + 1) for j in range(shape[0])]
    if key == "embed" and shape[0] > EMBED_ROWS:
        return [(r0, min(shape[0], r0 + EMBED_ROWS)) for r0 in range(0, shape[0], EMBED_ROWS)]
    return [None]


def alloc_tree(entries: Sequence[Entry], device, quantize: Optional[str] = None
               ) -> Dict[str, Any]:
    """The tree `entries` [(key, dtype, shape)] describe, uninitialised on
    `device`; under `quantize` the leaves of DEFAULT_QUANT_NAMES as the
    codes and scales quantize_params makes of them."""
    if quantize is not None and quantize not in QUANT_MODES:
        raise ValueError(f"unknown quantize mode {quantize!r}; one of {QUANT_MODES}")
    flat: Dict[str, Any] = {}
    for key, dtype, shape in entries:
        if quantize and key.split("/")[-1] in DEFAULT_QUANT_NAMES:
            embed = key == "embed"
            s_shape = (*shape[:-1], 1) if embed else (*shape[:-2], 1, shape[-1])
            leaf = {"q": torch.empty(shape, dtype=CODE_DTYPES[quantize], device=device),
                    "s": torch.empty(s_shape, dtype=torch.float32, device=device)}
            if embed:
                leaf["dt"] = torch.zeros((0,), dtype=dtype, device=device)
            flat[key] = leaf
        else:
            flat[key] = torch.empty(shape, dtype=dtype, device=device)
    return unflatten(flat)


def fill_tree(tree: Dict[str, Any], entries: Sequence[Entry], read: Reader,
              quantize: Optional[str] = None, sinks: Sequence[Any] = ()) -> None:
    """Fill `tree`'s leaves in place, a row range at a time (`_row_steps`)
    of the unquantized leaves `entries` [(key, dtype, shape)] names:
    `read(key, rows, out)` puts the leaf's values (rows [r0, r1), or all
    for None) into the contiguous `out`. A plain leaf's rows are read
    straight into it; a quantized leaf's ({"q", "s"}) into a temporary of
    the entry's type, quantized under `quantize` into its codes and
    scales as quantize_params would. Each range also goes to every sink's
    `write(key, values, r0)`. The device holds at most one range more
    than the tree."""
    for key, dtype, shape in entries:
        dst = _node(tree, key)
        quant = is_quantized_weight(dst)
        for rows in _row_steps(key, shape):
            if not quant:
                out = dst if rows is None else dst[rows[0]:rows[1]]
                read(key, rows, out)
            else:
                part = slice(None) if rows is None else slice(*rows)
                n = shape[0] if rows is None else rows[1] - rows[0]
                out = torch.empty((n, *shape[1:]), dtype=dtype, device=dst["q"].device)
                read(key, rows, out)
                qw = (quantize_embed if key == "embed" else quantize_weight)(out, quantize)
                dst["q"][part].copy_(qw["q"])
                dst["s"][part].copy_(qw["s"])
            for sink in sinks:
                sink.write(key, out, 0 if rows is None else rows[0])


class SnapshotWriter:
    """A params snapshot directory written a row range at a time (a sink
    of fill_tree, or save_snapshot's leaves): `begin(entries)` opens one
    safetensors file whose metadata names the format and the config's
    fingerprint, in a directory beside `path`; `commit` renames it into
    place (an existing snapshot is replaced whole), `abort` removes it.
    `seconds` is the time spent in its copies and writes."""

    def __init__(self, path: str, config: ModelConfig):
        self.path = Path(path).resolve()
        self.config = config
        self._tmp: Optional[Path] = None
        self._file: Optional[Writer] = None

    def begin(self, entries: Sequence[Entry]) -> None:
        bad = [k for k, _, _ in entries if k.split("/")[-1] in ("q", "s", "dt")]
        if bad:
            raise ValueError(f"a snapshot holds the unquantized tree; {bad[:3]} are "
                             "quantized leaves")
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._tmp = Path(tempfile.mkdtemp(prefix=".snapshot_", dir=self.path.parent))
        (self._tmp / "new").mkdir()
        self._file = Writer(self._tmp / "new" / SNAPSHOT_FILE, entries,
                            metadata={"format": SNAPSHOT_FORMAT,
                                      "fingerprint": json.dumps(
                                          weights_fingerprint(self.config), sort_keys=True)})

    def write(self, key: str, t: torch.Tensor, row0: int = 0) -> None:
        self._file.write(key, t, row0)

    @property
    def seconds(self) -> float:
        st = self._file.bounce.stats if self._file is not None else {}
        return st.get("d2h_s", 0.0) + st.get("write_s", 0.0)

    def commit(self) -> None:
        self._file.commit()
        if self.path.exists():
            os.rename(self.path, self._tmp / "old")
        os.rename(self._tmp / "new", self.path)
        shutil.rmtree(self._tmp, ignore_errors=True)

    def abort(self) -> None:
        if self._file is not None:
            self._file.abort()
        if self._tmp is not None:
            shutil.rmtree(self._tmp, ignore_errors=True)


def write_tree(sink: Any, params: Mapping[str, Any]) -> None:
    """Every leaf of `params` through `sink` (a SnapshotWriter or a shm
    StageWriter), committed; aborted on a failure."""
    flat = flatten(params)
    try:
        sink.begin([(k, t.dtype, tuple(t.shape)) for k, t in flat])
        for k, t in flat:
            sink.write(k, t.contiguous())
        sink.commit()
    except BaseException:
        sink.abort()
        raise


def save_snapshot(params: Mapping[str, Any], path: str, config: ModelConfig) -> None:
    """Write the unquantized `params` as a snapshot directory `path`
    (SnapshotWriter)."""
    write_tree(SnapshotWriter(path, config), params)


def _open_snapshot(path: str, config: ModelConfig) -> SafetensorsFile:
    """The snapshot's file, checked against `config` before anything is
    read: its format, its fingerprint (but the model's name) and every
    leaf's shape. A directory this port did not write raises ValueError
    naming the format it wants."""
    f = Path(path) / SNAPSHOT_FILE
    if not f.is_file():
        raise ValueError(
            f"{path} is not a {SNAPSHOT_FORMAT} snapshot (no {SNAPSHOT_FILE}); "
            "an orbax snapshot of the JAX worker is not read by this port")
    snap = SafetensorsFile(f)
    try:
        fmt = snap.metadata.get("format")
        if fmt != SNAPSHOT_FORMAT:
            raise ValueError(f"{path}: snapshot format {fmt!r}, not {SNAPSHOT_FORMAT!r}")
        got = json.loads(snap.metadata.get("fingerprint") or "{}")
        want = weights_fingerprint(config)
        if {k: v for k, v in got.items() if k != "model"} != \
                {k: v for k, v in want.items() if k != "model"}:
            raise ValueError(f"snapshot {path} does not match {config.name}: it holds "
                             f"{got}, the config is {want}")
        shapes = dict(flatten(param_shapes(config)))
        extra = sorted(set(snap.keys()) - set(shapes))
        missing = sorted(k for k in set(shapes) - set(snap.keys())
                         if k.split("/")[-1] not in OPTIONAL_LEAVES)
        wrong = sorted(k for k in snap.keys() if k in shapes
                       and tuple(snap.shape(k)) != tuple(shapes[k]))
        if extra or missing or wrong:
            raise ValueError(f"snapshot {path} does not match {config.name}: extra "
                             f"{extra}, missing {missing}, other shapes {wrong}")
    except BaseException:
        snap.close()
        raise
    return snap


def _read_leaf(snap: SafetensorsFile, key: str, dst: torch.Tensor, bounce: HostBounce,
               rows: Optional[Tuple[int, int]] = None) -> None:
    """Leaf `key` (or its rows) into `dst`, in place: straight in when the
    types agree, else through a staging tensor of the file's type."""
    if snap.dtype(key) == dst.dtype:
        snap.read(key, dst, bounce, rows)
        return
    dst.copy_(snap.read(key, torch.empty(dst.shape, dtype=snap.dtype(key),
                                         device=dst.device), bounce, rows))


def load_snapshot(path: str, config: ModelConfig, device=None,
                  dtype=torch.bfloat16, quantize: Optional[str] = None,
                  sinks: Sequence[Any] = ()) -> Dict[str, Any]:
    """A snapshot directory -> the params on `device` (matrices in
    `dtype`, norms and the router bias in f32), quantized under
    `quantize` a row range at a time; each range also goes to `sinks`."""
    device = resolve_device(device)
    with _open_snapshot(path, config) as snap:
        if device.type == "cuda":
            check_fits(config.name, param_bytes(config, dtype, quantize),
                       torch.cuda.mem_get_info(device)[0])
        entries = [(k, torch.float32 if k.split("/")[-1] in F32_LEAVES else dtype,
                    tuple(snap.shape(k))) for k in sorted(snap.keys())]
        params = alloc_tree(entries, device, quantize)
        for s in sinks:
            s.begin(entries)
        fill_tree(params, entries, _snapshot_reader(snap, HostBounce(device)), quantize,
                  sinks)
    check_tree(params)
    return params


def _snapshot_reader(snap: SafetensorsFile, bounce: HostBounce) -> Reader:
    return lambda key, rows, out: _read_leaf(snap, key, out, bounce, rows)


class PartialReload(RuntimeError):
    """A reload failed after its first copy: the served tree holds some
    leaves of the new weights and some of the old."""


def _node(tree: Mapping[str, Any], key: str):
    """The leaf at a flattened key, or KeyError."""
    for p in key.split("/"):
        tree = tree[p]
    return tree


def read_snapshot_into(path: str, config: ModelConfig, params: Dict[str, Any],
                       quantize: Optional[str] = None) -> None:
    """Overwrite `params`, in place, with a snapshot's weights. The
    snapshot is checked whole first (format, fingerprint, every leaf's
    shape, every leaf present in `params`): a failure there leaves
    `params` as they were. Then `fill_tree` copies it a row range at a
    time, a plain leaf's straight into its tensor and a quantized one's
    requantized under `quantize`, so the device holds at most one range
    more than the tree. A failure from the first copy on raises
    PartialReload."""
    with _open_snapshot(path, config) as snap:
        keys = sorted(snap.keys())
        entries = []
        for key in keys:
            try:
                dst = _node(params, key)
            except KeyError:
                raise KeyError(f"the served params lack {key!r}") from None
            entries.append((key, snap.dtype(key) if is_quantized_weight(dst) else dst.dtype,
                            tuple(snap.shape(key))))
        device = flatten(params)[0][1].device
        try:
            fill_tree(params, entries, _snapshot_reader(snap, HostBounce(device)), quantize)
        except Exception as e:
            raise PartialReload(f"the reload from {path} failed after its first copy "
                                f"({e}); the served weights mix old and new leaves") from e
