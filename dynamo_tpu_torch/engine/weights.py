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
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.models.llama import (
    F32_LEAVES,
    OPTIONAL_LEAVES,
    param_bytes,
    param_shapes,
)
from dynamo_tpu_torch.models.quant import DEFAULT_QUANT_NAMES, check_tree
from dynamo_tpu_torch.models.toolkit import kv_pool_bytes


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
                      device, dtype=torch.bfloat16) -> Dict[str, Any]:
    """numpy (or array-like) tree -> the port's params dict on `device`.
    Raises on a missing or an extra leaf (a branch the config does not
    run) or a shape that does not match `config`."""
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
            return quantized(where[name], name, shape)
        arr = np.asarray(where[name], dtype=np.float32)
        if arr.shape != shape:
            raise ValueError(f"{name}: shape {arr.shape}, config wants {shape}")
        t = torch.tensor(arr)  # a copy: the source may be read-only
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
                  draft_params=None) -> int:
    """Device bytes a ModelRunner places: its KV pools (`num_pages` + 1
    pages: the spare page takes the padding rows' writes), its params when
    it draws them (`params` None) or, given a tree under `quantize`, the
    codes and scales quantize_params adds beside it; with a draft model,
    the draft's pools (the same pages) and its params when drawn. Draft
    params are never quantized."""
    need = kv_pool_bytes(config, num_pages + 1, page_size, dtype, kv_quantize)
    if params is None:
        need += param_bytes(config, dtype, quantize)
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


def check_fits(name: str, need: int, free: int) -> None:
    """Raise MemoryError, before anything is drawn or copied, when `need`
    bytes of params and pools exceed the `free` bytes of the device."""
    if need > free:
        raise MemoryError(
            f"{name}: its params and KV pools take {need / 1e9:.1f} GB and the "
            f"device has {free / 1e9:.1f} GB free; serve fewer layers "
            "(config.with_(n_layers=...)), fewer pages, or nothing else on "
            "the device")
