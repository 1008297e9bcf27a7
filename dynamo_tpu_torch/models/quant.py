"""Quantization: weight-only int8 / fp8 matrices, and the int8 KV cache.

Port of dynamo_tpu/models/quant.py, both halves, with its conventions and
its arithmetic.

Weights: a quantized matrix is the dict {"q": int8 or float8_e4m3fn
[..., in, out], "s": f32 [..., 1, out]}, one symmetric scale per output
channel; the embedding table is quantized per row, {"q" [V, E], "s"
[V, 1], "dt"}, where "dt" is a zero-size leaf whose dtype records the
table's, because a row is both the gather unit and the tied head's output
channel. DEFAULT_QUANT_NAMES picks the leaves; norms, the router and the
biases stay as they are. Scales are max(amax, 1e-8) times the f32
reciprocal of 127 (int8) or 448 (e4m3's finite max): XLA rewrites the
reference's division by the constant into that product, and a true
division gives another scale for some columns. Codes: int8 clamp(round(w / s), -127, 127)
(torch.round rounds half to even, as jnp.round does), fp8 (w / s) cast to
float8_e4m3fn with no clip, as the reference has none.

`mm(x, w)` is the product every matrix of the forward goes through,
plain or quantized, and `tied_logits` the tied head's h @ embed^T. On a
quantized weight both run ops/quant_gemm.py: the hand-written weight-only
GEMM on CUDA tensors, its plain version (the reference's `mm`, two
roundings in x's dtype) on CPU tensors or under impl="ref".
`embed_lookup` is a gather and a product in plain PyTorch. `check_tree`
holds a tree's quantized CUDA leaves to what the kernels take, once, where
the tree is built (init_params, quantize_params, params_from_numpy, a
runner given a tree), so that a product checks only its activations.

KV cache: {"q": int8 [L, NP, PS, Hk, D], "s": f32 [L, NP, PS, Hk]}, one
scale per cached (token, head) vector: the amax over D in f32, s =
max(amax, 1e-8) times the f32 reciprocal of 127, as XLA computes the
reference's jitted `kv_quantize`, q = clamp(round(x / s), -127, 127).
D + 4 bytes a vector against 2 D in bf16, so decode's KV stream shrinks
to 0.52x at D 128. The attention kernels fold the scales into the scores
(K) and the probabilities (V); pages cross the transfer boundary
dequantized (engine/model_runner.py).
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch

from dynamo_tpu_torch.ops.quant_gemm import (
    check_weight,
    is_quantized_weight,
    mm_ref,
    quant_matmul,
    quant_matmul_ref,
)

KvDict = Dict[str, torch.Tensor]

# the per-step streamed bulk (the reference's list): every matrix of the
# attention and the FFN, the experts, and the vocab matrices
DEFAULT_QUANT_NAMES = (
    "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
    "we_gate", "we_up", "we_down", "ws_gate", "ws_up", "ws_down",
    "embed", "lm_head",
)
QUANT_MODES = ("int8", "fp8")
# each mode's code type and the largest code the scale maps amax to
CODE_DTYPES = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}
CODE_MAX = {"int8": 127.0, "fp8": 448.0}


def _reciprocal(x: float, device) -> torch.Tensor:
    """1 / x rounded to f32, on `device`: a tensor operand, so that the
    product is the f32 one on every device (a Python scalar would be
    taken in double precision on some). Filled on the device: a copy from
    the host would wait for the device at every KV write."""
    return torch.full((), 1.0 / x, dtype=torch.float32, device=device)


def _quantize(w: torch.Tensor, mode: str, dim: int) -> Dict[str, torch.Tensor]:
    if mode not in QUANT_MODES:
        raise ValueError(f"unknown quantize mode {mode!r}; one of {QUANT_MODES}")
    wf = w.float()
    amax = wf.abs().amax(dim, keepdim=True).clamp(min=1e-8)
    s = amax * _reciprocal(CODE_MAX[mode], w.device)
    scaled = wf / s
    if mode == "fp8":
        return {"q": scaled.to(torch.float8_e4m3fn), "s": s}
    return {"q": torch.round(scaled).clamp(-127, 127).to(torch.int8), "s": s}


def quantize_weight(w: torch.Tensor, mode: str = "int8") -> Dict[str, torch.Tensor]:
    """Per-output-channel symmetric quantization: w [..., in, out] ->
    {"q" [..., in, out], "s" f32 [..., 1, out]}. The caller's tensor is
    left as it is."""
    return _quantize(w, mode, -2)


def quantize_embed(w: torch.Tensor, mode: str = "int8") -> Dict[str, torch.Tensor]:
    """The [V, E] embedding table with per-row scales [V, 1]; "dt", a
    zero-size leaf, keeps the table's dtype for embed_lookup."""
    out = _quantize(w, mode, -1)
    out["dt"] = torch.zeros((0,), dtype=w.dtype, device=w.device)
    return out


def dequantize_weight(w: Dict[str, torch.Tensor], dtype=torch.bfloat16) -> torch.Tensor:
    """q * s in f32, then `dtype`."""
    return (w["q"].float() * w["s"]).to(dtype)


def mm(x: torch.Tensor, w: Any, impl: str = "kernel") -> torch.Tensor:
    """x @ w for a plain or a quantized weight [..., in, out]."""
    if impl == "ref" or not is_quantized_weight(w):
        return mm_ref(x, w)
    return quant_matmul(x, w["q"], w["s"])


def embed_lookup(embed: Any, tokens: torch.Tensor) -> torch.Tensor:
    """The token embeddings [..., E] of a plain or row-quantized table, in
    the table's dtype ("dt")."""
    idx = tokens.long()
    if not is_quantized_weight(embed):
        return embed[idx]
    dt = embed["dt"].dtype
    return embed["q"][idx].to(dt) * embed["s"][idx].to(dt)


def tied_logits(h: torch.Tensor, embed: Any, impl: str = "kernel") -> torch.Tensor:
    """h @ embed^T for a plain or row-quantized table (the tied head)."""
    if not is_quantized_weight(embed):
        return h @ embed.T
    if impl == "ref":
        return quant_matmul_ref(h, embed["q"], embed["s"], nk=True)
    return quant_matmul(h, embed["q"], embed["s"], nk=True)


def quantized_bytes(shape, mode: str, embed: bool = False) -> int:
    """Bytes of a quantized leaf of `shape`: one-byte codes and the f32
    scales (a column's [..., 1, out], or a row's [V, 1] for the table)."""
    codes = math.prod(shape)
    scales = shape[0] if embed else math.prod(shape[:-2]) * shape[-1]
    return codes + 4 * scales


def quantize_params(params: Dict[str, Any], mode: str = "int8") -> Dict[str, Any]:
    """A new tree with the leaves of DEFAULT_QUANT_NAMES quantized (the
    embedding per row); the rest, and the caller's tree, are left as they
    are."""
    out = dict(params)
    for stack in ("layers", "layers_dense"):
        if stack in params:
            out[stack] = {name: quantize_weight(w, mode)
                          if name in DEFAULT_QUANT_NAMES and not is_quantized_weight(w)
                          else w for name, w in params[stack].items()}
    if not is_quantized_weight(out["embed"]):
        out["embed"] = quantize_embed(out["embed"], mode)
    if out.get("lm_head") is not None and not is_quantized_weight(out["lm_head"]):
        out["lm_head"] = quantize_weight(out["lm_head"], mode)
    check_tree(out)
    return out


def check_tree(params: Dict[str, Any]) -> None:
    """Raise unless the kernels take every quantized leaf of the tree that
    lies off the CPU (ops/quant_gemm.py `check_weight`): the matrices in
    the KN layout, the embedding in the NK one where it is the tied head
    (an untied table is only gathered). CPU leaves run the plain versions
    and are not held to the kernels' shapes."""
    leaves = [w for stack in ("layers", "layers_dense")
              for w in params.get(stack, {}).values()]
    leaves.append(params.get("lm_head"))
    for w in leaves:
        if is_quantized_weight(w) and w["q"].device.type != "cpu":
            check_weight(w["q"], w["s"])
    embed = params["embed"]
    if (params.get("lm_head") is None and is_quantized_weight(embed)
            and embed["q"].device.type != "cpu"):
        check_weight(embed["q"], embed["s"], nk=True)


# -- the KV cache ------------------------------------------------------------


def kv_quantize(x: torch.Tensor) -> KvDict:
    """[..., D] -> {"q": int8 [..., D], "s": f32 [...]}."""
    xf = x.float()
    amax = xf.abs().amax(-1).clamp(min=1e-8)
    s = amax * _reciprocal(127.0, x.device)
    q = torch.round(xf / s[..., None]).clamp(-127, 127).to(torch.int8)
    return {"q": q, "s": s}


def kv_dequantize(d: KvDict, dtype=torch.bfloat16) -> torch.Tensor:
    """{"q", "s"} -> dense [..., D] in `dtype` (the product in f32)."""
    return (d["q"].float() * d["s"][..., None]).to(dtype)


def kv_pool_quantize(pool: torch.Tensor) -> KvDict:
    """A dense token-major pool [..., NP, PS, Hk, D] in the pool
    convention: the scales align with "q" minus the vector dim, so this is
    kv_quantize under the name pool-building callers use."""
    return kv_quantize(pool)


def kv_pool_dequantize(pool: KvDict, dtype=torch.bfloat16) -> torch.Tensor:
    """Inverse of kv_pool_quantize: pool dict -> dense [..., NP, PS, Hk, D]."""
    return kv_dequantize(pool, dtype)
