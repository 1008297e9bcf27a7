"""The int8 tier codec for KV blocks demoted below the device (G2/G3/G4).

Port of dynamo_tpu/kvbm/quant.py, on CPU tensors. A block quantizes once
when it leaves the device tier, and the int8 + scales pair is what host
memory, G3 files and G4 objects store: a bf16 [..., D] vector of 2 D
bytes becomes D + 4 (132 against 256 bytes at D 128), about 1.94x the
blocks for the same byte budget. Promotion dequantizes back to the pool
dtype, or, when the device pools are themselves int8 (`kv_quantize`),
passes q and s through with no second rounding.

A quantized block is the dict {"q": int8 [L, PS, Hk, D], "s": float32
[L, PS, Hk], "dt": "<dense dtype name>"}; "dt" is the reference's numpy
name ("bfloat16", "float32", "float16"), so the files and objects of the
two packages are the same bytes.

The scale is a true f32 division, max(amax, 1e-8) / 127, as the
reference's numpy computes it. The device pool quantizer
(models/quant.py `kv_quantize`) multiplies by the f32 reciprocal of 127
instead, as XLA compiles the reference's jitted version: the two give
the same codes and, for some vectors, scales one ulp apart. Both are the
reference's; neither is folded into the other. On the CPU, `t / 127.0`
divides truly (a CUDA tensor over a Python scalar would multiply by the
reciprocal), so the codec runs on the host.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

# dense element types by the reference's numpy names
DTYPE_NAMES = {torch.bfloat16: "bfloat16", torch.float16: "float16",
               torch.float32: "float32"}
_BY_NAME = {name: dt for dt, name in DTYPE_NAMES.items()}


def dtype_of(name: str) -> torch.dtype:
    """The torch dtype of a numpy dtype name ("bfloat16", "float32")."""
    dt = _BY_NAME.get(str(name))
    if dt is None:
        raise ValueError(f"KV dtype {name!r} has no torch type")
    return dt


def is_quantized_block(x: Any) -> bool:
    """True for a tier-codec quantized block (a dict with q/s leaves)."""
    return isinstance(x, dict) and "q" in x and "s" in x


def quantize_block(x: torch.Tensor) -> Dict[str, Any]:
    """Dense [..., D] -> {"q": int8 [..., D], "s": f32 [...], "dt": str}.

    amax over the head dim in f32, s = max(amax, 1e-8) / 127 (a true
    division), q = clip(round(x / s), -127, 127), rounding half to even:
    bit for bit the reference's numpy."""
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=-1)
    s = torch.clamp(amax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(xf / s[..., None]), -127, 127).to(torch.int8)
    return {"q": q, "s": s, "dt": DTYPE_NAMES[x.dtype]}


def dequantize_block(d: Dict[str, Any], dtype: Optional[Any] = None) -> torch.Tensor:
    """Inverse of quantize_block: dense [..., D] in the recorded dtype (or
    `dtype`, a torch dtype or a numpy name): q * s in f32, then one cast."""
    if dtype is None:
        dtype = d.get("dt", "float32")
    if not isinstance(dtype, torch.dtype):
        dtype = dtype_of(dtype)
    return (d["q"].to(torch.float32) * d["s"][..., None]).to(dtype)


def maybe_quantize(x: Optional[Any]) -> Optional[Any]:
    """Quantize a dense block; None and already-quantized dicts pass
    (a block demoted again down the ladder is not quantized twice)."""
    if x is None or is_quantized_block(x):
        return x
    return quantize_block(x)


def maybe_dequantize(x: Optional[Any], dtype: Optional[Any] = None) -> Optional[Any]:
    """Densify a tier block: quantized dicts dequantize, dense blocks and
    None pass through."""
    if is_quantized_block(x):
        return dequantize_block(x, dtype)
    return x


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def block_nbytes(x: Optional[Any]) -> int:
    """Stored bytes of a tier block: codes + scales when quantized, the
    dense bytes otherwise, 0 for None."""
    if x is None:
        return 0
    if is_quantized_block(x):
        return _nbytes(x["q"]) + _nbytes(x["s"])
    return _nbytes(x)


def quantized_ratio(head_dim: int, itemsize: int = 2) -> float:
    """Stored-bytes ratio quantized / dense: (D + 4) / (D * itemsize)."""
    return (head_dim + 4.0) / (head_dim * float(itemsize))


def roundtrip_error_bound(x: torch.Tensor) -> float:
    """The most the symmetric int8 fold can move this data: half a step
    of the largest scale."""
    amax = x.to(torch.float32).abs().amax(dim=-1)
    s = torch.clamp(amax, min=1e-8) / 127.0
    return float(s.max()) * 0.5


def pair_nbytes(k: Optional[Any], v: Optional[Any]) -> int:
    return block_nbytes(k) + block_nbytes(v)


def stacked_to_blocks(
    k: Optional[torch.Tensor], v: Optional[torch.Tensor], i: int
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Block i of stacked [L, n, PS, Hk, D] pages (page axis 1),
    contiguous (copied unless it is already, as numpy's
    ascontiguousarray): the unit every tier stores."""
    kb = k[:, i].contiguous() if k is not None else None
    vb = v[:, i].contiguous() if v is not None else None
    return kb, vb
