"""The int8 tier codec on the device: quantize KV blocks before their
device->host copy, dequantize them after the host->device copy.

Replaces no TPU kernel: the reference runs the codec on the host in numpy
(dynamo_tpu/kvbm/quant.py `quantize_block`, `dequantize_block`). On CUDA
tensors each wrapper launches the hand-written kernel in
csrc/tier_codec.cu; on CPU tensors it runs the plain version,
kvbm/quant.py's codec, which is also what the kernels are held against
bit for bit (the scale a true division by 127, rounding half to even).
A plain version on a CUDA tensor would not do: CUDA divides a tensor by a
Python scalar as a product with its reciprocal.
"""

from __future__ import annotations

from typing import Tuple

import torch

from dynamo_tpu_torch.kvbm.quant import dequantize_block, quantize_block
from dynamo_tpu_torch.ops import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def tier_quantize_ref(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    d = quantize_block(x)
    return d["q"], d["s"]


def tier_dequantize_ref(q: torch.Tensor, s: torch.Tensor,
                        dtype: torch.dtype) -> torch.Tensor:
    return dequantize_block({"q": q, "s": s}, dtype)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def tier_quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [..., D] (f32, bf16 or f16) -> (q int8 [..., D], s f32 [...]):
    s = max(amax, 1e-8) / 127 over each D vector, q = clip(rint(x / s),
    -127, 127)."""
    if x.device.type == "cpu":
        return tier_quantize_ref(x)
    if x.dtype not in _DTYPES:
        raise TypeError(f"no tier quantize kernel for {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("tier_quantize takes a contiguous tensor")
    D = x.shape[-1]
    rows = x.numel() // D if D else 0
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    s = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
    lib = _build.load()["tier_codec"]
    rc = lib.tier_quantize(x.data_ptr(), q.data_ptr(), s.data_ptr(), rows, D,
                           _DTYPES[x.dtype], _stream(x))
    _build.check(lib, rc, "tier_quantize")
    tier_quantize.launches += 1
    return q, s


def tier_dequantize(q: torch.Tensor, s: torch.Tensor,
                    dtype: torch.dtype) -> torch.Tensor:
    """(q int8 [..., D], s f32 [...]) -> f32(q) * s, rounded once to
    `dtype` (f32, bf16 or f16)."""
    if q.device.type == "cpu":
        return tier_dequantize_ref(q, s, dtype)
    if dtype not in _DTYPES:
        raise TypeError(f"no tier dequantize kernel for {dtype}")
    if q.dtype != torch.int8 or s.dtype != torch.float32:
        raise TypeError("tier_dequantize takes int8 codes and f32 scales")
    if tuple(s.shape) != tuple(q.shape[:-1]) or s.device != q.device:
        raise ValueError(f"scales {tuple(s.shape)} do not match codes {tuple(q.shape)}")
    if not (q.is_contiguous() and s.is_contiguous()):
        raise ValueError("tier_dequantize takes contiguous tensors")
    D = q.shape[-1]
    rows = q.numel() // D if D else 0
    out = torch.empty(q.shape, dtype=dtype, device=q.device)
    lib = _build.load()["tier_codec"]
    rc = lib.tier_dequantize(q.data_ptr(), s.data_ptr(), out.data_ptr(), rows, D,
                             _DTYPES[dtype], _stream(q))
    _build.check(lib, rc, "tier_dequantize")
    tier_dequantize.launches += 1
    return out


tier_quantize.launches = 0
tier_dequantize.launches = 0
