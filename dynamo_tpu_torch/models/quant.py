"""int8 KV-cache quantization: one symmetric f32 scale per cached (token,
head) vector, reduced over the head dim.

Port of the KV half of dynamo_tpu/models/quant.py (`kv_quantize`,
`kv_dequantize`, `kv_pool_quantize`, `kv_pool_dequantize`), with its
arithmetic: the amax over D in f32, s = max(amax, 1e-8) / 127, q =
clamp(round(x / s), -127, 127) (a division, not a product with 1 / s;
torch.round rounds half to even, as jnp.round does). A quantized pool is
the reference's dict {"q": int8 [L, NP, PS, Hk, D], "s": f32
[L, NP, PS, Hk]}: D + 4 bytes a vector against 2 D in bf16, so decode's
KV stream shrinks to 0.52x at D 128. The attention kernels fold the
scales into the scores (K) and the probabilities (V); pages cross the
transfer boundary dequantized (engine/model_runner.py). The weight-only
int8/fp8 path of the reference's module is not ported.
"""

from __future__ import annotations

from typing import Dict

import torch

KvDict = Dict[str, torch.Tensor]


def kv_quantize(x: torch.Tensor) -> KvDict:
    """[..., D] -> {"q": int8 [..., D], "s": f32 [...]}."""
    xf = x.float()
    amax = xf.abs().amax(-1).clamp(min=1e-8)
    # a divisor on x's device: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, an ulp off the division now and then
    s = amax / amax.new_full((), 127.0)
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
