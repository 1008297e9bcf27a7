"""Decode paged attention: one query token per sequence attends over that
sequence's pages of a token-major KV pool.

Port of dynamo_tpu/ops/paged_attention.py `decode_paged_attention` (plain
bf16 variant). On CUDA tensors the wrapper launches the hand-written
Hopper kernel in csrc/paged_attention.cu; on CPU tensors it runs the plain
PyTorch version below, which is also what the kernel is held against.
"""

from __future__ import annotations

from typing import Optional

import torch

from dynamo_tpu_torch.models.toolkit import paged_attention_ref
from dynamo_tpu_torch.ops import _build


def decode_paged_attention_ref(
    q: torch.Tensor, k_pool_l: torch.Tensor, v_pool_l: torch.Tensor,
    page_table: torch.Tensor, kv_lens: torch.Tensor,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain version: the query of row b sits at position kv_lens[b] - 1
    and sees positions [0, kv_lens[b]). Rows with kv_len 0 come out 0."""
    q_pos = (kv_lens.long() - 1).clamp(min=0)[:, None]
    return paged_attention_ref(
        q[:, None], k_pool_l, v_pool_l, page_table, q_pos, kv_lens, scale,
    )[:, 0]


def decode_paged_attention(
    q: torch.Tensor,  # [B, Hk, G, D]
    k_pool_l: torch.Tensor,  # [NP, PS, Hk, D] one layer's token-major pool
    v_pool_l: torch.Tensor,
    page_table: torch.Tensor,  # [B, MP] int32
    kv_lens: torch.Tensor,  # [B] int32, context length incl. this token
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Returns [B, Hk, G, D]. The current token's KV must already be in
    the pool. Table entries past kv_len are never read."""
    B, Hk, G, D = q.shape
    if scale is None:
        scale = D ** -0.5
    if q.device.type == "cpu":
        return decode_paged_attention_ref(
            q, k_pool_l, v_pool_l, page_table, kv_lens, scale)
    NP, PS, Hk2, D2 = k_pool_l.shape
    if (Hk2, D2) != (Hk, D) or v_pool_l.shape != k_pool_l.shape:
        raise ValueError(f"pool {tuple(k_pool_l.shape)} does not match q {tuple(q.shape)}")
    if q.dtype != torch.bfloat16 or k_pool_l.dtype != torch.bfloat16 \
            or v_pool_l.dtype != torch.bfloat16:
        raise TypeError("the decode kernel takes bf16 q and pools")
    if page_table.dtype != torch.int32 or kv_lens.dtype != torch.int32:
        raise TypeError("page_table and kv_lens must be int32")
    if D not in (64, 128) or G not in (1, 2, 3, 4, 8):
        raise ValueError(f"no decode kernel for D={D}, G={G}")
    tensors = (q, k_pool_l, v_pool_l, page_table, kv_lens)
    if any(t.device != q.device for t in tensors):
        raise ValueError("all operands must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the decode kernel takes contiguous operands")
    out = torch.empty_like(q)
    lib = _build.load()["paged_attention"]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.decode_paged_attention(
        q.data_ptr(), k_pool_l.data_ptr(), v_pool_l.data_ptr(),
        page_table.data_ptr(), kv_lens.data_ptr(), out.data_ptr(),
        B, Hk, G, D, PS, page_table.shape[1], float(scale), stream,
    )
    _build.check(lib, rc, "decode_paged_attention")
    decode_paged_attention.launches += 1
    return out


decode_paged_attention.launches = 0
