"""Chunked-prefill paged flash attention: an S-token chunk per sequence
attends causally over that sequence's whole paged context (prior prefix
plus the chunk, already written to the pool).

Port of dynamo_tpu/ops/flash_prefill.py `prefill_paged_attention` (plain
bf16 variant). Positions contract, as there: query token s of sequence b
sits at absolute position q_start[b] + s for s < q_len[b], padding after;
flat context index c is absolute position c. On CUDA tensors the wrapper
launches the hand-written Hopper kernel in csrc/flash_prefill.cu; on CPU
tensors it runs the plain PyTorch version below.
"""

from __future__ import annotations

from typing import Optional

import torch

from dynamo_tpu_torch.models.toolkit import paged_attention_ref
from dynamo_tpu_torch.ops import _build

# query rows (token x group) one kernel block holds, 16 per warp over 8
# warps; q_block is the most tokens whose rows fit in it, floor(128 / G)
ROWS_PER_BLOCK = 128


def prefill_paged_attention_ref(
    q: torch.Tensor, k_pool_l: torch.Tensor, v_pool_l: torch.Tensor,
    page_table: torch.Tensor, q_start: torch.Tensor, q_len: torch.Tensor,
    kv_lens: torch.Tensor, scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain version. Padding rows (s >= q_len[b]) come out 0."""
    S = q.shape[1]
    s_idx = torch.arange(S, device=q.device)
    valid = s_idx[None, :] < q_len[:, None]
    pos = torch.where(valid, q_start[:, None].long() + s_idx[None, :], 0)
    out = paged_attention_ref(q, k_pool_l, v_pool_l, page_table, pos,
                              kv_lens, scale)
    return torch.where(valid[:, :, None, None, None], out, 0.0).to(q.dtype)


def q_block_for(G: int) -> int:
    return ROWS_PER_BLOCK // G


def prefill_paged_attention(
    q: torch.Tensor,  # [B, S, Hk, G, D]
    k_pool_l: torch.Tensor,  # [NP, PS, Hk, D] (token-major)
    v_pool_l: torch.Tensor,
    page_table: torch.Tensor,  # [B, MP] int32
    q_start: torch.Tensor,  # [B] int32 absolute position of query token 0
    q_len: torch.Tensor,  # [B] int32 valid query tokens (rest padding)
    kv_lens: torch.Tensor,  # [B] int32 context length incl. this chunk
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Returns [B, S, Hk, G, D]; padding rows return 0. The chunk's own
    K/V must already be written to the pool."""
    B, S, Hk, G, D = q.shape
    if scale is None:
        scale = D ** -0.5
    if q.device.type == "cpu":
        return prefill_paged_attention_ref(
            q, k_pool_l, v_pool_l, page_table, q_start, q_len, kv_lens, scale)
    NP, PS, Hk2, D2 = k_pool_l.shape
    if (Hk2, D2) != (Hk, D) or v_pool_l.shape != k_pool_l.shape:
        raise ValueError(f"pool {tuple(k_pool_l.shape)} does not match q {tuple(q.shape)}")
    if q.dtype != torch.bfloat16 or k_pool_l.dtype != torch.bfloat16 \
            or v_pool_l.dtype != torch.bfloat16:
        raise TypeError("the prefill kernel takes bf16 q and pools")
    ints = (page_table, q_start, q_len, kv_lens)
    if any(t.dtype != torch.int32 for t in ints):
        raise TypeError("page_table, q_start, q_len and kv_lens must be int32")
    if D not in (64, 128) or G > ROWS_PER_BLOCK:
        raise ValueError(f"no prefill kernel for D={D}, G={G}")
    tensors = (q, k_pool_l, v_pool_l) + ints
    if any(t.device != q.device for t in tensors):
        raise ValueError("all operands must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the prefill kernel takes contiguous operands")
    out = torch.empty_like(q)
    lib = _build.load()["flash_prefill"]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.prefill_paged_attention(
        q.data_ptr(), k_pool_l.data_ptr(), v_pool_l.data_ptr(),
        page_table.data_ptr(), q_start.data_ptr(), q_len.data_ptr(),
        kv_lens.data_ptr(), out.data_ptr(),
        B, S, Hk, G, D, PS, page_table.shape[1], q_block_for(G),
        float(scale), stream,
    )
    _build.check(lib, rc, "prefill_paged_attention")
    prefill_paged_attention.launches += 1
    return out


prefill_paged_attention.launches = 0
