"""Chunked-prefill paged flash attention: an S-token chunk per sequence
attends causally over that sequence's whole paged context (prior prefix
plus the chunk, already written to the pool).

Port of dynamo_tpu/ops/flash_prefill.py `prefill_paged_attention`: the
bf16 bodies and the int8 ones (dict pools of models/quant.py,
`_prefill_kernel_int8[_win]`), each plain and Gemma-2's (sliding window,
score soft cap, scale override), at head dims 64, 96, 128 and 256. Positions
contract, as there:
query token s of sequence b sits at absolute position q_start[b] + s for
s < q_len[b], padding after; flat context index c is absolute position c;
with a window w > 0 the query at position p sees only c > p - w. On CUDA
tensors the wrapper launches the hand-written Hopper kernel in
csrc/flash_prefill.cu; on CPU tensors it runs the plain PyTorch version
below.
"""

from __future__ import annotations

from typing import Optional

import torch

from dynamo_tpu_torch.ops import _build
from dynamo_tpu_torch.ops.paged_attention import (
    KERNEL_HEAD_DIMS,
    attention_ref,
    count_launch,
    kv_operands,
    ptr_or_null,
    scale_tensors,
    window_operand,
)

# query rows (token x group) one kernel block holds, 16 per warp over 8
# warps; q_block is the most tokens whose rows fit in it, floor(128 / G)
ROWS_PER_BLOCK = 128


def prefill_paged_attention_ref(
    q: torch.Tensor, k_pool_l: torch.Tensor, v_pool_l: torch.Tensor,
    page_table: torch.Tensor, q_start: torch.Tensor, q_len: torch.Tensor,
    kv_lens: torch.Tensor, scale: Optional[float] = None, *,
    softcap: float = 0.0, window: Optional[int] = None,
) -> torch.Tensor:
    """Plain version (for int8 dict pools, the scale fold of
    toolkit.paged_attention_int8_ref). Padding rows (s >= q_len[b]) come
    out 0."""
    S = q.shape[1]
    s_idx = torch.arange(S, device=q.device)
    valid = s_idx[None, :] < q_len[:, None]
    pos = torch.where(valid, q_start[:, None].long() + s_idx[None, :], 0)
    out = attention_ref(k_pool_l)(q, k_pool_l, v_pool_l, page_table, pos,
                                  kv_lens, scale, softcap=softcap, window=window)
    return torch.where(valid[:, :, None, None, None], out, 0.0).to(q.dtype)


def q_block_for(G: int) -> int:
    return ROWS_PER_BLOCK // G


def prefill_paged_attention(
    q: torch.Tensor,  # [B, S, Hk, G, D]
    k_pool_l,  # [NP, PS, Hk, D] (token-major), or its int8 dict
    v_pool_l,
    page_table: torch.Tensor,  # [B, MP] int32
    q_start: torch.Tensor,  # [B] int32 absolute position of query token 0
    q_len: torch.Tensor,  # [B] int32 valid query tokens (rest padding)
    kv_lens: torch.Tensor,  # [B] int32 context length incl. this chunk
    window: Optional[int] = None,  # sliding window in tokens; 0/None: global
    *,
    scale: Optional[float] = None,  # score scale (default D^-0.5)
    softcap: float = 0.0,  # score soft cap (0 = off)
) -> torch.Tensor:
    """Returns [B, S, Hk, G, D]; padding rows return 0. The chunk's own
    K/V must already be written to the pool. The pools are bf16 or both
    int8 dicts {"q", "s"}."""
    B, S, Hk, G, D = q.shape
    if scale is None:
        scale = D ** -0.5
    window = window_operand(window)
    if q.device.type == "cpu":
        return prefill_paged_attention_ref(
            q, k_pool_l, v_pool_l, page_table, q_start, q_len, kv_lens, scale,
            softcap=softcap, window=window)
    (k, ks, v, vs), int8 = kv_operands(k_pool_l, v_pool_l, Hk, D, "prefill")
    if q.dtype != torch.bfloat16:
        raise TypeError(f"the prefill kernel takes a bf16 q, not {q.dtype}")
    ints = (page_table, q_start, q_len, kv_lens)
    if any(t.dtype != torch.int32 for t in ints):
        raise TypeError("page_table, q_start, q_len and kv_lens must be int32")
    if D not in KERNEL_HEAD_DIMS or G > ROWS_PER_BLOCK:
        raise ValueError(f"no prefill kernel for D={D}, G={G}")
    tensors = (q, k, v) + ints
    if any(t.device != q.device for t in tensors + scale_tensors(ks, vs)):
        raise ValueError("all operands must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the prefill kernel takes contiguous operands")
    out = torch.empty_like(q)
    lib = _build.load()["flash_prefill"]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.prefill_paged_attention(
        q.data_ptr(), k.data_ptr(), ptr_or_null(ks), v.data_ptr(),
        ptr_or_null(vs), page_table.data_ptr(), q_start.data_ptr(),
        q_len.data_ptr(), kv_lens.data_ptr(), out.data_ptr(),
        B, S, Hk, G, D, k.shape[1], page_table.shape[1], q_block_for(G),
        window, float(scale), float(softcap), stream,
    )
    _build.check(lib, rc, "prefill_paged_attention")
    count_launch(prefill_paged_attention, D, window, softcap, int8)
    return out


prefill_paged_attention.launches = 0
prefill_paged_attention.bodies = {}
