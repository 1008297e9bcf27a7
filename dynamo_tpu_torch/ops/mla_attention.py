"""Multi-head latent attention (MLA, DeepSeek V2/V3/R1) over a paged latent
cache: decode (one query token per sequence) and chunked prefill.

Port of dynamo_tpu/ops/mla_attention.py `decode_mla_attention` and
`prefill_mla_attention` (plain bf16 variant). Queries come absorbed,
q = [q_nope @ W_UK ; q_rope] per head ([.., H, d_c + d_rh]); the pool holds
one latent per token ([NP, PS, 1, d_c + d_rh]); scores are q . latent *
scale and values are the latent's first d_c columns, so the plain versions
are the gather attention with K = latent and V = latent[..., :d_c]. The
result is the attended latent [.., H, d_c], which the caller lifts through
W_UV. On CUDA tensors each wrapper launches the hand-written Hopper kernel
in csrc/mla_attention.cu; on CPU tensors it runs the plain version beside
it. The int8 latent pool and the `*_sharded` wrappers are not ported.
"""

from __future__ import annotations

import torch

from dynamo_tpu_torch.ops import _build
from dynamo_tpu_torch.ops.flash_prefill import prefill_paged_attention_ref
from dynamo_tpu_torch.ops.paged_attention import decode_paged_attention_ref

# the (d_c, d_rh) the kernels take: every DeepSeek V2/V3/R1 model's
KERNEL_DIMS = (512, 64)
HEADS_PER_BLOCK = 16  # H must be a multiple of it (prefill 16, decode 8)


def decode_mla_attention_ref(q, lat_pool_l, page_table, kv_lens, *, dc: int,
                             scale: float) -> torch.Tensor:
    """Plain version: q [B, H, Dl] at position kv_lens[b] - 1 over
    positions [0, kv_lens[b]). Rows with kv_len 0 come out 0. Like the TPU
    kernel it computes in f32 from the inputs' values and rounds only the
    result: at Dl 576 a bf16 rounding of the raw scores alone moves the
    output by a few hundredths."""
    lat = lat_pool_l.float()
    return decode_paged_attention_ref(q[:, None].float(), lat, lat[..., :dc],
                                      page_table, kv_lens, scale)[:, 0].to(q.dtype)


def prefill_mla_attention_ref(q, lat_pool_l, page_table, q_start, q_len,
                              kv_lens, *, dc: int, scale: float) -> torch.Tensor:
    """Plain version: q [B, S, H, Dl]; query token s of row b at position
    q_start[b] + s for s < q_len[b]. Padding rows come out 0. In f32, as
    the decode version."""
    lat = lat_pool_l.float()
    return prefill_paged_attention_ref(q[:, :, None].float(), lat,
                                       lat[..., :dc], page_table, q_start,
                                       q_len, kv_lens, scale)[:, :, 0].to(q.dtype)


def _check(q, lat_pool_l, ints, dc: int) -> int:
    """Operands the kernels take (`ints`: the page table, then the [B]
    int32 arrays); returns d_rh."""
    Dl = q.shape[-1]
    dr = Dl - dc
    if lat_pool_l.dim() != 4 or lat_pool_l.shape[2] != 1 \
            or lat_pool_l.shape[3] != Dl:
        raise ValueError(f"latent pool {tuple(lat_pool_l.shape)} does not "
                         f"match q {tuple(q.shape)}")
    if (dc, dr) != KERNEL_DIMS or q.shape[-2] % HEADS_PER_BLOCK:
        raise ValueError(f"no MLA kernel for d_c={dc}, d_rh={dr}, "
                         f"H={q.shape[-2]} (takes {KERNEL_DIMS}, H a "
                         f"multiple of {HEADS_PER_BLOCK})")
    if q.dtype != torch.bfloat16 or lat_pool_l.dtype != torch.bfloat16:
        raise TypeError("the MLA kernels take bf16 q and latent pool")
    if any(t.dtype != torch.int32 for t in ints):
        raise TypeError("page tables, positions and lengths must be int32")
    B = q.shape[0]
    if ints[0].dim() != 2 or ints[0].shape[0] != B \
            or any(tuple(t.shape) != (B,) for t in ints[1:]):
        raise ValueError(f"page table {tuple(ints[0].shape)} and lengths "
                         f"{[tuple(t.shape) for t in ints[1:]]} do not match "
                         f"the batch of {B}")
    tensors = (q, lat_pool_l) + tuple(ints)
    if any(t.device != q.device for t in tensors):
        raise ValueError("all operands must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the MLA kernels take contiguous operands")
    return dr


def decode_mla_attention(
    q: torch.Tensor,  # [B, H, Dl] absorbed + rope queries
    lat_pool_l: torch.Tensor,  # [NP, PS, 1, Dl] one layer's latent pool
    page_table: torch.Tensor,  # [B, MP] int32
    kv_lens: torch.Tensor,  # [B] int32, context incl. the current token
    *,
    dc: int,  # value width = kv_lora_rank
    scale: float,  # score scale (attn_score_scale)
) -> torch.Tensor:
    """Returns the attended latents [B, H, dc]. The current token's latent
    must already be in the pool. Table entries past kv_len are never read."""
    if q.device.type == "cpu":
        return decode_mla_attention_ref(q, lat_pool_l, page_table, kv_lens,
                                        dc=dc, scale=scale)
    B, H, _ = q.shape
    dr = _check(q, lat_pool_l, (page_table, kv_lens), dc)
    out = q.new_empty((B, H, dc))
    lib = _build.load()["mla_attention"]
    rc = lib.decode_mla_attention(
        q.data_ptr(), lat_pool_l.data_ptr(), page_table.data_ptr(),
        kv_lens.data_ptr(), out.data_ptr(), B, H, dc, dr,
        lat_pool_l.shape[1], page_table.shape[1], float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, rc, "decode_mla_attention")
    decode_mla_attention.launches += 1
    return out


def prefill_mla_attention(
    q: torch.Tensor,  # [B, S, H, Dl] absorbed + rope queries (chunk)
    lat_pool_l: torch.Tensor,  # [NP, PS, 1, Dl]
    page_table: torch.Tensor,  # [B, MP] int32
    q_start: torch.Tensor,  # [B] int32 absolute position of query token 0
    q_len: torch.Tensor,  # [B] int32 valid query tokens (rest padding)
    kv_lens: torch.Tensor,  # [B] int32 context incl. this chunk
    *,
    dc: int,
    scale: float,
) -> torch.Tensor:
    """Returns the attended latents [B, S, H, dc]; padding rows return 0.
    The chunk's own latents must already be in the pool."""
    if q.device.type == "cpu":
        return prefill_mla_attention_ref(q, lat_pool_l, page_table, q_start,
                                         q_len, kv_lens, dc=dc, scale=scale)
    B, S, H, _ = q.shape
    dr = _check(q, lat_pool_l, (page_table, q_start, q_len, kv_lens), dc)
    out = q.new_empty((B, S, H, dc))
    lib = _build.load()["mla_attention"]
    rc = lib.prefill_mla_attention(
        q.data_ptr(), lat_pool_l.data_ptr(), page_table.data_ptr(),
        q_start.data_ptr(), q_len.data_ptr(), kv_lens.data_ptr(),
        out.data_ptr(), B, S, H, dc, dr, lat_pool_l.shape[1],
        page_table.shape[1], float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, rc, "prefill_mla_attention")
    prefill_mla_attention.launches += 1
    return out


decode_mla_attention.launches = 0
prefill_mla_attention.launches = 0
