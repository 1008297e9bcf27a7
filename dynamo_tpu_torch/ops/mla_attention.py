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
it. Decode also takes the int8 latent pool {"q": int8 [NP, PS, 1, Dl],
"s": f32 [NP, PS, 1]} (`_mla_kernel_int8`): the one per-token scale folds
into the scores and, after the denominator, into p. As in the reference
there is no int8 prefill kernel (models/mla.py gathers instead). The
`*_sharded` wrappers are not ported.

The decode kernel splits each row's context into MLA_SPLIT_TOKENS-long
pieces and merges them by log-sum-exp; `decode_mla_split_partials_ref`
is that first pass in plain PyTorch (ops/paged_attention.py
`split_partials_ref`), merged by `merge_split_partials_ref`. The prefill
kernel's blocks and tiles, in the same way, are `prefill_mla_tiles_ref`.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from dynamo_tpu_torch.models.toolkit import is_quantized, pool_values
from dynamo_tpu_torch.ops import _build
from dynamo_tpu_torch.ops.flash_prefill import prefill_paged_attention_ref
from dynamo_tpu_torch.ops.paged_attention import (
    decode_paged_attention_ref,
    decode_split_count,
    gather_context,
    ptr_or_null,
    split_partials_ref,
)

# the (d_c, d_rh) the kernels take: every DeepSeek V2/V3/R1 model's
KERNEL_DIMS = (512, 64)
# H must be a multiple of it (prefill blocks own 16 heads, decode blocks 64
# or what is left of H)
HEADS_PER_BLOCK = 16
# query tokens a prefill block owns, each with its HEADS_PER_BLOCK heads
PREFILL_BLOCK_TOKENS = 4
# context tokens a tile of both kernels
TILE_TOKENS = 32
# context tokens one decode block walks: a multiple of TILE_TOKENS
MLA_SPLIT_TOKENS = 192


def decode_mla_attention_ref(q, lat_pool_l, page_table, kv_lens, *, dc: int,
                             scale: float) -> torch.Tensor:
    """Plain version: q [B, H, Dl] at position kv_lens[b] - 1 over
    positions [0, kv_lens[b]). Rows with kv_len 0 come out 0. Like the TPU
    kernel it computes in f32 from the inputs' values and rounds only the
    result: at Dl 576 a bf16 rounding of the raw scores alone moves the
    output by a few hundredths. An int8 latent pool keeps its codes and
    folds its scales (toolkit.paged_attention_int8_ref); the values are
    the codes' first dc columns with the same scale."""
    if is_quantized(lat_pool_l):
        lat, val = lat_pool_l, {"q": lat_pool_l["q"][..., :dc],
                                "s": lat_pool_l["s"]}
    else:
        lat = lat_pool_l.float()
        val = lat[..., :dc]
    return decode_paged_attention_ref(q[:, None].float(), lat, val,
                                      page_table, kv_lens, scale)[:, 0].to(q.dtype)


def decode_mla_split_partials_ref(q, lat_pool_l, page_table, kv_lens, *,
                                  dc: int, scale: float,
                                  split: int = MLA_SPLIT_TOKENS
                                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The decode kernel's partials in plain f32: (m [NS, B, H],
    l [NS, B, H], o [NS, B, H, dc]) over the splits of each row's positions
    [0, kv_lens[b]); an int8 pool's scale multiplies the scores and, after
    l, p."""
    lat, ls = gather_context(lat_pool_l, page_table.long())
    lat = lat[:, :, 0]  # [B, C, Dl]
    C = lat.shape[1]
    s = torch.einsum("bhd,bcd->bhc", q.float(), lat) * scale
    v_scale = None
    if ls is not None:
        v_scale = ls[:, None, :, 0]  # [B, 1, C]
        s = s * v_scale
    seen = (torch.arange(C, device=q.device)[None, :] < kv_lens[:, None])[:, None, :]
    return split_partials_ref(s, seen, lat[..., :dc], split, v_scale)


def prefill_mla_attention_ref(q, lat_pool_l, page_table, q_start, q_len,
                              kv_lens, *, dc: int, scale: float) -> torch.Tensor:
    """Plain version: q [B, S, H, Dl]; query token s of row b at position
    q_start[b] + s for s < q_len[b]. Padding rows come out 0. In f32, as
    the decode version."""
    lat = lat_pool_l.float()
    return prefill_paged_attention_ref(q[:, :, None].float(), lat,
                                       lat[..., :dc], page_table, q_start,
                                       q_len, kv_lens, scale)[:, :, 0].to(q.dtype)


def prefill_mla_tiles_ref(q, lat_pool_l, page_table, q_start, q_len,
                          kv_lens, *, dc: int, scale: float,
                          round_p: bool = True
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The prefill kernel's arithmetic in plain f32: blocks of
    PREFILL_BLOCK_TOKENS tokens x HEADS_PER_BLOCK heads walk TILE_TOKENS-wide
    tiles [0, ceil((last + 1) / TILE_TOKENS)), `last` the largest causal
    limit min(q_start + s, kv_len - 1) of the block's valid tokens, with an
    online softmax in base-2 units (running max from -1e30, masked scores
    -inf); with round_p, P is rounded to bf16 before the value product (the
    row sums keep it in f32). Returns (out [B, S, H, dc] in q's dtype,
    padding rows 0; tiles [B, ceil(S / PREFILL_BLOCK_TOKENS), H /
    HEADS_PER_BLOCK], the tiles each block walked, 0 for a block with no
    valid token)."""
    B, S, H, Dl = q.shape
    PS, MP = lat_pool_l.shape[1], page_table.shape[1]
    n_sb = -(-S // PREFILL_BLOCK_TOKENS)
    Sp = n_sb * PREFILL_BLOCK_TOKENS
    s_idx = torch.arange(Sp, device=q.device)
    kvl = kv_lens.long().clamp(max=MP * PS)
    # the last position each query token sees; -1: padding, or no context
    vis = torch.where(s_idx[None] < q_len[:, None],
                      torch.minimum(q_start[:, None].long() + s_idx[None],
                                    kvl[:, None] - 1), -1)
    last = vis.reshape(B, n_sb, PREFILL_BLOCK_TOKENS).amax(-1)
    tiles = torch.where(last >= 0, last // TILE_TOKENS + 1, 0)
    n_tiles = int(tiles.max()) if B else 0
    C = n_tiles * TILE_TOKENS
    lat = lat_pool_l[page_table.long()].reshape(B, MP * PS, Dl).float()
    lat = torch.nn.functional.pad(lat[:, :C], (0, 0, 0, max(C - MP * PS, 0)))
    qf = torch.nn.functional.pad(q.float(), (0, 0, 0, 0, 0, Sp - S))
    scale_log2 = scale * math.log2(math.e)
    m = torch.full((B, Sp, H), -1e30, device=q.device)
    l = torch.zeros((B, Sp, H), device=q.device)
    o = torch.zeros((B, Sp, H, dc), device=q.device)
    for t in range(n_tiles):
        c = t * TILE_TOKENS + torch.arange(TILE_TOKENS, device=q.device)
        lt = lat[:, t * TILE_TOKENS:(t + 1) * TILE_TOKENS]
        s = torch.einsum("bshd,bcd->bshc", qf, lt) * scale_log2
        seen = (c[None, None, :] <= vis[:, :, None])[:, :, None, :]
        s = s.masked_fill(~seen, float("-inf"))
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        if round_p:
            p = p.bfloat16().float()
        o = o * alpha[..., None] + torch.einsum("bshc,bcd->bshd", p, lt[..., :dc])
        m = m_new
    out = o / l.clamp(min=1e-30)[..., None]
    out = torch.where((vis >= 0)[:, :, None, None], out, 0.0)[:, :S]
    return (out.to(q.dtype),
            tiles[:, :, None].expand(B, n_sb, H // HEADS_PER_BLOCK))


def _check(q, lat_pool_l, ints, dc: int) -> int:
    """Operands the kernels take (`ints`: the page table, then the [B]
    int32 arrays; the pool bf16, or the int8 dict {"q", "s"} with 16-byte
    aligned codes); returns d_rh."""
    Dl = q.shape[-1]
    dr = Dl - dc
    lat = pool_values(lat_pool_l)
    if lat.dim() != 4 or lat.shape[2] != 1 or lat.shape[3] != Dl:
        raise ValueError(f"latent pool {tuple(lat.shape)} does not "
                         f"match q {tuple(q.shape)}")
    if (dc, dr) != KERNEL_DIMS or q.shape[-2] % HEADS_PER_BLOCK:
        raise ValueError(f"no MLA kernel for d_c={dc}, d_rh={dr}, "
                         f"H={q.shape[-2]} (takes {KERNEL_DIMS}, H a "
                         f"multiple of {HEADS_PER_BLOCK})")
    if q.dtype != torch.bfloat16:
        raise TypeError(f"the MLA kernels take a bf16 q, not {q.dtype}")
    if is_quantized(lat_pool_l):
        sc = lat_pool_l["s"]
        if lat.dtype != torch.int8 or sc.dtype != torch.float32:
            raise TypeError(f"the int8 latent pool takes int8 'q' and f32 "
                            f"'s', not {lat.dtype} and {sc.dtype}")
        if tuple(sc.shape) != tuple(lat.shape[:3]):
            raise ValueError(f"int8 latent pool 's' {tuple(sc.shape)} does "
                             f"not match its 'q' {tuple(lat.shape)}")
        if not sc.is_contiguous() or sc.device != q.device:
            raise ValueError("the int8 latent pool's 's' must be contiguous "
                             "and on q's device")
        if lat.data_ptr() % 16 or sc.data_ptr() % 4:
            raise ValueError("int8 latent pool 'q' must be 16-byte aligned "
                             "and its 's' 4-byte aligned")
    elif lat.dtype != torch.bfloat16:
        raise TypeError(f"the MLA kernels take a bf16 latent pool, not "
                        f"{lat.dtype}")
    if any(t.dtype != torch.int32 for t in ints):
        raise TypeError("page tables, positions and lengths must be int32")
    B = q.shape[0]
    if ints[0].dim() != 2 or ints[0].shape[0] != B \
            or any(tuple(t.shape) != (B,) for t in ints[1:]):
        raise ValueError(f"page table {tuple(ints[0].shape)} and lengths "
                         f"{[tuple(t.shape) for t in ints[1:]]} do not match "
                         f"the batch of {B}")
    tensors = (q, lat) + tuple(ints)
    if any(t.device != q.device for t in tensors):
        raise ValueError("all operands must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the MLA kernels take contiguous operands")
    return dr


def decode_mla_attention(
    q: torch.Tensor,  # [B, H, Dl] absorbed + rope queries
    lat_pool_l,  # [NP, PS, 1, Dl] one layer's latent pool, or its int8 dict
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
    lat = pool_values(lat_pool_l)
    scales = lat_pool_l["s"] if is_quantized(lat_pool_l) else None
    # every row is written by its one block or by the merge
    out = q.new_empty((B, H, dc))
    PS, MP = lat.shape[1], page_table.shape[1]
    part = torch.empty((decode_split_count(MP, PS, MLA_SPLIT_TOKENS), B, H,
                        dc + 4), dtype=torch.float32, device=q.device)
    lib = _build.load()["mla_attention"]
    rc = lib.decode_mla_attention(
        q.data_ptr(), lat.data_ptr(), ptr_or_null(scales),
        page_table.data_ptr(), kv_lens.data_ptr(), out.data_ptr(),
        part.data_ptr(), B, H, dc, dr, PS, MP, MLA_SPLIT_TOKENS, float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, rc, "decode_mla_attention")
    decode_mla_attention.launches += 1
    key = "int8" if scales is not None else "bf16"
    decode_mla_attention.bodies[key] = decode_mla_attention.bodies.get(key, 0) + 1
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
    The chunk's own latents must already be in the pool. The pool is bf16:
    as in the reference, int8 latents take the gather path instead
    (models/mla.py)."""
    if is_quantized(lat_pool_l):
        raise TypeError("the MLA prefill kernel takes a bf16 latent pool; "
                        "int8 latent prefill gathers (models/mla.py)")
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
decode_mla_attention.bodies = {}  # launches by latent type: "bf16", "int8"
prefill_mla_attention.launches = 0
