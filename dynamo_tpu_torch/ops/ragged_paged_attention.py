"""Ragged paged attention: one flat token axis of decode rows, prefill
chunks and speculative-verify rows, each segment over its own pages.

Port of dynamo_tpu/ops/ragged_paged_attention.py: the bf16 bodies and
the int8 ones (dict pools of models/quant.py, `_ragged_kernel_int8[_win]`),
each plain and Gemma-2's (sliding window, score soft cap, scale override;
each flat token at position p sees c > p - w under a window w > 0), at
head dims 64, 96, 128 and 256.
The host metadata helpers (`ragged_seg_cap`, `ragged_work_cap`,
`build_ragged_metadata`) are copies of the reference's numpy code: the
flat [T] axis is cut into q_block-token blocks, and every (block, segment)
overlap is one work unit of `meta [5, NW]`

    0 seg    segment row into seg_page_table / seg_kv_lens
    1 qblk   flat q block index
    2 rs     first row of this unit within the block
    3 rows   row count (0 = padding unit, a no-op)
    4 qpos0  absolute position of row rs

with the tail [sum(q_lens), T) covered by a dummy segment of kv_len 0,
whose rows come out 0. On CUDA tensors the wrapper launches the
hand-written Hopper kernel in csrc/ragged_paged_attention.cu; on CPU
tensors it runs the plain PyTorch version below, the counterpart of the
reference's `ragged_attention_reference`: every flat token is a B=T, S=1
row of `paged_attention_ref`.

The kernel splits each unit's context into SPLIT_TOKENS-long pieces, one
block each, and merges a long unit's pieces by log-sum-exp;
`ragged_split_partials_ref` is that arithmetic in plain PyTorch (on
ops/paged_attention.py's `split_partials_ref` and
`merge_split_partials_ref`, shared by every split-context kernel), and
`split_scratch_shape` the kernel's f32 scratch for it.
`ragged_paged_attention_sharded` is one tensor-parallel rank's call on
its own KV heads.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from dynamo_tpu_torch.models.toolkit import softcap_scores
from dynamo_tpu_torch.ops import _build
from dynamo_tpu_torch.ops.paged_attention import (  # noqa: F401 (re-export)
    KERNEL_HEAD_DIMS,
    attention_ref,
    check_local_heads,
    count_launch,
    count_sharded,
    decode_split_count,
    gather_context,
    head_scale,
    kv_operands,
    merge_split_partials_ref,
    ptr_or_null,
    scale_tensors,
    split_partials_ref,
    window_operand,
)

# decode batch (<=64) + packed chunks (<=32) in one mixed iteration
RAGGED_MAX_SEGS = 96
DEFAULT_Q_BLOCK = 8
# query rows (token x group) one kernel block stages
ROWS_PER_BLOCK = 64
# context tokens one kernel block walks: a multiple of the kernel's
# 64-token tile
SPLIT_TOKENS = 512


def ragged_seg_cap(t_bucket: int, max_segs: int = RAGGED_MAX_SEGS) -> int:
    """Segment-row capacity for a T bucket (+1 for the padding-tail
    segment); a function of the bucket only."""
    return min(t_bucket, max_segs) + 1


def ragged_work_cap(
    t_bucket: int,
    q_block: int = DEFAULT_Q_BLOCK,
    max_segs: int = RAGGED_MAX_SEGS,
) -> int:
    """Work-unit capacity: every block yields one unit plus one extra per
    segment that starts mid-block, so blocks + segments bounds it."""
    if t_bucket % q_block:
        raise ValueError(f"t_bucket {t_bucket} not a multiple of {q_block}")
    return t_bucket // q_block + ragged_seg_cap(t_bucket, max_segs)


def build_ragged_metadata(
    q_lens: Sequence[int],  # true (unpadded) query tokens per segment
    q_starts: Sequence[int],  # absolute position of each segment's token 0
    kv_lens: Sequence[int],  # context length per segment (incl. its chunk)
    page_rows: Sequence[Sequence[int]],  # page-table row per segment
    t_bucket: int,
    *,
    q_block: int = DEFAULT_Q_BLOCK,
    max_pages: Optional[int] = None,
    max_segs: int = RAGGED_MAX_SEGS,
) -> Dict[str, np.ndarray]:
    """Host-side (numpy) metadata for one ragged dispatch: the kernel
    operands (seg_page_table, seg_kv_lens, meta) padded to the bucket's
    caps, per-token arrays (tok_*), cu_q_lens and the per-segment
    last-token flat indices (last_index). Padding tokens get tok_pos=-1
    and tok_kv_len=1."""
    n = len(q_lens)
    t_real = int(sum(q_lens))
    if t_real > t_bucket:
        raise ValueError(f"{t_real} tokens exceed bucket {t_bucket}")
    if n > max_segs:
        raise ValueError(f"{n} segments exceed cap {max_segs}")
    seg_cap = ragged_seg_cap(t_bucket, max_segs)
    nw = ragged_work_cap(t_bucket, q_block, max_segs)
    if max_pages is None:
        max_pages = max((len(r) for r in page_rows), default=1)

    seg_pt = np.zeros((seg_cap, max_pages), np.int32)
    seg_kvl = np.zeros((seg_cap,), np.int32)
    for s, row in enumerate(page_rows):
        seg_pt[s, : len(row)] = row
    seg_kvl[:n] = kv_lens

    # flat extents per segment, dummy tail included
    lens_all: List[int] = list(int(x) for x in q_lens)
    if t_real < t_bucket:
        lens_all.append(t_bucket - t_real)
    meta = np.zeros((5, nw), np.int32)
    w = 0
    lo = 0
    for s, ln in enumerate(lens_all):
        hi = lo + ln
        for b in range(lo // q_block, (hi - 1) // q_block + 1):
            blo = max(lo, b * q_block)
            bhi = min(hi, (b + 1) * q_block)
            qp0 = int(q_starts[s]) + (blo - lo) if s < n else 0
            meta[:, w] = (s, b, blo - b * q_block, bhi - blo, qp0)
            w += 1
        lo = hi
    # padding units: rows=0 no-ops pointing at the last real block
    if w:
        pad_blk = meta[1, w - 1]
    else:
        pad_blk = 0
    pad_seg = min(n, seg_cap - 1)
    for j in range(w, nw):
        meta[:, j] = (pad_seg, pad_blk, 0, 0, 0)

    tok_pt = np.zeros((t_bucket, max_pages), np.int32)
    tok_kvl = np.ones((t_bucket,), np.int32)
    tok_pos = np.full((t_bucket,), -1, np.int32)
    cu = np.zeros((n + 1,), np.int32)
    off = 0
    for s in range(n):
        ln = int(q_lens[s])
        tok_pt[off : off + ln] = seg_pt[s]
        tok_kvl[off : off + ln] = kv_lens[s]
        tok_pos[off : off + ln] = int(q_starts[s]) + np.arange(ln)
        off += ln
        cu[s + 1] = off
    return {
        "seg_page_table": seg_pt,
        "seg_kv_lens": seg_kvl,
        "meta": meta,
        "tok_page_table": tok_pt,
        "tok_kv_lens": tok_kvl,
        "tok_positions": tok_pos,
        "cu_q_lens": cu,
        "last_index": (cu[1:] - 1).astype(np.int32),
        "n_work": np.int32(w),
    }


def ragged_token_index(meta: torch.Tensor, T: int,
                       q_block: int = DEFAULT_Q_BLOCK
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token (segment [T] int64, position [T] int64) derived from the
    work units on the tensors' device, with no host sync. Every flat
    token lies in exactly one unit; rows=0 padding units cover none. The
    dummy tail segment's tokens get positions from 0 (its kv_len is 0)."""
    seg, qblk, rs, rows, qpos0 = meta.long()
    i = torch.arange(q_block, device=meta.device)
    tok = qblk[:, None] * q_block + rs[:, None] + i[None, :]  # [NW, QB]
    # rows past a unit's count go to a discarded slot T
    tok = torch.where(i[None, :] < rows[:, None], tok, T).reshape(-1)
    tok_seg = torch.zeros(T + 1, dtype=torch.long, device=meta.device)
    tok_seg.scatter_(0, tok, seg[:, None].expand(-1, q_block).reshape(-1))
    tok_pos = torch.zeros(T + 1, dtype=torch.long, device=meta.device)
    tok_pos.scatter_(0, tok, (qpos0[:, None] + i[None, :]).reshape(-1))
    return tok_seg[:T], tok_pos[:T]


def ragged_paged_attention_ref(
    q: torch.Tensor, k_pool_l: torch.Tensor, v_pool_l: torch.Tensor,
    seg_page_table: torch.Tensor, seg_kv_lens: torch.Tensor,
    meta: torch.Tensor, window: Optional[int] = None, *,
    q_block: int = DEFAULT_Q_BLOCK, scale: Optional[float] = None,
    softcap: float = 0.0,
) -> torch.Tensor:
    """Plain version: each flat token is one S=1 row of
    paged_attention_ref (for int8 dict pools, paged_attention_int8_ref)
    over its segment's page table and kv_len. Rows of the dummy tail
    segment (kv_len 0) come out 0."""
    tok_seg, tok_pos = ragged_token_index(meta, q.shape[0], q_block)
    return attention_ref(k_pool_l)(
        q[:, None], k_pool_l, v_pool_l, seg_page_table[tok_seg],
        tok_pos[:, None], seg_kv_lens[tok_seg], scale,
        softcap=softcap, window=window,
    )[:, 0]


def split_count(max_pages: int, page_size: int) -> int:
    """Context splits the kernel's grid holds: enough for the longest
    context a page-table row can address. A function of shapes only."""
    return decode_split_count(max_pages, page_size, SPLIT_TOKENS)


def split_scratch_shape(n_work: int, Hk: int, G: int, D: int, max_pages: int,
                        page_size: int, q_block: int = DEFAULT_Q_BLOCK
                        ) -> Tuple[int, int, int, int, int]:
    """The kernel's f32 partials [NS, NW, Hk, q_block * G, D + 4]: per
    split, unit, head and row the unnormalised output (D), the running
    max, the sum, and 2 floats of padding that keep rows 16-byte aligned."""
    return (split_count(max_pages, page_size), n_work, Hk, q_block * G, D + 4)


def ragged_split_partials_ref(
    q: torch.Tensor, k_pool_l: torch.Tensor, v_pool_l: torch.Tensor,
    seg_page_table: torch.Tensor, seg_kv_lens: torch.Tensor,
    meta: torch.Tensor, window: Optional[int] = None, *,
    q_block: int = DEFAULT_Q_BLOCK, scale: Optional[float] = None,
    softcap: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the kernel's first pass, in f32: for each flat
    token and each context split z (positions [z * SPLIT_TOKENS,
    (z + 1) * SPLIT_TOKENS)), the max m of the row's visible scaled (and
    soft-capped) scores there, l = sum exp(s - m) and the unnormalised
    o = sum exp(s - m) v. A split in which the row sees no key (past its
    position, or wholly below its window) gives m = NEG_INF (-1e30),
    l = 0, o = 0. Returns (m [NS, T, Hk, G], l [NS, T, Hk, G],
    o [NS, T, Hk, G, D])."""
    T, Hk, G, D = q.shape
    if scale is None:
        scale = D ** -0.5
    tok_seg, tok_pos = ragged_token_index(meta, T, q_block)
    pages = seg_page_table[tok_seg].long()
    k, ks = gather_context(k_pool_l, pages)
    v, vs = gather_context(v_pool_l, pages)
    C = k.shape[1]
    s = torch.einsum("tkgd,tckd->tkgc", q.float(), k) * scale
    if ks is not None:
        s = s * head_scale(ks)
    s = softcap_scores(s, softcap)
    c = torch.arange(C, device=q.device)
    seen = ((c[None, :] < seg_kv_lens[tok_seg][:, None])
            & (c[None, :] <= tok_pos[:, None]))
    w = window_operand(window)
    if w:
        seen = seen & (c[None, :] > tok_pos[:, None] - w)
    return split_partials_ref(s, seen[:, None, None, :], v.permute(0, 2, 1, 3),
                              SPLIT_TOKENS, head_scale(vs))


def ragged_paged_attention(
    q: torch.Tensor,  # [T, Hk, G, D] flat query tokens (all segments)
    k_pool_l,  # [NP, PS, Hk, D] one layer's token-major pool, or its int8 dict
    v_pool_l,
    seg_page_table: torch.Tensor,  # [SEG, MP] int32
    seg_kv_lens: torch.Tensor,  # [SEG] int32
    meta: torch.Tensor,  # [5, NW] int32 work units (build_ragged_metadata)
    window: Optional[int] = None,  # sliding window in tokens; 0/None: global
    *,
    q_block: int = DEFAULT_Q_BLOCK,
    scale: Optional[float] = None,  # score scale (default D^-0.5)
    softcap: float = 0.0,  # score soft cap (0 = off)
) -> torch.Tensor:
    """Returns [T, Hk, G, D]; rows covered by no real segment return 0.
    Every segment's K/V (its own tokens included) must already be in the
    pool. Table entries past a segment's kv_len are never read. The pools
    are bf16 or both int8 dicts {"q", "s"}."""
    T, Hk, G, D = q.shape
    if scale is None:
        scale = D ** -0.5
    window = window_operand(window)
    if q.device.type == "cpu":
        return ragged_paged_attention_ref(
            q, k_pool_l, v_pool_l, seg_page_table, seg_kv_lens, meta, window,
            q_block=q_block, scale=scale, softcap=softcap)
    (k, ks, v, vs), int8 = kv_operands(k_pool_l, v_pool_l, Hk, D, "ragged")
    PS = k.shape[1]
    if q.dtype != torch.bfloat16:
        raise TypeError(f"the ragged kernel takes a bf16 q, not {q.dtype}")
    ints = (seg_page_table, seg_kv_lens, meta)
    if any(t.dtype != torch.int32 for t in ints):
        raise TypeError("seg_page_table, seg_kv_lens and meta must be int32")
    if meta.dim() != 2 or meta.shape[0] != 5 or seg_page_table.dim() != 2 \
            or seg_kv_lens.shape != seg_page_table.shape[:1]:
        raise ValueError("meta must be [5, NW], seg_page_table [SEG, MP] "
                         "and seg_kv_lens [SEG]")
    if T % q_block or D not in KERNEL_HEAD_DIMS or q_block * G > ROWS_PER_BLOCK:
        raise ValueError(f"no ragged kernel for T={T}, D={D}, G={G}, "
                         f"q_block={q_block}")
    tensors = (q, k, v) + ints
    if any(t.device != q.device for t in tensors + scale_tensors(ks, vs)):
        raise ValueError("all operands must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the ragged kernel takes contiguous operands")
    # every row of [0, T) belongs to exactly one unit, which writes it
    out = torch.empty_like(q)
    NW, MP = meta.shape[1], seg_page_table.shape[1]
    part = torch.empty(split_scratch_shape(NW, Hk, G, D, MP, PS, q_block),
                       dtype=torch.float32, device=q.device)
    lib = _build.load()["ragged_paged_attention"]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.ragged_paged_attention(
        q.data_ptr(), k.data_ptr(), ptr_or_null(ks), v.data_ptr(),
        ptr_or_null(vs), seg_page_table.data_ptr(), seg_kv_lens.data_ptr(),
        meta.data_ptr(), out.data_ptr(), part.data_ptr(), NW, Hk, G, D, PS,
        MP, q_block, SPLIT_TOKENS, window, float(scale), float(softcap),
        stream,
    )
    _build.check(lib, rc, "ragged_paged_attention")
    count_launch(ragged_paged_attention, D, window, softcap, int8)
    return out


ragged_paged_attention.launches = 0
ragged_paged_attention.bodies = {}


def ragged_paged_attention_sharded(
    q: torch.Tensor,  # [T, Hk / tp, G, D]: this rank's KV heads
    k_pool_l,  # [NP, PS, Hk / tp, D]: this rank's slice of one layer's pool
    v_pool_l,
    seg_page_table: torch.Tensor,  # whole on every rank
    seg_kv_lens: torch.Tensor,
    meta: torch.Tensor,
    window: Optional[int] = None,
    *,
    q_block: int = DEFAULT_Q_BLOCK,
    scale: Optional[float] = None,
    softcap: float = 0.0,
) -> torch.Tensor:
    """The tensor-parallel counterpart of ragged_paged_attention (the
    reference's `ragged_paged_attention_sharded`): one rank's call on its
    own KV heads over the whole step's metadata, no collective. Returns
    [T, Hk / tp, G, D]; counts its own launches beside the kernel's."""
    check_local_heads(q.shape[1], k_pool_l, v_pool_l, "ragged_paged_attention_sharded")
    before = ragged_paged_attention.launches
    out = ragged_paged_attention(q, k_pool_l, v_pool_l, seg_page_table, seg_kv_lens,
                                 meta, window, q_block=q_block, scale=scale,
                                 softcap=softcap)
    count_sharded(ragged_paged_attention_sharded, ragged_paged_attention.launches - before, q.shape[1])
    return out


ragged_paged_attention_sharded.launches = 0
ragged_paged_attention_sharded.heads = {}
