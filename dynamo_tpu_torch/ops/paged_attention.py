"""Decode paged attention: one query token per sequence attends over that
sequence's pages of a token-major KV pool.

Port of dynamo_tpu/ops/paged_attention.py `decode_paged_attention`: the
bf16 bodies, plain and Gemma-2's (a sliding window, a score soft cap and a
scale override), at head dims 64, 128 and 256. On CUDA tensors the wrapper
launches the hand-written Hopper kernel in csrc/paged_attention.cu; on CPU
tensors it runs the plain PyTorch version below, which is also what the
kernel is held against.

Window rule, as in the reference: the query of row b sits at position
kv_lens[b] - 1, and with a window w > 0 it sees positions
c >= kv_lens[b] - w only; w = 0 (or None) is global attention.

The kernel splits each row's context into DECODE_SPLIT_TOKENS-long pieces,
one block each, and merges a long row's pieces by log-sum-exp.
`split_partials_ref` and `merge_split_partials_ref` are that arithmetic in
plain PyTorch for every split-context kernel of the port (this one, the
ragged kernel and MLA decode); `decode_split_partials_ref` applies it here.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from dynamo_tpu_torch.models.toolkit import (
    NEG_INF,
    paged_attention_ref,
    softcap_scores,
)
from dynamo_tpu_torch.ops import _build

# context tokens one kernel block walks: a multiple of the kernel's 64-token
# tile, two tiles for each of its three warps
DECODE_SPLIT_TOKENS = 384


def split_partials_ref(s: torch.Tensor, seen: torch.Tensor, v: torch.Tensor,
                       split: int
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The first pass of a split-context kernel, in plain f32: scaled
    scores s [..., C], the keys each row sees `seen` (broadcastable to s)
    and values v [..., C, Dv] laid out so that p @ v is the rows' weighted
    sum for p like s (v [B, Hk, C, D] for s [B, Hk, G, C]). For each
    context split z (positions [z * split, (z + 1) * split)): the max m of
    the row's visible scores there, l = sum exp(s - m) and the
    unnormalised o = sum exp(s - m) v. A split in which the row sees no
    key gives m = NEG_INF (-1e30), l = 0, o = 0. Returns (m [NS, ...],
    l [NS, ...], o [NS, ..., Dv]), NS = ceil(C / split)."""
    C = s.shape[-1]
    ms, ls, os_ = [], [], []
    for z in range(-(-C // split)):
        lo, hi = z * split, min((z + 1) * split, C)
        mask = seen[..., lo:hi]
        sz = torch.where(mask, s[..., lo:hi], float("-inf"))
        m = sz.amax(-1).clamp(min=NEG_INF)
        p = torch.where(mask, torch.exp(sz - m[..., None]), 0.0)
        ms.append(m)
        ls.append(p.sum(-1))
        os_.append(p @ v[..., lo:hi, :])
    return torch.stack(ms), torch.stack(ls), torch.stack(os_)


def merge_split_partials_ref(m: torch.Tensor, l: torch.Tensor,
                             o: torch.Tensor) -> torch.Tensor:
    """The kernels' merge: rescale each split to the rows' overall max and
    sum in split order; a row that saw nothing comes out 0. In f32."""
    m_all = m.amax(0)
    l_all = torch.zeros_like(m_all)
    acc = torch.zeros_like(o[0])
    for z in range(m.shape[0]):
        w = torch.exp(m[z] - m_all)
        l_all = l_all + w * l[z]
        acc = acc + w[..., None] * o[z]
    return acc / l_all.clamp(min=1e-30)[..., None]


def decode_split_count(max_pages: int, page_size: int,
                       split: int = DECODE_SPLIT_TOKENS) -> int:
    """Context splits a split-context kernel's grid holds: enough for the
    longest context a page-table row can address. A function of shapes
    only (the launch needs no host sync)."""
    return -(-max_pages * page_size // split)


def window_operand(window: Optional[int]) -> int:
    """The kernels' window argument: a Python int, 0 for global attention
    (None, 0 or a negative window, as in the reference)."""
    if window is None:
        return 0
    if not isinstance(window, int):
        raise TypeError(f"window must be a Python int or None, not "
                        f"{type(window).__name__} (no host sync per launch)")
    return max(window, 0)


def decode_split_partials_ref(
    q: torch.Tensor, k_pool_l: torch.Tensor, v_pool_l: torch.Tensor,
    page_table: torch.Tensor, kv_lens: torch.Tensor,
    scale: Optional[float] = None, split: int = DECODE_SPLIT_TOKENS, *,
    softcap: float = 0.0, window: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The decode kernel's partials in plain f32: (m [NS, B, Hk, G],
    l [NS, B, Hk, G], o [NS, B, Hk, G, D]) over the splits of each row's
    visible positions [kv_lens[b] - window, kv_lens[b]) (from 0 without a
    window); a split wholly below the window is the empty partial."""
    B, Hk, G, D = q.shape
    if scale is None:
        scale = D ** -0.5
    MP = page_table.shape[1]
    PS = k_pool_l.shape[1]
    C = MP * PS
    pages = page_table.long()
    k = k_pool_l[pages].reshape(B, C, Hk, D).float()
    v = v_pool_l[pages].reshape(B, C, Hk, -1).float()
    s = softcap_scores(torch.einsum("bkgd,bckd->bkgc", q.float(), k) * scale,
                       softcap)
    c = torch.arange(C, device=q.device)[None, :]
    seen = c < kv_lens[:, None]
    w = window_operand(window)
    if w:
        seen = seen & (c >= kv_lens[:, None] - w)
    return split_partials_ref(s, seen[:, None, None, :], v.permute(0, 2, 1, 3),
                              split)


def decode_paged_attention_ref(
    q: torch.Tensor, k_pool_l: torch.Tensor, v_pool_l: torch.Tensor,
    page_table: torch.Tensor, kv_lens: torch.Tensor,
    scale: Optional[float] = None, *, softcap: float = 0.0,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Plain version: the query of row b sits at position kv_lens[b] - 1
    and sees positions [0, kv_lens[b]), the last `window` of them with a
    window. Rows with kv_len 0 come out 0."""
    q_pos = (kv_lens.long() - 1).clamp(min=0)[:, None]
    return paged_attention_ref(
        q[:, None], k_pool_l, v_pool_l, page_table, q_pos, kv_lens, scale,
        softcap=softcap, window=window,
    )[:, 0]


# head dims each attention kernel is built for (wrappers raise on others)
KERNEL_HEAD_DIMS = (64, 128, 256)


def count_launch(fn, D: int, window: int, softcap: float) -> None:
    """One launch of a GQA kernel: `fn.launches` and, by body,
    `fn.bodies` ("D128", "D256_window_softcap", ...). Called by the
    wrappers right after their kernel launched, and nowhere else."""
    fn.launches += 1
    key = f"D{D}" + ("_window" if window else "") + ("_softcap" if softcap else "")
    fn.bodies[key] = fn.bodies.get(key, 0) + 1


def decode_paged_attention(
    q: torch.Tensor,  # [B, Hk, G, D]
    k_pool_l: torch.Tensor,  # [NP, PS, Hk, D] one layer's token-major pool
    v_pool_l: torch.Tensor,
    page_table: torch.Tensor,  # [B, MP] int32
    kv_lens: torch.Tensor,  # [B] int32, context length incl. this token
    window: Optional[int] = None,  # sliding window in tokens; 0/None: global
    *,
    scale: Optional[float] = None,  # score scale (default D^-0.5)
    softcap: float = 0.0,  # score soft cap (0 = off)
) -> torch.Tensor:
    """Returns [B, Hk, G, D]. The current token's KV must already be in
    the pool. Table entries past kv_len, and below the window, are never
    read."""
    B, Hk, G, D = q.shape
    if scale is None:
        scale = D ** -0.5
    window = window_operand(window)
    if q.device.type == "cpu":
        return decode_paged_attention_ref(
            q, k_pool_l, v_pool_l, page_table, kv_lens, scale,
            softcap=softcap, window=window)
    NP, PS, Hk2, D2 = k_pool_l.shape
    if (Hk2, D2) != (Hk, D) or v_pool_l.shape != k_pool_l.shape:
        raise ValueError(f"pool {tuple(k_pool_l.shape)} does not match q {tuple(q.shape)}")
    if q.dtype != torch.bfloat16 or k_pool_l.dtype != torch.bfloat16 \
            or v_pool_l.dtype != torch.bfloat16:
        raise TypeError("the decode kernel takes bf16 q and pools")
    if page_table.dtype != torch.int32 or kv_lens.dtype != torch.int32:
        raise TypeError("page_table and kv_lens must be int32")
    if D not in KERNEL_HEAD_DIMS or G not in (1, 2, 3, 4, 8):
        raise ValueError(f"no decode kernel for D={D}, G={G}")
    tensors = (q, k_pool_l, v_pool_l, page_table, kv_lens)
    if any(t.device != q.device for t in tensors):
        raise ValueError("all operands must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the decode kernel takes contiguous operands")
    # every row is written by its one block or by the merge
    out = torch.empty_like(q)
    MP = page_table.shape[1]
    part = torch.empty((decode_split_count(MP, PS), B, Hk, G, D + 4),
                       dtype=torch.float32, device=q.device)
    lib = _build.load()["paged_attention"]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.decode_paged_attention(
        q.data_ptr(), k_pool_l.data_ptr(), v_pool_l.data_ptr(),
        page_table.data_ptr(), kv_lens.data_ptr(), out.data_ptr(),
        part.data_ptr(), B, Hk, G, D, PS, MP, DECODE_SPLIT_TOKENS, window,
        float(scale), float(softcap), stream,
    )
    _build.check(lib, rc, "decode_paged_attention")
    count_launch(decode_paged_attention, D, window, softcap)
    return out


decode_paged_attention.launches = 0
decode_paged_attention.bodies = {}
