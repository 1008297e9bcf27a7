"""Decode paged attention: one query token per sequence attends over that
sequence's pages of a token-major KV pool.

Port of dynamo_tpu/ops/paged_attention.py `decode_paged_attention`: the
bf16 bodies and the int8 ones (pools as the dict {"q": int8, "s": f32} of
models/quant.py, `_decode_kernel_int8[_win]`), each plain and Gemma-2's (a
sliding window, a score soft cap and a scale override), at head dims 64,
96, 128 and 256 and 1 to 8 query heads a KV head. On CUDA tensors the wrapper launches the hand-written Hopper
kernel in csrc/paged_attention.cu; on CPU tensors it runs the plain
PyTorch version below (for int8 pools toolkit.paged_attention_int8_ref,
which folds the scales in the TPU kernels' order), which is also what the
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
    is_quantized,
    paged_attention_int8_ref,
    paged_attention_ref,
    pool_values,
    softcap_scores,
)
from dynamo_tpu_torch.ops import _build

# context tokens one kernel block walks: a multiple of the kernel's 64-token
# tile, two tiles for each of its three warps
DECODE_SPLIT_TOKENS = 384


def split_partials_ref(s: torch.Tensor, seen: torch.Tensor, v: torch.Tensor,
                       split: int, v_scale: Optional[torch.Tensor] = None,
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The first pass of a split-context kernel, in plain f32: scaled
    scores s [..., C], the keys each row sees `seen` (broadcastable to s)
    and values v [..., C, Dv] laid out so that p @ v is the rows' weighted
    sum for p like s (v [B, Hk, C, D] for s [B, Hk, G, C]). For each
    context split z (positions [z * split, (z + 1) * split)): the max m of
    the row's visible scores there, l = sum exp(s - m) and the
    unnormalised o = sum exp(s - m) v; with int8 values, o = sum exp(s - m)
    v_scale v (v_scale broadcastable to s, applied after l is summed). A
    split in which the row sees no key gives m = NEG_INF (-1e30), l = 0,
    o = 0. Returns (m [NS, ...], l [NS, ...], o [NS, ..., Dv]), NS =
    ceil(C / split)."""
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
        if v_scale is not None:
            p = p * v_scale[..., lo:hi]
        os_.append(p @ v[..., lo:hi, :])
    return torch.stack(ms), torch.stack(ls), torch.stack(os_)


def gather_context(pool_l, pages: torch.Tensor
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """A layer's pages `pages` [N, MP] as f32 rows [N, C, Hk, D] (C = MP *
    PS) and, for an int8 dict pool, their scales [N, C, Hk] (else None):
    the split-partials refs' keys and values."""
    vals = pool_values(pool_l)
    N, C = pages.shape[0], pages.shape[1] * vals.shape[1]
    x = vals[pages].reshape(N, C, vals.shape[2], -1).float()
    if not is_quantized(pool_l):
        return x, None
    return x, pool_l["s"][pages].reshape(N, C, vals.shape[2])


def head_scale(scale: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """Per-token scales [N, C, Hk] laid out like scores [N, Hk, G, C]."""
    return None if scale is None else scale.permute(0, 2, 1)[:, :, None, :]


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
    k, ks = gather_context(k_pool_l, page_table.long())
    v, vs = gather_context(v_pool_l, page_table.long())
    C = k.shape[1]
    s = torch.einsum("bkgd,bckd->bkgc", q.float(), k) * scale
    if ks is not None:
        s = s * head_scale(ks)
    s = softcap_scores(s, softcap)
    c = torch.arange(C, device=q.device)[None, :]
    seen = c < kv_lens[:, None]
    w = window_operand(window)
    if w:
        seen = seen & (c >= kv_lens[:, None] - w)
    return split_partials_ref(s, seen[:, None, None, :], v.permute(0, 2, 1, 3),
                              split, head_scale(vs))


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
    return attention_ref(k_pool_l)(
        q[:, None], k_pool_l, v_pool_l, page_table, q_pos, kv_lens, scale,
        softcap=softcap, window=window,
    )[:, 0]


def attention_ref(pool_l):
    """The plain gather attention the kernels' plain versions run over
    this pool: the scale fold for int8 dict pools, else the bf16 one."""
    return paged_attention_int8_ref if is_quantized(pool_l) else paged_attention_ref


# head dims each attention kernel is built for (wrappers raise on others)
KERNEL_HEAD_DIMS = (64, 96, 128, 256)
# query heads a KV head the decode kernel takes: the rows of one warp's
# 16-row fragment that hold a KV head's queries (G > 8 would need two
# fragments a warp, or rows split over warps)
DECODE_MAX_G = 8


def count_launch(fn, D: int, window: int, softcap: float,
                 int8: bool = False) -> None:
    """One launch of a GQA kernel: `fn.launches` and, by body,
    `fn.bodies` ("D128", "D96_window", "D256_int8_window_softcap", ...).
    Called by the wrappers right after their kernel launched, and nowhere
    else."""
    fn.launches += 1
    key = (f"D{D}" + ("_int8" if int8 else "") + ("_window" if window else "")
           + ("_softcap" if softcap else ""))
    fn.bodies[key] = fn.bodies.get(key, 0) + 1


def kv_operands(k_pool_l, v_pool_l, Hk: int, D: int, what: str
                ) -> Tuple[tuple, bool]:
    """The pool operands of a GQA kernel, checked: bf16 pools [NP, PS, Hk,
    D], or int8 dict pools {"q": int8 [NP, PS, Hk, D], "s": f32 [NP, PS,
    Hk]} with 16-byte aligned rows. Returns ((k, ks, v, vs) tensors, ks
    and vs None for bf16; int8 or not). Raises naming the operand it
    refuses."""
    quant = is_quantized(k_pool_l)
    if quant != is_quantized(v_pool_l):
        raise TypeError(f"the {what} kernel takes two bf16 pools or two int8 "
                        "dict pools, not one of each")
    if not quant:
        for name, t in (("k_pool", k_pool_l), ("v_pool", v_pool_l)):
            if t.dtype != torch.bfloat16:
                raise TypeError(f"the {what} kernel takes a bf16 {name}, "
                                f"not {t.dtype}")
            if t.dim() != 4 or tuple(t.shape[2:]) != (Hk, D):
                raise ValueError(f"{name} {tuple(t.shape)} does not match "
                                 f"Hk={Hk}, D={D}")
        if v_pool_l.shape != k_pool_l.shape:
            raise ValueError("k_pool and v_pool differ in shape")
        return (k_pool_l, None, v_pool_l, None), False
    ops = []
    for name, pool in (("k_pool", k_pool_l), ("v_pool", v_pool_l)):
        qv, sc = pool.get("q"), pool.get("s")
        if qv is None or sc is None:
            raise TypeError(f"the int8 {name} must be the dict {{'q', 's'}}")
        if qv.dtype != torch.int8:
            raise TypeError(f"the {what} kernel takes an int8 {name}['q'], "
                            f"not {qv.dtype}")
        if sc.dtype != torch.float32:
            raise TypeError(f"the {what} kernel takes an f32 {name}['s'], "
                            f"not {sc.dtype}")
        if qv.dim() != 4 or tuple(qv.shape[2:]) != (Hk, D):
            raise ValueError(f"int8 {name}['q'] {tuple(qv.shape)} does not "
                             f"match Hk={Hk}, D={D}")
        if tuple(sc.shape) != tuple(qv.shape[:3]):
            raise ValueError(f"int8 {name}['s'] {tuple(sc.shape)} does not "
                             f"match its 'q' {tuple(qv.shape)}")
        if not (qv.is_contiguous() and sc.is_contiguous()):
            raise ValueError(f"the int8 {name} must be contiguous")
        if qv.data_ptr() % 16 or sc.data_ptr() % 4:
            raise ValueError(f"int8 {name}['q'] must be 16-byte aligned "
                             "and its 's' 4-byte aligned")
        ops += [qv, sc]
    if ops[0].shape != ops[2].shape:
        raise ValueError("the int8 k_pool and v_pool differ in shape")
    return tuple(ops), True


def scale_tensors(*scales: Optional[torch.Tensor]) -> tuple:
    """The int8 pools' scale tensors among `scales` (None for bf16)."""
    return tuple(t for t in scales if t is not None)


def ptr_or_null(t: Optional[torch.Tensor]) -> Optional[int]:
    """A kernel's pointer argument: the tensor's address, or NULL."""
    return None if t is None else t.data_ptr()


def decode_paged_attention(
    q: torch.Tensor,  # [B, Hk, G, D]
    k_pool_l,  # [NP, PS, Hk, D] one layer's token-major pool, or its int8 dict
    v_pool_l,
    page_table: torch.Tensor,  # [B, MP] int32
    kv_lens: torch.Tensor,  # [B] int32, context length incl. this token
    window: Optional[int] = None,  # sliding window in tokens; 0/None: global
    *,
    scale: Optional[float] = None,  # score scale (default D^-0.5)
    softcap: float = 0.0,  # score soft cap (0 = off)
) -> torch.Tensor:
    """Returns [B, Hk, G, D]. The current token's KV must already be in
    the pool. Table entries past kv_len, and below the window, are never
    read. The pools are bf16 or both int8 dicts {"q", "s"}."""
    B, Hk, G, D = q.shape
    if scale is None:
        scale = D ** -0.5
    window = window_operand(window)
    if q.device.type == "cpu":
        return decode_paged_attention_ref(
            q, k_pool_l, v_pool_l, page_table, kv_lens, scale,
            softcap=softcap, window=window)
    (k, ks, v, vs), int8 = kv_operands(k_pool_l, v_pool_l, Hk, D, "decode")
    PS = k.shape[1]
    if q.dtype != torch.bfloat16:
        raise TypeError(f"the decode kernel takes a bf16 q, not {q.dtype}")
    if page_table.dtype != torch.int32 or kv_lens.dtype != torch.int32:
        raise TypeError("page_table and kv_lens must be int32")
    if D not in KERNEL_HEAD_DIMS or not 1 <= G <= DECODE_MAX_G:
        raise ValueError(f"no decode kernel for D={D}, G={G}")
    tensors = (q, k, v, page_table, kv_lens)
    if any(t.device != q.device for t in tensors + scale_tensors(ks, vs)):
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
        q.data_ptr(), k.data_ptr(), ptr_or_null(ks), v.data_ptr(), ptr_or_null(vs),
        page_table.data_ptr(), kv_lens.data_ptr(), out.data_ptr(),
        part.data_ptr(), B, Hk, G, D, PS, MP, DECODE_SPLIT_TOKENS, window,
        float(scale), float(softcap), stream,
    )
    _build.check(lib, rc, "decode_paged_attention")
    count_launch(decode_paged_attention, D, window, softcap, int8)
    return out


decode_paged_attention.launches = 0
decode_paged_attention.bodies = {}
