"""Top-k expert routing, and the routed experts on a grouped GEMM.

Port of dynamo_tpu/ops/moe_dispatch.py `router_topk` (every branch:
softmax over the chosen logits, softmax over all experts without
renormalising, sigmoid gates with and without V3's selection bias and
group-limited choice, the 1e-9 floor of the renormalisation, the routed
scale) and `moe_dense_reference`. The expert-parallel `moe_ep` waits for
an expert mesh (ROADMAP A.14).

Off an expert mesh the reference computes every expert on every token (a
vmap over the experts that XLA compiles, dynamo_tpu/models/moe.py:65; no
Pallas kernel): on one card that is n_experts / k times the expert FLOPs
a token needs (16x for qwen3-30b-a3b, 32x for DeepSeek-V3). The port
computes the same function by routing instead:
- `route` sorts the (token, choice) pairs by expert with a stable sort,
  finds each expert's rows by a binary search over the sorted ids (not
  `bincount`, which reads its maximum back to the host on CUDA) and lays
  the rows out in tiles of MOE_BM rows, each within one expert: the tile
  map [NT, 3] (expert, first row, end row). NT is the upper bound
  ceil(T k / MOE_BM) + n_experts, a function of shapes only, so no value
  comes back to the host; tiles past the last live one hold expert -1
  (the kernel's persistent blocks stop at the first of them).
- `moe_gate_up` and `moe_down` run each expert's SwiGLU over its rows:
  on CUDA tensors the hand-written Hopper kernel of
  csrc/moe_grouped_gemm.cu (gate/up over more than MOE_GATHER_PAIRS
  pairs on a copy of x's rows in sorted order, `gate_up_rows`), on CPU
  tensors their plain versions
  (`*_ref`, a loop of torch.matmul over each expert's sorted rows), which
  is also what the kernel is held against.
- `combine` puts the rows back in (token, choice) order, multiplies them
  by the mixing weights and sums over the k choices in plain PyTorch, in
  a fixed order (no float atomics: greedy streams repeat run to run).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from dynamo_tpu_torch.ops import _build

# rows a tile of the grouped GEMM: the kernel's kBM (two warpgroups of 64)
MOE_BM = 128
# the K depth of one stage of the kernel's ring (kBK), and the columns of
# one weight box (kBox): the kernel takes K % 64 == 0 and N % 64 == 0
MOE_BK = 64
MOE_N_ALIGN = 64
# the kernel reads its matrices in 16-byte pieces (weights by the TMA unit,
# A rows by cp.async): each must start 16-byte aligned
MOE_PTR_ALIGN = 16
# gate/up launches of at most this many pairs (a decode step of up to 8
# tokens: no tile then holds more rows than one consumer warpgroup's 64)
# gather x's rows in the kernel; larger ones take a permuted copy of x,
# which the kernel reads in 64-row TMA boxes (a hot expert's 128-row tiles
# ran at half the rate on rows gathered 16 bytes at a time: PERF.md §6)
MOE_GATHER_PAIRS = MOE_BM // 2


def router_topk(logits: torch.Tensor, k: int, scoring: str = "softmax",
                norm_topk: bool = True, bias: Optional[torch.Tensor] = None,
                routed_scale: float = 1.0, n_groups: int = 0,
                topk_groups: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k routing weights and expert ids [..., k] from f32 router
    logits [..., n_experts]. softmax: Mixtral / Qwen (softmax over the
    chosen logits; norm_topk=False: the softmax over all experts, not
    renormalised, Qwen2-MoE); sigmoid: DeepSeek-V3 (independent gates,
    renormalised over the top-k). `bias` shifts the selection only: the
    mixing weights come from the unbiased gates. `n_groups` /
    `topk_groups`: keep the groups whose top-2 scores sum highest and
    choose within them. `routed_scale` multiplies the final weights."""
    if scoring == "sigmoid":
        gates = torch.sigmoid(logits)
        sel_scores = gates + bias.to(gates.dtype) if bias is not None else gates
        if n_groups > 1 and 0 < topk_groups < n_groups:
            *lead, n_exp = sel_scores.shape
            per = n_exp // n_groups
            grouped = sel_scores.reshape(*lead, n_groups, per)
            group_score = grouped.topk(min(2, per), dim=-1).values.sum(-1)
            keep_g = group_score.topk(topk_groups, dim=-1).indices
            keep = torch.zeros_like(group_score, dtype=torch.bool).scatter_(
                -1, keep_g, True)
            mask = keep.repeat_interleave(per, dim=-1)
            sel_scores = torch.where(mask, sel_scores, float("-inf"))
        if bias is not None or n_groups > 1:
            sel = sel_scores.topk(k, dim=-1).indices
            weights = gates.gather(-1, sel)
        else:
            weights, sel = gates.topk(k, dim=-1)
        if norm_topk:
            weights = weights / weights.sum(-1, keepdim=True).clamp(min=1e-9)
    elif not norm_topk:
        weights, sel = torch.softmax(logits, dim=-1).topk(k, dim=-1)
    else:
        weights, sel = logits.topk(k, dim=-1)
        weights = torch.softmax(weights, dim=-1)
    if routed_scale != 1.0:
        weights = weights * routed_scale
    return weights, sel


def dense_experts(x: torch.Tensor, sel: torch.Tensor, weights: torch.Tensor,
                  we_gate: torch.Tensor, we_up: torch.Tensor,
                  we_down: torch.Tensor) -> torch.Tensor:
    """The reference's every-expert form (models/moe.py:65-76): every
    expert's SwiGLU on every token x [N, E], then each token's k chosen
    outputs weighted by `weights` [N, k] and summed, in x's dtype."""
    gate = F.silu(torch.matmul(x, we_gate))  # [n_exp, N, F]
    out = torch.matmul(gate * torch.matmul(x, we_up), we_down)  # [n_exp, N, E]
    idx = sel.long()[..., None].expand(-1, -1, out.shape[-1])
    sel_out = out.permute(1, 0, 2).gather(1, idx)  # [N, k, E]
    return (sel_out * weights[..., None]).sum(1)


def moe_dense_reference(x, w_router, we_gate, we_up, we_down, k: int,
                        scoring: str = "softmax", norm_topk: bool = True):
    """Unsharded dense top-k MoE of x [N, E] (no bias, groups or scale:
    the reference's signature)."""
    logits = (x @ w_router).float()
    weights, sel = router_topk(logits, k, scoring, norm_topk)
    return dense_experts(x, sel, weights.to(x.dtype), we_gate, we_up, we_down)


class Routing(NamedTuple):
    """The pairs' layout for the grouped GEMM. Row r of the sorted order
    is pair order[r] (pair = token * k + choice) of token tok[r]."""
    order: torch.Tensor  # [T k] int64
    tok: torch.Tensor  # [T k] int32
    tiles: torch.Tensor  # [NT, 3] int32: (expert or -1, first row, end row)


def tile_count(pairs: int, n_experts: int) -> int:
    """Tiles the grid holds: sum over experts of ceil(rows / MOE_BM) is at
    most ceil(pairs / MOE_BM) + n_experts - 1, whatever the routing."""
    return -(-pairs // MOE_BM) + n_experts


def route(sel: torch.Tensor, n_experts: int) -> Routing:
    """Sort the (token, choice) pairs of sel [T, k] by expert (stable:
    within an expert, pairs stay in token order) and tile each expert's
    rows, MOE_BM to a tile (the kernel's tile). All on sel's device, with
    no value read back to the host."""
    k = sel.shape[-1]
    flat = sel.reshape(-1).long()
    sorted_e, order = torch.sort(flat, stable=True)
    dev = flat.device
    # offsets[e]: the first sorted row of expert e; offsets[n_experts] = T k
    offsets = torch.searchsorted(
        sorted_e, torch.arange(n_experts + 1, device=dev))
    bm = MOE_BM
    n_tiles = (offsets[1:] - offsets[:-1] + bm - 1) // bm
    tiles_end = torch.cumsum(n_tiles, 0)
    t = torch.arange(tile_count(flat.numel(), n_experts), device=dev)
    expert = torch.searchsorted(tiles_end, t, right=True)
    live = expert < n_experts
    e = expert.clamp(max=n_experts - 1)
    first = offsets[e] + (t - (tiles_end[e] - n_tiles[e])) * bm
    end = torch.minimum(first + bm, offsets[e + 1])
    tiles = torch.stack([torch.where(live, e, -1), torch.where(live, first, 0),
                         torch.where(live, end, 0)], 1).to(torch.int32)
    return Routing(order, (order // k).to(torch.int32), tiles)


def expert_rows(tiles: torch.Tensor) -> List[Tuple[int, int, int]]:
    """(expert, first row, end row) of each expert with rows, from the tile
    map (read back to the host: the plain versions' loop)."""
    spans = {}
    for e, r0, r1 in tiles.tolist():
        if e >= 0:
            lo, hi = spans.get(e, (r0, r1))
            spans[e] = (min(lo, r0), max(hi, r1))
    return [(e, lo, hi) for e, (lo, hi) in sorted(spans.items())]


def moe_gate_up_ref(x, tok_of_row, w_gate, w_up, tiles):
    """Plain version of moe_gate_up: per expert, silu(x_r @ w_gate[e]) *
    (x_r @ w_up[e]) over its rows' tokens x_r, in x's dtype."""
    h = x.new_zeros((tok_of_row.shape[0], w_gate.shape[-1]))
    for e, r0, r1 in expert_rows(tiles):
        xr = x[tok_of_row[r0:r1].long()]
        h[r0:r1] = F.silu(xr @ w_gate[e]) * (xr @ w_up[e])
    return h


def moe_down_ref(h, w_down, tiles):
    """Plain version of moe_down: per expert, h_r @ w_down[e] over its rows."""
    y = h.new_zeros((h.shape[0], w_down.shape[-1]))
    for e, r0, r1 in expert_rows(tiles):
        y[r0:r1] = h[r0:r1] @ w_down[e]
    return y


def _check_operands(what: str, mats, ints, K: int, N: int) -> None:
    """The kernel's operands: bf16 matrices and int32 maps, contiguous, on
    one device; K a multiple of MOE_BK and N of MOE_N_ALIGN; the matrices
    at MOE_PTR_ALIGN-byte aligned addresses."""
    dev = mats[0][1].device
    for name, t in mats:
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{what} takes a bf16 {name}, not {t.dtype}")
    for name, t in ints:
        if t.dtype != torch.int32:
            raise TypeError(f"{what} takes an int32 {name}, not {t.dtype}")
    for name, t in mats + ints:
        if t.device != dev:
            raise ValueError(f"{what}: {name} is on {t.device}, not {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{what} takes a contiguous {name}")
    if K % MOE_BK or N % MOE_N_ALIGN:
        raise ValueError(f"{what}: no kernel for K={K}, N={N} (K % {MOE_BK} "
                         f"and N % {MOE_N_ALIGN} must be 0)")
    for name, t in mats:
        if t.data_ptr() % MOE_PTR_ALIGN:
            raise ValueError(f"{what}: {name} is not {MOE_PTR_ALIGN}-byte aligned")


def _check_tiles(what: str, tiles: torch.Tensor) -> None:
    if tiles.dim() != 2 or tiles.shape[1] != 3:
        raise ValueError(f"{what}: tiles {tuple(tiles.shape)} is not [NT, 3]")


def gate_up_rows(x: torch.Tensor, tok_of_row: torch.Tensor):
    """The A operand of gate/up's kernel and its row map: x and the token
    of each sorted row (the kernel gathers the rows), or, over more than
    MOE_GATHER_PAIRS pairs, x's rows copied in sorted order and None (the
    kernel reads them as they lie)."""
    if tok_of_row.shape[0] > MOE_GATHER_PAIRS:
        return x.index_select(0, tok_of_row), None
    return x, tok_of_row


def moe_gate_up(x: torch.Tensor, tok_of_row: torch.Tensor,
                w_gate: torch.Tensor, w_up: torch.Tensor,
                tiles: torch.Tensor) -> torch.Tensor:
    """h [T k, F] = silu(x[tok] @ w_gate[e]) * (x[tok] @ w_up[e]) for each
    sorted row, e its tile's expert. x [T, E]; w_gate, w_up [n_exp, E, F];
    tok_of_row [T k] int32; tiles from `route`."""
    if x.device.type == "cpu":
        return moe_gate_up_ref(x, tok_of_row, w_gate, w_up, tiles)
    n_exp, E, F_ = w_gate.shape
    if x.dim() != 2 or x.shape[1] != E or w_up.shape != w_gate.shape:
        raise ValueError(f"moe_gate_up: x {tuple(x.shape)}, w_gate "
                         f"{tuple(w_gate.shape)}, w_up {tuple(w_up.shape)}")
    _check_operands("moe_gate_up", [("x", x), ("w_gate", w_gate), ("w_up", w_up)],
                    [("tok_of_row", tok_of_row), ("tiles", tiles)], E, F_)
    _check_tiles("moe_gate_up", tiles)
    h = torch.empty((tok_of_row.shape[0], F_), dtype=x.dtype, device=x.device)
    a, rows = gate_up_rows(x, tok_of_row)
    lib = _build.load()["moe_grouped_gemm"]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.moe_gate_up(a.data_ptr(), None if rows is None else rows.data_ptr(),
                         w_gate.data_ptr(), w_up.data_ptr(), tiles.data_ptr(),
                         h.data_ptr(), h.shape[0], n_exp, tiles.shape[0], E, F_, stream)
    _build.check(lib, rc, "moe_gate_up")
    moe_gate_up.launches += 1
    return h


def moe_down(h: torch.Tensor, w_down: torch.Tensor,
             tiles: torch.Tensor) -> torch.Tensor:
    """y [T k, E] = h_r @ w_down[e] for each sorted row r, e its tile's
    expert. h [T k, F]; w_down [n_exp, F, E]."""
    if h.device.type == "cpu":
        return moe_down_ref(h, w_down, tiles)
    n_exp, F_, E = w_down.shape
    if h.dim() != 2 or h.shape[1] != F_:
        raise ValueError(f"moe_down: h {tuple(h.shape)}, w_down "
                         f"{tuple(w_down.shape)}")
    _check_operands("moe_down", [("h", h), ("w_down", w_down)],
                    [("tiles", tiles)], F_, E)
    _check_tiles("moe_down", tiles)
    y = torch.empty((h.shape[0], E), dtype=h.dtype, device=h.device)
    lib = _build.load()["moe_grouped_gemm"]
    stream = torch.cuda.current_stream(h.device).cuda_stream
    rc = lib.moe_down(h.data_ptr(), w_down.data_ptr(), tiles.data_ptr(),
                      y.data_ptr(), h.shape[0], n_exp, tiles.shape[0], F_, E, stream)
    _build.check(lib, rc, "moe_down")
    moe_down.launches += 1
    return y


moe_gate_up.launches = 0
moe_down.launches = 0


def combine(y: torch.Tensor, order: torch.Tensor,
            weights: torch.Tensor) -> torch.Tensor:
    """Sorted rows y [T k, E] back to (token, choice) order, times the
    mixing weights [T, k], summed over the k choices: [T, E] in y's dtype.
    index_copy_ writes each row once, and the sum runs in a fixed order."""
    T, k = weights.shape
    pairs = torch.empty_like(y).index_copy_(0, order, y)
    return (pairs.view(T, k, -1) * weights[..., None]).sum(1)
