"""Mixture-of-experts block: token-choice top-k routing over the routed
experts, plus the always-active shared experts.

Port of dynamo_tpu/models/moe.py `_moe_block`, its expert-parallel
dispatch (moe.py:34-53) included. Under tensor parallelism a rank holds
F / tp columns of every routed expert it holds (we_gate / we_up cut F,
we_down its F rows) and its shared experts are a dense FFN's cut, so
their outputs are the rank's partial sums over the `model` group; the
router (w_router, router_bias) and ws_gatectl are whole, and every rank
routes the same tokens alike. The shared experts (DeepSeek, Qwen2-MoE) are
a dense SwiGLU added to the routed output, gated by sigmoid(x @
ws_gatectl) where the tree has it, and stay out of any dispatch. The
router product runs in x's dtype and is then cast to f32, and the mixing
weights are cast back to x's dtype, as there. The routed experts:
- impl="kernel": ops/moe_dispatch.py `route` -> `moe_gate_up` ->
  `moe_down` -> `combine`, the grouped GEMM on the Hopper kernel for CUDA
  tensors (its plain version on CPU tensors), with no host sync;
- impl="ref": `dense_experts`, the reference's every-expert form.
Under expert parallelism (`ep`, the rank's group over the `expert` axis;
a rank holds n_experts / ep of the experts) the reference's conditions
pick the path, on the padded shape of the step: with unquantized experts
and B S a multiple of the expert ranks, the token dispatch (moe_dispatch
`local_moe`: the rank's contiguous block of the B S tokens, routed as
every rank routes them all, its pairs sent to their experts' ranks, the
capacity from moe_capacity_factor or n_experts / k, and the expert
group's all-gather restoring [B S, E]); otherwise the reference's dense
fallback (`ep_fallback`: each rank's own experts over the pairs that
chose them, then one all-reduce over the expert group). Decode at one
row over two expert ranks takes the fallback. With the groups given the
block returns the whole output: the partial sums are reduced here.
Quantized experts ({"q", "s"} stacks, models/quant.py) take the grouped
GEMM's quantized body on the kernel path and the reference's `mm` on the
plain one; the shared experts go through `mm`, as the reference's do.
"""

from __future__ import annotations

from typing import Mapping

import torch
import torch.nn.functional as F

from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.models.quant import mm
from dynamo_tpu_torch.ops.moe_dispatch import (
    combine,
    dense_experts,
    ep_capacity,
    ep_fallback,
    local_moe,
    moe_down,
    moe_gate_up,
    route,
    router_topk,
)
from dynamo_tpu_torch.ops.quant_gemm import is_quantized_weight


def moe_block(c: ModelConfig, lp: Mapping[str, torch.Tensor], x: torch.Tensor,
              impl: str = "kernel", tp=None, ep=None) -> torch.Tensor:
    """x [B, S, E] -> [B, S, E]. `lp` holds one layer's MoE leaves
    (w_router [E, n_exp], we_gate / we_up [n_exp, E, F], we_down
    [n_exp, F, E]; router_bias [n_exp] for DeepSeek-V3; ws_gate, ws_up,
    ws_down and, from Qwen2-MoE checkpoints, ws_gatectl for the shared
    experts). Every token is routed, padding tokens too, as in the
    reference. `tp` / `ep`: the rank's groups over the model and expert
    axes (parallel/group.py AxisGroup, or None): the routed experts are the
    rank's (n_exp / ep of them, each F / tp wide) and the output is whole,
    summed over the groups here."""
    B, S, E = x.shape
    x2 = x.reshape(B * S, E)
    shared = None
    if c.n_shared_experts:
        gate = F.silu(mm(x2, lp["ws_gate"], impl))
        shared = mm(gate * mm(x2, lp["ws_up"], impl), lp["ws_down"], impl)
        if "ws_gatectl" in lp:  # Qwen2-MoE: a sigmoid-gated shared expert
            shared = shared * torch.sigmoid(x2 @ lp["ws_gatectl"])
    logits = (x2 @ lp["w_router"]).float()  # [B S, n_exp]
    weights, sel = router_topk(
        logits, c.n_experts_active, c.moe_scoring, c.moe_norm_topk,
        bias=lp.get("router_bias"), routed_scale=c.moe_routed_scale,
        n_groups=c.n_expert_groups, topk_groups=c.topk_groups)
    weights = weights.to(x.dtype)
    if ep is not None and ep.size > 1:
        # the reference's choice (moe.py:34-36): unquantized experts and a
        # padded step whose tokens split over the expert ranks
        if not is_quantized_weight(lp["we_gate"]) and (B * S) % ep.size == 0:
            T = (B * S) // ep.size
            rows = slice(ep.rank * T, (ep.rank + 1) * T)
            cf = c.moe_capacity_factor or (c.n_experts / c.n_experts_active)
            y = local_moe(x2[rows], weights[rows], sel[rows], lp["we_gate"], lp["we_up"],
                          lp["we_down"], ep, ep_capacity(T, c.n_experts_active, ep.size, cf),
                          tp, impl)
            y = ep.all_gather(y, 0)
            if shared is not None:
                y = y + (shared if tp is None else tp.all_reduce(shared))
        else:
            y = ep.all_reduce(ep_fallback(x2, weights, sel, lp["we_gate"], lp["we_up"],
                                          lp["we_down"], ep.rank, impl))
            if shared is not None:
                y = y + shared
            if tp is not None:
                tp.all_reduce(y)
        return y.reshape(B, S, E)
    if impl == "ref":
        y = dense_experts(x2, sel, weights, lp["we_gate"], lp["we_up"],
                          lp["we_down"])
    else:
        r = route(sel, c.n_experts)
        h = moe_gate_up(x2, r.tok, lp["we_gate"], lp["we_up"], r.tiles)
        y = combine(moe_down(h, lp["we_down"], r.tiles), r.order, weights)
    if shared is not None:
        y = y + shared
    if tp is not None:  # F is cut: the routed and shared sums are partial
        tp.all_reduce(y)
    return y.reshape(B, S, E)
