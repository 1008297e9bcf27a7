"""Mixture-of-experts block: token-choice top-k routing over the routed
experts, plus the always-active shared experts.

Port of dynamo_tpu/models/moe.py `_moe_block` off an expert mesh (the
expert-parallel dispatch, moe.py:34-53, waits for ROADMAP A.14). The
shared experts (DeepSeek, Qwen2-MoE) are a dense SwiGLU added to the
routed output, gated by sigmoid(x @ ws_gatectl) where the tree has it.
The router product runs in x's dtype and is then cast to f32, and the
mixing weights are cast back to x's dtype, as there. The routed experts:
- impl="kernel": ops/moe_dispatch.py `route` -> `moe_gate_up` ->
  `moe_down` -> `combine`, the grouped GEMM on the Hopper kernel for CUDA
  tensors (its plain version on CPU tensors), with no host sync;
- impl="ref": `dense_experts`, the reference's every-expert form.
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
    moe_down,
    moe_gate_up,
    route,
    router_topk,
)


def moe_block(c: ModelConfig, lp: Mapping[str, torch.Tensor], x: torch.Tensor,
              impl: str = "kernel") -> torch.Tensor:
    """x [B, S, E] -> [B, S, E]. `lp` holds one layer's MoE leaves
    (w_router [E, n_exp], we_gate / we_up [n_exp, E, F], we_down
    [n_exp, F, E]; router_bias [n_exp] for DeepSeek-V3; ws_gate, ws_up,
    ws_down and, from Qwen2-MoE checkpoints, ws_gatectl for the shared
    experts). Every token is routed, padding tokens too, as in the
    reference."""
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
    if impl == "ref":
        y = dense_experts(x2, sel, weights, lp["we_gate"], lp["we_up"],
                          lp["we_down"])
    else:
        r = route(sel, c.n_experts)
        h = moe_gate_up(x2, r.tok, lp["we_gate"], lp["we_up"], r.tiles)
        y = combine(moe_down(h, lp["we_down"], r.tiles), r.order, weights)
    if shared is not None:
        y = y + shared
    return y.reshape(B, S, E)
