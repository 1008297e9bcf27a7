"""Token sampling on the device: greedy / temperature / top-k / top-p.

Port of dynamo_tpu/engine/sampling.py `SamplingParams`, `sample` and
`filtered_probs`. The filter pipeline is the reference's: truncate to the
top MAX_CANDIDATES logits, then top-k, then top-p (nucleus over the
top-k-filtered candidates), then temperature. Randomness differs: the
reference folds the step into per-row threefry keys; here each sampled
row draws Gumbel noise from a torch.Generator seeded by (seed, step), so a
row's draw is a pure function of its seed, its step and its logits.
Penalties, logprobs, masks and logit bias are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import torch

# Sampling truncates to the top MAX_CANDIDATES logits first (one topk, no
# full-vocab sort); top_k requests above this cap are clamped.
MAX_CANDIDATES = 64


@dataclass
class SamplingParams:
    """Per-sequence sampling state for a batch of B rows."""

    temperature: torch.Tensor  # [B] f32; <= 0 -> greedy
    top_k: torch.Tensor  # [B] i32; 0 -> disabled
    top_p: torch.Tensor  # [B] f32; 1.0 -> disabled
    seeds: List[int]  # host: per-row seed
    sampled_rows: List[int]  # host: rows with temperature > 0

    @classmethod
    def make(cls, temperature: Sequence[float], top_k: Sequence[int],
             top_p: Sequence[float], seeds: Sequence[int],
             device="cpu") -> "SamplingParams":
        return cls(
            temperature=torch.tensor(list(temperature), dtype=torch.float32,
                                     device=device),
            top_k=torch.tensor(list(top_k), dtype=torch.int32, device=device),
            top_p=torch.tensor(list(top_p), dtype=torch.float32, device=device),
            seeds=[int(s) for s in seeds],
            sampled_rows=[i for i, t in enumerate(temperature) if t > 0.0],
        )


def _filtered_scaled(logits: torch.Tensor, params: SamplingParams):
    """top-K truncate, top-k/top-p masks, temperature. Returns (idx [B, K]
    token ids by descending logit, scaled [B, K])."""
    B, V = logits.shape
    K = min(MAX_CANDIDATES, V)
    vals, idx = torch.topk(logits, K, dim=-1)
    j = torch.arange(K, device=logits.device)
    k_eff = torch.where(params.top_k > 0, params.top_k.clamp(max=K), K)
    vals = torch.where(j[None, :] < k_eff[:, None], vals, -torch.inf)
    # nucleus: keep token j while the probability mass before it < top_p
    probs = torch.softmax(vals, dim=-1)
    cum_before = torch.cumsum(probs, dim=-1) - probs
    vals = torch.where(cum_before < params.top_p[:, None], vals, -torch.inf)
    scaled = vals / params.temperature.clamp(min=1e-6)[:, None]
    return idx, scaled


def filtered_probs(logits: torch.Tensor, params: SamplingParams):
    """The exact distribution `sample` draws from: (idx [B, K] candidate
    token ids, probs [B, K]). Greedy rows come back one-hot on idx[:, 0]."""
    idx, scaled = _filtered_scaled(logits, params)
    probs = torch.softmax(scaled, dim=-1)
    greedy = torch.zeros_like(probs)
    greedy[:, 0] = 1.0
    probs = torch.where((params.temperature <= 0.0)[:, None], greedy, probs)
    return idx, probs


def _row_seed(seed: int, step: int) -> int:
    return ((int(seed) & 0xFFFFFFFF) << 32) | (int(step) & 0xFFFFFFFF)


def sample(logits: torch.Tensor, params: SamplingParams, step: int) -> torch.Tensor:
    """logits [B, V] f32 -> token ids [B] int32, on the logits' device and
    without a host sync. Greedy rows take the top logit; sampled rows take
    argmax(scaled + Gumbel noise), a draw from softmax(scaled)."""
    idx, scaled = _filtered_scaled(logits, params)
    pick = torch.zeros(logits.shape[0], dtype=torch.long, device=logits.device)
    if params.sampled_rows:
        noise = torch.zeros_like(scaled)
        for i in params.sampled_rows:
            g = torch.Generator(device=logits.device)
            g.manual_seed(_row_seed(params.seeds[i], step))
            u = torch.rand(scaled.shape[1], generator=g, device=logits.device)
            noise[i] = -torch.log(-torch.log(u))
        choice = torch.argmax(scaled + noise, dim=-1)
        pick = torch.where(params.temperature > 0.0, choice, pick)
    return torch.gather(idx, 1, pick[:, None])[:, 0].to(torch.int32)
