"""Token sampling on the device: greedy / temperature / top-k / top-p,
penalties, logit bias, guided masks and the logprob report.

Port of dynamo_tpu/engine/sampling.py `SamplingParams`, `apply_penalties`,
`top_logprobs`, `sample` and `filtered_probs`. The filter pipeline is the
reference's: logit bias added, masked tokens set to -1e30 (not -inf, as
there), truncate to the top MAX_CANDIDATES logits, then top-k, then top-p
(nucleus over the top-k-filtered candidates), then temperature. Penalties
and the logprob report are the reference's too: the report is computed
from the raw logits, before penalties, bias and mask. Randomness differs:
the reference folds the step into per-row threefry keys; here each
sampled row draws Gumbel noise from a torch.Generator seeded by (seed,
step), so a row's draw is a pure function of its seed, its step and its
logits. Nothing here reads a tensor back to the host.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import torch

# Sampling truncates to the top MAX_CANDIDATES logits first (one topk, no
# full-vocab sort); top_k requests above this cap are clamped.
MAX_CANDIDATES = 64

# the logit a guided mask gives a banned token (the reference's fill)
MASKED_LOGIT = -1e30


@dataclass
class SamplingParams:
    """Per-sequence sampling state for a batch of B rows."""

    temperature: torch.Tensor  # [B] f32; <= 0 -> greedy
    top_k: torch.Tensor  # [B] i32; 0 -> disabled
    top_p: torch.Tensor  # [B] f32; 1.0 -> disabled
    seeds: List[int]  # host: per-row seed
    sampled_rows: List[int]  # host: rows with temperature > 0
    rep_penalty: torch.Tensor  # [B] f32; 1.0 -> disabled (HF multiplicative)
    freq_penalty: torch.Tensor  # [B] f32; 0.0 -> disabled (count-scaled)
    presence_penalty: torch.Tensor  # [B] f32; 0.0 -> disabled (flat)

    @classmethod
    def make(cls, temperature: Sequence[float], top_k: Sequence[int],
             top_p: Sequence[float], seeds: Sequence[int],
             rep_penalty: Optional[Sequence[float]] = None,
             freq_penalty: Optional[Sequence[float]] = None,
             presence_penalty: Optional[Sequence[float]] = None,
             device="cpu") -> "SamplingParams":
        n = len(temperature)

        def f32(values, default):
            vals = [default] * n if values is None else list(values)
            return torch.tensor(vals, dtype=torch.float32, device=device)

        return cls(
            temperature=f32(temperature, 0.0),
            top_k=torch.tensor(list(top_k), dtype=torch.int32, device=device),
            top_p=f32(top_p, 1.0),
            seeds=[int(s) for s in seeds],
            sampled_rows=[i for i, t in enumerate(temperature) if t > 0.0],
            rep_penalty=f32(rep_penalty, 1.0),
            freq_penalty=f32(freq_penalty, 0.0),
            presence_penalty=f32(presence_penalty, 0.0),
        )

    def rows(self, idx: torch.Tensor, seeds: List[int],
             sampled_rows: List[int]) -> "SamplingParams":
        """The params of rows `idx` (a device gather) with the given host
        seeds and sampled-row list."""
        return SamplingParams(
            temperature=self.temperature[idx], top_k=self.top_k[idx],
            top_p=self.top_p[idx], seeds=seeds, sampled_rows=sampled_rows,
            rep_penalty=self.rep_penalty[idx],
            freq_penalty=self.freq_penalty[idx],
            presence_penalty=self.presence_penalty[idx])


def apply_penalties(logits: torch.Tensor, counts_all: torch.Tensor,
                    counts_out: torch.Tensor,
                    params: SamplingParams) -> torch.Tensor:
    """Repetition / frequency / presence penalties over raw logits [B, V].
    `counts_all` (prompt + generated) drives HF-style repetition: a seen
    token's positive logit is divided by the penalty, a negative one
    multiplied. `counts_out` (generated only) drives the OpenAI pair:
    frequency subtracts penalty x count, presence subtracts the penalty
    once for any generated token. Default params are an exact no-op."""
    rp = params.rep_penalty[:, None]
    logits = torch.where(counts_all > 0.0,
                         torch.where(logits > 0, logits / rp, logits * rp), logits)
    logits = logits - params.freq_penalty[:, None] * counts_out
    return logits - params.presence_penalty[:, None] * (counts_out > 0.0)


def top_logprobs(logits: torch.Tensor, sampled: torch.Tensor, k: int):
    """The logprob report from the raw distribution: (tok_lp [B] of the
    sampled tokens, top_ids [B, k] int32, top_lps [B, k]); k = 0 gives
    empty top arrays."""
    lp = torch.log_softmax(logits, dim=-1)
    tok_lp = torch.gather(lp, 1, sampled.long()[:, None])[:, 0]
    if k <= 0:
        B = logits.shape[0]
        return (tok_lp, torch.zeros((B, 0), dtype=torch.int32, device=lp.device),
                torch.zeros((B, 0), dtype=torch.float32, device=lp.device))
    vals, ids = torch.topk(lp, k, dim=-1)
    return tok_lp, ids.to(torch.int32), vals


def _biased(logits: torch.Tensor, mask: Optional[torch.Tensor],
            bias: Optional[torch.Tensor]) -> torch.Tensor:
    """`bias` [B, V] added, then tokens where `mask` [B, V] is False set
    to MASKED_LOGIT (the caller keeps one token allowed in every row)."""
    if bias is not None:
        logits = logits + bias
    if mask is not None:
        logits = torch.where(mask, logits, MASKED_LOGIT)
    return logits


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


def filtered_probs(logits: torch.Tensor, params: SamplingParams,
                   mask: Optional[torch.Tensor] = None,
                   bias: Optional[torch.Tensor] = None):
    """The exact distribution `sample` draws from under the same mask and
    bias: (idx [B, K] candidate token ids, probs [B, K]). Greedy rows come
    back one-hot on idx[:, 0]."""
    idx, scaled = _filtered_scaled(_biased(logits, mask, bias), params)
    probs = torch.softmax(scaled, dim=-1)
    greedy = torch.zeros_like(probs)
    greedy[:, 0] = 1.0
    probs = torch.where((params.temperature <= 0.0)[:, None], greedy, probs)
    return idx, probs


def _row_seed(seed: int, step: int) -> int:
    return ((int(seed) & 0xFFFFFFFF) << 32) | (int(step) & 0xFFFFFFFF)


def sample(logits: torch.Tensor, params: SamplingParams, step: int,
           mask: Optional[torch.Tensor] = None,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """logits [B, V] f32 -> token ids [B] int32, on the logits' device and
    without a host sync. `bias` [B, V] f32 (OpenAI logit_bias) adds to the
    logits before filtering; `mask` [B, V] bool (guided decoding) bans its
    False tokens. Greedy rows take the top logit; sampled rows take
    argmax(scaled + Gumbel noise), a draw from softmax(scaled)."""
    idx, scaled = _filtered_scaled(_biased(logits, mask, bias), params)
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
