"""Draft-model speculative decoding on the device: the draft model
proposes gamma tokens with S = 1 decode steps, the target verifies all
gamma + 1 positions in one S = gamma + 1 forward, and a lossless
accept / resample keeps the output distributed as plain decoding of the
target.

Port of dynamo_tpu/engine/spec_decode.py `accept_and_finalize` and
`spec_rounds`, with the reference's math: a draft token is accepted with
probability min(1, p(x) / q(x)), the accepted prefix is the cumulative
product of the accepts, and the first rejection resamples from
norm(max(p - q, 0)) (p where that residual is empty), with a zero q row
at position gamma so that the all-accepted case is the bonus draw from
the target. p and q are the exact filtered distributions that
`sampling.sample` draws from, so greedy rows reproduce plain greedy
decoding token for token whatever the draft proposes.

The reference runs R rounds in a `lax.scan`; here the rounds are a
Python loop over device tensors (as the runner's `_decode_loop`), each
round's positions and last token fed to the next on the device, so a
dispatch reads back once. The draft's KV lives in pools of its own
addressed by the target's page tables; each round runs gamma + 1 draft
steps, the last of which only writes d_gamma's KV (its proposal is
discarded), so a fully accepted round leaves no hole in the draft pool.

Randomness differs from the reference's threefry keys folded by step and
tag: each sampled row draws from a torch.Generator seeded by (seed, step,
tag) (`tag_seed`), a stream apart from plain `sample`'s (seed, step)
seeds. The uniforms of the accept test and the final draw are separate
parts (`accept_uniforms`, `categorical_rows`), so a test can hand both
packages the same uniforms. Greedy rows draw nothing.
"""

from __future__ import annotations

import hashlib
from typing import Callable, Tuple

import torch

from dynamo_tpu_torch.engine.sampling import SamplingParams, filtered_probs
from dynamo_tpu_torch.models import llama

# draw tags: keep the speculative streams apart from plain sample() (which
# seeds by the step only) and from each other (the reference's fold tags)
TAG_DRAFT = 1_000_000
TAG_ACCEPT = 2_000_000
TAG_FINAL = 3_000_000


def tag_seed(seed: int, step: int, tag: int) -> int:
    """The 64-bit generator seed of one row's (seed, step, tag) draw."""
    d = hashlib.blake2b(f"{int(seed)}:{int(step)}:{int(tag)}".encode(),
                        digest_size=8).digest()
    return int.from_bytes(d, "big")


def _row_uniforms(seed: int, step: int, tag: int, n: int, device) -> torch.Tensor:
    g = torch.Generator(device=device)
    g.manual_seed(tag_seed(seed, step, tag))
    return torch.rand(n, generator=g, device=device)


def accept_uniforms(samp: SamplingParams, step: int, g: int,
                    device) -> torch.Tensor:
    """The accept test's uniforms [B, g] of `step`: a draw per sampled row,
    zeros for greedy rows (whose p(d) / q(d) is 0 or 1, so any u in [0, 1)
    decides the same)."""
    B = samp.temperature.shape[0]
    u = torch.zeros((B, g), dtype=torch.float32, device=device)
    if g:
        for i in samp.sampled_rows:
            u[i] = _row_uniforms(samp.seeds[i], step, TAG_ACCEPT, g, device)
    return u


def categorical_rows(probs: torch.Tensor, samp: SamplingParams, step: int,
                     tag: int) -> torch.Tensor:
    """A draw per row from explicit probabilities [B, K] -> [B] (long):
    argmax of log p plus Gumbel noise on sampled rows; one-hot rows
    (greedy) come out deterministic."""
    logp = torch.log(probs)
    if samp.sampled_rows:
        noise = torch.zeros_like(probs)
        for i in samp.sampled_rows:
            u = _row_uniforms(samp.seeds[i], step, tag, probs.shape[1], probs.device)
            noise[i] = -torch.log(-torch.log(u))
        logp = logp + noise
    return torch.argmax(logp, dim=-1)


def residual(t_probs: torch.Tensor, q_on_t: torch.Tensor,
             n_acc: torch.Tensor) -> torch.Tensor:
    """The resampling distribution [B, K] at the first rejected position
    r = n_acc: norm(max(p_r - q_r, 0)), or p_r where that is empty. q has a
    zero row at position g, so r = g (all accepted) gives p_{g+1}."""
    B, _, K = t_probs.shape
    q_ext = torch.cat([q_on_t, q_on_t.new_zeros((B, 1, K))], dim=1)
    sel = n_acc.long().view(B, 1, 1).expand(B, 1, K)
    p_r = torch.gather(t_probs, 1, sel)[:, 0]
    q_r = torch.gather(q_ext, 1, sel)[:, 0]
    resid = (p_r - q_r).clamp(min=0.0)
    rs = resid.sum(dim=-1, keepdim=True)
    return torch.where(rs > 1e-12, resid / rs.clamp(min=1e-30), p_r)


def accept_and_finalize(
    drafts: torch.Tensor,  # [B, g] proposed token ids
    q_d: torch.Tensor,  # [B, g] draft prob of each proposed token
    q_on_t: torch.Tensor,  # [B, g, K] draft probs on the target's candidates
    t_idx: torch.Tensor,  # [B, g+1, K] target candidate token ids
    t_probs: torch.Tensor,  # [B, g+1, K] target probs (the sampling dist)
    u: torch.Tensor,  # [B, g] uniforms of the accept test
    draw: Callable[[torch.Tensor], torch.Tensor],  # resid [B, K] -> [B]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The accept / resample math -> (out_tokens [B, g+1] int32, counts
    [B] int32): out_tokens[:, :n_acc] are the accepted drafts,
    out_tokens[:, n_acc] the resample (the bonus token when all were
    accepted); columns past counts are junk."""
    B, g1, K = t_probs.shape
    g = g1 - 1
    # p(d_i): the target's prob of draft token i (0 outside its candidates:
    # a certain rejection)
    match = t_idx[:, :g, :] == drafts[:, :, None]
    p_d = torch.where(match, t_probs[:, :g, :], 0.0).sum(dim=-1)
    accept = u < p_d / q_d.clamp(min=1e-30)
    n_acc = torch.cumprod(accept.to(torch.int32), dim=1).sum(dim=1)
    j = draw(residual(t_probs, q_on_t, n_acc))
    sel = n_acc.long().view(B, 1, 1).expand(B, 1, K)
    idx_r = torch.gather(t_idx, 1, sel)[:, 0]
    final = torch.gather(idx_r, 1, j.long()[:, None])
    out = torch.cat([drafts.to(torch.int32),
                     torch.zeros((B, 1), dtype=torch.int32, device=drafts.device)], 1)
    out.scatter_(1, n_acc.long()[:, None], final.to(torch.int32))
    return out, (n_acc + 1).to(torch.int32)


def accept_rows(drafts, q_d, q_on_t, t_idx, t_probs, samp: SamplingParams,
                step: int):
    """accept_and_finalize with this package's draws of `step`."""
    u = accept_uniforms(samp, step, drafts.shape[1], drafts.device)
    return accept_and_finalize(
        drafts, q_d, q_on_t, t_idx, t_probs, u,
        lambda resid: categorical_rows(resid, samp, step, TAG_FINAL))


def _pick(idx: torch.Tensor, probs: torch.Tensor, j: torch.Tensor):
    """(token ids, their probs) at candidate index j [B]."""
    j = j.long()[:, None]
    return (torch.gather(idx, 1, j)[:, 0].to(torch.int32),
            torch.gather(probs, 1, j)[:, 0])


def spec_rounds(
    config,
    draft_config,
    gamma: int,
    n_rounds: int,
    params,
    draft_params,
    tokens0: torch.Tensor,  # [B] current last token of each sequence
    positions0: torch.Tensor,  # [B] its write position (-1 = padding row)
    k_pool,
    v_pool,
    dk_pool,
    dv_pool,
    page_table: torch.Tensor,  # [B, MP]
    samp: SamplingParams,
    step0: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """R speculative rounds on the device, the four pools written in
    place. Returns (tokens [B, R, gamma+1], counts [B, R]) on the device;
    row i's round r holds counts[i, r] valid tokens. The page tables must
    cover positions0 + R * (gamma + 1) slots."""
    B = tokens0.shape[0]
    dev = tokens0.device
    g1 = gamma + 1
    offs = torch.arange(g1, dtype=torch.int32, device=dev)
    # the verify rows' sampling params: each sequence's row repeated
    # gamma + 1 times (only the filter fields are read)
    rep = samp.rows(torch.arange(B, device=dev).repeat_interleave(g1),
                    seeds=[s for s in samp.seeds for _ in range(g1)],
                    sampled_rows=[])
    tok, pos = tokens0.to(torch.int32), positions0.to(torch.int32)
    out_toks, out_counts = [], []
    for r in range(n_rounds):
        step = step0 + r
        # draft: gamma + 1 sequential S = 1 proposals; step i writes the
        # fed token's KV at pos + i, the last one d_gamma's
        t = tok
        d_seq, d_idx, d_probs, q_d = [], [], [], []
        for i in range(g1):
            p_i = torch.where(pos < 0, -1, pos + i)
            kvl = torch.where(pos < 0, 0, pos + i + 1).to(torch.int32)
            logits = llama.forward(draft_config, draft_params, t[:, None],
                                   p_i[:, None], dk_pool, dv_pool, page_table, kvl)
            if i == gamma:
                break  # its proposal is discarded
            idx, probs = filtered_probs(logits[:, 0], samp)
            d, qd = _pick(idx, probs, categorical_rows(probs, samp, step,
                                                       TAG_DRAFT + i))
            d_seq.append(d)
            d_idx.append(idx)
            d_probs.append(probs)
            q_d.append(qd)
            t = d
        drafts = (torch.stack(d_seq, 1) if d_seq
                  else torch.zeros((B, 0), dtype=torch.int32, device=dev))
        # target: one S = gamma + 1 verify pass
        ver_toks = torch.cat([tok[:, None], drafts], 1)
        ver_pos = torch.where(pos[:, None] < 0, -1, pos[:, None] + offs)
        kvl = torch.where(pos < 0, 0, pos + g1).to(torch.int32)
        logits = llama.forward(config, params, ver_toks, ver_pos, k_pool, v_pool,
                               page_table, kvl)  # [B, g+1, V]
        t_idx, t_probs = filtered_probs(logits.reshape(B * g1, -1), rep)
        K = t_idx.shape[-1]
        t_idx = t_idx.view(B, g1, K)
        t_probs = t_probs.view(B, g1, K)
        if gamma:
            di = torch.stack(d_idx, 1)  # [B, g, K]
            dp = torch.stack(d_probs, 1)
            # the draft distribution on the target's candidate ids
            pair = t_idx[:, :gamma, :, None] == di[:, :, None, :]
            q_on_t = torch.where(pair, dp[:, :, None, :], 0.0).sum(dim=-1)
            qd_t = torch.stack(q_d, 1)
        else:
            q_on_t = t_probs.new_zeros((B, 0, K))
            qd_t = t_probs.new_zeros((B, 0))
        toks, counts = accept_rows(drafts, qd_t, q_on_t, t_idx, t_probs, samp, step)
        pos = torch.where(pos < 0, pos, pos + counts)
        tok = torch.gather(toks, 1, (counts.long() - 1)[:, None])[:, 0]
        out_toks.append(toks)
        out_counts.append(counts)
    return torch.stack(out_toks, 1), torch.stack(out_counts, 1)
