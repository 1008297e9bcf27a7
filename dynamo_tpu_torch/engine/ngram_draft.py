"""N-gram (prompt-lookup) draft proposal and deterministic acceptance.

Copies of dynamo_tpu/engine/ngram_draft.py `propose`, `propose_tree`,
`accept_tree` and `accept_deterministic`, the `--spec-ngram` path:
propose the next K tokens by finding the current suffix earlier in the
sequence's own token history, verify them as a K+1-token row of the
ragged dispatch, and emit target samples up to and including the first
mismatch. Tree speculation proposes up to `branches` distinct
continuations, each verified on its own forked page table, and walks
them as a trie (`accept_tree`).
"""

from __future__ import annotations

from typing import List, Sequence

# bound the history scanned per proposal so drafting stays O(window) per
# sequence per iteration on the step thread, not O(context)
NGRAM_SCAN_WINDOW = 4096


def propose(
    tokens: Sequence[int],
    k: int,
    *,
    min_match: int = 1,
    max_match: int = 4,
    window: int = NGRAM_SCAN_WINDOW,
) -> List[int]:
    """Find the longest suffix of `tokens` (between min_match and
    max_match tokens) that also occurs earlier in the history, and propose
    the k tokens that followed its most recent earlier occurrence. Returns
    [] when nothing matches (the sequence then decodes plainly)."""
    n = len(tokens)
    if k <= 0 or n < min_match + 1:
        return []
    lo = max(0, n - window)
    hist = list(tokens[lo:n])
    h = len(hist)
    for m in range(min(max_match, h - 1), min_match - 1, -1):
        pattern = hist[h - m:]
        # scan right-to-left so the most recent occurrence wins
        for s in range(h - m - 1, -1, -1):
            if hist[s:s + m] == pattern:
                cont = hist[s + m : s + m + k]
                if cont:
                    return [int(t) for t in cont]
        # no occurrence of the longest suffix: try a shorter one
    return []


def propose_tree(
    tokens: Sequence[int],
    k: int,
    branches: int,
    *,
    min_match: int = 1,
    max_match: int = 4,
    window: int = NGRAM_SCAN_WINDOW,
) -> List[List[int]]:
    """Tree draft proposal: up to `branches` DISTINCT candidate
    continuations of the current suffix, from different earlier
    occurrences (most recent first, longest suffix first — branch 0 is
    exactly `propose()`'s draft, which pins tree speculation at
    branches=1 to the linear-K behavior). Later branches are clipped to
    branch 0's length so every branch's verify row fits the page
    capacity the scheduler guaranteed for the primary draft. Returns []
    when nothing matches; duplicates are dropped (verifying the same
    continuation twice buys nothing)."""
    n = len(tokens)
    if k <= 0 or branches <= 0 or n < min_match + 1:
        return []
    lo = max(0, n - window)
    hist = list(tokens[lo:n])
    h = len(hist)
    out: List[List[int]] = []
    seen = set()
    for m in range(min(max_match, h - 1), min_match - 1, -1):
        pattern = hist[h - m:]
        for s in range(h - m - 1, -1, -1):
            if hist[s:s + m] == pattern:
                cont = hist[s + m : s + m + k]
                if not cont:
                    continue
                if out:
                    cont = cont[: len(out[0])]  # clip to the primary draft
                key = tuple(cont)
                if key in seen:
                    continue
                seen.add(key)
                out.append([int(t) for t in cont])
                if len(out) >= branches:
                    return out
    return out


def accept_tree(
    drafts: Sequence[Sequence[int]], rows: Sequence[Sequence[int]]
) -> tuple:
    """Accept/reject a TREE of deterministic drafts against per-branch
    target samples; returns (emitted, winner) where `winner` indexes the
    branch whose verify row supplied the emitted suffix (the engine
    adopts that branch's forked page table; -1 = no branches were given
    or nothing beyond the correction came from a fork — adopt nothing).

    `rows[b][j]` must be a target sample at verify position j of branch
    b (position 0 fed the sequence's last real token for EVERY branch,
    so all rows sample the same position-0 distribution with the same
    per-sequence randomness — identical branch prefixes yield identical
    samples, which is what makes the trie walk well-defined).

    The walk emits one target sample per depth from the lowest-indexed
    LIVE branch (a branch stays live while its drafted tokens match the
    emitted stream), stopping after the first mismatch (that sample is
    the correction token) or after the bonus token on a full match —
    `accept_deterministic` applied down a trie instead of a chain, and
    exactly equal to it when len(drafts) == 1. Every emitted token is a
    target sample at its position, so the output distribution is the
    target's at any temperature (same argument as the linear proof in
    `accept_deterministic`'s docstring)."""
    if not drafts:
        return [], -1
    live = list(range(len(drafts)))
    out: List[int] = []
    winner = 0
    for j in range(len(drafts[0])):
        b = live[0]  # lowest-index live branch supplies the sample
        winner = b
        tok = int(rows[b][j])
        out.append(tok)
        live = [
            i for i in live
            if j < len(drafts[i]) and int(drafts[i][j]) == tok
        ]
        if not live:
            return out, winner  # mismatch everywhere: tok is the correction
    b = live[0]
    out.append(int(rows[b][len(drafts[b])]))  # bonus token
    return out, b


def accept_deterministic(
    draft: Sequence[int], sampled: Sequence[int]
) -> List[int]:
    """Accept/reject a deterministic (one-hot q) draft against target
    samples, emitting 1..len(draft)+1 tokens.

    `sampled[j]` is a token drawn from the target distribution at verify
    position j (position j fed draft[j-1], position 0 fed the sequence's
    last real token), with independent randomness per position. Emit
    target samples up to and including the first mismatch; on a full
    match, emit all K+1 (the last is the bonus token). Every emitted
    token is a target sample at its position, so the output follows the
    target distribution, and at temperature 0 it is the greedy stream.
    """
    out: List[int] = []
    for j, d in enumerate(draft):
        tok = int(sampled[j])
        out.append(tok)
        if tok != int(d):
            return out  # first mismatch: the target sample corrects it
    out.append(int(sampled[len(draft)]))  # bonus token
    return out
