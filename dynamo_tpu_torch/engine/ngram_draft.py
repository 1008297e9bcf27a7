"""N-gram (prompt-lookup) draft proposal and deterministic acceptance.

Copies of dynamo_tpu/engine/ngram_draft.py `propose` and
`accept_deterministic`, the linear `--spec-ngram` path: propose the next K
tokens by finding the current suffix earlier in the sequence's own token
history, verify them as a K+1-token row of the ragged dispatch, and emit
target samples up to and including the first mismatch.
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
