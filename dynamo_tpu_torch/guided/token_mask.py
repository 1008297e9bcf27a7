"""Lift a byte-level DFA to per-state token masks for a tokenizer.

The worker-side half of guided decoding: the frontend ships a compact
byte DFA; this module walks every token's byte string through it to
answer "from DFA state s, which TOKENS may be sampled next, and where
does each land?". Rows are computed lazily per visited state (a
generation visits tens of states; a dense [S, V] table for a 128k vocab
would be hundreds of MB) and vectorized over the vocab (one numpy
advance per byte position, ~Lmax*V ops per row).

EOS is never part of the DFA alphabet: it is legal exactly in accepting
states (the constraint is complete), and a state whose row allows
nothing else force-stops generation there.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

import numpy as np

from dynamo_tpu_torch.guided.regex_dfa import ByteDFA


class TokenLifter:
    """Per-tokenizer byte table, shared across all matchers.

    `token_bytes[i]` is token i's byte string (None/empty → the token can
    never be sampled under a constraint — special tokens, padding ids).
    """

    def __init__(self, token_bytes: List[Optional[bytes]], eos_id: int,
                 vocab_size: int):
        self.vocab_size = vocab_size
        self.eos_id = eos_id
        V = vocab_size
        lens = np.zeros(V, np.int32)
        maxlen = 1
        for i, b in enumerate(token_bytes[:V]):
            if b:
                lens[i] = len(b)
                maxlen = max(maxlen, len(b))
        mat = np.zeros((V, maxlen), np.uint8)
        for i, b in enumerate(token_bytes[:V]):
            if b:
                mat[i, : len(b)] = np.frombuffer(b, np.uint8)
        self.tok_mat = mat
        self.tok_len = lens

    @classmethod
    def for_tokenizer(cls, tokenizer, vocab_size: int) -> "TokenLifter":
        """Build from the port's byte tokenizer: ids 0..255 are their
        byte, every other id (BOS, EOS, the model's ids past the
        tokenizer) can never be sampled under a constraint. The
        reference's branch for a tokenizer.json vocabulary is not copied:
        the port reads none."""
        tb: List[Optional[bytes]] = [
            bytes([i]) if i < 256 and i < tokenizer.vocab_size else None
            for i in range(vocab_size)
        ]
        return cls(
            tb, tokenizer.eos_id if tokenizer.eos_id is not None else -1,
            vocab_size,
        )

    def lift(self, dfa: ByteDFA) -> "GuidedMatcher":
        return GuidedMatcher(self, dfa)


# Bound on cached per-state rows ([V] int32 each — ~0.5MB at 128k vocab).
# Literal-heavy constraints advance through a fresh state per byte, so an
# unbounded cache grows with generation length; recomputing an evicted row
# costs ~Lmax vectorized vocab passes (sub-ms), so a small cap is cheap.
_ROW_CACHE_MAX = 128


class GuidedMatcher:
    """One compiled constraint against one tokenizer. Thread-safe row
    cache (the engine step thread and admission path may both touch it)."""

    def __init__(self, lifter: TokenLifter, dfa: ByteDFA):
        self.lifter = lifter
        self.dfa = dfa
        self.start = dfa.start
        self._rows: Dict[int, np.ndarray] = {}  # insertion-ordered (FIFO)
        self._lock = threading.Lock()

    def _row(self, state: int) -> np.ndarray:
        """[V] int32: token id → DFA state after consuming the token's
        bytes from `state` (-1 = token not allowed)."""
        row = self._rows.get(state)
        if row is not None:
            return row
        lf = self.lifter
        V = lf.vocab_size
        states = np.full(V, state, np.int32)
        for pos in range(lf.tok_mat.shape[1]):
            live = (lf.tok_len > pos) & (states >= 0)
            if not live.any():
                break
            states[live] = self.dfa.trans[states[live], lf.tok_mat[live, pos]]
        states[lf.tok_len == 0] = -1  # empty tokens would loop forever
        with self._lock:
            while len(self._rows) >= _ROW_CACHE_MAX:
                self._rows.pop(next(iter(self._rows)))
            self._rows[state] = states
        return states

    def allowed(self, state: int) -> np.ndarray:
        """[V] bool sampling mask for a sequence in `state`."""
        mask = self._row(state) >= 0
        if self.dfa.accept[state] and 0 <= self.lifter.eos_id < len(mask):
            mask = mask.copy()
            mask[self.lifter.eos_id] = True
        return mask

    def advance(self, state: int, token: int) -> int:
        """State after sampling `token`. EOS (legal only in accepting
        states) is terminal: returns the state unchanged."""
        if token == self.lifter.eos_id:
            return state
        nxt = int(self._row(state)[token])
        if nxt < 0:
            raise ValueError(
                f"token {token} is not allowed in constraint state {state} "
                "(mask desync)"
            )
        return nxt

    def is_accepting(self, state: int) -> bool:
        return bool(self.dfa.accept[state])
