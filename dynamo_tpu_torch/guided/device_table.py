"""Device-resident guided DFA: dense token-level transition + mask tables.

Copy of dynamo_tpu/guided/device_table.py. `token_mask.GuidedMatcher`
answers "which tokens may follow state s" one row at a time, on the
host, which inside the fused decode loop means a host round trip per
step (the DFA must advance between steps the host never sees). This
module compiles the whole matcher down to two dense arrays so the
advance and the mask gather happen on the device:

- ``trans`` int32 ``[S+1, V]`` - token-level transition table. Row ``s``
  column ``t`` is the state after sampling token ``t`` in state ``s``;
  ``DEAD`` (== S, the last row) encodes every way a row leaves the
  constraint: the token was banned (desync), the token was EOS
  (terminal), or the row was never guided at all. ``DEAD`` self-loops
  and its mask row is all-True, mirroring ``GuidedMaskContext``'s
  ``alive=False`` rows.
- ``mask`` bool ``[S+1, V]`` - the sampling mask per state, with the
  same degrade rule as the host path: EOS is legal exactly in accepting
  states, and a state that allows nothing at all force-allows EOS so the
  row stops instead of sampling garbage.

Both tables are a function of (matcher, vocab) only, so they are built
once per compiled constraint and the runner keeps them staged on the
device across every dispatch that uses the schema.

The build is refused (``None``) past ``max_elems`` total table cells:
an unbounded-state schema would cost S*V*5 bytes of device memory; the
caller keeps the host mask callback for those, with a warn-once.

numpy-only on purpose; the device staging of these arrays lives in the
runner.
"""

from __future__ import annotations

import os
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np

from dynamo_tpu_torch.guided.token_mask import GuidedMatcher

# Cell budget for one schema's [S, V] tables (~5 bytes/cell: int32 trans
# + bool mask). The default admits S*V <= 8M — at a 128k vocab that is
# 64 DFA states (tool-call/enum/JSON-shape schemas), at test vocabs it
# is effectively unbounded. Env-tunable for bigger device-memory budgets.
DEVICE_TABLE_MAX_ELEMS = int(
    os.environ.get("DYN_GUIDED_DEVICE_MAX_ELEMS", str(8 << 20))
)

_uid_lock = threading.Lock()
_uid_next = [1]


class DeviceGuidedTable:
    """One schema's dense token-level DFA, host-built, ready to stage.

    ``trans``/``mask`` are ``[S+1, V]`` with the DEAD row last (see
    module docstring). ``uid`` keys the runner's staged-combination
    cache (object identity is unstable across rebuilds; uids are not).
    """

    def __init__(self, trans: np.ndarray, mask: np.ndarray, start: int,
                 eos_id: int):
        assert trans.shape == mask.shape and trans.ndim == 2
        self.trans = trans  # int32 [S+1, V], DEAD row last
        self.mask = mask  # bool [S+1, V]
        self.start = int(start)
        self.eos_id = int(eos_id)
        self.n_states = int(trans.shape[0]) - 1  # excluding DEAD
        self.vocab_size = int(trans.shape[1])
        with _uid_lock:
            self.uid = _uid_next[0]
            _uid_next[0] += 1

    @property
    def dead(self) -> int:
        return self.n_states

    def nbytes(self) -> int:
        return int(self.trans.nbytes + self.mask.nbytes)


def build_device_table(
    matcher: GuidedMatcher, max_elems: Optional[int] = None
) -> Optional[DeviceGuidedTable]:
    """Compile a GuidedMatcher to a DeviceGuidedTable, or None when the
    schema's S*V cell count exceeds the budget (the caller falls back to
    the host mask callback).

    Vectorized over (S, V) jointly: the same byte-position walk
    `GuidedMatcher._row` does for one state, run for every state at
    once. Byte-identical to the host path by construction — the mask
    table IS `matcher.allowed(s)` (plus the force-EOS degrade of
    `GuidedMaskContext._row_mask`) for every live state, and the
    transition table agrees with `matcher.advance` wherever the host
    path would not raise/deactivate."""
    dfa = matcher.dfa
    lf = matcher.lifter
    S = int(dfa.trans.shape[0])
    V = int(lf.vocab_size)
    budget = DEVICE_TABLE_MAX_ELEMS if max_elems is None else int(max_elems)
    if S * V > budget:
        return None

    # token-level transition for ALL states at once: walk every (state,
    # token) pair through the token's bytes
    states = np.repeat(np.arange(S, dtype=np.int32)[:, None], V, axis=1)
    tok_len = lf.tok_len[None, :]  # [1, V]
    for pos in range(lf.tok_mat.shape[1]):
        live = (tok_len > pos) & (states >= 0)
        if not live.any():
            break
        byte_col = np.repeat(lf.tok_mat[None, :, pos], S, axis=0)
        states[live] = dfa.trans[states[live], byte_col[live]]
    states[:, lf.tok_len == 0] = -1  # empty tokens would loop forever

    mask = states >= 0
    eos = lf.eos_id
    if 0 <= eos < V:
        mask[dfa.accept.astype(bool), eos] = True
        # degrade rule: a state allowing nothing force-allows EOS
        # (matches Engine._guided_mask / GuidedMaskContext._row_mask)
        dead_end = ~mask.any(axis=1)
        mask[dead_end, eos] = True
        # EOS is terminal: the row goes all-True afterwards (host sets
        # alive=False) — encode as a transition to DEAD
        states[:, eos] = -1

    dead = S
    trans_full = np.where(states >= 0, states, dead).astype(np.int32)
    trans_full = np.concatenate(
        [trans_full, np.full((1, V), dead, np.int32)], axis=0
    )
    mask_full = np.concatenate([mask, np.ones((1, V), bool)], axis=0)
    return DeviceGuidedTable(trans_full, mask_full, dfa.start, eos)


def combine_tables(
    tables: Sequence[DeviceGuidedTable],
) -> Tuple[np.ndarray, np.ndarray, List[int]]:
    """Stack several schemas' tables into ONE pair of device operands so
    a mixed batch (rows under different constraints) still gathers from
    a single ``[G, V]`` table — per-row states become global indices
    ``offset[i] + local_state``. Returns (trans [G, V], mask [G, V],
    offsets) with one shared DEAD row last; local DEAD entries are
    remapped to it. The common one-schema batch passes through with a
    trivial offset."""
    assert tables, "combine_tables needs at least one table"
    V = tables[0].vocab_size
    total = sum(t.n_states for t in tables)
    dead = total  # one shared DEAD row
    trans = np.empty((total + 1, V), np.int32)
    mask = np.empty((total + 1, V), bool)
    offsets: List[int] = []
    o = 0
    for t in tables:
        assert t.vocab_size == V, "mixed vocab sizes in one guided batch"
        s = t.n_states
        local = t.trans[:s]  # drop the per-table DEAD row
        trans[o : o + s] = np.where(local >= t.dead, dead, local + o)
        mask[o : o + s] = t.mask[:s]
        offsets.append(o)
        o += s
    trans[dead] = dead
    mask[dead] = True
    return trans, mask, offsets
