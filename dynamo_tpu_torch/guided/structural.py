"""Structural tags: free text with trigger-activated constrained regions.

Reference semantics (lib/llm/src/preprocessor/tools/ structural-tag
support): generation is unconstrained until the model emits a *trigger*
string (e.g. "<tool_call>"); from that point the output must complete
one of the trigger's *structures* — begin tag + constrained content +
end tag — after which generation is free again (and further structures
may fire). EOS is legal only outside a structure.

The whole thing is one regular language, compiled here into a single
byte DFA:

- free states = an Aho-Corasick automaton over the trigger set (PMA
  with failure links, completed into a dense goto table) — every byte
  is allowed, the state just tracks trigger progress; all free states
  accept;
- when a goto lands on a trigger match, the edge is REDIRECTED into
  that trigger's structure DFA (compiled from
  "(begin_tail content end | ...)" with begin_tail = begin minus the
  trigger prefix);
- structure accept states get the free-root's transitions grafted on
  (back to free text) and become accepting.

Triggers must be prefixes of their structures' begin tags (validated).
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

from dynamo_tpu_torch.guided.regex_dfa import ByteDFA, RegexError, compile_regex, escape
from dynamo_tpu_torch.guided.json_schema import WS, schema_to_regex


def _aho_corasick(patterns: List[bytes]):
    """Dense goto table for the pattern set: (goto [S,256] int32,
    match [S] int32 = index of the longest pattern ending here or -1)."""
    # trie
    children: List[Dict[int, int]] = [{}]
    match: List[int] = [-1]
    for pi, pat in enumerate(patterns):
        s = 0
        for b in pat:
            nxt = children[s].get(b)
            if nxt is None:
                nxt = len(children)
                children.append({})
                match.append(-1)
                children[s][b] = nxt
            s = nxt
        match[s] = pi
    # BFS failure links → dense goto
    S = len(children)
    goto = np.zeros((S, 256), np.int32)
    fail = [0] * S
    from collections import deque

    q = deque()
    for b in range(256):
        nxt = children[0].get(b)
        if nxt is None:
            goto[0, b] = 0
        else:
            goto[0, b] = nxt
            fail[nxt] = 0
            q.append(nxt)
    while q:
        s = q.popleft()
        if match[fail[s]] >= 0 and match[s] < 0:
            match[s] = match[fail[s]]  # suffix completes a pattern
        for b in range(256):
            nxt = children[s].get(b)
            if nxt is None:
                goto[s, b] = goto[fail[s], b]
            else:
                goto[s, b] = nxt
                fail[nxt] = int(goto[fail[s], b])
                q.append(nxt)
    return goto, np.asarray(match, np.int32)


def structure_pattern(struct: Dict[str, Any]) -> str:
    """One structure's content pattern: schema → regex (or a raw
    pattern passthrough)."""
    if "pattern" in struct:
        return struct["pattern"]
    schema = struct.get("schema", {"type": "object"})
    return schema_to_regex(schema)


def compile_structural(spec: Dict[str, Any]) -> ByteDFA:
    """spec: {"triggers": [str, ...],
              "structures": [{"begin": str, "schema"|"pattern": ...,
                              "end": str}, ...]}
    → composite byte DFA (see module docstring)."""
    triggers: List[str] = list(spec.get("triggers") or [])
    structures: List[Dict[str, Any]] = list(spec.get("structures") or [])
    if not triggers or not structures:
        raise RegexError("structural spec needs triggers and structures")

    trig_bytes = [t.encode("utf-8") for t in triggers]
    # per trigger: alternation over its structures' begin_tail+content+end
    per_trigger: List[str] = []
    for ti, trig in enumerate(triggers):
        alts = []
        for st in structures:
            begin = st.get("begin", "")
            if not begin.startswith(trig):
                continue
            tail = begin[len(trig):]
            alts.append(
                escape(tail) + WS + "(" + structure_pattern(st) + ")" + WS
                + escape(st.get("end", ""))
            )
        if not alts:
            raise RegexError(
                f"trigger {trig!r} matches no structure begin tag"
            )
        per_trigger.append("(" + "|".join(alts) + ")")

    goto, match = _aho_corasick(trig_bytes)
    n_free = goto.shape[0]

    sub: List[ByteDFA] = [compile_regex(p) for p in per_trigger]
    offs: List[int] = []
    total = n_free
    for d in sub:
        offs.append(total)
        total += d.n_states

    trans = np.full((total, 256), -1, np.int32)
    accept = np.zeros(total, bool)
    # free block: goto edges; redirect trigger-completing edges into subs
    trans[:n_free] = goto
    accept[:n_free] = True
    for s in range(n_free):
        for b in range(256):
            m = int(match[int(goto[s, b])])
            if m >= 0:
                trans[s, b] = offs[m] + sub[m].start
    # structure blocks
    for m, d in enumerate(sub):
        o = offs[m]
        blk = np.where(d.trans >= 0, d.trans + o, -1)
        trans[o : o + d.n_states] = blk
        for st in np.where(d.accept)[0]:
            row = trans[o + st]
            free_row = trans[0]  # free root (trigger tracking restarts)
            # graft: bytes the structure doesn't consume continue as free
            take = row < 0
            row[take] = free_row[take]
            accept[o + st] = True
    return ByteDFA(trans, accept, start=0)
