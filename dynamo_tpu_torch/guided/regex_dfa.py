"""Byte-level regex → DFA compiler for constrained generation.

Supports the subset JSON-schema compilation emits (and typical
user-supplied guided_regex patterns): literals, `.`, character classes
(ranges, negation, class escapes), groups, alternation, `* + ?` and
bounded `{m}`/`{m,n}`/`{m,}` repetition. Operates on BYTES: non-ASCII
literal characters compile to their UTF-8 byte sequence, and negated
classes / `.` admit all bytes (so arbitrary UTF-8 content streams
through byte-by-byte — the right semantics for generation masks).

Pipeline: parse → Thompson NFA → subset construction over byte
equivalence classes → dense DFA table [S, 256] int32 (-1 = reject),
pruned so every surviving state can still reach an acceptor (no dead
ends: a sampled prefix can always be completed).
"""

from __future__ import annotations

from typing import Dict, FrozenSet, List, Optional, Tuple

import numpy as np

_ALL = frozenset(range(256))
_DIGIT = frozenset(range(0x30, 0x3A))
_WORD = _DIGIT | frozenset(range(0x41, 0x5B)) | frozenset(range(0x61, 0x7B)) | {0x5F}
_SPACE = frozenset(b" \t\n\r\f\v")
_CLASS_ESC = {
    "d": _DIGIT, "D": _ALL - _DIGIT,
    "w": _WORD, "W": _ALL - _WORD,
    "s": _SPACE, "S": _ALL - _SPACE,
}
_CHAR_ESC = {"n": 0x0A, "r": 0x0D, "t": 0x09, "f": 0x0C, "v": 0x0B, "0": 0x00}


class RegexError(ValueError):
    pass


# -- AST ----------------------------------------------------------------------
# ("lit", frozenset[int])  one byte from the set
# ("seq", [nodes])
# ("alt", [nodes])
# ("rep", node, m, n|None)  m..n repetitions (None = unbounded)


class _Parser:
    def __init__(self, pattern: str):
        self.p = pattern
        self.i = 0
        # per-instance (NOT class-level): a shared set mutated in place
        # would leak character-class escapes across concurrently compiled
        # patterns, silently corrupting their DFAs
        self._cls_extra: set = set()

    def peek(self) -> Optional[str]:
        return self.p[self.i] if self.i < len(self.p) else None

    def next(self) -> str:
        c = self.p[self.i]
        self.i += 1
        return c

    def parse(self):
        node = self._alt()
        if self.i != len(self.p):
            raise RegexError(f"unexpected {self.p[self.i]!r} at {self.i}")
        return node

    def _alt(self):
        branches = [self._seq()]
        while self.peek() == "|":
            self.next()
            branches.append(self._seq())
        return branches[0] if len(branches) == 1 else ("alt", branches)

    def _seq(self):
        items = []
        while (c := self.peek()) is not None and c not in "|)":
            items.append(self._quantified())
        if len(items) == 1:
            return items[0]
        return ("seq", items)

    def _quantified(self):
        atom = self._atom()
        c = self.peek()
        if c == "*":
            self.next()
            return ("rep", atom, 0, None)
        if c == "+":
            self.next()
            return ("rep", atom, 1, None)
        if c == "?":
            self.next()
            return ("rep", atom, 0, 1)
        if c == "{":
            save = self.i
            self.next()
            spec = ""
            while (c := self.peek()) is not None and c != "}":
                spec += self.next()
            if self.peek() != "}" or not _valid_repeat(spec):
                # not a quantifier — treat '{' as a literal (JSON braces)
                self.i = save
                return atom
            self.next()
            if "," in spec:
                lo, hi = spec.split(",", 1)
                m = int(lo)
                n = None if hi == "" else int(hi)
            else:
                m = n = int(spec)
            if n is not None and n < m:
                raise RegexError(f"bad repeat {{{spec}}}")
            return ("rep", atom, m, n)
        return atom

    def _atom(self):
        c = self.next()
        if c in "^$":
            # anchors are zero-width no-ops: the DFA always fullmatches
            # (vLLM/outlines-style guided_regex patterns routinely anchor)
            return ("seq", [])
        if c == "(":
            if self.p[self.i : self.i + 2] == "?:":
                self.i += 2
            node = self._alt()
            if self.peek() != ")":
                raise RegexError("unbalanced (")
            self.next()
            return node
        if c == "[":
            return ("lit", self._char_class())
        if c == ".":
            return ("lit", _ALL - {0x0A})
        if c == "\\":
            return self._escape()
        if c in "*+?":
            raise RegexError(f"dangling quantifier {c!r}")
        return _char_lit(c)

    def _escape(self):
        c = self.next()
        if c in _CLASS_ESC:
            return ("lit", _CLASS_ESC[c])
        if c in _CHAR_ESC:
            return ("lit", frozenset({_CHAR_ESC[c]}))
        if c == "x":
            h = self.next() + self.next()
            return ("lit", frozenset({int(h, 16)}))
        return _char_lit(c)  # escaped punctuation: \. \[ \{ \\ ...

    def _char_class(self):
        neg = False
        if self.peek() == "^":
            self.next()
            neg = True
        out: set = set()
        first = True
        while True:
            c = self.peek()
            if c is None:
                raise RegexError("unterminated [")
            if c == "]" and not first:
                self.next()
                break
            first = False
            lo = self._class_char()
            if lo is None:  # class escape like \d inside [...]
                continue
            if self.peek() == "-" and self.p[self.i + 1 : self.i + 2] not in ("]", ""):
                self.next()
                hi = self._class_char()
                if hi is None or hi < lo:
                    raise RegexError("bad range in class")
                out.update(range(lo, hi + 1))
            else:
                out.add(lo)
        # class escapes accumulate in self._cls_extra
        if self._cls_extra:
            out.update(self._cls_extra)
            self._cls_extra = set()
        s = frozenset(out)
        return _ALL - s if neg else s

    def _class_char(self) -> Optional[int]:
        c = self.next()
        if c == "\\":
            e = self.next()
            if e in _CLASS_ESC:
                self._cls_extra = set(self._cls_extra) | set(_CLASS_ESC[e])
                return None
            if e in _CHAR_ESC:
                return _CHAR_ESC[e]
            if e == "x":
                return int(self.next() + self.next(), 16)
            b = e.encode("utf-8")
            if len(b) != 1:
                raise RegexError("non-ASCII char in class")
            return b[0]
        b = c.encode("utf-8")
        if len(b) != 1:
            raise RegexError("non-ASCII char in class (use literals outside classes)")
        return b[0]


def _valid_repeat(spec: str) -> bool:
    if "," in spec:
        lo, hi = spec.split(",", 1)
        return lo.isdigit() and (hi == "" or hi.isdigit())
    return spec.isdigit()


def _char_lit(c: str):
    b = c.encode("utf-8")
    if len(b) == 1:
        return ("lit", frozenset({b[0]}))
    return ("seq", [("lit", frozenset({x})) for x in b])


def escape(text: str) -> str:
    """Escape a literal string for embedding in a pattern."""
    return "".join(
        "\\" + c if c in ".\\()[]{}|*+?^$" else c for c in text
    )


# -- NFA ----------------------------------------------------------------------


class _NFA:
    def __init__(self):
        self.n = 0
        self.eps: List[List[int]] = []
        self.edges: List[List[Tuple[FrozenSet[int], int]]] = []

    def state(self) -> int:
        self.eps.append([])
        self.edges.append([])
        self.n += 1
        return self.n - 1

    def add(self, a: int, byteset: FrozenSet[int], b: int) -> None:
        self.edges[a].append((byteset, b))

    def add_eps(self, a: int, b: int) -> None:
        self.eps[a].append(b)


def _build(nfa: _NFA, node) -> Tuple[int, int]:
    kind = node[0]
    if kind == "lit":
        a, b = nfa.state(), nfa.state()
        if not node[1]:
            raise RegexError("empty character class")
        nfa.add(a, node[1], b)
        return a, b
    if kind == "seq":
        if not node[1]:
            a = nfa.state()
            return a, a
        a, b = _build(nfa, node[1][0])
        for item in node[1][1:]:
            c, d = _build(nfa, item)
            nfa.add_eps(b, c)
            b = d
        return a, b
    if kind == "alt":
        a, b = nfa.state(), nfa.state()
        for br in node[1]:
            c, d = _build(nfa, br)
            nfa.add_eps(a, c)
            nfa.add_eps(d, b)
        return a, b
    if kind == "rep":
        _, inner, m, n = node
        a = nfa.state()
        cur = a
        for _ in range(m):
            c, d = _build(nfa, inner)
            nfa.add_eps(cur, c)
            cur = d
        if n is None:  # unbounded tail: one loop block
            c, d = _build(nfa, inner)
            nfa.add_eps(cur, c)
            nfa.add_eps(d, c)
            end = nfa.state()
            nfa.add_eps(cur, end)
            nfa.add_eps(d, end)
            return a, end
        end = nfa.state()
        nfa.add_eps(cur, end)
        for _ in range(n - m):
            c, d = _build(nfa, inner)
            nfa.add_eps(cur, c)
            cur = d
            nfa.add_eps(cur, end)
        return a, end
    raise RegexError(f"bad node {kind}")


# -- DFA ----------------------------------------------------------------------


class ByteDFA:
    """Dense byte-transition table. `trans[s, b]` = next state or -1;
    `accept[s]` marks states where the match may end (EOS is legal)."""

    def __init__(self, trans: np.ndarray, accept: np.ndarray, start: int = 0):
        self.trans = trans  # [S, 256] int32
        self.accept = accept  # [S] bool
        self.start = start

    @property
    def n_states(self) -> int:
        return self.trans.shape[0]

    def matches(self, data: bytes) -> bool:
        s = self.start
        for b in data:
            s = int(self.trans[s, b])
            if s < 0:
                return False
        return bool(self.accept[s])

    def to_wire(self) -> Dict[str, object]:
        return {
            "trans": self.trans.astype(np.int32).tobytes(),
            "n_states": int(self.n_states),
            "accept": np.packbits(self.accept).tobytes(),
            "start": int(self.start),
        }

    @classmethod
    def from_wire(cls, d: Dict[str, object]) -> "ByteDFA":
        S = int(d["n_states"])
        trans = np.frombuffer(d["trans"], np.int32).reshape(S, 256).copy()
        accept = np.unpackbits(
            np.frombuffer(d["accept"], np.uint8), count=S
        ).astype(bool)
        return cls(trans, accept, int(d["start"]))


def _eps_closure(nfa: _NFA, states: FrozenSet[int]) -> FrozenSet[int]:
    stack = list(states)
    seen = set(states)
    while stack:
        s = stack.pop()
        for t in nfa.eps[s]:
            if t not in seen:
                seen.add(t)
                stack.append(t)
    return frozenset(seen)


def _byte_classes(nfa: _NFA) -> Tuple[np.ndarray, int]:
    """Partition 0..255 into equivalence classes: bytes that fall in
    exactly the same edge bytesets transition identically, so subset
    construction runs over ~10-40 columns instead of 256."""
    uniq = {byteset for edges in nfa.edges for (byteset, _) in edges}
    if not uniq:
        return np.zeros(256, np.int32), 1
    M = np.zeros((len(uniq), 256), bool)
    for i, byteset in enumerate(uniq):
        M[i, list(byteset)] = True
    _, cls = np.unique(M, axis=1, return_inverse=True)
    return cls.astype(np.int32), int(cls.max()) + 1


def compile_regex(pattern: str, max_states: int = 20000) -> ByteDFA:
    """pattern → pruned byte DFA. Raises RegexError on unsupported syntax
    or state blow-up (protects the worker from pathological schemas)."""
    nfa = _NFA()
    start, end = _build(nfa, _Parser(pattern).parse())
    accept_nfa = end

    cls_of, n_cls = _byte_classes(nfa)
    # representative byte per class
    rep = np.zeros(n_cls, np.int32)
    for c in range(n_cls):
        rep[c] = int(np.argmax(cls_of == c))

    init = _eps_closure(nfa, frozenset({start}))
    index: Dict[FrozenSet[int], int] = {init: 0}
    order = [init]
    rows: List[List[int]] = []
    i = 0
    while i < len(order):
        cur = order[i]
        i += 1
        row = [-1] * n_cls
        for c in range(n_cls):
            b = int(rep[c])
            nxt = set()
            for s in cur:
                for byteset, t in nfa.edges[s]:
                    if b in byteset:
                        nxt.add(t)
            if nxt:
                closed = _eps_closure(nfa, frozenset(nxt))
                j = index.get(closed)
                if j is None:
                    j = len(order)
                    if j >= max_states:
                        raise RegexError(
                            f"DFA exceeds {max_states} states — simplify the "
                            "pattern/schema"
                        )
                    index[closed] = j
                    order.append(closed)
                row[c] = j
        rows.append(row)

    S = len(order)
    trans_c = np.asarray(rows, np.int32)  # [S, n_cls]
    accept = np.asarray([accept_nfa in st for st in order], bool)

    # prune states that cannot reach an acceptor (reverse BFS)
    co = accept.copy()
    changed = True
    while changed:
        changed = False
        reach = co[np.where(trans_c >= 0, trans_c, 0)] & (trans_c >= 0)
        new = co | reach.any(axis=1)
        if (new != co).any():
            co = new
            changed = True
    if not co[0]:
        raise RegexError("pattern matches nothing")
    remap = -np.ones(S, np.int32)
    remap[co] = np.arange(int(co.sum()), dtype=np.int32)
    trans_c = np.where(trans_c >= 0, remap[np.where(trans_c >= 0, trans_c, 0)], -1)
    trans_c = trans_c[co]
    accept = accept[co]

    trans = trans_c[:, cls_of]  # expand classes → full 256 columns
    return ByteDFA(np.ascontiguousarray(trans), accept, int(remap[0]))
