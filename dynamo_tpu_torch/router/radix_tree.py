"""Lineage-hash block index.

Port of dynamo_tpu/router/radix_tree.py. Block hashes are lineage hashes
(each commits to its whole prefix, tokens/hashing.py), so the prefix tree
is a hash → node map with parent links: matching a request walks its hash
chain h0, h1, ... until a hash is unknown, keeping per-worker counts of
leading blocks held. The router's event mode uses the C++ index of
`native/block_index.py`; this one serves the TTL (approximate) mode and
the host-tier index.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from dynamo_tpu_torch.router.protocols import OverlapScores, RouterEvent

Worker = Tuple[int, int]


@dataclass
class _Node:
    block_hash: int
    parent_hash: Optional[int]
    workers: Set[Worker] = field(default_factory=set)
    children: Set[int] = field(default_factory=set)
    last_access: float = 0.0
    expires_at: Optional[float] = None  # approximate-mode TTL


class BlockIndex:
    def __init__(self):
        self.nodes: Dict[int, _Node] = {}
        self.worker_blocks: Dict[Worker, Set[int]] = {}

    # -- queries -----------------------------------------------------------
    def find_matches(self, block_hashes: List[int],
                     now: Optional[float] = None) -> OverlapScores:
        """Walk the lineage chain; a worker's score is the number of
        leading blocks it holds (a worker's chain has no holes: prefix
        caching registers blocks in order)."""
        now = now if now is not None else time.monotonic()
        scores: Dict[Worker, int] = {}
        alive: Set[Worker] = set()
        first = True
        for i, h in enumerate(block_hashes):
            node = self.nodes.get(h)
            if node is None or (node.expires_at is not None and node.expires_at < now):
                break
            node.last_access = now
            current = set(node.workers)
            if first:
                alive = current
                first = False
            else:
                alive = alive & current
            if not alive:
                break
            for w in alive:
                scores[w] = i + 1
        return OverlapScores(scores=scores, total_blocks=len(block_hashes))

    def worker_block_count(self, worker: Worker) -> int:
        return len(self.worker_blocks.get(worker, ()))

    # -- mutations ---------------------------------------------------------
    def apply_event(self, ev: RouterEvent, ttl: Optional[float] = None) -> None:
        worker = tuple(ev.worker)
        if ev.kind == "store":
            parent = ev.parent_hash
            expires = (time.monotonic() + ttl) if ttl else None
            for h in ev.block_hashes:
                node = self.nodes.get(h)
                if node is None:
                    node = _Node(block_hash=h, parent_hash=parent)
                    self.nodes[h] = node
                    if parent is not None and parent in self.nodes:
                        self.nodes[parent].children.add(h)
                node.workers.add(worker)
                node.expires_at = expires
                self.worker_blocks.setdefault(worker, set()).add(h)
                parent = h
        elif ev.kind == "remove":
            for h in ev.block_hashes:
                self._remove_worker_block(worker, h)
        elif ev.kind == "clear":
            self.remove_worker(worker)

    def _remove_worker_block(self, worker: Worker, h: int) -> None:
        node = self.nodes.get(h)
        if node is None:
            return
        node.workers.discard(worker)
        blocks = self.worker_blocks.get(worker)
        if blocks:
            blocks.discard(h)
        if not node.workers and not node.children:
            self._prune(h)

    def _prune(self, h: int) -> None:
        node = self.nodes.pop(h, None)
        if node is None:
            return
        if node.parent_hash is not None:
            parent = self.nodes.get(node.parent_hash)
            if parent is not None:
                parent.children.discard(h)
                if not parent.workers and not parent.children:
                    self._prune(parent.block_hash)

    def remove_worker(self, worker: Worker) -> None:
        """Worker left (lease expired): drop all its blocks."""
        for h in list(self.worker_blocks.get(worker, ())):
            self._remove_worker_block(worker, h)
        self.worker_blocks.pop(worker, None)

    def expire(self, now: Optional[float] = None) -> int:
        """Approximate mode: drop TTL-expired nodes; returns the count."""
        now = now if now is not None else time.monotonic()
        dead = [h for h, n in self.nodes.items() if n.expires_at is not None and n.expires_at < now]
        for h in dead:
            node = self.nodes.get(h)
            if node is None:
                continue
            for w in list(node.workers):
                self._remove_worker_block(w, h)
        return len(dead)

    def __len__(self) -> int:
        return len(self.nodes)
