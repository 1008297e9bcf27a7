"""G2 host-DRAM KV block pool.

Port of dynamo_tpu/kvbm/host_pool.py (the reference's G2 tier:
content-addressed storage of complete KV blocks evicted from device
memory, onboarded back on prefix-cache hits). Blocks are CPU tensors
[L, PS, Hk, D], one token-major page per pool; device↔host movement goes
through the runner's export/import, the primitives the P→D path uses.
Capacity is bounded in blocks; eviction is LRU. The int8 tier codec
(`quantize`) and the byte budget (`capacity_bytes`) wait for quantization;
the G3 disk and G4 object tiers below this one wait too.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, List, Optional, Tuple

import torch


@dataclass
class HostBlock:
    block_hash: int
    parent_hash: Optional[int]
    k: torch.Tensor  # [L, PS, Hk, D] one token-major page
    v: torch.Tensor

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in (self.k, self.v))


class HostKvPool:
    def __init__(self, capacity_blocks: int = 4096):
        self.capacity = capacity_blocks
        self._blocks: "OrderedDict[int, HostBlock]" = OrderedDict()  # LRU
        self.stats = {"offloaded": 0, "onboarded": 0, "evicted": 0,
                      "stored_bytes": 0}
        self._evict_listeners: List[Any] = []

    def on_evict(self, cb) -> None:
        """cb(list[int]) — hashes dropped from the host tier."""
        self._evict_listeners.append(cb)

    def __contains__(self, block_hash: int) -> bool:
        return block_hash in self._blocks

    def __len__(self) -> int:
        return len(self._blocks)

    # -- offload (G1 → G2) --------------------------------------------------
    def put(
        self,
        hashes: List[int],
        parents: List[Optional[int]],
        k: torch.Tensor,  # [L, n, PS, Hk, D]
        v: torch.Tensor,
    ) -> None:
        for i, (h, p) in enumerate(zip(hashes, parents)):
            # one page's own storage: a block outlives the payload it came in
            self.put_block(h, p, k[:, i].clone(), v[:, i].clone())

    def put_block(self, block_hash: int, parent_hash: Optional[int],
                  k: torch.Tensor, v: torch.Tensor) -> None:
        """Store one dense [L, PS, Hk, D] page pair; a block already held
        only moves to the most-recently-used end."""
        if block_hash in self._blocks:
            self._blocks.move_to_end(block_hash)
            return
        block = HostBlock(block_hash, parent_hash, k, v)
        self._blocks[block_hash] = block
        self.stats["offloaded"] += 1
        self.stats["stored_bytes"] += block.nbytes
        self._enforce_capacity()

    def _enforce_capacity(self) -> None:
        dropped: List[int] = []
        while len(self._blocks) > self.capacity:
            victim, block = self._blocks.popitem(last=False)
            self.stats["stored_bytes"] -= block.nbytes
            dropped.append(victim)
            self.stats["evicted"] += 1
        if dropped:
            for cb in self._evict_listeners:
                cb(dropped)

    def clear(self) -> List[int]:
        """Drop every block (policy flush: the data is invalid). Fires
        removal events; returns the cleared hashes."""
        dropped = list(self._blocks)
        self._blocks.clear()
        self.stats["stored_bytes"] = 0
        if dropped:
            for cb in self._evict_listeners:
                cb(dropped)
        return dropped

    # -- onboard (G2 → G1) --------------------------------------------------
    def match(self, hashes: List[int]) -> int:
        """Leading blocks of `hashes` resident in this tier."""
        n = 0
        for h in hashes:
            if h not in self._blocks:
                break
            n += 1
        return n

    def get(self, hashes: List[int]) -> Tuple[torch.Tensor, torch.Tensor]:
        """Stacked dense [L, n, PS, Hk, D] pages. Raises KeyError if a
        block was evicted since the caller's match()."""
        blocks = [self._blocks[h] for h in hashes]
        for b in blocks:
            self._blocks.move_to_end(b.block_hash)
        self.stats["onboarded"] += len(blocks)
        k = torch.stack([b.k for b in blocks], dim=1)
        v = torch.stack([b.v for b in blocks], dim=1)
        return k, v
