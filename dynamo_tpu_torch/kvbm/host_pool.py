"""G2 host-DRAM KV block pool.

Port of dynamo_tpu/kvbm/host_pool.py (the reference's G2 tier:
content-addressed storage of complete KV blocks evicted from device
memory, onboarded back on prefix-cache hits). Blocks are CPU tensors
[L, PS, Hk, D], one token-major page per pool, or with `quantize` the
int8 tier codec's dicts (kvbm/quant.py, ~1.94x the blocks a byte at D
128); `get` hands back dense tensors, `get_block_raw` the stored form.
Capacity is bounded in blocks and optionally in bytes
(`capacity_bytes`); eviction is LRU and skips blocks pinned by a
prefetch promotion. A `spill_hook` receives each block the LRU drops,
so a lower tier (G3 disk, G4 objects; kvbm/disk_pool.py TieredKv) can
absorb it. Device<->host movement is the runner's (its host blocks,
pinned up to a cap, and the block-copy kernels).
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, List, Optional, Tuple

import torch

from .quant import (
    block_nbytes,
    is_quantized_block,
    maybe_dequantize,
    maybe_quantize,
    stacked_to_blocks,
)


@dataclass
class HostBlock:
    block_hash: int
    parent_hash: Optional[int]
    k: Any  # [L, PS, Hk, D] one token-major page, or a quantized dict
    v: Any

    @property
    def nbytes(self) -> int:
        return block_nbytes(self.k) + block_nbytes(self.v)


class HostKvPool:
    def __init__(self, capacity_blocks: int = 4096, quantize: bool = False,
                 capacity_bytes: Optional[int] = None):
        self.capacity = capacity_blocks
        self.capacity_bytes = capacity_bytes
        self.quantize = quantize
        self._blocks: "OrderedDict[int, HostBlock]" = OrderedDict()  # LRU
        self.stats = {"offloaded": 0, "onboarded": 0, "evicted": 0,
                      "stored_bytes": 0, "quant_blocks": 0}
        self._evict_listeners: List[Any] = []
        # demotion: called with the HostBlock before an LRU drop
        self.spill_hook: Optional[Any] = None
        # prefetch pins: hashes capacity enforcement must not drop while a
        # promotion reads them (capacity may overshoot until they release)
        self._pinned: set = set()

    def pin(self, block_hash: int) -> None:
        self._pinned.add(block_hash)

    def unpin(self, block_hash: int) -> None:
        self._pinned.discard(block_hash)

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
        k: Optional[torch.Tensor],  # [L, n, PS, Hk, D]
        v: Optional[torch.Tensor],
    ) -> None:
        for i, (h, p) in enumerate(zip(hashes, parents)):
            # a contiguous page: a copy of its own unless the stack holds
            # one page (the offload's, whose tensors are handed over)
            kb, vb = stacked_to_blocks(k, v, i)
            self.put_block(h, p, kb, vb)
        self._enforce_capacity()

    def put_block(self, block_hash: int, parent_hash: Optional[int],
                  k: Any, v: Any) -> None:
        """Store one block: a dense [L, PS, Hk, D] page pair (kept as
        given: the caller hands over storage of its own) or quantized
        dicts (a promotion from a quantized lower tier is not quantized
        again). A block already held only moves to the most-recently-used
        end."""
        if block_hash in self._blocks:
            self._blocks.move_to_end(block_hash)
            return
        if self.quantize:
            k, v = maybe_quantize(k), maybe_quantize(v)
        block = HostBlock(block_hash, parent_hash, k, v)
        self._blocks[block_hash] = block
        self.stats["offloaded"] += 1
        self.stats["stored_bytes"] += block.nbytes
        if is_quantized_block(k):
            self.stats["quant_blocks"] += 1
        self._enforce_capacity()

    def _over_budget(self) -> bool:
        if len(self._blocks) > self.capacity:
            return True
        return (self.capacity_bytes is not None
                and self.stats["stored_bytes"] > self.capacity_bytes)

    def _enforce_capacity(self) -> None:
        dropped: List[int] = []
        while self._over_budget():
            # LRU order, skipping pinned blocks; all pinned: overshoot
            victim = next((h for h in self._blocks if h not in self._pinned), None)
            if victim is None:
                break
            block = self._blocks.pop(victim)
            self.stats["stored_bytes"] -= block.nbytes
            if is_quantized_block(block.k):
                self.stats["quant_blocks"] -= 1
            if self.spill_hook is not None:
                self.spill_hook(block)
            dropped.append(victim)
            self.stats["evicted"] += 1
        if dropped:
            for cb in self._evict_listeners:
                cb(dropped)

    def clear(self) -> List[int]:
        """Drop every block without spilling (policy flush: the data is
        invalid). Fires removal events; returns the cleared hashes."""
        dropped = list(self._blocks)
        self._blocks.clear()
        self._pinned.clear()
        self.stats["stored_bytes"] = 0
        self.stats["quant_blocks"] = 0
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

    def get_blocks(self, hashes: List[int]) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """Each block's dense (k, v) [L, PS, Hk, D] (quantized blocks
        dequantized into their recorded dtype), LRU-touched. Raises
        KeyError if a block was evicted since the caller's match()."""
        blocks = [self._blocks[h] for h in hashes]
        for b in blocks:
            self._blocks.move_to_end(b.block_hash)
        self.stats["onboarded"] += len(blocks)
        return [(maybe_dequantize(b.k), maybe_dequantize(b.v)) for b in blocks]

    def get(self, hashes: List[int]) -> Tuple[torch.Tensor, torch.Tensor]:
        """Stacked dense [L, n, PS, Hk, D] pages."""
        pairs = self.get_blocks(hashes)
        return (torch.stack([p[0] for p in pairs], dim=1),
                torch.stack([p[1] for p in pairs], dim=1))

    def get_block_raw(self, block_hash: int) -> Tuple[Any, Any]:
        """One block's (k, v) as stored (quantized dicts when the tier
        quantizes): the int8 pools' pass-through onboard reads this.
        Raises KeyError if evicted since the caller's match()."""
        b = self._blocks[block_hash]
        self._blocks.move_to_end(block_hash)
        self.stats["onboarded"] += 1
        return b.k, b.v

    def lookup_chain(self, hashes: List[int]) -> List[int]:
        return [h for h in hashes if h in self._blocks]
