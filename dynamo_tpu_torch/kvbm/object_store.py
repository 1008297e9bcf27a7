"""G4 object-store KV tier.

Port of dynamo_tpu/kvbm/object_store.py `FsBackend` and `ObjectKvPool`:
the bottom rung of the ladder. Blocks evicted from the disk tier (or
from the host tier when there is no disk tier) demote into a store keyed
by content hash, `<hash:016x>.kvb`, in the G3 file format
(kvbm/disk_pool.py `encode_block`), so any worker sharing the store can
onboard a prefix another worker computed. Writes and promotion reads run
on the pool's writer thread. The reference's `S3Backend` (boto3 and a
network) is not ported.
"""

from __future__ import annotations

import logging
import os
import queue
import struct
import threading
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

from .disk_pool import BlockLayoutMismatch, decode_block, encode_block
from .quant import is_quantized_block, maybe_quantize, pair_nbytes

log = logging.getLogger("dynamo_tpu_torch.kvbm.object")


class FsBackend:
    """Object store over a (shared) filesystem directory."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, key: str) -> str:
        return os.path.join(self.root, key)

    def put(self, key: str, data: bytes) -> None:
        tmp = self._path(key) + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, self._path(key))

    def get(self, key: str) -> Optional[bytes]:
        try:
            with open(self._path(key), "rb") as f:
                return f.read()
        except FileNotFoundError:
            return None

    def delete(self, key: str) -> None:
        try:
            os.unlink(self._path(key))
        except FileNotFoundError:
            pass

    def exists(self, key: str) -> bool:
        return os.path.exists(self._path(key))

    def list_keys(self) -> List[str]:
        return [n for n in os.listdir(self.root) if n.endswith(".kvb")]


class ObjectKvPool:
    """Content-addressed KV blocks in an object store, with DiskKvPool's
    surface so TieredKv chains it as the terminal tier. Capacity is LRU in
    blocks and bounds the local index only: the store is shared, so
    nothing is deleted from it."""

    def __init__(self, backend, capacity_blocks: int = 1 << 20,
                 quantize: bool = False, dedup: bool = True):
        self.backend = backend
        self.capacity = capacity_blocks
        # quantize dense blocks on entry (blocks from quantized upper
        # tiers arrive quantized already)
        self.quantize = quantize
        # fleet-wide dedup: a block whose object a peer already stored is
        # adopted instead of uploaded again (content-addressed keys)
        self.dedup = dedup
        self._blocks: "OrderedDict[int, Optional[int]]" = OrderedDict()
        self.stats = {"offloaded": 0, "onboarded": 0, "evicted": 0,
                      "stored_bytes": 0, "quant_blocks": 0,
                      "dedup_hits": 0, "dedup_bytes_saved": 0}
        self._evict_listeners: List[Any] = []
        # called with (hash, parent) when a block becomes locally indexed
        # (write queued or dedup-adopted): the engine forwards it as a
        # tier="obj" KV event. May fire from the spill or writer thread,
        # so the listener posts to the engine's inbox.
        self.store_listener = None
        self._lock = threading.Lock()
        self._hash_only: set = set()  # entries with no data behind them
        self._pending: Dict[int, Tuple[Any, Any, Optional[int]]] = {}
        # prefetch pins: hashes capacity enforcement must not drop while a
        # promotion read is queued or in flight
        self._pinned: set = set()
        self._write_q: "queue.Queue" = queue.Queue()
        self._writer = threading.Thread(target=self._write_loop, daemon=True,
                                        name="kv-g4-writer")
        self._writer.start()
        # adopt the objects already in the store (another worker's blocks)
        for key in backend.list_keys():
            try:
                self._blocks[int(key[:-4], 16)] = None
            except ValueError:
                continue
        if self._blocks:
            log.info("G4 adopted %d existing objects", len(self._blocks))

    def pin(self, block_hash: int) -> None:
        with self._lock:
            self._pinned.add(block_hash)

    def unpin(self, block_hash: int) -> None:
        with self._lock:
            self._pinned.discard(block_hash)

    def _key(self, block_hash: int) -> str:
        return f"{block_hash & 0xFFFFFFFFFFFFFFFF:016x}.kvb"

    def clear(self) -> List[int]:
        """Policy flush: drop the local index and pending writes (stored
        objects stay; the store's operator collects them)."""
        with self._lock:
            dropped = list(self._blocks)
            self._blocks.clear()
            self._hash_only.clear()
            self._pending.clear()
            self._pinned.clear()
        if dropped:
            for cb in self._evict_listeners:
                cb(dropped)
        return dropped

    def on_evict(self, cb) -> None:
        self._evict_listeners.append(cb)

    def __contains__(self, h: int) -> bool:
        with self._lock:
            return h in self._blocks

    def __len__(self) -> int:
        with self._lock:
            return len(self._blocks)

    def put_block(self, block_hash, parent_hash, k, v) -> None:
        if self.quantize:
            k, v = maybe_quantize(k), maybe_quantize(v)
        deduped = False
        with self._lock:
            if block_hash in self._blocks:
                self._blocks.move_to_end(block_hash)
                # a data-less entry upgrades when data arrives; entries
                # with data are final
                if k is None or block_hash not in self._hash_only:
                    return
                self._hash_only.discard(block_hash)
            else:
                self._blocks[block_hash] = parent_hash
                self.stats["offloaded"] += 1
        # the dedup probe outside the lock (backend IO): an object with
        # this key is this block
        if k is not None and self.dedup and self.backend.exists(self._key(block_hash)):
            deduped = True
        with self._lock:
            if block_hash not in self._blocks:
                return  # evicted during the probe
            if deduped:
                self._hash_only.discard(block_hash)
                self.stats["dedup_hits"] += 1
                self.stats["dedup_bytes_saved"] += pair_nbytes(k, v)
            elif k is not None:
                self._pending[block_hash] = (k, v, parent_hash)
                self.stats["stored_bytes"] += pair_nbytes(k, v)
                if is_quantized_block(k):
                    self.stats["quant_blocks"] += 1
            else:
                self._hash_only.add(block_hash)
        if k is not None and not deduped:
            self._write_q.put(block_hash)
        if self.store_listener is not None:
            try:
                self.store_listener(block_hash, parent_hash)
            except Exception:
                log.exception("G4 store listener failed for %x", block_hash)
        self._enforce_capacity()

    def _write_loop(self) -> None:
        while True:
            item = self._write_q.get()
            if item is None:
                return
            if isinstance(item, tuple) and item[0] == "read":
                self._read_item(*item[1:])
                continue
            h = item
            with self._lock:
                entry = self._pending.get(h)
            if entry is None:
                continue
            k, v, parent = entry
            try:
                self.backend.put(self._key(h), encode_block(parent, k, v))
            except Exception:
                log.exception("G4 write failed for %x", h)
                with self._lock:
                    self._blocks.pop(h, None)
            finally:
                with self._lock:
                    self._pending.pop(h, None)

    def _read_item(self, h: int, parent, cb) -> None:
        """Writer thread: an async promotion read (G4 -> G2 prefetch)."""
        with self._lock:
            present = h in self._blocks
            pending = self._pending.get(h)
            hash_only = h in self._hash_only
        k = v = None
        if present and pending is not None:
            k, v = pending[0], pending[1]
        elif present and not hash_only:
            try:
                k, v = self.get_block(h)
            except KeyError:
                present = False
            except Exception:
                log.exception("G4 async read failed for %x", h)
                k = v = None
        try:
            cb(h, parent, k, v, present)
        except Exception:
            log.exception("G4 read callback failed for %x", h)

    def flush(self, timeout: float = 60.0) -> None:
        """Wait until every queued write is in the store."""
        deadline = time.monotonic() + timeout
        while True:
            with self._lock:
                if not self._pending:
                    return
            if time.monotonic() > deadline:
                raise TimeoutError("G4 writer did not drain")
            time.sleep(0.005)

    def _enforce_capacity(self) -> None:
        dropped: List[int] = []
        with self._lock:
            while len(self._blocks) > self.capacity:
                # LRU order, skipping pinned blocks; all pinned: overshoot
                h = next((b for b in self._blocks if b not in self._pinned), None)
                if h is None:
                    break
                self._blocks.pop(h)
                self._pending.pop(h, None)
                self._hash_only.discard(h)
                dropped.append(h)
                self.stats["evicted"] += 1
        if dropped:
            for cb in self._evict_listeners:
                cb(dropped)

    def match(self, hashes: List[int]) -> int:
        n = 0
        with self._lock:
            for h in hashes:
                if h not in self._blocks:
                    break
                n += 1
        return n

    def get_block(self, block_hash: int):
        """One block's (k, v) as stored; (None, None) for a missing,
        stale-layout or corrupt object (a data miss: the onboard
        recomputes). Raises KeyError if the block left the index."""
        with self._lock:
            self._blocks.move_to_end(block_hash)  # KeyError if gone
            pending = self._pending.get(block_hash)
        self.stats["onboarded"] += 1
        if pending is not None:
            return pending[0], pending[1]
        data = self.backend.get(self._key(block_hash))
        if data is None:
            return None, None
        try:
            _, k, v = decode_block(data)
        except BlockLayoutMismatch:
            log.warning("G4 object %x has a stale block layout; ignoring", block_hash)
            return None, None
        except (KeyError, ValueError, struct.error):
            # truncated or corrupt: drop the local entry so it stops
            # matching; the object stays (the store's GC policy)
            log.warning("G4 object %x truncated/corrupt; ignoring",
                        block_hash, exc_info=True)
            with self._lock:
                self._blocks.pop(block_hash, None)
                self._pinned.discard(block_hash)
            return None, None
        return k, v

    def read_block_async(self, block_hash: int, cb) -> bool:
        """Queue a block read on the writer thread (G4 -> G2 prefetch
        promotion), behind any queued write of the same block.
        `cb(block_hash, parent, k, v, found)` fires on the writer thread.
        Returns False (no callback) when the block is absent already."""
        with self._lock:
            if block_hash not in self._blocks:
                return False
            parent = self._blocks[block_hash]
            self._blocks.move_to_end(block_hash)
        self._write_q.put(("read", block_hash, parent, cb))
        return True
