"""G3 disk KV block tier, the block file codec, and the tier chain.

Port of dynamo_tpu/kvbm/disk_pool.py. Content-addressed KV blocks spilled
from the host tier land in files; prefix-cache misses in G1/G2 onboard
from here instead of recomputing. File IO runs on the pool's writer
thread (spills, deferred demotions and `read_block_async`), never on the
engine's step thread; blocks are CPU tensors and no CUDA tensor crosses
into that thread.

Layout: one file per block, `<hash:016x>.kvb` — an 8-byte little-endian
JSON-header length, the JSON header (shape, dtype, parent, layout), then
the raw k bytes and the raw v bytes (a quantized block: k.q, k.s, v.q,
v.s). The header is the reference's json.dumps, key for key, and bf16
bytes go through uint8 views, so a directory written by one package is
adopted by the other's `_rescan`. Capacity is bounded in blocks and
optionally bytes, with LRU eviction (files unlinked, or handed down to
the G4 tier through `spill_hook`).
"""

from __future__ import annotations

import json
import logging
import mmap
import os
import queue
import struct
import threading
import time
import warnings
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

import torch

from .quant import (
    DTYPE_NAMES,
    dtype_of,
    is_quantized_block,
    maybe_dequantize,
    maybe_quantize,
    pair_nbytes,
)

log = logging.getLogger("dynamo_tpu_torch.kvbm.disk")

# On-disk/object block layout version. v2 = token-major [L, PS, Hk, D]
# pages; v1 (no field) was head-major. Readers reject other versions:
# adopting an old-layout block would import transposed KV.
BLOCK_LAYOUT_VERSION = 2


class BlockLayoutMismatch(ValueError):
    pass


def _raw(x: torch.Tensor) -> bytes:
    """A CPU tensor's elements as bytes, through a uint8 view (bf16 has
    no numpy type on the card's machine)."""
    return x.contiguous().view(torch.uint8).numpy().tobytes()


def _seg(data: bytes, off: int, n: int, dtype: torch.dtype, shape) -> torch.Tensor:
    """Read-only tensor over the n bytes at data[off:] (never written:
    tiers copy out of it)."""
    count = n // torch.empty((), dtype=dtype).element_size()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # immutable bytes
        return torch.frombuffer(data, dtype=dtype, count=count,
                                offset=off).reshape(shape)


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def encode_block(parent_hash, k, v) -> bytes:
    """The tier codec shared by G3 files and G4 objects: 8-byte LE header
    length, JSON header, then the payload segments. Dense blocks carry two
    segments (raw k, raw v); quantized blocks four (k.q, k.s, v.q, v.s)
    with quant "int8_ts", the scale shape and the dense dtype."""
    if is_quantized_block(k):
        header = json.dumps(
            {
                "shape": list(k["q"].shape),
                "dtype": "int8",
                "parent": parent_hash,
                "layout": BLOCK_LAYOUT_VERSION,
                "quant": "int8_ts",
                "sshape": list(k["s"].shape),
                "dt": k.get("dt", "float32"),
            }
        ).encode()
        return (struct.pack("<Q", len(header)) + header
                + _raw(k["q"]) + _raw(k["s"]) + _raw(v["q"]) + _raw(v["s"]))
    header = json.dumps(
        {
            "shape": list(k.shape),
            "dtype": DTYPE_NAMES[k.dtype],
            "parent": parent_hash,
            "layout": BLOCK_LAYOUT_VERSION,
        }
    ).encode()
    return struct.pack("<Q", len(header)) + header + _raw(k) + _raw(v)


def decode_block(data: bytes):
    """Inverse of encode_block -> (parent_hash, k, v), k/v quantized
    dicts when the block was stored quantized. Raises BlockLayoutMismatch
    for another layout and ValueError for a truncated payload (a missing
    or short scale segment included)."""
    (hlen,) = struct.unpack("<Q", data[:8])
    header = json.loads(data[8:8 + hlen])
    if header.get("layout") != BLOCK_LAYOUT_VERSION:
        raise BlockLayoutMismatch(
            f"block layout {header.get('layout')} != {BLOCK_LAYOUT_VERSION}")
    shape = tuple(header["shape"])
    off = 8 + hlen
    if header.get("quant") == "int8_ts":
        sshape = tuple(header["sshape"])
        nq = _numel(shape)  # int8: 1 byte an element
        ns = _numel(sshape) * 4  # f32 scales
        if len(data) - off != 2 * (nq + ns):
            raise ValueError(
                f"quantized block payload {len(data) - off}B != expected "
                f"{2 * (nq + ns)}B (scale segment missing or truncated)")
        dt = header.get("dt", "float32")
        k = {"q": _seg(data, off, nq, torch.int8, shape),
             "s": _seg(data, off + nq, ns, torch.float32, sshape), "dt": dt}
        v = {"q": _seg(data, off + nq + ns, nq, torch.int8, shape),
             "s": _seg(data, off + 2 * nq + ns, ns, torch.float32, sshape),
             "dt": dt}
        return header.get("parent"), k, v
    dtype = dtype_of(header["dtype"])
    n = _numel(shape) * torch.empty((), dtype=dtype).element_size()
    if len(data) - off < 2 * n:
        raise ValueError(f"block payload {len(data) - off}B < expected {2 * n}B")
    k = _seg(data, off, n, dtype, shape)
    v = _seg(data, off + n, n, dtype, shape)
    return header.get("parent"), k, v


class DiskKvPool:
    """Content-addressed KV block store on disk, with HostKvPool's
    match/get/put surface so the tier chain composes them."""

    def __init__(self, root: str, capacity_blocks: int = 1 << 16,
                 quantize: bool = False, capacity_bytes: Optional[int] = None):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self.capacity = capacity_blocks
        # optional byte budget: under byte pressure data-bearing blocks
        # spill down to G4 through spill_hook, as with the block count
        self.capacity_bytes = capacity_bytes
        # quantize dense blocks on entry (blocks demoted from a quantized
        # G2 arrive quantized already)
        self.quantize = quantize
        # LRU index: hash -> parent (file presence is authoritative for data)
        self._blocks: "OrderedDict[int, Optional[int]]" = OrderedDict()
        self._hash_only: set = set()  # entries with no file behind them
        self._bytes: Dict[int, int] = {}  # hash -> stored payload bytes
        self._quant: set = set()  # hashes stored int8 + scales
        self.stats = {"offloaded": 0, "onboarded": 0, "evicted": 0,
                      "stored_bytes": 0, "quant_blocks": 0}
        self._evict_listeners: List[Any] = []
        self._lock = threading.Lock()
        # demotion: called with (hash, parent, k, v) before an LRU drop so
        # a lower tier (G4) can absorb the block
        self.spill_hook = None
        # spills arrive on the step thread; the file writes run on the
        # writer thread. _pending holds blocks not written yet, so
        # get_block stays consistent meanwhile.
        self._pending: Dict[int, Tuple[Any, Any]] = {}
        # prefetch pins: hashes capacity enforcement must not drop while a
        # promotion read is queued or in flight
        self._pinned: set = set()
        self._outstanding = 0  # queued writer items not processed yet
        self._write_q: "queue.Queue" = queue.Queue()
        self._writer = threading.Thread(target=self._write_loop, daemon=True,
                                        name="kv-g3-writer")
        self._writer.start()
        self._rescan()

    def _rescan(self) -> None:
        """Adopt .kvb files a previous process left under the same root:
        rebuild the LRU index in mtime order, so they stay matchable and
        capacity-managed. Files of another layout, or unreadable, go."""
        entries = []
        for name in os.listdir(self.root):
            if not name.endswith(".kvb"):
                continue
            path = os.path.join(self.root, name)
            try:
                with open(path, "rb") as f:
                    (hlen,) = struct.unpack("<Q", f.read(8))
                    header = json.loads(f.read(hlen))
                if header.get("layout") != BLOCK_LAYOUT_VERSION:
                    log.warning("dropping %s: stale block layout %s",
                                name, header.get("layout"))
                    os.unlink(path)
                    continue
                payload = max(0, os.path.getsize(path) - 8 - hlen)
                entries.append((os.path.getmtime(path), int(name[:-4], 16),
                                header.get("parent"), payload,
                                header.get("quant") == "int8_ts"))
            except (OSError, ValueError, struct.error):
                try:
                    os.unlink(path)
                except OSError:
                    pass
        for _, h, parent, payload, quant in sorted(entries):
            self._blocks[h] = parent
            self._bytes[h] = payload
            self.stats["stored_bytes"] += payload
            if quant:
                self._quant.add(h)
                self.stats["quant_blocks"] += 1
        if entries:
            log.info("G3 rescan adopted %d blocks from %s", len(entries), self.root)
        self._enforce_capacity()

    def _put_q(self, item) -> None:
        with self._lock:
            self._outstanding += 1
        self._write_q.put(item)

    def _write_loop(self) -> None:
        while True:
            item = self._write_q.get()
            if item is None:
                return
            try:
                self._process(item)
            except Exception:
                log.exception("G3 writer item failed")
            finally:
                with self._lock:
                    self._outstanding -= 1

    def _drop_accounting(self, block_hash: int) -> None:
        """Caller holds self._lock: byte and quant bookkeeping for a block
        leaving the index."""
        self.stats["stored_bytes"] -= self._bytes.pop(block_hash, 0)
        if block_hash in self._quant:
            self._quant.discard(block_hash)
            self.stats["quant_blocks"] -= 1

    def pin(self, block_hash: int) -> None:
        with self._lock:
            self._pinned.add(block_hash)

    def unpin(self, block_hash: int) -> None:
        with self._lock:
            self._pinned.discard(block_hash)

    def _process(self, item) -> None:
        if item[0] == "read":
            # async promotion read (G3 -> G2 prefetch)
            _, block_hash, parent, cb = item
            with self._lock:
                present = block_hash in self._blocks
                pending = self._pending.get(block_hash)
                hash_only = block_hash in self._hash_only
            k = v = None
            if present and pending is not None:
                k, v = pending
            elif present and not hash_only:
                try:
                    if os.path.exists(self._path(block_hash)):
                        k, v = self._read_file(block_hash)
                    else:
                        present = False
                except Exception:
                    log.exception("G3 async read failed for %x", block_hash)
                    k = v = None
            try:
                cb(block_hash, parent, k, v, present)
            except Exception:
                log.exception("G3 read callback failed for %x", block_hash)
            return
        if item[0] == "spill":
            # deferred demotion of a block already on disk: read the file
            # off the step thread, hand it down, then unlink
            _, h, parent = item
            try:
                k, v = self._read_file(h)
                if self.spill_hook is not None:
                    self.spill_hook(h, parent, k, v)
            except (OSError, ValueError):
                log.warning("G3 spill read failed for %x; block lost", h)
            finally:
                try:
                    os.unlink(self._path(h))
                except FileNotFoundError:
                    pass
            return
        _, block_hash, parent_hash, k, v = item
        with self._lock:
            if block_hash not in self._pending:
                return  # evicted before the write happened
        try:
            self._write_file(block_hash, parent_hash, k, v)
        except OSError:
            log.exception("G3 write failed for %x", block_hash)
            with self._lock:
                self._blocks.pop(block_hash, None)
        finally:
            with self._lock:
                self._pending.pop(block_hash, None)

    def _write_file(self, block_hash, parent_hash, k, v) -> None:
        tmp = self._path(block_hash) + ".tmp"
        with open(tmp, "wb") as f:
            f.write(encode_block(parent_hash, k, v))
        os.replace(tmp, self._path(block_hash))

    def clear(self) -> List[int]:
        """Policy flush: drop the index and the backing files (a restart's
        rescan must not bring stale-policy blocks back). No spilling."""
        with self._lock:
            dropped = list(self._blocks)
            self._blocks.clear()
            self._hash_only.clear()
            self._pending.clear()
            self._pinned.clear()
            self._bytes.clear()
            self._quant.clear()
            self.stats["stored_bytes"] = 0
            self.stats["quant_blocks"] = 0
        for h in dropped:
            try:
                os.unlink(self._path(h))
            except OSError:
                pass
        if dropped:
            for cb in self._evict_listeners:
                cb(dropped)
        return dropped

    def on_evict(self, cb) -> None:
        self._evict_listeners.append(cb)

    def __contains__(self, block_hash: int) -> bool:
        with self._lock:
            return block_hash in self._blocks

    def __len__(self) -> int:
        with self._lock:
            return len(self._blocks)

    def _path(self, block_hash: int) -> str:
        return os.path.join(self.root, f"{block_hash & 0xFFFFFFFFFFFFFFFF:016x}.kvb")

    # -- offload (G2 → G3) --------------------------------------------------
    def put_block(self, block_hash: int, parent_hash: Optional[int],
                  k: Any, v: Any) -> None:
        """One [L, PS, Hk, D] block (dense or quantized dicts; None: an
        entry with no data)."""
        if self.quantize:
            k, v = maybe_quantize(k), maybe_quantize(v)
        with self._lock:
            if block_hash in self._blocks:
                self._blocks.move_to_end(block_hash)
                return
            self._blocks[block_hash] = parent_hash
            if k is not None:
                self._pending[block_hash] = (k, v)
                self._bytes[block_hash] = pair_nbytes(k, v)
                self.stats["stored_bytes"] += self._bytes[block_hash]
                if is_quantized_block(k):
                    self._quant.add(block_hash)
                    self.stats["quant_blocks"] += 1
            else:
                self._hash_only.add(block_hash)
            self.stats["offloaded"] += 1
        if k is not None:
            self._put_q(("write", block_hash, parent_hash, k, v))
        self._enforce_capacity()

    def flush(self, timeout: float = 60.0) -> None:
        """Wait until queued writes and deferred spills are processed."""
        deadline = time.monotonic() + timeout
        while True:
            with self._lock:
                if not self._pending and self._outstanding == 0:
                    return
            if time.monotonic() > deadline:
                raise TimeoutError("G3 writer did not drain")
            time.sleep(0.005)

    def _over_budget(self) -> bool:
        """Caller holds self._lock."""
        if len(self._blocks) > self.capacity:
            return True
        return (self.capacity_bytes is not None
                and self.stats["stored_bytes"] > self.capacity_bytes)

    def _enforce_capacity(self) -> None:
        dropped: List[int] = []
        unlink_now: List[int] = []
        spill_mem = []
        spill_deferred = []
        with self._lock:
            while self._over_budget():
                # LRU order, skipping pinned blocks; all pinned: overshoot
                h = next((b for b in self._blocks if b not in self._pinned), None)
                if h is None:
                    break
                parent = self._blocks.pop(h)
                pend = self._pending.pop(h, None)
                self._drop_accounting(h)
                dropped.append(h)
                self.stats["evicted"] += 1
                if self.spill_hook is None:
                    self._hash_only.discard(h)
                    unlink_now.append(h)
                elif pend is not None:
                    spill_mem.append((h, parent, pend))
                    unlink_now.append(h)
                elif h in self._hash_only:
                    self._hash_only.discard(h)
                    spill_mem.append((h, parent, None))
                else:
                    # on disk already: read and demote on the writer
                    # thread, never on the step thread (it unlinks after)
                    spill_deferred.append((h, parent))
        for h, parent, pend in spill_mem:
            try:
                if pend is None:
                    self.spill_hook(h, parent, None, None)
                else:
                    self.spill_hook(h, parent, pend[0], pend[1])
            except Exception:
                log.exception("G3 spill hook failed for %x", h)
        for h, parent in spill_deferred:
            self._put_q(("spill", h, parent))
        for h in unlink_now:
            try:
                os.unlink(self._path(h))
            except FileNotFoundError:
                pass
        if dropped:
            for cb in self._evict_listeners:
                cb(dropped)

    # -- onboard (G3 → up) --------------------------------------------------
    def match(self, hashes: List[int]) -> int:
        n = 0
        with self._lock:
            for h in hashes:
                if h not in self._blocks:
                    break
                n += 1
        return n

    def get_block(self, block_hash: int):
        """One block's (k, v) as stored; (None, None) for an entry with no
        data. Raises KeyError if the block was evicted since the caller's
        match(): onboard callers then recompute."""
        with self._lock:
            self._blocks.move_to_end(block_hash)  # KeyError if evicted
            pending = self._pending.get(block_hash)
        self.stats["onboarded"] += 1
        if pending is not None:  # spilled but not on disk yet
            return pending
        if not os.path.exists(self._path(block_hash)):
            return None, None
        return self._read_file(block_hash)

    def read_block_async(self, block_hash: int, cb) -> bool:
        """Queue a block read on the writer thread (G3 -> G2 prefetch
        promotion), behind any queued write of the same block.
        `cb(block_hash, parent, k, v, found)` fires on the writer thread:
        k/v None for data-less or corrupt blocks, found False if the block
        left before the read ran. Returns False (no callback) when the
        block is absent already."""
        with self._lock:
            if block_hash not in self._blocks:
                return False
            parent = self._blocks[block_hash]
            self._blocks.move_to_end(block_hash)
        self.stats["onboarded"] += 1
        self._put_q(("read", block_hash, parent, cb))
        return True

    def _read_file(self, block_hash: int):
        try:
            with open(self._path(block_hash), "rb") as f:
                # mapped, not read: the block's tensors view the page
                # cache (kept mapped while they live, an unlink included)
                # instead of a fresh buffer the read would fill
                _, k, v = decode_block(mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ))
        except BlockLayoutMismatch:
            # a shared root can gain stale-layout files under a live
            # process: a data miss
            log.warning("block %x has a stale layout on disk; ignoring", block_hash)
            return None, None
        except (OSError, KeyError, ValueError, struct.error):
            # truncated or corrupt (a half-written file of a crashed
            # process): a data miss the onboard recomputes through, never
            # an exception into it; quarantined so it stops matching
            log.warning("block %x truncated/corrupt on disk; unlinking",
                        block_hash, exc_info=True)
            try:
                os.unlink(self._path(block_hash))
            except OSError:
                pass
            with self._lock:
                self._blocks.pop(block_hash, None)
                self._hash_only.discard(block_hash)
                self._pinned.discard(block_hash)
                self._drop_accounting(block_hash)
            return None, None
        return k, v

    def get(self, hashes: List[int]):
        """Stacked dense [L, n, PS, Hk, D] pages (quantized blocks
        dequantized); (None, None) if any block has no data."""
        pairs = [self.get_block(h) for h in hashes]
        if not pairs or any(p[0] is None for p in pairs):
            return None, None
        return (torch.stack([maybe_dequantize(p[0]) for p in pairs], dim=1),
                torch.stack([maybe_dequantize(p[1]) for p in pairs], dim=1))


class TieredKv:
    """G2 (host) + optional G3 (disk) + optional G4 (objects) as one
    lower-tier pool for the scheduler and the engine: match() walks the
    leading run across the tiers, get() reads each block from whichever
    holds it, and host evictions spill down instead of dropping. Removal
    events fire only from the terminal tier, so the router's lower-tier
    credits persist while data merely demotes."""

    def __init__(self, host, disk: Optional[DiskKvPool] = None, obj=None):
        self.host = host
        self.disk = disk
        self.obj = obj  # G4 ObjectKvPool (kvbm/object_store.py)
        if disk is not None:
            host.spill_hook = self._spill
            if obj is not None:
                disk.spill_hook = obj.put_block
        elif obj is not None:
            host.spill_hook = self._spill_to_obj

    def _spill(self, block) -> None:  # HostBlock
        self.disk.put_block(block.block_hash, block.parent_hash, block.k, block.v)

    def _spill_to_obj(self, block) -> None:  # HostBlock (no G3 tier)
        self.obj.put_block(block.block_hash, block.parent_hash, block.k, block.v)

    def on_evict(self, cb) -> None:
        # only terminal drops remove lower-tier residency (pools define
        # __len__, so `a or b` would take an empty tier for absent)
        terminal = self.host if self.disk is None else self.disk
        terminal = terminal if self.obj is None else self.obj
        terminal.on_evict(cb)

    def _tiers(self):
        return [t for t in (self.host, self.disk, self.obj) if t is not None]

    def clear(self) -> None:
        """Flush every tier; each fires its own removal events."""
        for t in self._tiers():
            t.clear()

    def match(self, hashes: List[int]) -> int:
        n = 0
        tiers = self._tiers()
        for h in hashes:
            if any(h in t for t in tiers):
                n += 1
            else:
                break
        return n

    def get_blocks(self, hashes: List[int]) -> Optional[List[Tuple[torch.Tensor, torch.Tensor]]]:
        """Each block's dense (k, v) from whichever tier holds it; None if
        a block has no data. Raises KeyError if a block left every tier
        after the caller's match()."""
        out = []
        for h in hashes:
            if h in self.host:
                (k, v), = self.host.get_blocks([h])
            elif self.disk is not None and h in self.disk:
                k, v = self.disk.get_block(h)
            elif self.obj is not None:
                k, v = self.obj.get_block(h)
            else:
                raise KeyError(h)
            if k is None:
                return None
            out.append((maybe_dequantize(k), maybe_dequantize(v)))
        return out

    def get(self, hashes: List[int]):
        """Stacked dense [L, n, PS, Hk, D] pages; (None, None) if a block
        has no data."""
        pairs = self.get_blocks(hashes)
        if pairs is None:
            return None, None
        return (torch.stack([p[0] for p in pairs], dim=1),
                torch.stack([p[1] for p in pairs], dim=1))

    def residency(self, hashes: List[int]) -> List[str]:
        """Tier label per hash ("host" / "disk" / "obj" / "miss"), the
        attribution the per-tier onboard EWMA charges time against."""
        out = []
        for h in hashes:
            if h in self.host:
                out.append("host")
            elif self.disk is not None and h in self.disk:
                out.append("disk")
            elif self.obj is not None and h in self.obj:
                out.append("obj")
            else:
                out.append("miss")
        return out

    def put(self, hashes, parents, k, v) -> None:
        self.host.put(hashes, parents, k, v)

    @property
    def stats(self):
        s = dict(self.host.stats)
        if self.disk is not None:
            s.update({f"disk_{k}": val for k, val in self.disk.stats.items()})
        if self.obj is not None:
            s.update({f"obj_{k}": val for k, val in self.obj.stats.items()})
        return s

    def __contains__(self, h: int) -> bool:
        return any(h in t for t in self._tiers())
