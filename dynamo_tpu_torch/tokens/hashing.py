"""Positional lineage hashing of token blocks.

Analog of reference lib/kv-hashing (lib/kv-hashing/src/lib.rs:6-12): a pure
`tokens → [block_hash]` computation that every component agrees on — the
router indexes these hashes, the engine's prefix cache registers pages under
them, and KV events carry them on the wire.

Hash i covers tokens [0, (i+1)*block_size) by chaining: each block hash
mixes the parent block's hash with this block's token ids, so equal hashes
imply equal full prefixes (lineage), not just equal block contents. u64
values (msgpack/wire friendly); blake2b-8 keyed with a fixed seed so every
process computes identical hashes.
"""

from __future__ import annotations

import hashlib
import struct
from typing import List, Optional, Sequence

BLOCK_HASH_SEED = b"dynamo-tpu-kv-v1"


def hash_block(parent_hash: Optional[int], tokens: Sequence[int]) -> int:
    h = hashlib.blake2b(digest_size=8, key=BLOCK_HASH_SEED)
    if parent_hash is not None:
        h.update(struct.pack("<Q", parent_hash))
    h.update(struct.pack(f"<{len(tokens)}I", *[t & 0xFFFFFFFF for t in tokens]))
    return struct.unpack("<Q", h.digest())[0]


def block_hashes(
    tokens: Sequence[int], block_size: int, parent: Optional[int] = None
) -> List[int]:
    """Hashes for every *complete* block of `tokens`. `parent` seeds the
    chain — used to salt per-adapter KV (LoRA changes K/V projections, so
    equal tokens under different adapters must never share cache blocks)."""
    out: List[int] = []
    for i in range(len(tokens) // block_size):
        parent = hash_block(parent, tokens[i * block_size : (i + 1) * block_size])
        out.append(parent)
    return out


def request_seed(adapter: Optional[str], mm_seed: Optional[int]) -> Optional[int]:
    """Canonical hash-chain seed for a request: LoRA adapter and multimodal
    content each fork the block lineage. The router and the worker
    scheduler MUST compose seeds identically or overlap scoring breaks."""
    seed = adapter_seed(adapter) if adapter else None
    if mm_seed:
        seed = hash_block(seed, [mm_seed & 0xFFFFFFFF, mm_seed >> 32])
    return seed


def mm_content_seed(data: bytes) -> int:
    """Content hash of a multimodal embedding payload (blake2b-8)."""
    h = hashlib.blake2b(data, digest_size=8)
    return int.from_bytes(h.digest(), "little")


def adapter_seed(name: str) -> int:
    """Chain seed for a LoRA adapter: block hashes of adapter-attributed
    sequences live in a disjoint lineage from base-model hashes."""
    h = hashlib.blake2b(digest_size=8, key=BLOCK_HASH_SEED)
    h.update(b"lora:" + name.encode())
    return struct.unpack("<Q", h.digest())[0]
