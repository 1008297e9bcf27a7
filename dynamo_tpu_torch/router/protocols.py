"""Router wire protocols.

Port of dynamo_tpu/router/protocols.py: the KV event subject and payload
(`RouterEvent`) and the FPM subject. Events ride the event plane as
msgpack dicts; block identity is the lineage hash of `tokens/hashing.py`,
shared with the engine's prefix cache and the host tier.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from dynamo_tpu_torch.runtime.event_plane import FPM_SUBJECT, KV_EVENT_SUBJECT

__all__ = ["FPM_SUBJECT", "KV_EVENT_SUBJECT", "RouterEvent", "WorkerId"]


@dataclass(frozen=True)
class WorkerId:
    """Routing target: (instance_id, dp_rank)."""

    instance_id: int
    dp_rank: int = 0

    def key(self) -> Tuple[int, int]:
        return (self.instance_id, self.dp_rank)


@dataclass
class RouterEvent:
    """One KV-cache mutation on a worker. Monotonic event_id per
    (worker, dp_rank) enables gap detection."""

    worker: Tuple[int, int]  # (instance_id, dp_rank)
    event_id: int
    kind: str  # "store" | "remove" | "clear"
    block_hashes: List[int] = field(default_factory=list)
    parent_hash: Optional[int] = None  # lineage anchor of block_hashes[0]
    tier: str = "device"  # "device" (G1) | "host" (G2)

    def to_wire(self) -> Dict[str, Any]:
        return {
            "worker": list(self.worker),
            "event_id": self.event_id,
            "kind": self.kind,
            "block_hashes": self.block_hashes,
            "parent_hash": self.parent_hash,
            "tier": self.tier,
        }

    @classmethod
    def from_wire(cls, d: Dict[str, Any]) -> "RouterEvent":
        return cls(
            worker=tuple(d["worker"]),
            event_id=int(d["event_id"]),
            kind=d["kind"],
            block_hashes=list(d.get("block_hashes") or []),
            parent_hash=d.get("parent_hash"),
            tier=d.get("tier", "device"),
        )
