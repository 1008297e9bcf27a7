"""Worker-side KV event publishing.

Port of dynamo_tpu/router/publisher.py: the engine's step thread reports
PagePool and host-tier events through a callback; they are handed to the
asyncio loop, stamped with a monotonic event_id, batched, and published on
the event plane. A current-block snapshot is kept so a router can resync
after a gap or on discovery (`dump_state`, served as the worker's
`kv_state` endpoint).
"""

from __future__ import annotations

import asyncio
import logging
from typing import Any, Dict, List, Optional

from dynamo_tpu_torch.engine.kv_pool import KvEvent
from dynamo_tpu_torch.router.protocols import KV_EVENT_SUBJECT, RouterEvent
from dynamo_tpu_torch.runtime.event_plane import EventPublisher

log = logging.getLogger("dynamo_tpu_torch.router.publisher")


class KvEventPublisher:
    def __init__(
        self,
        publisher: EventPublisher,
        instance_id: int,
        dp_rank: int = 0,
        flush_interval: float = 0.005,
    ):
        self._pub = publisher
        self.worker = (instance_id, dp_rank)
        self.flush_interval = flush_interval
        self._event_id = 0
        self._pending: List[RouterEvent] = []
        self._current: Dict[int, Optional[int]] = {}  # hash -> parent (snapshot)
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._flusher: Optional[asyncio.Task] = None
        self._dirty = asyncio.Event()

    @property
    def address(self) -> str:
        return self._pub.address

    async def start(self) -> None:
        self._loop = asyncio.get_running_loop()
        if self._flusher is None:
            self._flusher = asyncio.create_task(self._flush_loop())

    async def stop(self) -> None:
        if self._flusher is not None:
            self._flusher.cancel()
            self._flusher = None

    # -- engine callback (called from the engine step thread) --------------
    def on_engine_events(self, events: List[KvEvent]) -> None:
        if self._loop is None:
            return
        self._loop.call_soon_threadsafe(self._ingest, list(events))

    def _ingest(self, events: List[KvEvent]) -> None:
        for ev in events:
            self._event_id += 1
            self._pending.append(
                RouterEvent(
                    worker=self.worker,
                    event_id=self._event_id,
                    kind=ev.kind,
                    block_hashes=list(ev.block_hashes),
                    parent_hash=ev.parent_hash,
                    tier=getattr(ev, "tier", "device"),
                )
            )
            if getattr(ev, "tier", "device") != "device":
                continue  # the recovery snapshot tracks the device tier
            if ev.kind == "store":
                parent = ev.parent_hash
                for h in ev.block_hashes:
                    self._current[h] = parent
                    parent = h
            elif ev.kind == "remove":
                for h in ev.block_hashes:
                    self._current.pop(h, None)
        self._dirty.set()

    # -- publishing --------------------------------------------------------
    async def _flush_loop(self) -> None:
        try:
            while True:
                await self._dirty.wait()
                await asyncio.sleep(self.flush_interval)  # batch window
                self._dirty.clear()
                batch, self._pending = self._pending, []
                if batch:
                    await self._pub.publish(
                        KV_EVENT_SUBJECT,
                        {"events": [e.to_wire() for e in batch]},
                    )
        except asyncio.CancelledError:
            pass
        except Exception:  # pragma: no cover
            log.exception("kv event flush failed")

    # -- recovery dump (served as a worker endpoint) -----------------------
    async def dump_state(self, request: Any, context) -> Dict[str, Any]:
        """Unary endpoint handler: full current-block snapshot."""
        return {
            "worker": list(self.worker),
            "last_event_id": self._event_id,
            "blocks": [[h, p] for h, p in self._current.items()],
        }
