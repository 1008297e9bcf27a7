"""Router-side KV indexer: the event plane's KV events into block indexes,
with gap detection and recovery from the worker's own dump.

Port of dynamo_tpu/router/indexer.py `KvIndexer`. Freshness loop: a
worker's PagePool mutation → KvEventPublisher → the TCP event plane →
this subscriber → `apply_event` → the next `find_matches` sees it.
Device-tier events go to `index` (the C++ index in event mode, the
Python one in TTL mode), host-tier (G2) events to `host_index`, and
object-tier (G4) store and remove events to `obj_index`.
Recovery: a gap in a worker's event ids (a subscriber that fell behind
the publisher's high-water mark) triggers a full-state resync from that
worker's `kv_state` endpoint; the same dump seeds the index when a worker
is first discovered.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Dict, Optional, Tuple

from dynamo_tpu_torch.native.block_index import make_block_index
from dynamo_tpu_torch.router.protocols import RouterEvent
from dynamo_tpu_torch.router.radix_tree import BlockIndex
from dynamo_tpu_torch.runtime.event_plane import EventSubscriber
from dynamo_tpu_torch.runtime.tasks import spawn_tracked

log = logging.getLogger("dynamo_tpu_torch.router.indexer")

Worker = Tuple[int, int]


class KvIndexer:
    # a worker that cannot produce its dump within this window is treated
    # as failed: an unbounded await would wedge the resync slot (the
    # worker may be the very corpse whose death caused the gap)
    DUMP_TIMEOUT_S = 10.0

    def __init__(
        self,
        subscriber: EventSubscriber,
        index=None,
        dump_fn=None,  # async (instance_id) -> dump dict; wired by KvRouter
        ttl: Optional[float] = None,  # approximate-mode TTL
    ):
        self.index = index if index is not None else make_block_index(
            ttl_mode=ttl is not None)
        self.host_index = BlockIndex()  # G2 residency (partial credits)
        self.obj_index = BlockIndex()  # G4 object-tier residency
        self._sub = subscriber
        self._dump_fn = dump_fn
        self.ttl = ttl
        self._last_event_id: Dict[Worker, int] = {}
        self._task: Optional[asyncio.Task] = None
        self._resyncing: set = set()
        # live events arriving while a worker's dump is in flight are
        # parked here and replayed after the snapshot lands: applied at
        # once, remove_worker() would wipe them and the older snapshot
        # would resurrect state they superseded
        self._resync_buffer: Dict[Worker, list] = {}
        # bumped by remove_worker; a resync whose dump outlives the worker
        # must not repopulate the index with a corpse's blocks
        self._epoch: Dict[Worker, int] = {}

    async def start(self) -> None:
        if self._task is None:
            self._task = asyncio.create_task(self._consume())

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None
        await self._sub.close()

    def connect_publisher(self, address: str) -> None:
        self._sub.connect(address)

    def disconnect_publisher(self, address: str) -> None:
        self._sub.disconnect(address)

    def remove_worker(self, worker: Worker) -> None:
        self._epoch[worker] = self._epoch.get(worker, 0) + 1
        self.index.remove_worker(worker)
        self.host_index.remove_worker(worker)
        self.obj_index.remove_worker(worker)
        self._last_event_id.pop(worker, None)

    def remove_instance(self, instance_id: int, dp_size: int = 1) -> None:
        """Expire every rank of a departed instance, including ranks seen
        only in events (beyond the metadata's dp_size)."""
        ranks = set(range(max(1, int(dp_size))))
        ranks.update(r for (iid, r) in list(self._last_event_id) if iid == instance_id)
        for r in ranks:
            self.remove_worker((instance_id, r))

    async def _consume(self) -> None:
        try:
            async for _subject, payload in self._sub.events():
                for wire in payload.get("events", []):
                    self._apply(RouterEvent.from_wire(wire))
        except asyncio.CancelledError:
            pass
        except Exception:  # the consumer is the boundary that must report
            log.exception("kv event consumer failed")

    def _apply(self, ev: RouterEvent) -> None:
        worker = tuple(ev.worker)
        buf = self._resync_buffer.get(worker)
        if buf is not None:
            # resync in flight: park the event un-deduped (the snapshot
            # rewinds _last_event_id) and replay it after the dump applies
            buf.append(ev)
            return
        last = self._last_event_id.get(worker, 0)
        if ev.event_id <= last:
            return  # replay or duplicate
        if ev.event_id != last + 1 and last != 0:
            log.warning("kv event gap for worker %s: %d -> %d; scheduling resync",
                        worker, last, ev.event_id)
            self._schedule_resync(worker)
        self._last_event_id[worker] = ev.event_id
        if ev.tier == "host":
            target = self.host_index
        elif ev.tier == "obj":
            target = self.obj_index
        else:
            target = self.index
        target.apply_event(ev, ttl=self.ttl)

    # -- recovery ----------------------------------------------------------
    def _schedule_resync(self, worker: Worker) -> None:
        if self._dump_fn is None or worker in self._resyncing:
            return
        self._resyncing.add(worker)
        spawn_tracked(self._resync(worker), logger=log)

    async def _resync(self, worker: Worker) -> None:
        try:
            await self.resync_worker(worker)
        finally:
            self._resyncing.discard(worker)

    async def resync_worker(self, worker: Worker) -> None:
        """Full-state seed or resync from the worker's kv_state dump. Live
        events that land during the dump are buffered and replayed
        (deduplicated against the dump's watermark) after the snapshot;
        a discovery delete during the dump (the epoch moved) discards
        it."""
        if self._dump_fn is None:
            return
        epoch = self._epoch.get(worker, 0)
        owns_buffer = worker not in self._resync_buffer
        if owns_buffer:
            self._resync_buffer[worker] = []
        try:
            try:
                dump = await asyncio.wait_for(self._dump_fn(worker[0]),
                                              timeout=self.DUMP_TIMEOUT_S)
            except asyncio.TimeoutError:
                log.warning("kv dump from worker %s timed out", worker)
                return
            except Exception as e:  # a dead or failing worker: not ours to raise
                log.warning("kv dump from worker %s failed: %s", worker, e)
                return
            if self._epoch.get(worker, 0) != epoch:
                log.warning("discarding stale kv dump for %s (removed mid-resync)", worker)
                return
            self.index.remove_worker(worker)
            # replay the snapshot as store events, parent first so chains
            # link (an iterative walk: lineage chains reach thousands)
            blocks = {int(h): (int(p) if p is not None else None)
                      for h, p in dump.get("blocks", [])}
            emitted = set()
            for h0 in list(blocks):
                chain = []
                h = h0
                while h is not None and h not in emitted and h in blocks:
                    chain.append(h)
                    h = blocks[h]
                for h in reversed(chain):
                    self.index.apply_event(
                        RouterEvent(worker=worker, event_id=0, kind="store",
                                    block_hashes=[h], parent_hash=blocks[h]),
                        ttl=self.ttl)
                    emitted.add(h)
            self._last_event_id[worker] = int(dump.get("last_event_id", 0))
        finally:
            if owns_buffer:
                buffered = self._resync_buffer.pop(worker, [])
                if self._epoch.get(worker, 0) == epoch:
                    # ids the snapshot covers fall to the dedup check
                    for ev in buffered:
                        self._apply(ev)
