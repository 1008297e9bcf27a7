"""KV-aware routing: KvRouter and KvPushRouter.

Port of dynamo_tpu/router/kv_router.py. `KvRouter` joins the block
index's overlap scores to `ActiveSequences`' load and the cost-based
selector to pick a (worker, dp_rank) per request; it watches the worker
set through the EndpointClient and wires each discovered worker's event
publisher into the indexer, seeding it from the worker's `kv_state` dump.
`KvPushRouter` is the pipeline engine: hash the prompt's blocks, select a
worker, push straight to that instance, and keep the request's
active-sequence charge (add on routing, prefill done at the first item,
free at the end). Without KV events (approximate mode) the router
predicts cache state from what it routed, with a TTL.

Not ported yet: the router replica sync, the prefetch and remote-host
hints and hot-trunk replication (with the host-tier peer pulls, A.7), the
LoRA filter (A.9), the routing audit and the tracing spans (A.11).
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Any, AsyncIterator, Dict, List, Optional, Tuple

from dynamo_tpu_torch.router.indexer import KvIndexer
from dynamo_tpu_torch.router.protocols import KV_EVENT_SUBJECT, RouterEvent
from dynamo_tpu_torch.router.queue import AdmissionConfig, AdmissionQueue
from dynamo_tpu_torch.router.scheduling import KvRouterConfig, WorkerSelector
from dynamo_tpu_torch.router.sequences import ActiveSequences
from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.runtime.request_plane import PushRouter, RequestPlaneError
from dynamo_tpu_torch.runtime.tasks import spawn_tracked
from dynamo_tpu_torch.tokens.hashing import block_hashes

log = logging.getLogger("dynamo_tpu_torch.router")

Worker = Tuple[int, int]


class KvRouter:
    APPROX_TTL_S = 120.0  # approximate mode: how long a routed prefix counts

    def __init__(
        self,
        runtime,
        client,
        block_size: int,
        config: Optional[KvRouterConfig] = None,
        use_kv_events: bool = True,
        admission: Optional[AdmissionConfig] = None,
    ):
        self.runtime = runtime
        self.client = client
        self.block_size = block_size
        self.config = config or KvRouterConfig()
        self.use_kv_events = use_kv_events
        self.selector = WorkerSelector(self.config)
        self.sequences = ActiveSequences()
        # parks requests while every worker is saturated; off unless
        # busy_blocks > 0
        self.admission = AdmissionQueue(
            admission or AdmissionConfig(),
            load_fn=lambda w: (self.sequences.prefill_blocks(w)
                               + self.sequences.decode_blocks(w)),
            workers_fn=self.workers,
        )
        self.indexer = KvIndexer(
            runtime.event_subscriber([KV_EVENT_SUBJECT]) if use_kv_events else _NullSub(),
            dump_fn=self._dump_worker if use_kv_events else None,
            ttl=None if use_kv_events else self.APPROX_TTL_S,
        )
        self._started = False
        self._known_workers: set = set()

    async def start(self) -> None:
        if self._started:
            return
        self._started = True
        await self.client.start()
        self.client.on_instance_change(self._on_instance)
        if self.use_kv_events:
            await self.indexer.start()
            for inst in list(self.client.instances.values()):
                await self._connect_worker(inst)

    def _on_instance(self, kind: str, inst) -> None:
        if kind == "put":
            if self.use_kv_events:
                # never block the discovery watch on a worker RPC
                spawn_tracked(self._connect_worker(inst), logger=log)
            # fresh capacity drains the admission queue, but only for a
            # NEW instance: discovery also emits puts for metadata updates
            # and lease renewals of known (perhaps saturated) workers
            if inst.instance_id not in self._known_workers:
                self._known_workers.add(inst.instance_id)
                self.admission.notify(self.admission.depth)
        elif kind == "delete":
            self._known_workers.discard(inst.instance_id)
            meta = inst.metadata or {}
            # expire every dp rank's blocks now: a resync would leave the
            # selector crediting overlap on a corpse
            dp = int(meta.get("dp_size", 1))
            self.indexer.remove_instance(inst.instance_id, dp)
            kv_addr = meta.get("kv_publisher")
            if kv_addr:
                self.indexer.disconnect_publisher(kv_addr)
            for r in range(dp):
                self.sequences.remove_worker((inst.instance_id, r))
            if not self.workers():
                # nothing left to route to: reject waiters at once
                self.admission.fail_all(f"no workers for {self.client.path}",
                                        code="no_instances")
            elif not self.admission.saturated():
                self.admission.notify(self.admission.depth)

    async def _connect_worker(self, inst) -> None:
        addr = (inst.metadata or {}).get("kv_publisher")
        if not addr:
            return
        self.indexer.connect_publisher(addr)
        try:
            await asyncio.wait_for(
                self.indexer.resync_worker((inst.instance_id, 0)), timeout=10.0)
        except asyncio.TimeoutError:
            log.warning("kv_state seed dump from %x timed out", inst.instance_id)

    async def _dump_worker(self, instance_id: int) -> Dict[str, Any]:
        inst = self.client.instances.get(instance_id)
        if inst is None:
            raise RuntimeError(f"worker {instance_id:x} gone")
        path = inst.endpoint_address.path.rsplit("/", 1)[0] + "/kv_state"
        dump_client = self.runtime.client(path)
        dump_client.router.update_instance(instance_id, inst.address)
        try:
            async for item in dump_client.direct({}, instance_id):
                return item
        finally:
            await dump_client.close()
        raise RuntimeError("empty kv dump")

    # -- selection ---------------------------------------------------------
    def workers(self) -> List[Worker]:
        out: List[Worker] = []
        for inst in self.client.instances.values():
            dp = int((inst.metadata or {}).get("dp_size", 1))
            out.extend((inst.instance_id, r) for r in range(dp))
        return sorted(out)

    def find_best_match(
        self, token_ids: List[int], pinned_instance: Optional[int] = None,
    ) -> Tuple[Worker, int, List[int]]:
        """Returns (worker, overlap blocks, block hashes); `pinned_instance`
        restricts selection to that instance's ranks. The hash chain is
        the base model's: the workers refuse LoRA adapters and
        multimodal inputs, whose lineages fork it (A.9, A.12)."""
        hashes = block_hashes(token_ids, self.block_size)
        overlaps = self.indexer.index.find_matches(hashes)
        host_overlaps = self.indexer.host_index.find_matches(hashes).scores
        workers = self.workers()
        if pinned_instance is not None:
            # an explicit pin bypasses the sick filter, and a pinned
            # target that is gone fails loudly (migratable), never
            # silently re-routes
            workers = [w for w in workers if w[0] == pinned_instance]
            if not workers:
                raise RequestPlaneError(f"instance {pinned_instance:x} not found",
                                        code="cannot_connect")
        else:
            # skip replicas in their transport-failure cooldown: between a
            # worker's death and its lease expiry the index still lists it
            sick = self.client.router.sick_instances()
            if sick:
                healthy = [w for w in workers if w[0] not in sick]
                if healthy:
                    workers = healthy
        worker, overlap = self.selector.select(
            workers, len(hashes), overlaps, self.sequences,
            host_overlaps=host_overlaps)
        return worker, overlap, hashes

    # -- lifecycle charging -------------------------------------------------
    def add_request(self, request_id: str, worker: Worker, hashes: List[int],
                    overlap: int) -> None:
        self.sequences.add_request(request_id, worker, len(hashes), overlap)
        if not self.use_kv_events and hashes:
            # approximate mode: predict the worker will cache these blocks
            self.indexer.index.apply_event(
                RouterEvent(worker=worker, event_id=0, kind="store",
                            block_hashes=hashes, parent_hash=None),
                ttl=self.indexer.ttl)

    def mark_prefill_completed(self, request_id: str) -> None:
        self.sequences.mark_prefill_completed(request_id)

    def free(self, request_id: str) -> None:
        self.sequences.free(request_id)
        self.admission.notify(1)  # one slot freed: admit one waiter

    async def stop(self) -> None:
        await self.indexer.stop()


class KvPushRouter:
    """Pipeline engine: KV-aware selection → direct push → lifecycle."""

    def __init__(self, router: KvRouter):
        self.router = router

    async def generate(self, request: Dict[str, Any], context: Context) -> AsyncIterator[Any]:
        t_route = time.monotonic()
        await self.router.start()
        # parks here while every worker is saturated; raises queue_full /
        # queue_timeout (HTTP 429) on rejection
        await self.router.admission.acquire(request.get("priority"))
        worker, overlap, hashes = self.router.find_best_match(
            request.get("token_ids") or [],
            pinned_instance=context.metadata.get("target_instance"))
        rid = context.id
        self.router.add_request(rid, worker, hashes, overlap)
        context.metadata["kv_overlap_blocks"] = overlap
        context.metadata["routed_instance"] = worker[0]
        # the selection's cost (admission wait included), accumulated
        # across migration retries; the metadata rides to the worker
        ph = context.metadata.setdefault("phases", {})
        ph["route_s"] = ph.get("route_s", 0.0) + (time.monotonic() - t_route)
        first = True
        try:
            async for item in self.router.client.direct(request, worker[0], context):
                if first:
                    self.router.mark_prefill_completed(rid)
                    first = False
                yield item
        except RequestPlaneError as e:
            if e.code in PushRouter.SICK_CODES:
                # direct() bypasses PushRouter.generate's sick marking:
                # record the corpse so a migration retry avoids it
                self.router.client.router.mark_sick(worker[0])
            raise
        finally:
            self.router.free(rid)


class _NullSub:
    """The approximate mode's subscriber: no events."""

    def connect(self, address: str) -> None:
        pass

    def disconnect(self, address: str) -> None:
        pass

    async def events(self):
        while True:
            await asyncio.sleep(3600)
        yield  # pragma: no cover

    async def close(self) -> None:
        pass
