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

The lower tiers: the selector prices the workers' host-tier (G2) and
object-tier (G4) residency, a peer's G2 by the link class of the pull
(`kv_slice` metadata: same slice "ici", another "dcn"), and measured
onboard costs when a `tier_cost_fn` is bound. A request whose longest
prefix sits in a peer's lower tier carries a `kv_remote_host` hint (the
worker pulls the blocks through the peer's `kv_host_fetch`), a worker
that runs a prefetch manager gets a `kv_prefetch` hint ahead of the
request, and a trunk (first block) that proves hot is replicated once
onto a slice that holds none of it.

LoRA and multimodal requests hash their blocks on their own lineage (the
chain seeded by tokens/hashing.py `request_seed`, as the worker's
scheduler seeds it), in the overlap scores and every hint, and a
request whose context carries `allowed_instances` (a LoRA adapter
entry's holders) is routed among those workers only, before cost-based
selection (the reference's two-stage LoRA-filtered routing).

Observability: every decision goes into the router's `RoutingAudit`
with the selector's per-candidate cost breakdown (each lower tier's
credit weight and whether it was measured or the prior), served at the
frontend's /debug/routing; KvPushRouter opens a `route.kv` span around
admission and selection, and the remote-pull and prefetch hints carry it
so the worker's `kv.peer_pull` and `kv.prefetch.promote` join the trace.
The frontend binds its FleetObserver's `onboard_costs` (the workers'
measured `kv_onboard_ewma` from their fleet digests) as `tier_cost_fn`.

Not ported yet: the router replica sync.
"""

from __future__ import annotations

import asyncio
import logging
import time
from collections import OrderedDict
from typing import Any, AsyncIterator, Dict, List, Optional, Tuple

from dynamo_tpu_torch.router.indexer import KvIndexer
from dynamo_tpu_torch.router.protocols import KV_EVENT_SUBJECT, RouterEvent
from dynamo_tpu_torch.router.queue import AdmissionConfig, AdmissionQueue
from dynamo_tpu_torch.router.scheduling import KvRouterConfig, WorkerSelector
from dynamo_tpu_torch.router.sequences import ActiveSequences
from dynamo_tpu_torch.runtime import tracing
from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.runtime.fleet_observer import RoutingAudit
from dynamo_tpu_torch.runtime.request_plane import PushRouter, RequestPlaneError
from dynamo_tpu_torch.runtime.tasks import spawn_tracked
from dynamo_tpu_torch.tokens.hashing import block_hashes, mm_content_seed, request_seed

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
        # kv_prefetch hints ahead of the request, to workers that advertise
        # a prefetch manager; fire-and-forget, and an instance whose hint
        # endpoint errors is hinted no more
        self.prefetch_hints = True
        self._prefetch_client = None  # {ns}/{comp}/kv_prefetch, lazily
        self._prefetch_bad: set = set()
        self._prefetch_tasks: set = set()
        # measured per-(worker, tier) onboard costs (bind_tier_costs: () ->
        # {worker: {tier: s_per_block}}), snapshotted at most once a second
        # (find_best_match is the per-request hot path); None keeps the
        # config's constant priors
        self.tier_cost_fn = None
        self._tier_costs_cache: Dict[Worker, Dict[str, float]] = {}
        self._tier_costs_at = 0.0
        # routing decisions with their candidates' cost breakdowns
        self.audit = RoutingAudit()
        # per-trunk (first block hash) popularity: a hot trunk is
        # replicated once onto a slice that holds none of it
        self.prefix_stats = {"replications": 0, "hot_trunks": 0}
        self._trunk_pop: "OrderedDict[int, int]" = OrderedDict()
        self._trunk_replicated: Dict[int, float] = {}  # trunk -> mono ts
        self.replicate_hot_threshold = 8
        self.replicate_cooldown_s = 30.0
        self._trunk_cap = 4096

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
    def bind_tier_costs(self, fn) -> None:
        """Late-bind the measured-cost source."""
        self.tier_cost_fn = fn

    def _tier_costs(self) -> Dict[Worker, Dict[str, float]]:
        if self.tier_cost_fn is None:
            return {}
        now = time.monotonic()
        if now - self._tier_costs_at > 1.0:
            try:
                self._tier_costs_cache = self.tier_cost_fn() or {}
            except Exception:
                log.debug("tier cost snapshot failed", exc_info=True)
                self._tier_costs_cache = {}
            self._tier_costs_at = now
        return self._tier_costs_cache

    def workers(self) -> List[Worker]:
        out: List[Worker] = []
        for inst in self.client.instances.values():
            dp = int((inst.metadata or {}).get("dp_size", 1))
            out.extend((inst.instance_id, r) for r in range(dp))
        return sorted(out)

    def _slice_of(self, instance_id: int) -> Optional[str]:
        """A worker's kv_slice label; None: topology unknown."""
        inst = self.client.instances.get(instance_id)
        if inst is None:
            return None
        s = (inst.metadata or {}).get("kv_slice")
        return str(s) if s is not None else None

    def _link_classes(self, workers: List[Worker],
                      host_overlaps: Dict[Worker, int]) -> Dict[Worker, str]:
        """Each candidate's link to the best G2 holder: the same slice
        "ici", another "dcn". Candidates or holders without a slice stay
        absent (the selector's flat "remote" prior)."""
        holder, best_n = None, 0
        for w, n in sorted(host_overlaps.items()):
            if n > best_n:
                holder, best_n = w, n
        out: Dict[Worker, str] = {}
        if holder is None:
            return out
        h_slice = self._slice_of(holder[0])
        if h_slice is None:
            return out
        for w in workers:
            if w[0] == holder[0]:
                continue  # its own lower tier, not a peer pull
            w_slice = self._slice_of(w[0])
            if w_slice is not None:
                out[w] = "ici" if w_slice == h_slice else "dcn"
        return out

    def find_best_match(
        self, token_ids: List[int], adapter: Optional[str] = None,
        mm_seed: Optional[int] = None, pinned_instance: Optional[int] = None,
        collect: Optional[Dict[str, Any]] = None, allowed_instances=None,
    ) -> Tuple[Worker, int, List[int]]:
        """Returns (worker, overlap blocks, block hashes). `adapter` and
        `mm_seed` seed the hash chain as the worker's scheduler does
        (request_seed), so a LoRA request scores overlap only against its
        own lineage's blocks; `pinned_instance` restricts selection to
        that instance's ranks; `allowed_instances` (the LoRA filter) to
        the replicas holding the adapter, before cost-based selection;
        `collect` receives the host and object overlaps (for the hints,
        without a second walk) and the candidates' cost breakdowns."""
        hashes = block_hashes(token_ids, self.block_size, request_seed(adapter, mm_seed))
        overlaps = self.indexer.index.find_matches(hashes)
        host_overlaps = self.indexer.host_index.find_matches(hashes).scores
        obj_overlaps = self.indexer.obj_index.find_matches(hashes).scores
        if collect is not None:
            collect["host_overlaps"] = host_overlaps
            collect["obj_overlaps"] = obj_overlaps
        workers = self.workers()
        if allowed_instances is not None:
            workers = [w for w in workers if w[0] in allowed_instances]
            if not workers:
                raise RequestPlaneError(f"no workers hold adapter {adapter!r}",
                                        code="no_instances")
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
        cand_audit: List[dict] = []
        worker, overlap = self.selector.select(
            workers, len(hashes), overlaps, self.sequences,
            host_overlaps=host_overlaps, tier_costs=self._tier_costs(),
            link_class=self._link_classes(workers, host_overlaps),
            obj_overlaps=obj_overlaps, audit=cand_audit)
        if collect is not None:
            collect["candidates"] = cand_audit
        return worker, overlap, hashes

    def _kv_path(self, endpoint: str) -> str:
        ns, comp = self.client.path.split("/")[:2]
        return f"{ns}/{comp}/{endpoint}"

    def remote_host_hint(
        self, hashes: List[int], selected: Worker, overlap: int,
        seed: Optional[int], host_overlaps: Optional[Dict[Worker, int]] = None,
    ) -> Optional[Dict[str, Any]]:
        """When a peer's lower tier holds a longer prefix than the
        selected worker holds anywhere, tell the selected worker where to
        pull the rest from: the suffix past its own best run, anchored on
        its last local block (or `seed`)."""
        if not hashes:
            return None
        host = (host_overlaps if host_overlaps is not None
                else self.indexer.host_index.find_matches(hashes).scores)
        local_best = max([overlap] + [n for w, n in host.items()
                                      if w[0] == selected[0]])
        peer, peer_n = None, local_best
        for w, n in sorted(host.items()):
            if w[0] != selected[0] and n > peer_n:
                peer, peer_n = w, n
        if peer is None:
            return None
        chain = hashes[local_best:peer_n]
        anchor = hashes[local_best - 1] if local_best > 0 else seed
        hint = {
            "instance": peer[0],
            "path": self._kv_path("kv_host_fetch"),
            "hashes": chain,
            "parents": [anchor] + chain[:-1],
        }
        # the pull's link class: the worker notes its onboard EWMA under
        # remote_<link>
        sel_slice = self._slice_of(selected[0])
        peer_slice = self._slice_of(peer[0])
        if sel_slice is not None and peer_slice is not None:
            hint["link"] = "ici" if sel_slice == peer_slice else "dcn"
        return hint

    # -- predictive prefetch (kvbm/prefetch.py) -----------------------------
    def prefetch_hint(
        self, hashes: List[int], selected: Worker, overlap: int,
        seed: Optional[int], host_overlaps: Optional[Dict[Worker, int]] = None,
        remote: Optional[Dict[str, Any]] = None,
    ) -> Optional[Dict[str, Any]]:
        """The blocks the selected worker will onboard from its lower
        tiers beyond its device overlap, plus those a remote hint's pull
        will land in its G2; None when nothing below G1 is worth
        promoting or the worker runs no prefetch manager."""
        if not self.prefetch_hints or not hashes:
            return None
        if selected[0] in self._prefetch_bad:
            return None
        inst = self.client.instances.get(selected[0])
        if inst is None or not (inst.metadata or {}).get("kv_prefetch"):
            return None
        host = (host_overlaps if host_overlaps is not None
                else self.indexer.host_index.find_matches(hashes).scores)
        end = max([overlap] + [n for w, n in host.items() if w[0] == selected[0]])
        if remote is not None:
            # the remote chain goes on where the local tiers end
            end += len(remote.get("hashes") or [])
        chain = hashes[overlap:end]
        if not chain:
            return None
        anchor = hashes[overlap - 1] if overlap > 0 else seed
        hint: Dict[str, Any] = {"hashes": chain, "parents": [anchor] + chain[:-1]}
        if remote is not None:
            hint["remote"] = remote
        return hint

    def emit_prefetch(self, instance_id: int, hint: Dict[str, Any]) -> None:
        """Fire and forget: the hint races the request by design; losing
        the race leaves the worker's synchronous onboard as it was."""
        t = asyncio.get_running_loop().create_task(
            self._send_prefetch(instance_id, hint))
        self._prefetch_tasks.add(t)
        t.add_done_callback(self._prefetch_tasks.discard)

    async def _send_prefetch(self, instance_id: int, hint: Dict[str, Any]) -> None:
        try:
            if self._prefetch_client is None:
                # cached before the awaits; start() is idempotent
                self._prefetch_client = self.runtime.client(self._kv_path("kv_prefetch"))
            await self._prefetch_client.start()
            # the first hint races the discovery watch: wait briefly for
            # the target rather than mark it bad
            loop = asyncio.get_running_loop()
            deadline = loop.time() + 2.0
            while (instance_id not in self._prefetch_client.instances
                   and loop.time() < deadline):
                await asyncio.sleep(0.05)
            async for _ in self._prefetch_client.direct({"kv_prefetch": hint},
                                                        instance_id):
                break
        except Exception as e:
            # a dead instance or one without the endpoint: hint it no more
            self._prefetch_bad.add(instance_id)
            log.debug("kv_prefetch hint to %x failed: %s", instance_id, e)

    # -- hot trunks ---------------------------------------------------------
    def note_popularity(self, hashes: List[int]) -> Optional[int]:
        """Count the request's trunk (its first block hash), LRU-capped."""
        if not hashes:
            return None
        trunk = hashes[0]
        pop = self._trunk_pop
        pop[trunk] = pop.get(trunk, 0) + 1
        pop.move_to_end(trunk)
        if pop[trunk] == self.replicate_hot_threshold:
            self.prefix_stats["hot_trunks"] += 1
        while len(pop) > self._trunk_cap:
            pop.popitem(last=False)
        return trunk

    def maybe_replicate(self, hashes: List[int], seed: Optional[int],
                        host_overlaps: Optional[Dict[Worker, int]] = None) -> None:
        """Replicate a hot trunk onto one slice that holds none of it,
        through the prefetch and peer-pull path; once a cooldown per
        trunk, fire and forget."""
        trunk = self.note_popularity(hashes)
        if trunk is None or not self.prefetch_hints:
            return
        if self._trunk_pop.get(trunk, 0) < self.replicate_hot_threshold:
            return
        now = time.monotonic()
        last = self._trunk_replicated.get(trunk)
        if last is not None and now - last < self.replicate_cooldown_s:
            return
        host = (host_overlaps if host_overlaps is not None
                else self.indexer.host_index.find_matches(hashes).scores)
        src, src_n = None, 0
        for w, n in sorted(host.items()):
            if n > src_n:
                src, src_n = w, n
        if src is None:
            return  # nothing in any G2 to pull from yet
        # the slices that hold (part of) the trunk, any tier
        dev = self.indexer.index.find_matches(hashes).scores
        holder_slices = set()
        for w, n in list(host.items()) + list(dev.items()):
            if n > 0:
                s = self._slice_of(w[0])
                if s is not None:
                    holder_slices.add(s)
        if not holder_slices:
            return  # no topology metadata: nothing to spread across
        target = None
        for w in self.workers():
            if w[0] == src[0] or w[0] in self._prefetch_bad:
                continue
            s = self._slice_of(w[0])
            if s is None or s in holder_slices:
                continue
            inst = self.client.instances.get(w[0])
            if inst is None or not (inst.metadata or {}).get("kv_prefetch"):
                continue
            target = w
            break
        if target is None:
            return  # every slice holds it already (or cannot prefetch)
        self._trunk_replicated[trunk] = now
        if len(self._trunk_replicated) > self._trunk_cap:
            for k in sorted(self._trunk_replicated,
                            key=self._trunk_replicated.get)[
                                :len(self._trunk_replicated) - self._trunk_cap]:
                self._trunk_replicated.pop(k, None)
        self.prefix_stats["replications"] += 1
        chain = hashes[:src_n]
        remote: Dict[str, Any] = {
            "instance": src[0],
            "path": self._kv_path("kv_host_fetch"),
            "hashes": chain,
            "parents": [seed] + chain[:-1],
        }
        t_slice, s_slice = self._slice_of(target[0]), self._slice_of(src[0])
        if t_slice is not None and s_slice is not None:
            remote["link"] = "ici" if t_slice == s_slice else "dcn"
        self.emit_prefetch(target[0], {
            "hashes": chain, "parents": [seed] + chain[:-1], "remote": remote})

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
        # the client may outlive this router (a LoRA adapter entry's router
        # over its base model's client)
        off = getattr(self.client, "off_instance_change", None)
        if off is not None:
            off(self._on_instance)
        for t in list(self._prefetch_tasks):
            t.cancel()
        if self._prefetch_client is not None:
            await self._prefetch_client.close()
        await self.indexer.stop()


class KvPushRouter:
    """Pipeline engine: KV-aware selection → direct push → lifecycle."""

    def __init__(self, router: KvRouter):
        self.router = router

    async def generate(self, request: Dict[str, Any], context: Context) -> AsyncIterator[Any]:
        t_route = time.monotonic()
        await self.router.start()
        # the route hop's span covers admission and selection; the direct
        # rpc and the hinted pulls and promotions child off it
        with tracing.span("route.kv", parent=context.metadata.get("traceparent")) as rspan:
            # parks here while every worker is saturated; raises queue_full
            # / queue_timeout (HTTP 429) on rejection
            await self.router.admission.acquire(request.get("priority"))
            collect: Dict[str, Any] = {}
            mm = request.get("mm")
            mm_seed = mm_content_seed(mm["data"]) if mm else None
            allowed = context.metadata.get("allowed_instances")
            worker, overlap, hashes = self.router.find_best_match(
                request.get("token_ids") or [], adapter=request.get("adapter"),
                mm_seed=mm_seed, pinned_instance=context.metadata.get("target_instance"),
                collect=collect,
                allowed_instances=set(allowed) if allowed is not None else None)
            host_overlaps = collect.get("host_overlaps")
            # the hash chain's seed: the anchor of the hints' first parents
            seed = request_seed(request.get("adapter"), mm_seed)
            rtp = getattr(rspan, "traceparent", None)
            hint = self.router.remote_host_hint(hashes, worker, overlap, seed,
                                                host_overlaps=host_overlaps)
            if hint is not None:
                if rtp:
                    hint["traceparent"] = rtp
                request = dict(request)
                request["kv_remote_host"] = hint
            pf = self.router.prefetch_hint(hashes, worker, overlap, seed,
                                           host_overlaps=host_overlaps, remote=hint)
            if pf is not None:
                if rtp:
                    pf["traceparent"] = rtp
                self.router.emit_prefetch(worker[0], pf)
            # count the trunk; replicate it onto a cold slice once it
            # proves hot (fire and forget, off the request's path)
            try:
                self.router.maybe_replicate(hashes, seed, host_overlaps=host_overlaps)
            except Exception:
                log.debug("hot-trunk replication failed", exc_info=True)
            rid = context.id
            self.router.add_request(rid, worker, hashes, overlap)
            context.metadata["kv_overlap_blocks"] = overlap
            context.metadata["routed_instance"] = worker[0]
            self.router.audit.record(
                rid, "kv", worker, candidates=collect.get("candidates"),
                overlap_blocks=overlap, total_blocks=len(hashes),
                remote_hint=hint is not None, prefetch_hint=pf is not None)
            # the selection's cost (admission wait included), accumulated
            # across migration retries; the metadata rides to the worker
            ph = context.metadata.setdefault("phases", {})
            ph["route_s"] = ph.get("route_s", 0.0) + (time.monotonic() - t_route)
            rspan.set_attribute("request.id", rid)
            rspan.set_attribute("router.mode", "kv")
            rspan.set_attribute("routed.instance", worker[0])
            rspan.set_attribute("kv.overlap_blocks", overlap)
            tracing.child_traceparent(context.metadata, rspan)
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
