"""Model discovery and the per-model serving chain.

Port of dynamo_tpu/frontend/service.py `ModelEntry`, `ModelManager` and
`ModelWatcher`. Workers publish a ModelCard in their instance metadata;
the watcher reacts to discovery events, builds a chain per model

    Migration → Backend (detokenize, stops) → PrefillRouter → router → worker

and tears it down when the model's last instance goes. The router is the
EndpointClient's PushRouter (round_robin, random, p2c, least_loaded) or,
in `kv` mode, a KvPushRouter. Instances registered with the prefill role
activate the PrefillRouter; in `kv` mode it picks among them by KV
overlap through a second KvRouter over the prefill pool.

LoRA adapters a card lists (ModelCard.adapters) become models of their
own: an adapter entry shares its base model's client, has a chain and a
preprocessor of its own (which stamps the adapter into every request),
and lists as instances only the workers whose card holds the adapter. Its
chain head (`_AdapterGate`) stamps those holders into the routing context
(`allowed_instances`), so every picker below (PushRouter modes, the KV
router's cost selection) chooses among them only; its PrefillRouter hops
only to prefill workers holding it (`_restrict_adapter_prefill`; with
none, aggregated). An adapter a worker loads at run time reaches the
watcher as a republished card; the entry goes when its last holder does.

Observability: `ModelManager.routing_audits()` gathers every router's
decision ring (the /debug/routing source), and a `tier_cost_source` the
frontend binds (its FleetObserver's measured onboard costs) prices the
lower KV tiers of every KV router the watcher builds.

Not ported yet: session affinity, the encoder stage (A.12), the
`kv-remote` and `device_aware` modes.
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Set

from dynamo_tpu_torch.frontend.backend import BackendOperator
from dynamo_tpu_torch.frontend.migration import Migration
from dynamo_tpu_torch.frontend.preprocessor import Preprocessor
from dynamo_tpu_torch.frontend.protocols import ModelCard
from dynamo_tpu_torch.router.kv_router import KvPushRouter, KvRouter
from dynamo_tpu_torch.router.prefill_router import DisaggPolicy, PrefillRouter
from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.runtime.pipeline import StageSpec, build_chain
from dynamo_tpu_torch.runtime.request_plane import RouterMode

log = logging.getLogger("dynamo_tpu_torch.frontend")

ROUTER_MODES = (RouterMode.ROUND_ROBIN, RouterMode.RANDOM, RouterMode.P2C,
                RouterMode.LEAST_LOADED, "kv")


@dataclass
class ModelEntry:
    card: ModelCard
    endpoint_path: str
    preprocessor: Preprocessor
    client: Any  # EndpointClient over the model's generate endpoint
    chain: Any  # runtime.pipeline.Chain
    instance_ids: Set[int] = field(default_factory=set)
    prefill_client: Any = None
    prefill_instance_ids: Set[int] = field(default_factory=set)
    prefill_kv_router: Any = None  # KvRouter over the prefill pool (kv mode)
    owns_client: bool = True  # False for a LoRA adapter entry (shared client)
    adapter_names: Set[str] = field(default_factory=set)  # entries this base spawned
    # base entries: each prefill instance's adapters (the adapter entries'
    # prefill-pool restriction), and the pool's kv_fetch path (for an
    # adapter entry made after the pool was activated)
    prefill_instance_adapters: Dict[int, Set[str]] = field(default_factory=dict)
    prefill_fetch_path: Optional[str] = None

    @property
    def prefill_router(self) -> Optional[PrefillRouter]:
        return self.chain.get("prefill_router")

    async def close(self) -> None:
        await self.chain.teardown()
        # claim before the await, so a concurrent close cannot stop twice
        router, self.prefill_kv_router = self.prefill_kv_router, None
        if router is not None:
            await router.stop()
        if self.prefill_client is not None:
            await self.prefill_client.close()
        if self.owns_client:
            await self.client.close()


class ModelManager:
    """The per-model serving chains the HTTP layer dispatches to."""

    def __init__(self):
        self.models: Dict[str, ModelEntry] = {}

    def get(self, model: str) -> ModelEntry:
        entry = self.models.get(model)
        if entry is None:
            raise KeyError(f"model {model!r} not found")
        return entry

    def list_models(self) -> list:
        return sorted(self.models)

    def routing_audits(self) -> Dict[str, Any]:
        """{label: RoutingAudit} across entries: the /debug/routing source.
        Labels name the model and the router that recorded the decision."""
        audits: Dict[str, Any] = {}
        for name, entry in self.models.items():
            if not entry.owns_client:
                continue  # adapter entries share the base's client and sink
            for label, obj in (
                    (f"{name}/kv", getattr(entry.chain.sink, "router", None)),
                    (f"{name}/push", getattr(entry.client, "router", None)),
                    (f"{name}/prefill_kv", entry.prefill_kv_router),
                    (f"{name}/prefill_push",
                     getattr(entry.prefill_client, "router", None))):
                audit = getattr(obj, "audit", None)
                if audit is not None:
                    audits[label] = audit
        return audits


class ModelWatcher:
    """Watches discovery; builds and tears down ModelEntries."""

    def __init__(
        self,
        runtime,
        manager: ModelManager,
        router_mode: str = RouterMode.ROUND_ROBIN,
        migration_limit: int = 3,
        disagg_min_prefill_tokens: int = 256,
        admission_config=None,  # router.queue.AdmissionConfig (kv mode)
        router_config=None,  # router.scheduling.KvRouterConfig (kv mode)
        router_kv_events: bool = True,  # False: approximate mode (TTL)
    ):
        if router_mode not in ROUTER_MODES:
            raise ValueError(f"router mode {router_mode!r} (expected one of "
                             f"{', '.join(ROUTER_MODES)})")
        self.runtime = runtime
        self.manager = manager
        self.router_mode = router_mode
        self.migration_limit = migration_limit
        self.disagg_min_prefill_tokens = disagg_min_prefill_tokens
        self.admission_config = admission_config
        self.router_config = router_config
        self.router_kv_events = router_kv_events
        self._task: Optional[asyncio.Task] = None
        self._ready = asyncio.Event()
        # prefill-role instances seen before their model's entry existed
        self._pending_prefill: Dict[str, list] = {}
        self._refused: Set[str] = set()  # models whose card was refused
        # the measured onboard-cost source of the KV routers' tier pricing:
        # () -> {worker: {tier: s_per_block}}, bound by the frontend once
        # its FleetObserver exists (the routers read it late)
        self.tier_cost_source = None

    def _tier_costs(self):
        src = self.tier_cost_source
        return src() if src is not None else {}

    def _kv_router(self, card: ModelCard, client) -> KvRouter:
        router = KvRouter(self.runtime, client, block_size=card.kv_block_size,
                          config=self.router_config, use_kv_events=self.router_kv_events,
                          admission=self.admission_config)
        router.bind_tier_costs(self._tier_costs)
        return router

    def _build_chain(self, card: ModelCard, client, pre: Preprocessor):
        if self.router_mode == "kv":
            kv_router = self._kv_router(card, client)
            sink, sink_teardown = KvPushRouter(kv_router), kv_router.stop
        else:
            sink, sink_teardown = _ClientEngine(client), None
        specs = [
            StageSpec("migration", lambda inner, ctx: Migration(
                inner, migration_limit=self.migration_limit)),
            StageSpec("backend", lambda inner, ctx: BackendOperator(pre.tokenizer, inner)),
            StageSpec("prefill_router", lambda inner, ctx: PrefillRouter(
                inner, DisaggPolicy(min_prefill_tokens=self.disagg_min_prefill_tokens))),
        ]
        return build_chain(specs, sink, self, sink_teardown=sink_teardown)

    async def start(self) -> None:
        if self._task is None:
            self._task = asyncio.create_task(self._watch())

    async def wait_for_model(self, timeout: float = 30.0) -> None:
        await self.start()
        await asyncio.wait_for(self._ready.wait(), timeout)

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None
        for entry in self.manager.models.values():
            await entry.close()
        self.manager.models.clear()

    async def _watch(self) -> None:
        try:
            async for ev in self.runtime.discovery.watch("services/"):
                inst = ev.instance
                card_dict = (inst.metadata or {}).get("model_card")
                if not card_dict:
                    continue
                card = ModelCard.from_dict(card_dict)
                if ev.kind == "put":
                    await self._on_put(card, inst)
                else:
                    await self._on_delete(card, inst)
        except asyncio.CancelledError:
            pass
        except Exception:  # the watch is the boundary that must report
            log.exception("model watcher failed")

    async def _on_put(self, card: ModelCard, inst) -> None:
        if (inst.metadata or {}).get("disagg_role") == "prefill":
            await self._on_prefill_put(card, inst)
            return
        entry = self.manager.models.get(card.name)
        if entry is None:
            try:
                pre = Preprocessor(card)
            except ValueError as e:
                if card.name not in self._refused:
                    self._refused.add(card.name)
                    log.error("model %s refused: %s", card.name, e)
                return
            client = self.runtime.client(inst.endpoint_address.path, self.router_mode)
            await client.start()
            entry = ModelEntry(card=card, endpoint_path=inst.endpoint_address.path,
                               preprocessor=pre, client=client,
                               chain=self._build_chain(card, client, pre))
            self.manager.models[card.name] = entry
            log.info("model %s added (endpoint %s)", card.name, entry.endpoint_path)
            for pending in self._pending_prefill.pop(card.name, []):
                await self._on_prefill_put(card, pending)
        # the LoRA adapters this instance serves, each a model; on every
        # put, so a later replica's (or a runtime load's) new adapter
        # registers too
        held = set(card.adapters or [])
        for aname in sorted(held):
            self._ensure_adapter_entry(entry, card, aname)
        entry.instance_ids.add(inst.instance_id)
        # an adapter entry lists only the replicas holding its adapter:
        # the set its routing filters on
        for aname in entry.adapter_names:
            aentry = self.manager.models.get(aname)
            if aentry is None:
                continue
            if aname in held:
                aentry.instance_ids.add(inst.instance_id)
            else:
                aentry.instance_ids.discard(inst.instance_id)
        self._ready.set()

    def _ensure_adapter_entry(self, entry: ModelEntry, card: ModelCard,
                              aname: str) -> None:
        """The adapter's entry: the base's client, its own preprocessor
        (stamping the adapter) and chain, under `_AdapterGate`."""
        if aname in self.manager.models:
            entry.adapter_names.add(aname)
            return
        acard = dataclasses.replace(card, name=aname, adapters=[])
        apre = Preprocessor(acard, tokenizer=entry.preprocessor.tokenizer, adapter=aname)
        aentry = ModelEntry(card=acard, endpoint_path=entry.endpoint_path,
                            preprocessor=apre, client=entry.client,
                            chain=self._build_chain(acard, entry.client, apre),
                            owns_client=False)
        aentry.chain = _AdapterGate(aentry.chain, aentry)
        self.manager.models[aname] = aentry
        entry.adapter_names.add(aname)
        self._restrict_adapter_prefill(entry, aname, aentry)
        if entry.prefill_client is not None and entry.prefill_fetch_path:
            # an adapter after the prefill pool's activation joins it now
            aentry.prefill_router.activate(entry.prefill_client, entry.prefill_fetch_path,
                                           kv_router=entry.prefill_kv_router)
        log.info("adapter %s added (base %s)", aname, card.name)

    def _restrict_adapter_prefill(self, entry: ModelEntry, aname: str,
                                  aentry: ModelEntry) -> None:
        """The prefill pool's face of the LoRA filter: hops for this
        adapter go only to prefill workers holding it; with none, the
        empty set makes every hop fall back to aggregated serving."""
        aentry.prefill_router.restrict_prefill(
            {pid for pid, pads in entry.prefill_instance_adapters.items()
             if aname in pads})

    async def _on_prefill_put(self, card: ModelCard, inst) -> None:
        entry = self.manager.models.get(card.name)
        if entry is None:
            self._pending_prefill.setdefault(card.name, []).append(inst)
            return
        if entry.prefill_client is None:
            entry.prefill_client = self.runtime.client(inst.endpoint_address.path)
            await entry.prefill_client.start()
            addr = inst.endpoint_address
            fetch_path = f"{addr.namespace}/{addr.component}/kv_fetch"
            if self.router_mode == "kv":
                # a second KvRouter over the PREFILL pool, started now: its
                # workers' kv_state seeding must not ride the first
                # request's TTFT
                entry.prefill_kv_router = self._kv_router(card, entry.prefill_client)
                await entry.prefill_kv_router.start()
            entry.prefill_fetch_path = fetch_path
            entry.prefill_router.activate(entry.prefill_client, fetch_path,
                                          kv_router=entry.prefill_kv_router)
            # the adapter entries disaggregate too, over the same pool
            for aentry in self._adapter_entries(entry):
                aentry.prefill_router.activate(entry.prefill_client, fetch_path,
                                               kv_router=entry.prefill_kv_router)
        entry.prefill_instance_ids.add(inst.instance_id)
        # from the instance's own card: a pending prefill instance is
        # joined under its decode peer's card
        own = (inst.metadata or {}).get("model_card") or {}
        entry.prefill_instance_adapters[inst.instance_id] = set(own.get("adapters") or [])
        for aname in entry.adapter_names:
            aentry = self.manager.models.get(aname)
            if aentry is not None:
                self._restrict_adapter_prefill(entry, aname, aentry)

    def _adapter_entries(self, entry: ModelEntry):
        return [self.manager.models[a] for a in sorted(entry.adapter_names)
                if a in self.manager.models]

    async def _on_delete(self, card: ModelCard, inst) -> None:
        pending = self._pending_prefill.get(card.name)
        if pending:
            pending[:] = [p for p in pending if p.instance_id != inst.instance_id]
        entry = self.manager.models.get(card.name)
        if entry is None:
            return
        if (inst.metadata or {}).get("disagg_role") == "prefill":
            entry.prefill_instance_ids.discard(inst.instance_id)
            entry.prefill_instance_adapters.pop(inst.instance_id, None)
            for aname in entry.adapter_names:
                aentry = self.manager.models.get(aname)
                if aentry is not None:
                    self._restrict_adapter_prefill(entry, aname, aentry)
            if not entry.prefill_instance_ids:
                entry.prefill_router.deactivate()
                for aentry in self._adapter_entries(entry):
                    aentry.prefill_router.deactivate()
                entry.prefill_fetch_path = None
                router, entry.prefill_kv_router = entry.prefill_kv_router, None
                if router is not None:
                    await router.stop()
                client, entry.prefill_client = entry.prefill_client, None
                if client is not None:
                    await client.close()
            return
        entry.instance_ids.discard(inst.instance_id)
        # an adapter entry goes with its last holder
        for aname in sorted(entry.adapter_names):
            aentry = self.manager.models.get(aname)
            if aentry is None:
                continue
            aentry.instance_ids.discard(inst.instance_id)
            if not aentry.instance_ids:
                del self.manager.models[aname]
                entry.adapter_names.discard(aname)
                await aentry.close()
                log.info("adapter %s removed (last holder gone)", aname)
        if not entry.instance_ids:
            del self.manager.models[card.name]
            await entry.close()
            log.info("model %s removed (last instance gone)", card.name)


class _AdapterGate:
    """An adapter entry's chain head: stamps the entry's live holders (the
    replicas whose card lists its adapter) into the routing context as
    `allowed_instances`, so every picker below filters before it selects
    (the reference's two-stage LoRA-filtered routing). With no holder the
    pick raises no_instances: a clean error, not an "unknown adapter" one
    from an arbitrary worker. Stages and teardown are the chain's."""

    def __init__(self, inner, entry: ModelEntry):
        self.inner = inner
        self.entry = entry

    async def generate(self, request: Any, context: Context):
        # a list, not a set: the metadata stays serializable
        context.metadata["allowed_instances"] = sorted(self.entry.instance_ids)
        async for item in self.inner.generate(request, context):
            yield item

    def get(self, name: str):
        return self.inner.get(name)

    @property
    def sink(self):
        return self.inner.sink

    async def teardown(self) -> None:
        await self.inner.teardown()


class _ClientEngine:
    """EndpointClient as an AsyncEngine (the router egress node)."""

    def __init__(self, client):
        self.client = client

    async def generate(self, request: Any, context: Context):
        async for item in self.client.generate(request, context):
            yield item
