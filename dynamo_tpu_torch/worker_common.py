"""Serve an InferenceEngine over the runtime: the generate, kv_fetch and
kv_state endpoints, KV events and forward-pass metrics on the event plane,
and the decode side of disaggregated serving.

Port of dynamo_tpu/worker_common.py `ServedWorker`, `serve_worker`,
`LOCAL_ENGINES`, `DisaggDecodeAdapter`, the `kv_fetch` endpoint and the
KV tiers' endpoints: `kv_host_fetch` (a peer pulls up to
MAX_HOST_FETCH_BLOCKS of this worker's lower-tier blocks), `kv_prefetch`
(the router's promotion hints; advertised as `kv_prefetch` metadata when
the engine runs a prefetch manager) and the engine's `remote_kv_fetch`
(the pull of a peer's blocks a `kv_remote_host` hint names). A
request carrying `kv_transfer_src` pulls the prefill worker's parked KV
before admission: from a colocated engine (same process, registered in
`LOCAL_ENGINES`) on the device, gathered on the prefill engine's step
thread and scattered on the decode engine's; from any other instance
host-staged, through an EndpointClient to that instance's `kv_fetch`
endpoint, in chunks of `chunk_pages` pages (0: one payload). The `rl`
admin endpoint (`rl_admin`): `describe`, `pause` / `resume` (the engine's
admission gate) and `load_adapter` (a LoRA adapter into a free slot, from
a PEFT directory or random factors from a seed, zero-padded to the
tree's rank; the card republished so the frontend routes the adapter to
this worker) and `update_weights` (the engine reloads a params snapshot
and flushes its KV state; the reply carries the new weights_version).
Observability: the fleet digest (`digest_period_s` > 0: a
DigestPublisher on the event plane, advertised as `digest_publisher`
metadata), the latency spine and the dispatch families
(`dynamo_compile_variants{family}`) on the runtime's metrics, the flight
recorder's anomaly counter (advertised as `flight_recorder`), and the
remote-G2 pull as a `kv.peer_pull` span under the router's route span.
The shadow server is not ported yet.
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
import os
import time
import weakref
from typing import Any, AsyncIterator, Dict, Optional

from dynamo_tpu_torch.frontend.protocols import ModelCard
from dynamo_tpu_torch.models import lora as lora_mod
from dynamo_tpu_torch.router.protocols import FPM_SUBJECT
from dynamo_tpu_torch.router.publisher import KvEventPublisher
from dynamo_tpu_torch.runtime.component import Instance, new_instance_id
from dynamo_tpu_torch.runtime import tracing
from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.runtime.engine import FnEngine
from dynamo_tpu_torch.runtime.fleet_observer import DigestBuilder, DigestPublisher
from dynamo_tpu_torch.runtime.tasks import spawn_tracked

log = logging.getLogger("dynamo_tpu_torch.worker")

# in-process engine registry: when prefill and decode engines share one
# process (colocated disagg), the KV transfer stays entirely on the device
LOCAL_ENGINES: "weakref.WeakValueDictionary" = weakref.WeakValueDictionary()

# the most blocks one kv_host_fetch reply carries (64 blocks of the 3B:
# ~117 MB in bf16)
MAX_HOST_FETCH_BLOCKS = 64


async def kv_fetch(engine, request: Dict[str, Any]) -> AsyncIterator[Any]:
    """The prefill worker's parked-KV pull: `chunk_pages` selects the
    streamed export (bounded payloads, chunk reads interleaved with the
    prefill engine's steps); absent keeps the single-payload path."""
    chunk = int(request.get("chunk_pages") or 0)
    rid = request.get("request_id")
    if chunk > 0:
        any_sent = False
        finished = False
        try:
            async for part in engine.export_parked_kv_stream(rid, chunk):
                any_sent = True
                yield part
            finished = True
            if not any_sent:
                yield {}  # parked entry gone: caller recomputes
        finally:
            if not finished:
                # puller died mid-stream: release the parked pages now
                # instead of pinning them for the full TTL
                await engine.export_parked_kv(rid, discard=True)
        return
    yield await engine.export_parked_kv(rid, discard=bool(request.get("discard")))


class DisaggDecodeAdapter:
    """Wraps the decode engine: requests carrying kv_transfer_src pull the
    parked KV pages from the prefill worker before admission. A failed or
    truncated pull falls back to local recompute, counted in
    `fallbacks`."""

    def __init__(self, engine, runtime, chunk_pages: int = 16):
        self.engine = engine
        self.runtime = runtime
        self.chunk_pages = chunk_pages  # 0 = monolithic single-payload pull
        self.fallbacks = 0
        self._fetch_clients: Dict[str, Any] = {}

    async def _fetch(self, src) -> Optional[dict]:
        local = LOCAL_ENGINES.get(src["instance_id"])
        if local is not None and local is not self.engine:
            # device-resident transfer: gather on the prefill engine's step
            # thread, scatter on ours — no bytes touch the host
            return await local.export_parked_kv_device(src["request_id"])
        path = src["path"]
        client = self._fetch_clients.get(path)
        if client is None:
            client = self._fetch_clients[path] = self.runtime.client(path)
        # the source names the instance's address: no discovery wait
        client.router.update_instance(src["instance_id"], src["address"])
        req = {"request_id": src["request_id"]}
        if self.chunk_pages:
            req["chunk_pages"] = self.chunk_pages
        chunks = []
        async for item in client.direct(req, src["instance_id"], Context()):
            if not self.chunk_pages:
                return item
            if item:
                chunks.append(item)
        if not chunks:
            return None
        if len(chunks) == 1 and "offset" not in chunks[0]:
            return chunks[0]  # the monolithic path answered
        if not any(c.get("data") for c in chunks):
            return None  # empty transfer: recompute locally
        # a truncated stream (prefill-side expiry/abort mid-transfer) must
        # trigger local recompute, never a half-imported KV cache
        total = int(chunks[0].get("total_pages") or 0)
        covered = sum(int(c.get("n_pages") or 0) for c in chunks)
        if total and covered < total:
            log.warning("chunked KV pull truncated (%d/%d pages); recomputing",
                        covered, total)
            return None
        return {"chunks": chunks}

    async def generate(self, request, context):
        src = request.get("kv_transfer_src")
        if src is not None:
            t0 = time.monotonic()
            try:
                payload = await self._fetch(src)
            except Exception as e:
                log.warning("kv fetch from prefill worker failed: %s", e)
                payload = None
            request = dict(request)
            if payload is not None and (
                payload.get("data") or payload.get("device") or payload.get("chunks")
            ):
                request["kv_import"] = payload
            else:
                # transfer failed → recompute prefill locally (aggregated)
                self.fallbacks += 1
                ann = dict(request.get("annotations") or {})
                ann.pop("disagg", None)
                request["annotations"] = ann
            request.pop("kv_transfer_src", None)
            # latency spine: the pull's wall time rides to the final item
            phases = dict(context.metadata.get("phases") or {})
            phases["kv_fetch_s"] = time.monotonic() - t0
            context.metadata["phases"] = phases
        async for item in self.engine.generate(request, context):
            yield item

    async def close(self) -> None:
        for client in self._fetch_clients.values():
            await client.close()
        self._fetch_clients.clear()


async def rl_admin(engine, card: ModelCard, request: Dict[str, Any],
                   republish, instance_id: int) -> Dict[str, Any]:
    """One op of the `rl` endpoint (the reference's lib/rl role), as its
    reply: `describe` (the default), `pause`, `resume`, `load_adapter`
    ({"name", "peft"?: dir, "seed"?, "scale"?, "rank"?}) and
    `update_weights` ({"orbax": a params snapshot dir}, the reference's
    key; engine/weights.py `save_snapshot` writes one). `republish()`
    registers the instance again with the card after a load. Failures
    come back as {"error": ...}."""
    op = request.get("op", "describe")
    if op == "pause":
        engine.paused = True
    elif op == "resume":
        engine.paused = False
    elif op == "load_adapter":
        return await _load_adapter(engine, card, request, republish, instance_id)
    elif op == "update_weights":
        path = request.get("orbax")
        if not path:
            return {"error": "update_weights needs 'orbax': <snapshot dir>"}
        try:
            version = await engine.update_weights(path)
        except Exception as e:
            return {"error": f"weight reload failed: {e}"}
        return {"model": card.name, "paused": bool(engine.paused),
                "weights_version": version, "instance": instance_id}
    elif op != "describe":
        return {"error": f"unknown rl op {op!r}"}
    out = {"model": card.name, "paused": bool(getattr(engine, "paused", False)),
           "weights_version": int(getattr(engine, "weights_version", 0)),
           "adapters": list(card.adapters or []), "instance": instance_id}
    if getattr(engine, "weights_error", None):
        # a reload failed mid-copy: every request is refused until one succeeds
        out["weights_error"] = engine.weights_error
    return out


async def _load_adapter(engine, card: ModelCard, request: Dict[str, Any],
                        republish, instance_id: int) -> Dict[str, Any]:
    """Install an adapter into a free slot and republish the card: the
    frontend's watcher makes the name a model, or this worker one more
    of its holders. Slots are append-only: a registered name is refused
    (its factors would not change), a rank above the tree's too."""
    name = request.get("name")
    runner = getattr(engine, "runner", None)
    if not name:
        return {"error": "load_adapter needs 'name'"}
    if runner is None or getattr(runner, "lora", None) is None:
        return {"error": "worker built without --lora slots"}
    if name in runner.adapter_names:
        return {"error": f"adapter {name!r} already registered; "
                         "weight rollover needs a new name"}
    from dynamo_tpu_torch.worker import pad_rank

    try:
        if request.get("peft"):
            factors = await asyncio.to_thread(lora_mod.load_peft_adapter,
                                              request["peft"], runner.config)
        else:  # random dev factors from a seed
            factors = lora_mod.random_adapter(
                runner.config, rank=int(request.get("rank") or runner.lora_rank),
                targets=runner.lora_targets, seed=int(request.get("seed") or 0),
                scale=float(request.get("scale") or 2.0))
        factors = {k: pad_rank(k, a, runner.lora_rank) for k, a in factors.items()}
        # on the step thread: the slot is written between dispatches
        slot = await engine.call_on_step_thread(runner.register_adapter, name, factors)
    except Exception as e:
        return {"error": f"adapter load failed: {e}"}
    if name not in card.adapters:
        card.adapters = list(card.adapters) + [name]
    await republish()
    return {"model": card.name, "adapter": name, "slot": slot,
            "adapters": list(card.adapters), "instance": instance_id}


class ServedWorker:
    """What `serve_worker` started: the engine, its generate instance, the
    KV event publisher and the generate handler (the disagg adapter)."""

    def __init__(self, runtime, engine, instance: Instance, publisher,
                 handler: DisaggDecodeAdapter, fetch_clients=None, digest_pub=None):
        self.runtime = runtime
        self.engine = engine
        self.instance = instance
        self.publisher = publisher
        self.handler = handler
        self._fetch_clients = fetch_clients if fetch_clients is not None else {}
        self.digest_pub = digest_pub

    async def stop(self) -> None:
        """Stop the engine and what serves it (after the runtime drained);
        the digest publisher flushes its last window first."""
        if self.digest_pub is not None:
            await self.digest_pub.stop()
        self.engine.stop()
        if self.publisher is not None:
            await self.publisher.stop()
        await self.handler.close()
        for client in self._fetch_clients.values():
            await client.close()
        self._fetch_clients.clear()


async def serve_worker(
    runtime,
    engine,
    card: ModelCard,
    namespace: str = "dyn",
    component: str = "tpu-worker",
    endpoint: str = "generate",
    publish_kv_events: bool = True,
    publish_fpm: bool = True,
    disagg_role: Optional[str] = None,  # None/"both" | "prefill" | "decode"
    disagg_chunk_pages: int = 16,  # P->D pull chunk size (0 = monolithic)
    digest_period_s: float = 2.0,  # fleet digest publish period (0 = off)
    colocated: bool = True,  # enter LOCAL_ENGINES: same-process pulls of
    #   this instance's parked KV stay on the device
) -> ServedWorker:
    """Serve `engine` at `ns/component/{endpoint, kv_fetch, kv_state}` as
    one instance whose metadata carries the model card and the event
    publisher's address."""
    instance_id = new_instance_id()
    # a data rank mirrors its peers (parallel/group.py), so the worker
    # publishes data rank 0 alone, as the reference's worker does
    dp_rank = 0
    if colocated:
        LOCAL_ENGINES[instance_id] = engine
    metadata: Dict[str, Any] = {"model_card": card.to_dict(), "dp_rank": dp_rank}
    if disagg_role:
        metadata["disagg_role"] = disagg_role
    # topology label for link-class routing: one kv_slice is one island
    kv_slice = os.environ.get("DYN_KV_SLICE")
    if kv_slice:
        metadata["kv_slice"] = str(kv_slice)
    # the devices the worker's mesh spans (a tensor-parallel worker's ranks)
    mesh = getattr(getattr(engine, "runner", None), "mesh_config", None)
    if mesh is not None:
        metadata["device_weight"] = float(mesh.n_devices)

    publisher = None
    if publish_kv_events:
        publisher = KvEventPublisher(runtime.event_publisher(), instance_id,
                                     dp_rank=dp_rank)
        await publisher.start()
        engine.on_kv_event(publisher.on_engine_events)
        metadata["kv_publisher"] = publisher.address
        await runtime.serve_endpoint(f"{namespace}/{component}/kv_state",
                                     publisher.dump_state, instance_id=instance_id)

    loop = asyncio.get_running_loop()
    if publish_fpm:
        pub = runtime.event_publisher()

        def on_fpm(m) -> None:  # called from the engine step thread
            payload = dataclasses.asdict(m)
            payload["worker"] = [instance_id, dp_rank]

            def _send() -> None:
                spawn_tracked(pub.publish(FPM_SUBJECT, payload), logger=log)

            loop.call_soon_threadsafe(_send)

        engine.on_fpm(on_fpm)
        metadata["fpm_publisher"] = pub.address

    # latency spine -> metrics: per-finished-request phase durations
    # (queue_wait/ttft/kv_fetch/...; ITL samples fold into phase="itl")
    metrics = runtime.metrics.child(dynamo_namespace=namespace)

    def observe_phases(phases: dict) -> None:  # step thread
        for key, val in phases.items():
            if key == "itl_s" and isinstance(val, list):
                h = metrics.histogram("request_phase_seconds", phase="itl")
                for x in val:
                    h.observe(float(x))
            elif isinstance(val, (int, float)):
                metrics.histogram("request_phase_seconds",
                                  phase=key.removesuffix("_s")).observe(float(val))

    engine.on_phases(observe_phases)

    # the dispatch families (kind, bucket shapes) as the reference's
    # compile gauges, refreshed after each iteration's FPM; the port
    # compiles nothing per shape, so compile_seconds_total stays 0
    def update_compile_gauges(_m=None) -> None:
        for fam, st in engine.runner.compile_stats().items():
            metrics.gauge("compile_variants",
                          "compiled XLA variants per step-function family",
                          family=fam).set(st["variants"])
            metrics.gauge("compile_seconds_total",
                          "cumulative trace+compile wall seconds per family",
                          family=fam).set(0.0)

    engine.on_fpm(update_compile_gauges)
    update_compile_gauges()

    # the flight recorder's anomaly counter on the shared metrics, and the
    # recorder advertised so tooling knows /debug/timeline is live
    if engine.recorder.enabled:
        engine.recorder.bind_metrics(metrics)
        metadata["flight_recorder"] = True

    # the fleet digest plane: phase histograms, queue depth, KV tiers and
    # the measured onboard costs, pushed every period; the accumulation
    # hooks run on the step thread, the publish task on the event loop
    digest_pub = None
    if digest_period_s and digest_period_s > 0:
        builder = DigestBuilder(instance_id, dp_rank)
        engine.on_fpm(builder.observe_fpm)
        engine.on_phases(builder.observe_phases)
        digest_pub = DigestPublisher(builder, runtime.event_publisher(), engine=engine,
                                     period_s=digest_period_s)
        digest_pub.bind_metrics(metrics)
        digest_pub.start()
        metadata["digest_publisher"] = digest_pub.address
        metadata["digest_period_s"] = digest_pub.period_s

    await runtime.serve_endpoint(
        f"{namespace}/{component}/kv_fetch",
        FnEngine(lambda request, context: kv_fetch(engine, request or {})),
        instance_id=instance_id)

    # cross-worker onboarding: peers pull this worker's lower-tier blocks
    async def kv_host_fetch(request, context):
        hashes = [int(h) for h in (request or {}).get("hashes") or []]
        return await engine.export_host_blocks(hashes[:MAX_HOST_FETCH_BLOCKS])

    await runtime.serve_endpoint(f"{namespace}/{component}/kv_host_fetch",
                                 kv_host_fetch, instance_id=instance_id)

    # the prefetch plane: the router names what a request will need before
    # it sends the request; advertised so routers hint only such workers
    if getattr(engine, "prefetch", None) is not None:
        metadata["kv_prefetch"] = True
        engine.prefetch.bind_metrics(runtime.metrics.child(dynamo_namespace=namespace))

    async def kv_prefetch(request, context):
        hint = (request or {}).get("kv_prefetch") or {}
        ok = False
        if getattr(engine, "prefetch", None) is not None and hint:
            ok = await engine.prefetch_hint_async(hint)
        yield {"ok": bool(ok)}

    await runtime.serve_endpoint(f"{namespace}/{component}/kv_prefetch",
                                 FnEngine(kv_prefetch), instance_id=instance_id)

    fetch_clients: Dict[str, Any] = {}

    async def remote_kv_fetch(hint):
        """Pull the blocks a kv_remote_host hint names from the peer's
        kv_host_fetch endpoint; the first reply item is the payload."""
        path = hint["path"]
        client = fetch_clients.get(path)
        if client is None:
            # cached before any await that can raise: a failed first pull
            # must not leak a client a request
            client = fetch_clients[path] = runtime.client(path)
            await client.start()
        peer = int(hint["instance"])
        # the pull is a traced hop under the route span the hint carries
        with tracing.span("kv.peer_pull", parent=hint.get("traceparent"), kind=3,
                          attributes={"kv.n_blocks": len(hint.get("hashes") or []),
                                      "kv.peer_instance": peer}):
            # the first pull after the client's creation races the
            # discovery watch: give the peer a moment to appear
            loop = asyncio.get_running_loop()
            deadline = loop.time() + 2.0
            while peer not in client.instances and loop.time() < deadline:
                await asyncio.sleep(0.05)
            req = {"hashes": [int(h) for h in hint["hashes"][:MAX_HOST_FETCH_BLOCKS]]}
            async for item in client.direct(req, peer):
                return item
            return None

    engine.remote_kv_fetch = remote_kv_fetch

    # the rl admin endpoint; a loaded adapter republishes the card in the
    # generate instance's metadata (set below)
    served: Dict[str, Any] = {}

    async def republish() -> None:
        if served.get("inst") is not None:
            await runtime.update_instance_metadata(
                served["inst"], {"model_card": card.to_dict()})

    async def rl(request, context):
        yield await rl_admin(engine, card, request or {}, republish, instance_id)

    await runtime.serve_endpoint(f"{namespace}/{component}/rl", FnEngine(rl),
                                 instance_id=instance_id)

    handler = DisaggDecodeAdapter(engine, runtime, chunk_pages=disagg_chunk_pages)
    engine.start()
    inst = await runtime.serve_endpoint(f"{namespace}/{component}/{endpoint}", handler,
                                        metadata=metadata, instance_id=instance_id)
    served["inst"] = inst
    log.info("worker %x serving %s (role=%s)", instance_id, card.name,
             disagg_role or "both")
    return ServedWorker(runtime, engine, inst, publisher, handler, fetch_clients,
                        digest_pub=digest_pub)
