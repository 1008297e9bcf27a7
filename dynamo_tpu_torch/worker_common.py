"""Serve an InferenceEngine over the runtime: the generate, kv_fetch and
kv_state endpoints, KV events and forward-pass metrics on the event plane,
and the decode side of disaggregated serving.

Port of dynamo_tpu/worker_common.py `ServedWorker`, `serve_worker`,
`LOCAL_ENGINES`, `DisaggDecodeAdapter` and the `kv_fetch` endpoint. A
request carrying `kv_transfer_src` pulls the prefill worker's parked KV
before admission: from a colocated engine (same process, registered in
`LOCAL_ENGINES`) on the device, gathered on the prefill engine's step
thread and scattered on the decode engine's; from any other instance
host-staged, through an EndpointClient to that instance's `kv_fetch`
endpoint, in chunks of `chunk_pages` pages (0: one payload). The fleet
digest, the RL admin endpoint, the host-tier peer pulls, the prefetch
plane and the shadow server are not ported yet.
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
import time
import weakref
from typing import Any, AsyncIterator, Dict, Optional

from dynamo_tpu_torch.frontend.protocols import ModelCard
from dynamo_tpu_torch.router.protocols import FPM_SUBJECT
from dynamo_tpu_torch.router.publisher import KvEventPublisher
from dynamo_tpu_torch.runtime.component import Instance, new_instance_id
from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.runtime.engine import FnEngine
from dynamo_tpu_torch.runtime.tasks import spawn_tracked

log = logging.getLogger("dynamo_tpu_torch.worker")

# in-process engine registry: when prefill and decode engines share one
# process (colocated disagg), the KV transfer stays entirely on the device
LOCAL_ENGINES: "weakref.WeakValueDictionary" = weakref.WeakValueDictionary()


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


class ServedWorker:
    """What `serve_worker` started: the engine, its generate instance, the
    KV event publisher and the generate handler (the disagg adapter)."""

    def __init__(self, runtime, engine, instance: Instance, publisher,
                 handler: DisaggDecodeAdapter):
        self.runtime = runtime
        self.engine = engine
        self.instance = instance
        self.publisher = publisher
        self.handler = handler

    async def stop(self) -> None:
        """Stop the engine and what serves it (after the runtime drained)."""
        self.engine.stop()
        if self.publisher is not None:
            await self.publisher.stop()
        await self.handler.close()


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
    colocated: bool = True,  # enter LOCAL_ENGINES: same-process pulls of
    #   this instance's parked KV stay on the device
) -> ServedWorker:
    """Serve `engine` at `ns/component/{endpoint, kv_fetch, kv_state}` as
    one instance whose metadata carries the model card and the event
    publisher's address."""
    instance_id = new_instance_id()
    dp_rank = 0  # no data parallelism in the port yet
    if colocated:
        LOCAL_ENGINES[instance_id] = engine
    metadata: Dict[str, Any] = {"model_card": card.to_dict(), "dp_rank": dp_rank}
    if disagg_role:
        metadata["disagg_role"] = disagg_role

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

    await runtime.serve_endpoint(
        f"{namespace}/{component}/kv_fetch",
        FnEngine(lambda request, context: kv_fetch(engine, request or {})),
        instance_id=instance_id)

    handler = DisaggDecodeAdapter(engine, runtime, chunk_pages=disagg_chunk_pages)
    engine.start()
    inst = await runtime.serve_endpoint(f"{namespace}/{component}/{endpoint}", handler,
                                        metadata=metadata, instance_id=instance_id)
    log.info("worker %x serving %s (role=%s)", instance_id, card.name,
             disagg_role or "both")
    return ServedWorker(runtime, engine, inst, publisher, handler)
