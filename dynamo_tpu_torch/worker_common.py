"""Disaggregated serving on the decode side: pull a prefill engine's parked
KV and admit the request with it.

Port of dynamo_tpu/worker_common.py `LOCAL_ENGINES`, `DisaggDecodeAdapter`
and the body of the `kv_fetch` endpoint. Until the request plane is ported
the prefill engines are reached in process: `register_prefill` gives an
engine an instance id, and a colocated one (same device) also enters
`LOCAL_ENGINES`, whose transfer stays on the device (gather on the prefill
engine's step thread, scatter on the decode engine's). Any other instance
is pulled host-staged through `kv_fetch`, chunk by chunk, exactly the
payloads the reference endpoint streams.
"""

from __future__ import annotations

import logging
import time
import uuid
import weakref
from typing import Any, AsyncIterator, Dict, Optional

log = logging.getLogger("dynamo_tpu_torch.worker")

# in-process engine registry: when prefill and decode engines share one
# process (colocated disagg), the KV transfer stays entirely on the device
LOCAL_ENGINES: "weakref.WeakValueDictionary" = weakref.WeakValueDictionary()
# prefill engines by instance id whose parked KV `kv_fetch` serves: the
# request plane's endpoint addressing, in process until it is ported
PREFILL_ENGINES: "weakref.WeakValueDictionary" = weakref.WeakValueDictionary()


def register_prefill(engine, colocated: bool = True) -> str:
    """Make `engine` a prefill instance; returns its instance id. A
    colocated instance transfers on the device, any other host-staged."""
    instance_id = uuid.uuid4().hex
    PREFILL_ENGINES[instance_id] = engine
    if colocated:
        LOCAL_ENGINES[instance_id] = engine
    return instance_id


async def kv_fetch(engine, request: Dict[str, Any]) -> AsyncIterator[Any]:
    """The prefill worker's parked-KV pull (the reference `kv_fetch`
    endpoint): `chunk_pages` selects the streamed export (bounded payloads,
    chunk reads interleaved with the prefill engine's steps); absent keeps
    the single-payload path."""
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
    parked KV pages from the prefill engine before admission. Colocated
    prefill engines transfer device-to-device; others host-staged. A
    failed or truncated pull falls back to local recompute."""

    def __init__(self, engine, chunk_pages: int = 16):
        self.engine = engine
        self.chunk_pages = chunk_pages  # 0 = monolithic single-payload pull

    async def _fetch(self, src) -> Optional[dict]:
        local = LOCAL_ENGINES.get(src["instance_id"])
        if local is not None and local is not self.engine:
            # device-resident transfer: gather on the prefill engine's step
            # thread, scatter on ours — no bytes touch the host
            return await local.export_parked_kv_device(src["request_id"])
        peer = PREFILL_ENGINES.get(src["instance_id"])
        if peer is None:
            raise LookupError(f"no prefill instance {src['instance_id']}")
        req = {"request_id": src["request_id"]}
        if self.chunk_pages:
            req["chunk_pages"] = self.chunk_pages
        chunks = []
        async for item in kv_fetch(peer, req):
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
