"""PrefillRouter: disaggregated prefill/decode orchestration.

Port of dynamo_tpu/router/prefill_router.py `DisaggPolicy` and
`PrefillRouter.generate` / `_run_prefill_hop`: the prefill worker computes
the KV and the first token and parks the pages; the router emits that
token, then sends the decode continuation (prompt + first token,
max_tokens − 1, `annotations.disagg = "decode"`, `kv_transfer_src`)
downstream to a decode worker's `DisaggDecodeAdapter`, which pulls the KV
from the prefill instance's `kv_fetch` endpoint and resumes decode with no
prefill. The prefill pool is an EndpointClient over the prefill
component's generate endpoint, kept by discovery. With a KvRouter over
that pool (`activate(..., kv_router=...)`, the frontend's `kv` mode) a
hop picks the prefill instance by KV overlap and load, charging it for
the hop's duration; without one it picks by the client's router mode. A
failed hop falls back to aggregated serving downstream, and a transport
failure cools the instance down (`mark_sick`). The LoRA filter over the
prefill pool (`restrict_prefill`): a LoRA adapter entry's router hops only
to prefill instances that hold its adapter; with none (the empty set) its
hops fall back to aggregated serving on the decode worker, which holds
it. A kv-mode hop hashes the request on the adapter's lineage.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Any, AsyncIterator, Dict, Optional

from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.runtime.request_plane import PushRouter, RequestPlaneError
from dynamo_tpu_torch.runtime.tasks import spawn_tracked
from dynamo_tpu_torch.tokens.hashing import mm_content_seed

log = logging.getLogger("dynamo_tpu_torch.prefill_router")


@dataclass
class DisaggPolicy:
    """Conditional disaggregation: only prompts at least this long are
    worth the transfer hop."""

    min_prefill_tokens: int = 256
    enabled: bool = True

    def should_disagg(self, token_ids) -> bool:
        return self.enabled and len(token_ids) >= self.min_prefill_tokens


class PrefillRouter:
    """Engine wrapper. Inactive (no prefill instances) → pure passthrough.

    Active: push the request to a prefill worker with disagg=prefill, emit
    its first token at once, then push the decode continuation (with the
    transfer source) downstream."""

    def __init__(self, downstream, policy: Optional[DisaggPolicy] = None):
        self.downstream = downstream
        self.policy = policy or DisaggPolicy()
        self._prefill_client = None  # EndpointClient over the prefill pool
        self._fetch_path: Optional[str] = None
        self._kv_router = None  # KvRouter over the prefill pool (kv mode)
        # the LoRA filter over the prefill pool: None = unrestricted, a set
        # of instance ids = the prefill replicas holding this entry's
        # adapter (empty: none does, every hop falls back to aggregated)
        self.allowed_prefill = None

    def restrict_prefill(self, instance_ids) -> None:
        self.allowed_prefill = None if instance_ids is None else set(instance_ids)

    def activate(self, prefill_client, fetch_path: str, kv_router=None) -> None:
        """`prefill_client`: an EndpointClient over the prefill
        component's generate endpoint; `fetch_path`: that component's
        kv_fetch endpoint, which the decode worker pulls from;
        `kv_router`: a KvRouter over the prefill pool, so that repeated
        prefixes hop to the prefill instance that holds their blocks."""
        self._prefill_client = prefill_client
        self._fetch_path = fetch_path
        self._kv_router = kv_router
        log.info("prefill router ACTIVE (fetch path %s, %s selection)", fetch_path,
                 "kv-overlap" if kv_router else "round-robin")

    def deactivate(self) -> None:
        self._prefill_client = None
        self._fetch_path = None
        self._kv_router = None
        log.info("prefill router inactive (no prefill workers)")

    @property
    def active(self) -> bool:
        return self._prefill_client is not None and bool(self._prefill_client.instances)

    async def generate(self, request: Dict[str, Any], context: Context) -> AsyncIterator[Any]:
        token_ids = request.get("token_ids") or []
        if not self.active or not self.policy.should_disagg(token_ids):
            async for item in self.downstream.generate(request, context):
                yield item
            return

        prefill_result = await self._run_prefill_hop(request, context)
        if prefill_result is None:  # fall back to aggregated
            async for item in self.downstream.generate(request, context):
                yield item
            return

        first_token, transfer_src = prefill_result
        stop = dict(request.get("stop") or {})
        max_tokens = stop.get("max_tokens")  # None = unlimited (engine semantics)
        # Scheduler.complete_decode only honors stop_ids past min_tokens; match
        # it so a request terminates identically on the agg and disagg paths
        if (first_token in set(stop.get("stop_ids") or [])
                and not stop.get("ignore_eos")
                and int(stop.get("min_tokens") or 0) < 1):
            self._discard_parked(transfer_src)
            yield {"token_ids": [], "finish_reason": "stop"}
            return
        yield {"token_ids": [first_token], "finish_reason": None}
        if max_tokens is not None and int(max_tokens) <= 1:
            self._discard_parked(transfer_src)
            yield {"token_ids": [], "finish_reason": "length"}
            return

        # decode continuation: prompt += first token, budget -= 1
        dreq = dict(request)
        dreq["token_ids"] = list(token_ids) + [int(first_token)]
        if request.get("guided"):
            # the prefill worker sampled first_token under the constraint:
            # the decode worker replays it through its own DFA copy
            dreq["guided_advanced"] = 1
        if max_tokens is not None:
            stop["max_tokens"] = int(max_tokens) - 1
        if int(stop.get("min_tokens") or 0) >= 1:
            stop["min_tokens"] = int(stop["min_tokens"]) - 1
        dreq["stop"] = stop
        ann = dict(dreq.get("annotations") or {})
        ann["disagg"] = "decode"
        dreq["annotations"] = ann
        dreq["kv_transfer_src"] = transfer_src

        async for item in self.downstream.generate(dreq, context):
            yield item

    def _discard_parked(self, transfer_src) -> None:
        """Early finish: release the prefill worker's parked pages without
        transferring them (fire-and-forget; the parked TTL is the
        backstop)."""
        client = self._prefill_client
        if client is None:
            return
        iid = transfer_src["instance_id"]

        async def _release():
            fetch = client.runtime.client(transfer_src["path"])
            fetch.router.update_instance(iid, transfer_src["address"])
            try:
                req = {"request_id": transfer_src["request_id"], "discard": True}
                async for _ in fetch.direct(req, iid):
                    pass
            except RequestPlaneError as e:
                log.debug("parked-page discard failed (%s); TTL reclaims", e.code)
            finally:
                await fetch.close()

        spawn_tracked(_release(), logger=log)

    async def _run_prefill_hop(self, request, context):
        preq = dict(request)
        ann = dict(preq.get("annotations") or {})
        ann["disagg"] = "prefill"
        preq["annotations"] = ann
        # fresh metadata: routing pins must not leak to the prefill pool
        pctx = Context(request_id=context.id + ":prefill", parent=context)
        result = None
        client = self._prefill_client
        kv = self._kv_router
        iid = rid = None
        try:
            if kv is not None:
                await kv.start()  # idempotent; the watcher starts it eagerly
                mm = request.get("mm")
                worker, overlap, hashes = kv.find_best_match(
                    request.get("token_ids") or [], adapter=request.get("adapter"),
                    mm_seed=mm_content_seed(mm["data"]) if mm else None,
                    allowed_instances=self.allowed_prefill)
                iid = worker[0]
                rid = pctx.id
                kv.add_request(rid, worker, hashes, overlap)
                address = client.instances[iid].address
            else:
                iid, address = client.router._pick(allowed=self.allowed_prefill)
            # read the stream to its end (the done frame follows the
            # prefill_complete item): abandoning it sends a kill
            async for item in client.direct(preq, iid, pctx):
                kt = item.get("kv_transfer")
                if kt is not None and result is None:
                    src = {"instance_id": iid, "address": address,
                           "path": self._fetch_path, "request_id": kt["request_id"]}
                    result = (int(item["token_ids"][0]), src)
        except RequestPlaneError as e:
            if iid is not None and e.code in PushRouter.SICK_CODES:
                # cool the dead prefill instance so the next hop avoids it
                client.router.mark_sick(iid)
            log.warning("prefill hop failed (%s); falling back to aggregated", e.code)
            return None
        except (RuntimeError, KeyError) as e:
            # the selector's empty worker list, or an instance gone from
            # discovery between selection and the push: fall back too
            log.warning("prefill hop failed (%s); falling back to aggregated", e)
            return None
        finally:
            if rid is not None:
                kv.free(rid)
        if result is None:
            log.warning("prefill hop returned no kv_transfer; falling back")
        return result
