"""PrefillRouter: disaggregated prefill/decode orchestration.

Port of dynamo_tpu/router/prefill_router.py `DisaggPolicy` and
`PrefillRouter.generate` / `_run_prefill_hop`: the prefill engine computes
the KV and the first token and parks the pages; the router emits that
token, then sends the decode continuation (prompt + first token,
max_tokens − 1, `annotations.disagg = "decode"`, `kv_transfer_src`)
downstream to a `DisaggDecodeAdapter`, which pulls the KV and resumes
decode with no prefill. A failed prefill hop falls back to aggregated
serving downstream. The prefill pool is in process
(`LocalPrefillClient`) until the request plane is ported; there is no KV
router and no discovery.
"""

from __future__ import annotations

import asyncio
import itertools
import logging
from dataclasses import dataclass
from typing import Any, AsyncIterator, Dict, Optional, Set

from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.worker_common import PREFILL_ENGINES

log = logging.getLogger("dynamo_tpu_torch.prefill_router")


@dataclass
class DisaggPolicy:
    """Conditional disaggregation: only prompts at least this long are
    worth the transfer hop."""

    min_prefill_tokens: int = 256
    enabled: bool = True

    def should_disagg(self, token_ids) -> bool:
        return self.enabled and len(token_ids) >= self.min_prefill_tokens


class LocalPrefillClient:
    """The prefill pool as the router sees it: instance ids (from
    `worker_common.register_prefill`), picked round-robin, each request
    sent straight to that engine's `generate`."""

    def __init__(self, instance_ids):
        self.instances = list(instance_ids)
        self._next = itertools.cycle(self.instances)

    def pick(self) -> str:
        return next(self._next)

    def direct(self, request, instance_id: str, context: Context):
        return PREFILL_ENGINES[instance_id].generate(request, context)


class PrefillRouter:
    """Engine wrapper. Inactive (no prefill instances) → pure passthrough.

    Active: push the request to a prefill engine with disagg=prefill, emit
    its first token at once, then push the decode continuation (with the
    transfer source) downstream."""

    def __init__(self, downstream, policy: Optional[DisaggPolicy] = None):
        self.downstream = downstream
        self.policy = policy or DisaggPolicy()
        self._prefill_client: Optional[LocalPrefillClient] = None
        self._tasks: Set[asyncio.Task] = set()

    def activate(self, prefill_client: LocalPrefillClient) -> None:
        self._prefill_client = prefill_client
        log.info("prefill router ACTIVE (%d prefill instances)",
                 len(prefill_client.instances))

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
        """Early finish: release the prefill engine's parked pages without
        transferring them (fire-and-forget; the parked TTL is the
        backstop)."""
        engine = PREFILL_ENGINES.get(transfer_src["instance_id"])
        if engine is None:
            return
        task = asyncio.ensure_future(
            engine.export_parked_kv(transfer_src["request_id"], discard=True))
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)

    async def _run_prefill_hop(self, request, context):
        preq = dict(request)
        ann = dict(preq.get("annotations") or {})
        ann["disagg"] = "prefill"
        preq["annotations"] = ann
        # fresh metadata: routing pins must not leak to the prefill pool
        pctx = Context(request_id=context.id + ":prefill", parent=context)
        result = None
        try:
            client = self._prefill_client
            iid = client.pick()
            # read the stream to its end: closing an in-process engine
            # stream early aborts the request, which releases parked pages
            async for item in client.direct(preq, iid, pctx):
                kt = item.get("kv_transfer")
                if kt is not None and result is None:
                    result = (int(item["token_ids"][0]),
                              {"instance_id": iid, "request_id": kt["request_id"]})
        except Exception as e:
            log.warning("prefill hop failed (%s); falling back to aggregated", e)
            return None
        if result is None:
            log.warning("prefill hop returned no kv_transfer; falling back")
        return result
