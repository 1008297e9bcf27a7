"""In-flight request migration.

Port of dynamo_tpu/frontend/migration.py `is_migratable` and `Migration`.
A pipeline operator between the preprocessor and the router: when the
worker connection fails mid-stream with a migratable error
(cannot_connect, disconnected, connection_timeout, draining), the request
is sent again to a fresh worker with the tokens generated so far appended
to its prompt, so generation resumes where it stopped, at most
`migration_limit` times a request. The backoff before a retry is
jittered deterministically from (request id, attempt). `migrations`
counts the retries this operator made.

Every frontend request funnels through this operator, so it opens the
serving pipeline's root span, `frontend.request` (continuing the
caller's `traceparent`), re-points the request metadata at it, and adds
a `first_token` event, a `migration` event per retry and the phase
spine as `phase.*` events. A migrated request, an error finish or an
SLO excursion (`DYN_TRACE_TAIL_TTFT_S` / `DYN_TRACE_TAIL_E2E_S`,
seconds) tail-marks the trace so the span rings keep it whole, with a
zero-length `trace.tail` span carrying the reason.
"""

from __future__ import annotations

import asyncio
import logging
import os
import time
import zlib
from typing import Any, AsyncIterator, Dict

from dynamo_tpu_torch.runtime import tracing
from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.runtime.request_plane import RequestPlaneError

log = logging.getLogger("dynamo_tpu_torch.migration")

MIGRATABLE_CODES = {"cannot_connect", "disconnected", "connection_timeout", "draining"}


def is_migratable(err: Exception) -> bool:
    return isinstance(err, RequestPlaneError) and err.code in MIGRATABLE_CODES


class Migration:
    def __init__(self, downstream, migration_limit: int = 3,
                 backoff_base_s: float = 0.05, backoff_max_s: float = 2.0):
        self.downstream = downstream
        self.migration_limit = migration_limit
        self.backoff_base_s = backoff_base_s
        self.backoff_max_s = backoff_max_s
        self.migrations = 0

    def _backoff_s(self, rid: str, attempt: int) -> float:
        """Exponential backoff with jitter from (rid, attempt), not a PRNG:
        runs replay identically, and a mass disconnect still does not
        re-dispatch as one synchronized wave."""
        if self.backoff_base_s <= 0.0:
            return 0.0
        cap = min(self.backoff_max_s, self.backoff_base_s * (2.0 ** max(0, attempt - 1)))
        r = zlib.crc32(f"{rid}:{attempt}".encode()) / 0xFFFFFFFF
        return cap * (0.5 + 0.5 * r)

    async def generate(self, request: Dict[str, Any], context: Context) -> AsyncIterator[Any]:
        retries_left = self.migration_limit
        accumulated: list[int] = []  # tokens already delivered downstream
        with tracing.span(
                "frontend.request", parent=context.metadata.get("traceparent"), kind=2,
                attributes={"request.id": context.id,
                            "model": str(context.metadata.get("model") or "")}) as root:
            tracing.child_traceparent(context.metadata, root)
            # the frontend's wait before dispatch, in the phase dict that
            # rides the request plane to the worker
            t_dispatch = time.monotonic()
            ph = context.metadata.setdefault("phases", {})
            ph["frontend_queue_s"] = max(0.0, t_dispatch - context.created_at)
            first_token_seen = False
            while True:
                try:
                    # a retry gets a fresh child context, so a stop on the
                    # dead stream does not poison it
                    attempt_ctx = context.child()
                    async for item in self.downstream.generate(request, attempt_ctx):
                        accumulated.extend(item.get("token_ids") or [])
                        if not first_token_seen and item.get("token_ids"):
                            first_token_seen = True
                            root.add_event("first_token", {
                                "frontend_ttft_s": time.monotonic() - t_dispatch})
                        if item.get("finish_reason"):
                            self._finish_phases(
                                item, root, t_dispatch,
                                attempts=self.migration_limit - retries_left)
                            self._maybe_tail(item, context)
                        yield item
                    return
                except RequestPlaneError as e:
                    if not is_migratable(e) or retries_left <= 0 or context.is_stopped:
                        raise
                    retries_left -= 1
                    self.migrations += 1
                    attempts = self.migration_limit - retries_left
                    root.set_attribute("migration.attempts", attempts)
                    context.metadata["migration_attempt"] = attempts
                    ph["migration_attempts"] = attempts
                    root.add_event("migration", {"attempt": attempts})
                    # a migrated request is always kept: the tail mark on
                    # the metadata's traceparent rides every retry hop
                    tracing.mark_tail(context.metadata)
                    request = self._replay_request(request, accumulated)
                    n_replayed = len(accumulated)
                    accumulated = []  # folded into the replayed prompt
                    log.warning("migrating request %s after %s (%d retries left, "
                                "%d tokens replayed)", context.id, e.code, retries_left,
                                n_replayed)
                    delay = self._backoff_s(context.id, attempts)
                    if delay > 0.0:
                        # by the second attempt the dead instance is in its
                        # failure cooldown and selection avoids it
                        await asyncio.sleep(delay)

    @staticmethod
    def _finish_phases(item: Dict[str, Any], root, t_dispatch: float,
                       attempts: int = 0) -> None:
        """Fold the frontend's stamps into the final item's phases and
        surface every scalar phase as an event on the root span."""
        phases = item.get("phases")
        if not isinstance(phases, dict):
            phases = {}
            item["phases"] = phases
        phases["frontend_e2e_s"] = max(0.0, time.monotonic() - t_dispatch)
        if attempts:
            # a request that migrated and then finished is a migration
            # success
            phases["migration_attempts"] = attempts
            phases["migration_succeeded"] = 1
        for key, val in phases.items():
            if isinstance(val, (int, float)):
                root.add_event(f"phase.{key}", {"seconds": float(val)})

    @staticmethod
    def _maybe_tail(item: Dict[str, Any], context: Context) -> None:
        """Finish-time tail marking: migrated requests, error finishes and
        SLO excursions survive sampling; a zero-length `trace.tail` span
        carries the mark (the ring samples at read time, so late marking
        keeps the whole trace)."""
        phases = item.get("phases") or {}
        reason = None
        if phases.get("migration_attempts"):
            reason = "migration"
        elif item.get("finish_reason") == "error":
            reason = "error"
        else:
            for env, key in (("DYN_TRACE_TAIL_TTFT_S", "ttft_s"),
                             ("DYN_TRACE_TAIL_E2E_S", "e2e_s")):
                raw = os.environ.get(env)
                if not raw:
                    continue
                try:
                    if float(phases.get(key) or 0.0) > float(raw):
                        reason = f"{key}_excursion"
                        break
                except ValueError:
                    continue
        if reason is None:
            return
        tp = tracing.mark_tail(context.metadata)
        if tp is not None:
            now = time.time_ns()
            tracing.record_span("trace.tail", now, now, parent=tp,
                                attributes={"reason": reason, "request.id": context.id})

    @staticmethod
    def _replay_request(request: Dict[str, Any], accumulated: list[int]) -> Dict[str, Any]:
        if not accumulated:
            return request
        req = dict(request)
        req["token_ids"] = list(request["token_ids"]) + accumulated
        stop = dict(req.get("stop") or {})
        if "max_tokens" in stop:
            stop["max_tokens"] = max(1, int(stop["max_tokens"]) - len(accumulated))
        req["stop"] = stop
        ann = dict(req.get("annotations") or {})
        ann["migrated_tokens"] = ann.get("migrated_tokens", 0) + len(accumulated)
        req["annotations"] = ann
        return req
