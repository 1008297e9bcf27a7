"""In-flight request migration.

Port of dynamo_tpu/frontend/migration.py `is_migratable` and `Migration`.
A pipeline operator between the preprocessor and the router: when the
worker connection fails mid-stream with a migratable error
(cannot_connect, disconnected, connection_timeout, draining), the request
is sent again to a fresh worker with the tokens generated so far appended
to its prompt, so generation resumes where it stopped, at most
`migration_limit` times a request. The backoff before a retry is
jittered deterministically from (request id, attempt). `migrations`
counts the retries this operator made. The tracing spans and the tail
marks are not ported (A.11); the phase accounting is.
"""

from __future__ import annotations

import asyncio
import logging
import time
import zlib
from typing import Any, AsyncIterator, Dict

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
        # the frontend's wait before dispatch, in the phase dict that rides
        # the request plane to the worker
        t_dispatch = time.monotonic()
        ph = context.metadata.setdefault("phases", {})
        ph["frontend_queue_s"] = max(0.0, t_dispatch - context.created_at)
        while True:
            try:
                # a retry gets a fresh child context, so a stop on the dead
                # stream does not poison it
                attempt_ctx = context.child()
                async for item in self.downstream.generate(request, attempt_ctx):
                    accumulated.extend(item.get("token_ids") or [])
                    if item.get("finish_reason"):
                        self._finish_phases(item, t_dispatch,
                                            attempts=self.migration_limit - retries_left)
                    yield item
                return
            except RequestPlaneError as e:
                if not is_migratable(e) or retries_left <= 0 or context.is_stopped:
                    raise
                retries_left -= 1
                self.migrations += 1
                attempts = self.migration_limit - retries_left
                context.metadata["migration_attempt"] = attempts
                ph["migration_attempts"] = attempts
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
    def _finish_phases(item: Dict[str, Any], t_dispatch: float, attempts: int = 0) -> None:
        """Fold the frontend's stamps into the final item's phases."""
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
