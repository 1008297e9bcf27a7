"""Router admission queue.

Port of dynamo_tpu/router/queue.py `AdmissionConfig` and `AdmissionQueue`.
When every candidate worker sits past the busy threshold, the router
parks the request in a bounded in-memory priority queue instead of
pushing it: requests drain in (priority, arrival) order as capacity
frees, one wake per freed slot. Depth overflow and wait timeout raise
RequestPlaneError codes (queue_full, queue_timeout) that the frontend
maps to HTTP 429. Priority classes are small ints (0 = most urgent), FIFO
within a class. Off unless `busy_blocks` > 0.
"""

from __future__ import annotations

import asyncio
import heapq
import itertools
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

from dynamo_tpu_torch.runtime.request_plane import RequestPlaneError

Worker = Tuple[int, int]


@dataclass
class AdmissionConfig:
    # total charged blocks (prefill + decode projection) at which one
    # worker counts as saturated; 0 disables queueing entirely
    busy_blocks: int = 0
    # waiting requests beyond this are rejected immediately (429)
    max_depth: int = 256
    # queued longer than this is rejected (429) — bounded staleness beats
    # serving a request whose client gave up
    max_wait_s: float = 30.0
    default_priority: int = 1


class AdmissionQueue:
    """`load_fn(worker) -> blocks` and `workers_fn() -> [workers]` are
    supplied by the router (ActiveSequences projections over the live
    instance set), so the queue holds no routing state of its own."""

    def __init__(
        self,
        config: AdmissionConfig,
        load_fn: Callable[[Worker], float],
        workers_fn: Callable[[], List[Worker]],
    ):
        self.config = config
        self._load = load_fn
        self._workers = workers_fn
        self._heap: List[Tuple[int, int, asyncio.Future]] = []
        self._seq = itertools.count()
        self.stats = {"queued": 0, "rejected_full": 0, "rejected_timeout": 0}

    @property
    def enabled(self) -> bool:
        return self.config.busy_blocks > 0

    @property
    def depth(self) -> int:
        return sum(1 for _, _, f in self._heap if not f.done())

    def saturated(self) -> bool:
        """True when every live worker is past the busy threshold. With no
        workers at all this is False — the no-instances failure downstream
        is the clearer error than a queue timeout."""
        if not self.enabled:
            return False
        workers = self._workers()
        if not workers:
            return False
        return all(self._load(w) >= self.config.busy_blocks for w in workers)

    async def acquire(self, priority: Optional[int] = None) -> None:
        """Admit one request: returns immediately while any worker has
        headroom; parks in the priority queue otherwise. Raises
        RequestPlaneError(queue_full | queue_timeout) on rejection."""
        if not self.enabled or not self.saturated():
            return
        if self.depth >= self.config.max_depth:
            self.stats["rejected_full"] += 1
            raise RequestPlaneError(
                f"router queue full ({self.config.max_depth} waiting)",
                code="queue_full",
            )
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        pri = self.config.default_priority if priority is None else int(priority)
        heapq.heappush(self._heap, (pri, next(self._seq), fut))
        self.stats["queued"] += 1
        try:
            await asyncio.wait_for(fut, self.config.max_wait_s)
        except asyncio.TimeoutError:
            self.stats["rejected_timeout"] += 1
            self._compact()
            raise RequestPlaneError(
                f"queued longer than {self.config.max_wait_s}s",
                code="queue_timeout",
            ) from None
        except asyncio.CancelledError:
            # the waiter's task died (client disconnected while queued). If
            # notify() had already granted it a wakeup, pass that wakeup on
            # — the capacity it represents is real and the next waiter must
            # not stall until another request completes
            if fut.done() and not fut.cancelled() and fut.exception() is None:
                self.notify(1)
            self._compact()
            raise

    def _compact(self) -> None:
        """Drop done-future tombstones. Called on timeout/cancel — without
        it a hung cluster (no notify() ever firing) grows the heap without
        bound while clients churn."""
        live = [e for e in self._heap if not e[2].done()]
        if len(live) != len(self._heap):
            self._heap = live
            heapq.heapify(self._heap)

    def notify(self, n: int = 1) -> None:
        """Release up to `n` waiters in (priority, arrival) order. Called
        with n=1 per freed request slot and with n=depth when fresh
        capacity appears (worker joined) — each release corresponds to
        capacity the caller observed, so released requests don't re-check
        saturation (their charge lands via add_request right after)."""
        while n > 0 and self._heap:
            _, _, fut = heapq.heappop(self._heap)
            if fut.done():
                continue  # tombstone: timed out or cancelled while queued
            fut.set_result(None)
            n -= 1

    def fail_all(self, msg: str, code: str = "no_instances") -> None:
        """Reject every waiter (e.g. the last worker left)."""
        while self._heap:
            _, _, fut = heapq.heappop(self._heap)
            if not fut.done():
                fut.set_exception(RequestPlaneError(msg, code=code))
