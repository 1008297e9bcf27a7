"""Router-hinted KV prefetch: promotion up the tiers before the request.

Port of dynamo_tpu/kvbm/prefetch.py `PrefetchManager`, its real-bytes
branches. The KV router knows which blocks the chosen worker will need
before the request reaches it, and sends a `kv_prefetch` hint ahead of
the request; this manager spends that lead time promoting the hinted
blocks:

    G3/G4 -> G2: file and object reads ride the lower pools' writer
                 threads (`read_block_async`); results come back to the
                 step thread through the engine inbox.
    G2 -> G1:    the runner's `import_page_tensors` on the step thread,
                 between iterations.

Promoted pages are registered in the PagePool and released into its
reusable cache *pinned*: eviction skips them, and the scheduler's
ordinary `match_prefix` claims them when the hinted request arrives.
Governed by `max_inflight` (lower-tier reads in flight),
`bandwidth_mbps` (a token bucket on promoted bytes, 0 = off),
`hint_ttl_s` (a hinted block not promoted in time is cancelled) and
`pin_ttl_s` (a promoted block unclaimed that long is unpinned). A request
that arrives mid-promotion takes the synchronous onboard
(`note_sync_onboard` cancels the job); a duplicate import resolves
through the PagePool's register() dedup. Hits come from the PagePool's
claim hook, lates from the synchronous onboard, cancels from the TTLs.

A hint that carries the router's route-span `traceparent` gets each
promotion as a `kv.prefetch.promote` span (G2->G1), rebuilt at promotion
from the job's start, so promotions land in the request's trace.

Not ported: the reference's hash-only branches (`_sim_runner`,
`sim_block_bytes`), which serve its mocker workers (the port has none).
"""

from __future__ import annotations

import logging
import time
from collections import OrderedDict, deque
from typing import Any, Dict, List, Optional

from dynamo_tpu_torch.engine.kv_pool import NoSpace
from dynamo_tpu_torch.runtime import tracing

from .quant import pair_nbytes

log = logging.getLogger("dynamo_tpu_torch.kvbm.prefetch")

# job states
QUEUED = "queued"  # accepted, waiting for budget or an in-flight slot
READING = "reading"  # a G3/G4 read in flight on the pool's thread
PROMOTED = "promoted"  # registered and pinned in the device pool


class _Job:
    __slots__ = ("h", "parent", "state", "t0", "deadline", "pin_deadline", "tp")

    def __init__(self, h: int, parent: Optional[int], t0: float, deadline: float,
                 tp: Optional[str] = None):
        self.h = h
        self.parent = parent
        self.state = QUEUED
        self.t0 = t0
        self.deadline = deadline
        self.pin_deadline = 0.0
        self.tp = tp  # the hinting route span's traceparent


class PrefetchManager:
    """Owned by the engine; every method runs on the engine step thread
    unless noted. The lower-tier read callbacks post back through the
    engine inbox."""

    def __init__(self, engine, *, max_inflight: int = 4,
                 bandwidth_mbps: float = 0.0, hint_ttl_s: float = 10.0,
                 pin_ttl_s: float = 5.0, metrics=None,
                 clock=time.monotonic):  # injectable for TTL tests
        self.engine = engine
        self.pool = engine.pool
        self.tiered = engine.host_pool  # TieredKv (G2 [+G3] [+G4])
        self.max_inflight = max(1, int(max_inflight))
        self.hint_ttl_s = float(hint_ttl_s)
        self.pin_ttl_s = float(pin_ttl_s)
        self._clock = clock
        self._bps = float(bandwidth_mbps) * 1e6
        self._limited = self._bps > 0
        # token bucket with one-block overdraft: dispatch waits for a
        # non-negative balance, charges land at completion, tick() refills
        self._budget_bytes = self._bps * 0.1 if self._limited else 0.0
        self._budget_burst = max(self._bps * 0.5, float(1 << 18))
        self._last_refill = clock()
        self._jobs: "OrderedDict[int, _Job]" = OrderedDict()  # hash -> job
        self._queue: deque = deque()  # hashes awaiting dispatch (FIFO)
        self._reading: set = set()  # hashes with a lower-tier read in flight
        self.stats: Dict[str, Any] = {
            "hints": 0,  # hint messages accepted
            "hinted_blocks": 0,  # blocks enqueued for promotion
            "promoted": 0,  # blocks registered and pinned in G1
            "hits": 0,  # pinned blocks claimed by a request
            "late": 0,  # the synchronous onboard won mid-promotion
            "cancelled": 0,  # hint and pin TTL expiries
            "dup": 0,  # the import lost the register() dedup race
            "no_space": 0,  # device pool full: left to the synchronous path
            "lost": 0,  # the block left the tiers under the job
            "bytes_promoted": 0,
            # per hop, at the stored width (quantized tiers move ~0.52x)
            "bytes_promoted_g3": 0,
            "bytes_promoted_g2": 0,
            "bytes_promoted_g4": 0,
            "reading_peak": 0,
            "promote_latency_sum_s": 0.0,
        }
        if metrics is None:
            from dynamo_tpu_torch.runtime.metrics import make_metrics

            metrics = make_metrics("worker")
        self.bind_metrics(metrics)
        self.pool.claim_hook = self._on_claim

    def bind_metrics(self, metrics) -> None:
        """Re-home the counters onto a shared hierarchy (the worker's
        runtime metrics at serve time)."""
        node = metrics.child(dynamo_component="kv_prefetch")
        self._m_hits = node.counter(
            "kv_prefetch_hits_total", "prefetched blocks claimed by a request")
        self._m_late = node.counter(
            "kv_prefetch_late_total",
            "blocks onboarded synchronously while their promotion was in flight")
        self._m_cancelled = node.counter(
            "kv_prefetch_cancelled_total", "hinted blocks expired by TTL unclaimed")
        self._m_bytes = node.counter(
            "kv_prefetch_bytes_total", "bytes promoted up the KV ladder")

    # -- hint ingress (engine inbox op "prefetch") ---------------------------
    def on_hint(self, hint: Dict[str, Any]) -> None:
        hashes = [int(h) for h in (hint.get("hashes") or [])]
        parents = list(hint.get("parents") or [])
        if not hashes:
            return
        self.stats["hints"] += 1
        now = self._clock()
        for i, h in enumerate(hashes):
            if h in self._jobs or h in self.pool.by_hash:
                continue  # already warm or already being promoted
            parent = parents[i] if i < len(parents) else None
            parent = int(parent) if parent is not None else None
            job = _Job(h, parent, now, now + self.hint_ttl_s, hint.get("traceparent"))
            if h in self._reading:
                # a TTL-expired job's read is still in flight: adopt it
                # rather than queue a second read (pins are a set, so the
                # first completion would unpin the second read mid-flight)
                job.state = READING
            else:
                self._queue.append(h)
            self._jobs[h] = job
            self.stats["hinted_blocks"] += 1
        self._pump()

    # -- periodic (every engine inbox drain) ---------------------------------
    def tick(self) -> None:
        now = self._clock()
        if self._limited:
            self._budget_bytes = min(
                self._budget_burst,
                self._budget_bytes + (now - self._last_refill) * self._bps)
        self._last_refill = now
        for h, job in list(self._jobs.items()):
            if job.state == PROMOTED:
                if now >= job.pin_deadline:
                    self.pool.unpin(h)
                    del self._jobs[h]
                    self._cancelled(1)
            elif now >= job.deadline:
                # QUEUED: dropped (lazy queue removal); READING: the read's
                # result finds no job and is discarded
                del self._jobs[h]
                self._cancelled(1)
        self._pump()

    def _cancelled(self, n: int) -> None:
        self.stats["cancelled"] += n
        self._m_cancelled.inc(n)

    # -- dispatch ------------------------------------------------------------
    def _pump(self) -> None:
        disk = self.tiered.disk
        obj = self.tiered.obj
        while self._queue:
            if self._limited and self._budget_bytes <= 0:
                break
            h = self._queue[0]
            job = self._jobs.get(h)
            if job is None or job.state != QUEUED:
                self._queue.popleft()  # cancelled or moved on
                continue
            if h in self.tiered.host:
                self._queue.popleft()
                self._promote_from_host(job)
                continue
            lower = None
            if disk is not None and h in disk:
                lower, cb = disk, self._on_disk_read
            elif obj is not None and h in obj:
                lower, cb = obj, self._on_obj_read
            if lower is None:
                # in no tier we promote from (evicted underneath us)
                self._queue.popleft()
                self._drop(job, "lost")
                continue
            if len(self._reading) >= self.max_inflight:
                break  # FIFO: wait for a slot rather than skip ahead
            self._queue.popleft()
            job.state = READING
            self._reading.add(h)
            self.stats["reading_peak"] = max(self.stats["reading_peak"],
                                             len(self._reading))
            lower.pin(h)
            if not lower.read_block_async(h, cb):
                self._reading.discard(h)
                lower.unpin(h)
                self._drop(job, "lost")

    def _drop(self, job: _Job, reason: str) -> None:
        self.stats[reason] += 1
        self._jobs.pop(job.h, None)

    # -- G3/G4 → G2 ----------------------------------------------------------
    def _on_disk_read(self, h: int, parent: Optional[int], k, v, found: bool) -> None:
        """G3 writer thread: hand the block to the step thread."""
        self.engine._inbox.put(("prefetch_disk", (h, parent, k, v, found)))

    def _on_obj_read(self, h: int, parent: Optional[int], k, v, found: bool) -> None:
        """G4 writer thread: hand the block to the step thread."""
        self.engine._inbox.put(("prefetch_obj", (h, parent, k, v, found)))

    def on_disk_read(self, h: int, parent: Optional[int], k, v, found: bool) -> None:
        """Step thread (inbox op "prefetch_disk")."""
        self._on_lower_read(h, k, v, found, self.tiered.disk, "bytes_promoted_g3")

    def on_obj_read(self, h: int, parent: Optional[int], k, v, found: bool) -> None:
        """Step thread (inbox op "prefetch_obj")."""
        self._on_lower_read(h, k, v, found, self.tiered.obj, "bytes_promoted_g4")

    def _on_lower_read(self, h: int, k, v, found: bool, pool, hop_stat: str) -> None:
        self._reading.discard(h)
        if pool is not None:
            pool.unpin(h)
        job = self._jobs.get(h)
        if job is None or job.state != READING:
            self._pump()  # cancelled or superseded while the read ran
            return
        if not found or k is None:
            # gone, or a corrupt block quarantined underneath us
            self._drop(job, "lost")
            self._pump()
            return
        # one [L, PS, Hk, D] block, dense or quantized, as the lower tier
        # stored it: the host tier takes either
        self.tiered.host.put_block(h, job.parent, k, v)
        nbytes = pair_nbytes(k, v)
        if self._limited:
            self._budget_bytes -= nbytes
        self.stats["bytes_promoted"] += nbytes
        self.stats[hop_stat] += nbytes
        job.state = QUEUED  # host-resident now: the next stage
        self._promote_from_host(job)
        self._pump()

    # -- G2 → G1 -------------------------------------------------------------
    def _promote_from_host(self, job: _Job) -> None:
        h = job.h
        try:
            (k, v), = self.tiered.host.get_blocks([h])
        except KeyError:
            return self._drop(job, "lost")
        if k is None:
            return self._drop(job, "lost")
        try:
            page = self.pool.alloc(1)[0]
        except NoSpace:
            # the device pool is full of live sequences: the synchronous
            # onboard handles this block at admission
            return self._drop(job, "no_space")
        nbytes = pair_nbytes(k, v)
        self.engine.runner.import_page_tensors([page], [k], [v])
        canonical = self.pool.register(page, h, job.parent)
        if canonical != page:
            # the synchronous path imported this block meanwhile: ours is
            # the duplicate
            self.pool.release([page])
            return self._drop(job, "dup")
        self.pool.release([page])  # registered, ref 0 -> reusable cache
        self.pool.pin(h)
        now = self._clock()
        job.state = PROMOTED
        job.pin_deadline = now + self.pin_ttl_s
        if self._limited:
            self._budget_bytes -= nbytes
        self.stats["promoted"] += 1
        self.stats["bytes_promoted"] += nbytes
        self.stats["bytes_promoted_g2"] += nbytes
        self.stats["promote_latency_sum_s"] += now - job.t0
        self._m_bytes.inc(nbytes)
        if job.tp is not None:
            # a promotion spans engine ticks: its span is rebuilt now, under
            # the route span that hinted it
            end_ns = time.time_ns()
            tracing.record_span(
                "kv.prefetch.promote", end_ns - max(0, int((now - job.t0) * 1e9)),
                end_ns, parent=job.tp,
                attributes={"kv.block_hash": h, "kv.tier": "G2->G1", "kv.bytes": nbytes})

    # -- accounting hooks ----------------------------------------------------
    def _on_claim(self, h: int) -> None:
        """PagePool claim hook: match_prefix claimed a pinned hash (the
        pool dropped the pin already)."""
        if self._jobs.pop(h, None) is not None:
            self.stats["hits"] += 1
            self._m_hits.inc()

    def note_sync_onboard(self, hashes: List[int]) -> None:
        """The synchronous onboard: blocks still mid-promotion arrived
        late; their jobs are cancelled (the synchronous import wins)."""
        for h in hashes:
            job = self._jobs.get(h)
            if job is None:
                continue
            if job.state == PROMOTED:
                # promoted blocks are device-resident and not onboard
                # candidates; unpin all the same
                self.pool.unpin(h)
                del self._jobs[h]
            else:
                del self._jobs[h]
                self.stats["late"] += 1
                self._m_late.inc()

    # -- shutdown ------------------------------------------------------------
    def stop(self) -> None:
        """After the step thread has joined: release every pin."""
        for h, job in list(self._jobs.items()):
            if job.state == PROMOTED:
                self.pool.unpin(h)
        self._jobs.clear()
        self._queue.clear()
        self._reading.clear()

    @property
    def mean_promote_latency_s(self) -> float:
        n = self.stats["promoted"]
        return self.stats["promote_latency_sum_s"] / n if n else 0.0
