"""Fleet observability plane: worker digests, fleet aggregation, and the
routing decision audit ring.

Port of dynamo_tpu/runtime/fleet_observer.py, whole: the mergeable phase
histograms (fixed log-spaced buckets shared by every worker), the
worker-side `DigestBuilder` (engine callbacks in on the step thread, one
digest dict out per window), `DigestPublisher` (a periodic task
publishing on the runtime's event plane under ``FLEET_DIGEST_SUBJECT``),
the frontend's `FleetObserver` (digests windowed by local receive time,
deduplicated by the per-worker ``seq``, merged into per-worker and
fleet-wide percentiles; `onboard_costs` is the KV router's measured tier
cost feed) and `RoutingAudit` (a bounded ring of routing decisions keyed
by request id, served at ``/debug/routing``). The digest payload is the
reference's field for field; it travels on the port's TCP event plane
(runtime/event_plane.py), msgpack-encoded by runtime/codec.py, so a
reference observer reads a port worker's digests.

`DigestBuilder.build(engine=...)` reads the port engine: its flight
recorder, its KV tiers' occupancy and stored bytes, the measured onboard
EWMA (`kv_onboard_ewma`), the prefetch manager's counters, the runner's
dispatch-family counters (`compile_stats`), speculation and the prefix
tree. The SLO engine that decorates `fleet()` in the reference is not
ported (planner/slo.py).
"""

from __future__ import annotations

import asyncio
import logging
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Tuple

from dynamo_tpu_torch.runtime.event_plane import (
    FLEET_DIGEST_SUBJECT,
    EventPublisher,
    EventSubscriber,
)

log = logging.getLogger("dynamo_tpu_torch.fleet_observer")

Worker = Tuple[int, int]

# -- mergeable phase histograms ---------------------------------------------
# log1.1-spaced bounds from 0.25ms to ~1900s: wide enough for ITL at the
# bottom and a wedged e2e at the top. The fine 1.1 factor bounds the
# in-bucket interpolation error of a percentile estimate at <10% worst
# case, typically ~2% (a factor-2 grid can be ~20-50% off inside one
# bucket, blowing the /debug/fleet-vs-goodput agreement budget). Cost:
# 167 small ints per non-empty phase, ~1KB msgpack per digest — still
# two orders below a scrape. 166 bounds -> 167 buckets (last is the
# overflow). Shared constants, never serialized per-message: a digest
# carries only the counts vector.
HIST_BASE_S = 0.00025
HIST_FACTOR = 1.1
HIST_NBOUNDS = 166
HIST_BOUNDS = tuple(HIST_BASE_S * HIST_FACTOR ** i for i in range(HIST_NBOUNDS))


def new_hist() -> List[int]:
    return [0] * (HIST_NBOUNDS + 1)


def hist_observe(counts: List[int], value_s: float) -> None:
    """Bucket a sample. Pure int/float ops — safe on the engine step
    thread (worker_common wires this behind engine.on_phases)."""
    if value_s < 0.0:
        value_s = 0.0
    import math

    if value_s <= HIST_BASE_S:
        counts[0] += 1
        return
    idx = int(math.log(value_s / HIST_BASE_S, HIST_FACTOR)) + 1
    counts[min(idx, HIST_NBOUNDS)] += 1


def merge_hist(into: List[int], other: List[int]) -> List[int]:
    """Elementwise add `other` into `into` (tolerates short/long vectors
    from a version-skewed worker by clamping to the local layout)."""
    for i in range(min(len(into), len(other))):
        into[i] += int(other[i])
    return into


def hist_count(counts: List[int]) -> int:
    return sum(counts)


def hist_quantile(counts: List[int], q: float) -> Optional[float]:
    """Percentile estimate via cumulative walk + log-linear interpolation
    within the bucket. None when empty. The overflow bucket reports its
    lower bound (same convention as Prometheus's +Inf clamp)."""
    total = sum(counts)
    if total <= 0:
        return None
    q = min(1.0, max(0.0, q))
    rank = q * total
    acc = 0.0
    for i, c in enumerate(counts):
        if c <= 0:
            continue
        if acc + c >= rank:
            frac = (rank - acc) / c
            if i >= HIST_NBOUNDS:
                return HIST_BOUNDS[-1]
            lo = 0.0 if i == 0 else HIST_BOUNDS[i - 1]
            hi = HIST_BOUNDS[i]
            return lo + (hi - lo) * frac
        acc += c
    return HIST_BOUNDS[-1]


def hist_frac_over(counts: List[int], threshold_s: float) -> Optional[float]:
    """Fraction of samples above `threshold_s` (bucket-interpolated).
    The SLO burn-rate input. None when empty."""
    total = sum(counts)
    if total <= 0:
        return None
    over = 0.0
    for i, c in enumerate(counts):
        if c <= 0:
            continue
        lo = 0.0 if i == 0 else HIST_BOUNDS[i - 1]
        hi = HIST_BOUNDS[i] if i < HIST_NBOUNDS else float("inf")
        if lo >= threshold_s:
            over += c
        elif hi > threshold_s and hi != float("inf"):
            over += c * (hi - threshold_s) / (hi - lo)
    return over / total


# phases folded into digest histograms (the latency spine's SLO-relevant
# subset; itl_s is a per-request sample LIST, flattened)
DIGEST_PHASES = ("ttft_s", "itl_s", "e2e_s", "queue_wait_s", "route_s",
                 "kv_onboard_s")


class DigestBuilder:
    """Worker-side accumulator: engine callbacks in, one digest dict out
    per window. `observe_phases` runs on the engine STEP thread — bucket
    increments only, no locks, no I/O (the flight-recorder append-path
    discipline). `build()` runs on the event loop and
    swaps the accumulation dicts wholesale, so a torn read costs at most
    one sample landing in the next window."""

    # bounded per-window trace-id reservoir: enough to join a breaching
    # window back to concrete traces, small enough to never bloat a digest
    MAX_TRACE_IDS = 16

    def __init__(self, instance_id: int, dp_rank: int = 0):
        self.worker = [instance_id, dp_rank]
        self.seq = 0
        self._hists: Dict[str, List[int]] = {}
        self._counters = {"requests": 0, "decode_tokens": 0,
                          "prefill_tokens": 0, "decode_iters": 0,
                          "decode_wall_s": 0.0}
        self._last_fpm: Dict[str, Any] = {}
        self._trace_ids: List[str] = []
        # engine probes that raised (their block left out of the digest)
        self.probe_failures = 0
        self._m_probe = None

    def _probe_failed(self, what: str) -> None:
        self.probe_failures += 1
        if self._m_probe is not None:
            self._m_probe.inc()
        log.warning("digest %s probe failed", what, exc_info=True)

    # -- engine hooks (step thread) -----------------------------------------
    def observe_phases(self, phases: Dict[str, Any]) -> None:
        hists = self._hists
        self._counters["requests"] += 1
        tid = phases.get("trace_id")
        if (isinstance(tid, str) and len(self._trace_ids) < self.MAX_TRACE_IDS
                and tid not in self._trace_ids):
            # list append only (step thread); the window close swaps it
            self._trace_ids.append(tid)
        for key in DIGEST_PHASES:
            val = phases.get(key)
            if val is None:
                continue
            h = hists.get(key)
            if h is None:
                h = hists[key] = new_hist()
            if isinstance(val, list):
                for s in val:
                    if isinstance(s, (int, float)):
                        hist_observe(h, float(s))
            elif isinstance(val, (int, float)):
                hist_observe(h, float(val))

    def observe_fpm(self, m) -> None:
        kind = getattr(m, "kind", None)
        tokens = int(getattr(m, "scheduled_tokens", 0) or 0)
        c = self._counters
        if kind == "decode":
            c["decode_tokens"] += tokens
            c["decode_iters"] += 1
            c["decode_wall_s"] += float(getattr(m, "wall_time_s", 0.0) or 0.0)
        elif kind in ("prefill", "mixed"):
            c["prefill_tokens"] += tokens
        self._last_fpm = {
            "n_running": int(getattr(m, "n_running", 0) or 0),
            "n_waiting": int(getattr(m, "n_waiting", 0) or 0),
            "kv_usage": float(getattr(m, "kv_usage", 0.0) or 0.0),
        }

    # -- window close (event loop) ------------------------------------------
    def build(self, engine=None, period_s: float = 0.0) -> Dict[str, Any]:
        """Close the window: emit the digest and reset accumulation.
        `engine` (optional) is sampled for KV tier / prefetch / compile
        state — getattr-guarded so mockers and partial engines work."""
        hists, self._hists = self._hists, {}
        trace_ids, self._trace_ids = self._trace_ids, []
        counters = dict(self._counters)
        for k in self._counters:
            self._counters[k] = 0 if isinstance(self._counters[k], int) else 0.0
        self.seq += 1
        digest: Dict[str, Any] = {
            "worker": list(self.worker),
            "seq": self.seq,
            "ts": time.time(),
            "period_s": period_s,
            "phases": {k.removesuffix("_s"): h for k, h in hists.items()},
            "counters": counters,
            "queue": dict(self._last_fpm) or
                     {"n_running": 0, "n_waiting": 0, "kv_usage": 0.0},
        }
        if trace_ids:
            # join key back to the distributed span rings: the traces this
            # window's requests belonged to (bounded reservoir)
            digest["trace_ids"] = trace_ids
        if engine is not None:
            g2 = g3 = 0
            tiers: Dict[str, Any] = {}
            host_pool = getattr(engine, "host_pool", None)
            if host_pool is not None:
                try:
                    g2 = len(host_pool.host)
                    if getattr(host_pool, "disk", None) is not None:
                        g3 = len(host_pool.disk)
                    # per-tier byte/quantization occupancy (int8 tiered
                    # storage): stored_bytes is the ACTUAL footprint at
                    # the stored width, quant_blocks the int8 fraction's
                    # numerator. dynamo_top renders effective-vs-raw
                    # capacity from these; the router's measured-cost
                    # placement reads onboard_ewma below.
                    for name, pool in (("host", getattr(host_pool, "host", None)),
                                       ("disk", getattr(host_pool, "disk", None)),
                                       ("obj", getattr(host_pool, "obj", None))):
                        st = getattr(pool, "stats", None)
                        if not isinstance(st, dict):
                            continue
                        tiers[name] = {
                            "blocks": len(pool) if hasattr(pool, "__len__") else 0,
                            "stored_bytes": int(st.get("stored_bytes", 0)),
                            "quant_blocks": int(st.get("quant_blocks", 0)),
                        }
                        if "dedup_hits" in st:
                            # G4 prefix economy: fleet-shared store, so
                            # dedup hits are bytes the fleet did NOT
                            # store twice (dynamo_top's dedup ratio)
                            tiers[name]["dedup_hits"] = int(
                                st.get("dedup_hits", 0))
                            tiers[name]["dedup_bytes_saved"] = int(
                                st.get("dedup_bytes_saved", 0))
                except Exception:
                    self._probe_failed("host pool size")
            digest["kv"] = {
                "g1_usage": digest["queue"].get("kv_usage", 0.0),
                "g2_blocks": g2, "g3_blocks": g3,
            }
            kv_slice = getattr(engine, "slice_id", None)
            if kv_slice is not None:
                digest["kv"]["slice"] = str(kv_slice)
            if tiers:
                digest["kv"]["tiers"] = tiers
            ewma = getattr(engine, "kv_onboard_ewma", None)
            if ewma:
                digest["kv"]["onboard_ewma"] = {
                    t: {"s_per_block": round(float(v.get("s_per_block", 0.0)), 6),
                        "n": int(v.get("n", 0))}
                    for t, v in ewma.items()
                }
            pf = getattr(engine, "prefetch", None)
            if pf is not None:
                digest["prefetch"] = {
                    k: v for k, v in getattr(pf, "stats", {}).items()
                }
            runner = getattr(engine, "runner", None)
            if hasattr(runner, "compile_stats"):
                try:
                    digest["compile"] = {
                        fam: {"variants": st.get("variants", 0),
                              "calls": st.get("calls", 0)}
                        for fam, st in runner.compile_stats().items()
                    }
                except Exception:
                    self._probe_failed("compile stats")
            spec = getattr(engine, "spec_stats", None)
            if spec and spec.get("verify_iters", 0) > 0:
                rows = max(1, spec.get("verify_rows", 0))
                digest["spec"] = {
                    "drafted": spec.get("drafted", 0),
                    "accepted": spec.get("accepted", 0),
                    "rejected": spec.get("rejected", 0),
                    "verify_iters": spec.get("verify_iters", 0),
                    "accept_rate": (spec.get("accepted", 0)
                                    / max(1, spec.get("drafted", 0))),
                    "accepted_per_step": spec.get("spec_emitted", 0) / rows,
                    "tree_rows": spec.get("tree_rows", 0),
                    "tree_switches": spec.get("tree_switches", 0),
                }
            pool = getattr(engine, "pool", None)
            if pool is not None and hasattr(pool, "match_hit_blocks"):
                # session-tree reuse: cumulative engine-lifetime counters
                # (like spec above); hit_rate is reused prompt tokens over
                # all admitted prompt tokens
                sched = getattr(engine, "scheduler", None)
                reused = int(getattr(sched, "reused_prefix_tokens", 0) or 0)
                prompts = int(getattr(sched, "prompt_tokens_total", 0) or 0)
                digest["tree"] = {
                    "hit_blocks": int(pool.match_hit_blocks),
                    "forks": int(getattr(pool, "forks", 0)),
                    "reused_prefix_tokens": reused,
                    "prompt_tokens": prompts,
                    "hit_rate": round(reused / prompts, 4) if prompts else 0.0,
                }
            rec = getattr(engine, "recorder", None)
            if rec is not None and getattr(rec, "enabled", False):
                digest["recorder"] = {
                    "appended": rec.total_appended,
                    "anomalies_fired": rec.anomalies_fired,
                }
            # actuation state: the live co-scheduling knob values plus the
            # retune counter, so the planner's fast loop reads CURRENT
            # knobs off the digest plane (planner/actuator.py) and
            # dynamo_top's ACT column shows what the actuator last did
            sched = getattr(engine, "scheduler", None)
            if sched is not None and hasattr(sched, "mixed_prefill_tokens"):
                digest["act"] = {
                    "mixed_prefill_tokens": int(sched.mixed_prefill_tokens),
                    "mixed_prefill_seqs": int(
                        getattr(sched, "mixed_prefill_seqs", 0) or 0),
                    "spec_k": int(getattr(engine, "spec_k", 0) or 0),
                    "retunes": int(getattr(engine, "retunes", 0) or 0),
                }
        return digest


class DigestPublisher:
    """Periodic publish task wrapping a DigestBuilder. Owned by
    worker_common.serve_worker; the publisher is the runtime's shared
    event publisher (same socket FPM rides)."""

    def __init__(self, builder: DigestBuilder, pub: EventPublisher,
                 engine=None, period_s: float = 2.0):
        self.builder = builder
        self.pub = pub
        self.engine = engine
        self.period_s = max(0.1, float(period_s))
        self._task: Optional[asyncio.Task] = None
        self.published = 0
        self.publish_failures = 0
        self._m_failures = None

    @property
    def address(self) -> str:
        return self.pub.address

    def start(self) -> None:
        if self._task is None:
            self._task = asyncio.get_running_loop().create_task(self._loop())

    async def stop(self, flush: bool = True) -> None:
        # claim before the await: a concurrent stop() must see None, not
        # re-await the half-torn-down task
        task, self._task = self._task, None
        if task is not None:
            task.cancel()
            try:
                await task
            except asyncio.CancelledError:
                pass
        if flush:
            await self.publish_once()

    def bind_metrics(self, metrics) -> None:
        """Count publish failures and the builder's failed engine probes
        on a shared MetricsHierarchy (the worker's /metrics)."""
        node = metrics.child(dynamo_component="fleet_digest")
        self._m_failures = node.counter(
            "digest_publish_failures_total", "digests that failed to publish")
        self.builder._m_probe = node.counter(
            "digest_probe_failures_total",
            "engine probes that raised while building a digest")

    async def publish_once(self) -> None:
        digest = self.builder.build(self.engine, period_s=self.period_s)
        try:
            await self.pub.publish(FLEET_DIGEST_SUBJECT, digest)
            self.published += 1
        except Exception:
            # the digest plane is advisory: a transient publish failure
            # must never touch the serving path, so it is counted and
            # logged instead
            self.publish_failures += 1
            if self._m_failures is not None:
                self._m_failures.inc()
            log.warning("digest publish failed", exc_info=True)

    async def _loop(self) -> None:
        try:
            while True:
                await asyncio.sleep(self.period_s)
                await self.publish_once()
        except asyncio.CancelledError:
            raise


class FleetObserver:
    """Aggregate worker digests into per-worker and fleet-wide views.

    Robustness contract (tested under churn in test_fleet_observer.py):
    - digests are windowed by LOCAL receive time, so a worker with a
      skewed wall clock cannot move fleet percentiles;
    - duplicates and out-of-order arrivals are dropped via the per-worker
      monotonic `seq` (a replayed digest never double-counts);
    - a worker that stops publishing ages out after `gone_after_s`
      (default 3x window) — a mid-window death leaves its already-counted
      samples in the window and then disappears, never NaNs.
    """

    def __init__(self, subscriber: Optional[EventSubscriber],
                 window_s: float = 60.0, max_digests_per_worker: int = 512):
        self._sub = subscriber
        self.window_s = float(window_s)
        self.gone_after_s = 3.0 * self.window_s
        self._max = int(max_digests_per_worker)
        # worker -> deque[(recv_mono_s, digest)]
        self._digests: Dict[Worker, Deque[Tuple[float, dict]]] = {}
        self._last_seq: Dict[Worker, int] = {}
        self._task: Optional[asyncio.Task] = None
        self.received = 0
        self.dropped_stale = 0  # duplicate / out-of-order seq
        self.dropped_malformed = 0  # ingest raised

    # -- plumbing -----------------------------------------------------------
    def connect_publisher(self, address: str) -> None:
        if self._sub is not None:
            self._sub.connect(address)

    async def start(self) -> None:
        if self._task is None and self._sub is not None:
            self._task = asyncio.create_task(self._consume())

    async def stop(self) -> None:
        # claim before the await: a concurrent stop() must see None
        task, self._task = self._task, None
        if task is not None:
            task.cancel()
            try:
                await task
            except asyncio.CancelledError:
                pass

    async def _consume(self) -> None:
        async for subject, payload in self._sub.events():
            if subject != FLEET_DIGEST_SUBJECT:
                continue
            try:
                self.ingest(payload)
            except Exception:
                self.dropped_malformed += 1
                log.warning("malformed digest dropped", exc_info=True)

    def ingest(self, payload: dict, now: Optional[float] = None) -> bool:
        """Feed one digest (the subscription task calls this; tests and
        in-process consumers call it directly). `now` is the observer's
        monotonic receive time. Returns False when dropped."""
        worker = tuple(payload.get("worker") or (0, 0))
        seq = int(payload.get("seq") or 0)
        last = self._last_seq.get(worker)
        if last is not None and seq <= last:
            self.dropped_stale += 1
            return False
        self._last_seq[worker] = seq
        q = self._digests.setdefault(worker, deque(maxlen=self._max))
        q.append((now if now is not None else time.monotonic(), payload))
        self.received += 1
        return True

    def forget(self, worker: Worker) -> None:
        self._digests.pop(tuple(worker), None)
        self._last_seq.pop(tuple(worker), None)

    def forget_instance(self, instance_id: int) -> int:
        """Drop every (instance_id, dp_rank) worker immediately — wired
        to discovery DELETE events so a killed worker's already-ingested
        digests stop feeding load aggregates the moment the fleet knows
        it is gone, instead of lingering until the 3x-window age-out. An
        actuator scaling against that ghost load would fight a worker
        that no longer exists. Returns the number of workers dropped."""
        victims = [w for w in self._digests if w[0] == instance_id]
        for w in victims:
            self.forget(w)
        return len(victims)

    # -- aggregation --------------------------------------------------------
    def _window(self, now: Optional[float], window_s: Optional[float]
                ) -> Dict[Worker, List[dict]]:
        now = now if now is not None else time.monotonic()
        win = window_s if window_s is not None else self.window_s
        cutoff = now - win
        out: Dict[Worker, List[dict]] = {}
        for worker, q in list(self._digests.items()):
            recent = [d for t, d in q if t >= cutoff]
            if not recent:
                if q and now - q[-1][0] > self.gone_after_s:
                    self.forget(worker)  # worker gone
                continue
            out[worker] = recent
        return out

    def workers(self, now: Optional[float] = None) -> List[Worker]:
        return sorted(self._window(now, None))

    def window_digests(self, now: Optional[float] = None,
                       window_s: Optional[float] = None
                       ) -> Dict[Worker, List[dict]]:
        """Raw in-window digests per worker (newest last) — the adapter
        surface for consumers doing their own aggregation (planner's
        FleetLoadObserver)."""
        return self._window(now, window_s)

    def phase_hists(self, now: Optional[float] = None,
                    window_s: Optional[float] = None,
                    worker: Optional[Worker] = None,
                    ) -> Dict[str, List[int]]:
        """Merged phase histograms over the window — fleet-wide, or one
        worker's. Keys are spine phase names without the _s suffix."""
        merged: Dict[str, List[int]] = {}
        for w, digests in self._window(now, window_s).items():
            if worker is not None and tuple(worker) != w:
                continue
            for d in digests:
                for phase, counts in (d.get("phases") or {}).items():
                    h = merged.get(phase)
                    if h is None:
                        h = merged[phase] = new_hist()
                    merge_hist(h, counts)
        return merged

    def onboard_costs(self, now: Optional[float] = None,
                      window_s: Optional[float] = None
                      ) -> Dict[Worker, Dict[str, float]]:
        """Per-worker measured onboarding cost: {worker: {tier:
        s_per_block}} from the newest in-window digest that carried an
        EWMA block. The KvRouter's topology-aware placement feeds this to
        WorkerSelector as `tier_costs`; workers that haven't measured a
        tier yet simply omit it (the selector falls back to its
        constant-cost priors — cold-start safe)."""
        out: Dict[Worker, Dict[str, float]] = {}
        for w, digests in self._window(now, window_s).items():
            for d in reversed(digests):
                ewma = (d.get("kv") or {}).get("onboard_ewma")
                if ewma:
                    out[w] = {
                        str(t): float(v.get("s_per_block", 0.0))
                        for t, v in ewma.items()
                        if isinstance(v, dict) and v.get("n", 0) > 0
                    }
                    break
        return out

    @staticmethod
    def _pct_block(hists: Dict[str, List[int]]) -> Dict[str, Any]:
        out = {}
        for phase, h in sorted(hists.items()):
            n = hist_count(h)
            if not n:
                continue
            out[phase] = {
                "n": n,
                "p50_s": round(hist_quantile(h, 0.5), 6),
                "p95_s": round(hist_quantile(h, 0.95), 6),
                "p99_s": round(hist_quantile(h, 0.99), 6),
            }
        return out

    def fleet(self, now: Optional[float] = None,
              window_s: Optional[float] = None) -> Dict[str, Any]:
        """The /debug/fleet payload core: per-worker rows (latest
        instantaneous state + windowed percentiles) and fleet-wide merged
        percentiles."""
        windowed = self._window(now, window_s)
        workers_out = {}
        for w, digests in sorted(windowed.items()):
            latest = digests[-1]
            hists: Dict[str, List[int]] = {}
            counters = {"requests": 0, "decode_tokens": 0,
                        "prefill_tokens": 0, "decode_iters": 0,
                        "decode_wall_s": 0.0}
            for d in digests:
                for phase, counts in (d.get("phases") or {}).items():
                    merge_hist(hists.setdefault(phase, new_hist()), counts)
                for k, v in (d.get("counters") or {}).items():
                    if k in counters:
                        counters[k] += v
            row = {
                "worker": list(w),
                "digests": len(digests),
                "last_seq": latest.get("seq"),
                "last_ts": latest.get("ts"),
                "queue": latest.get("queue") or {},
                "kv": latest.get("kv") or {},
                "prefetch": latest.get("prefetch") or {},
                "compile": latest.get("compile") or {},
                # spec stats are cumulative on the engine; surface the most
                # recent digest that carried a block (quiet windows omit it)
                "spec": next((d["spec"] for d in reversed(digests)
                              if d.get("spec")), {}),
                "tree": next((d["tree"] for d in reversed(digests)
                              if d.get("tree")), {}),
                "act": next((d["act"] for d in reversed(digests)
                             if d.get("act")), {}),
                "counters": {k: round(v, 6) if isinstance(v, float) else v
                             for k, v in counters.items()},
                "phases": self._pct_block(hists),
            }
            workers_out[f"{w[0]:x}.{w[1]}"] = row
        return {
            "window_s": window_s if window_s is not None else self.window_s,
            "n_workers": len(windowed),
            "received": self.received,
            "dropped_stale": self.dropped_stale,
            "dropped_malformed": self.dropped_malformed,
            "workers": workers_out,
            "fleet": {"phases": self._pct_block(
                self.phase_hists(now, window_s))},
        }


class RoutingAudit:
    """Bounded ring of routing decisions, joinable to the phase spine by
    request id. Append is O(1) on the frontend event loop; query walks
    at most `capacity` entries. Per-router instance — no module-global
    mutable state."""

    def __init__(self, capacity: int = 1024):
        self.capacity = max(1, int(capacity))
        self._ring: Deque[dict] = deque(maxlen=self.capacity)
        self.recorded = 0

    def record(self, rid: str, mode: str, chosen, *,
               candidates: Optional[List[dict]] = None,
               **extra: Any) -> None:
        entry = {
            "rid": rid,
            "ts": time.time(),
            "mode": mode,
            "chosen": list(chosen) if isinstance(chosen, (list, tuple))
                      else chosen,
            "candidates": candidates or [],
        }
        entry.update(extra)
        self._ring.append(entry)
        self.recorded += 1

    def query(self, rid: Optional[str] = None,
              last_n: Optional[int] = None) -> List[dict]:
        if rid is not None:
            return [e for e in self._ring if e.get("rid") == rid]
        entries = list(self._ring)
        if last_n is not None and last_n > 0:
            entries = entries[-last_n:]
        return entries

    def __len__(self) -> int:
        return len(self._ring)


def routing_debug_payload(audits: Dict[str, RoutingAudit],
                          rid: Optional[str] = None,
                          last_n: int = 64) -> Dict[str, Any]:
    """The /debug/routing payload: decisions across every router in the
    process (frontends run one PushRouter per endpoint client plus an
    optional KvRouter), newest last. `rid` filters to one request."""
    decisions: List[dict] = []
    for name, audit in sorted(audits.items()):
        for e in audit.query(rid=rid, last_n=None if rid else last_n):
            d = dict(e)
            d["router"] = name
            decisions.append(d)
    decisions.sort(key=lambda e: e.get("ts", 0.0))
    if rid is None and last_n > 0:
        decisions = decisions[-last_n:]
    return {
        "n": len(decisions),
        "recorded": sum(a.recorded for a in audits.values()),
        "decisions": decisions,
    }
