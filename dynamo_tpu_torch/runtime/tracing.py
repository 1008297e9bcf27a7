"""Distributed tracing: W3C trace context + OTLP/HTTP span export.

Port of dynamo_tpu/runtime/tracing.py, whole and stdlib-only: the W3C
`traceparent` (tail-keep mark in the flags byte), the span context
managers and retroactive `record_span`, the bounded `SpanRing` (sampling
applied at read time, `DYN_TRACE_RING` / `DYN_TRACE_KEEP`), and the
`OtlpSpanExporter` on urllib with its bounded queue
(`DYN_OTLP_TRACES_ENDPOINT` / `DYN_OTLP_ENDPOINT`). The span and wire
formats are the reference's, so a port process and a reference process
join one trace and ship to one collector; the default OTLP service name
stays "dynamo_tpu" for the same reason.

How a trace forms in the port: the frontend's Migration operator opens
the `frontend.request` root (continuing a caller's `traceparent`), the
PushRouter or KvPushRouter opens `route.push` / `route.kv`, each server
hop (`PushEndpoint._handle_request`) opens `rpc <endpoint>`, and the
engine reconstructs `worker.request` and its queue / kv_onboard /
prefill / stream children from the phase spine at finish. Each hop
writes its span's traceparent into `Context.metadata`, which rides the
request-plane frame headers. With no exporter installed the only cost is
forwarding the existing traceparent string.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import logging
import os
import secrets
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

log = logging.getLogger("dynamo_tpu_torch.tracing")

# W3C trace flags: bit 0 (0x01) = sampled; we claim bit 1 (0x02) as the
# tail-keep mark (migrated / SLO-breaching requests are always kept by
# the SpanRing regardless of the probabilistic sampling decision)
TAIL_FLAG = 0x02


@dataclass
class SpanContext:
    trace_id: str  # 32 hex chars
    span_id: str  # 16 hex chars
    flags: str = "01"

    @property
    def traceparent(self) -> str:
        return f"00-{self.trace_id}-{self.span_id}-{self.flags}"

    @property
    def tail(self) -> bool:
        try:
            return bool(int(self.flags, 16) & TAIL_FLAG)
        except ValueError:
            return False


def parse_traceparent(value: Optional[str]) -> Optional[SpanContext]:
    """W3C trace-context header -> SpanContext (None when absent/invalid)."""
    if not value or not isinstance(value, str):
        return None
    parts = value.split("-")
    if len(parts) != 4 or len(parts[1]) != 32 or len(parts[2]) != 16:
        return None
    if parts[1] == "0" * 32 or parts[2] == "0" * 16:
        return None
    try:
        # non-hex ids would poison the whole OTLP export batch downstream
        # (a collector 400s the entire /v1/traces request on one bad id)
        int(parts[1], 16), int(parts[2], 16), int(parts[3][:2] or "01", 16)
    except ValueError:
        return None
    return SpanContext(trace_id=parts[1].lower(), span_id=parts[2].lower(),
                       flags=parts[3][:2] or "01")


@dataclass
class TraceContext:
    """The compact trace context that rides Context.metadata across every
    hop: trace id, the parent span at this hop, flags (with the tail-keep
    bit). A thin, explicit view over the traceparent string — helpers for
    code that reasons about the trace rather than opening a span."""

    trace_id: str
    span_id: str  # the parent span for anything opened at this hop
    flags: str = "01"

    @property
    def traceparent(self) -> str:
        return f"00-{self.trace_id}-{self.span_id}-{self.flags}"

    @property
    def tail(self) -> bool:
        try:
            return bool(int(self.flags, 16) & TAIL_FLAG)
        except ValueError:
            return False

    @classmethod
    def from_metadata(cls, metadata: Optional[Dict[str, Any]]
                      ) -> Optional["TraceContext"]:
        ctx = parse_traceparent((metadata or {}).get("traceparent"))
        if ctx is None:
            return None
        return cls(ctx.trace_id, ctx.span_id, ctx.flags)

    def with_tail(self) -> "TraceContext":
        try:
            flags = int(self.flags, 16) | TAIL_FLAG
        except ValueError:
            flags = 0x01 | TAIL_FLAG
        return TraceContext(self.trace_id, self.span_id, f"{flags:02x}")

    def apply(self, metadata: Dict[str, Any]) -> None:
        metadata["traceparent"] = self.traceparent


def mark_tail(metadata: Dict[str, Any]) -> Optional[str]:
    """Set the tail-keep bit on the metadata traceparent (and return the
    rewritten value). Called when a request turns interesting after the
    fact — a migration replay, an SLO-threshold excursion — so every
    LATER hop's spans inherit the mark for free. No-op without a valid
    traceparent."""
    tc = TraceContext.from_metadata(metadata)
    if tc is None:
        return None
    tc = tc.with_tail()
    tc.apply(metadata)
    return tc.traceparent


def trace_keep(trace_id: str, keep_prob: float) -> bool:
    """Coordination-free sampling agreement: a deterministic hash of the
    trace_id against `keep_prob`, so every worker in the fleet keeps (or
    drops) the same traces without talking to each other."""
    if keep_prob >= 1.0:
        return True
    if keep_prob <= 0.0:
        return False
    try:
        # FNV-1a over the hex id: cheap, stable across processes (unlike
        # hash()), uniform enough for a sampling decision
        acc = 0x811C9DC5
        for ch in trace_id:
            acc = ((acc ^ ord(ch)) * 0x01000193) & 0xFFFFFFFF
        return (acc / 0xFFFFFFFF) < keep_prob
    except TypeError:
        return False


@dataclass
class Span:
    name: str
    context: SpanContext
    parent_span_id: Optional[str]
    start_ns: int
    end_ns: int = 0
    kind: int = 1  # OTLP SpanKind: 1=internal, 2=server, 3=client
    attributes: Dict[str, Any] = field(default_factory=dict)
    status_error: Optional[str] = None
    events: List[Dict[str, Any]] = field(default_factory=list)

    @property
    def traceparent(self) -> str:
        return self.context.traceparent

    def set_attribute(self, key: str, value: Any) -> None:
        self.attributes[key] = value

    def add_event(self, name: str,
                  attributes: Optional[Dict[str, Any]] = None) -> None:
        """Timestamped point event inside the span (OTLP span events) —
        the latency spine's phase marks ride these."""
        self.events.append({
            "name": name,
            "time_ns": time.time_ns(),
            "attributes": dict(attributes or {}),
        })

    def record_error(self, err: str) -> None:
        self.status_error = err


class _NoopSpan:
    """Returned when tracing is disabled; forwards nothing, costs nothing."""

    traceparent = None

    def set_attribute(self, key: str, value: Any) -> None:
        pass

    def add_event(self, name: str,
                  attributes: Optional[Dict[str, Any]] = None) -> None:
        pass

    def record_error(self, err: str) -> None:
        pass


NOOP_SPAN = _NoopSpan()


class MemorySpanExporter:
    """Test exporter: finished spans in a list."""

    def __init__(self):
        self.spans: List[Span] = []

    def export(self, span: Span) -> None:
        self.spans.append(span)


def span_to_dict(s: Span) -> Dict[str, Any]:
    """JSON form for /debug/traces and incident bundles (inverse-friendly:
    dump_timeline --trace consumes exactly this shape)."""
    return {
        "name": s.name,
        "trace_id": s.context.trace_id,
        "span_id": s.context.span_id,
        "parent_span_id": s.parent_span_id,
        "flags": s.context.flags,
        "start_ns": s.start_ns,
        "end_ns": s.end_ns,
        "kind": s.kind,
        "attributes": dict(s.attributes),
        "status_error": s.status_error,
        "events": [dict(e) for e in s.events],
    }


class SpanRing:
    """Bounded in-process span ring with tail-based sampling at READ time.

    Every finished span lands in the ring (O(1) append, deque-bounded —
    the ring is the memory ceiling, natural FIFO eviction). The sampling
    decision happens when someone reads the ring (`snapshot`,
    `/debug/traces`, an incident bundle): a trace survives if ANY of its
    spans carried the tail-keep flag (migrated / SLO-breaching requests)
    or if the deterministic `trace_keep` hash clears `keep_prob`. Late
    marking therefore keeps the WHOLE trace — the early spans are still
    in the ring when the mark arrives. `spans_for` (incident forensics)
    never samples: evidence beats budgets once a trace id is named."""

    def __init__(self, capacity: int = 4096, keep_prob: float = 1.0):
        from collections import deque

        self.capacity = max(16, int(capacity))
        self.keep_prob = float(keep_prob)
        self._ring = deque(maxlen=self.capacity)
        # bounded memory of tail-marked trace ids (survives ring eviction
        # of the marking span; bounded so a long-lived worker can't grow it)
        self._tail: "deque" = deque(maxlen=self.capacity)
        self._tail_set: set = set()
        self.exported = 0

    def export(self, span: Span) -> None:
        self._ring.append(span)
        self.exported += 1
        if span.context.tail and span.context.trace_id not in self._tail_set:
            if len(self._tail) == self._tail.maxlen:
                self._tail_set.discard(self._tail[0])
            self._tail.append(span.context.trace_id)
            self._tail_set.add(span.context.trace_id)

    def __len__(self) -> int:
        return len(self._ring)

    def keeps(self, trace_id: str) -> bool:
        return trace_id in self._tail_set or trace_keep(trace_id,
                                                        self.keep_prob)

    def tail_trace_ids(self) -> List[str]:
        """Tail-marked trace ids still remembered (incident bundles list
        these so forensics knows which traces were kept by policy)."""
        return sorted(self._tail_set)

    def spans_for(self, trace_id: str) -> List[Span]:
        """Every ring span of one trace, oldest first — unsampled (the
        incident path and trace-id queries want ALL the evidence)."""
        return [s for s in self._ring if s.context.trace_id == trace_id]

    def snapshot(self, last_n: int = 0, sampled: bool = True) -> List[Span]:
        spans = list(self._ring)
        if sampled:
            spans = [s for s in spans if self.keeps(s.context.trace_id)]
        if last_n > 0:
            spans = spans[-last_n:]
        return spans

    def payload(self, trace_id: Optional[str] = None,
                last_n: int = 0) -> Dict[str, Any]:
        """The /debug/traces JSON body."""
        if trace_id:
            spans = self.spans_for(trace_id)
        else:
            spans = self.snapshot(last_n=last_n)
        return {
            "n": len(spans),
            "exported": self.exported,
            "capacity": self.capacity,
            "keep_prob": self.keep_prob,
            "tail_traces": len(self._tail_set),
            "spans": [span_to_dict(s) for s in spans],
        }


class MultiExporter:
    """Fan a span out to several exporters (ring + OTLP coexist)."""

    def __init__(self, *exporters):
        self.exporters = [e for e in exporters if e is not None]

    def export(self, span: Span) -> None:
        for e in self.exporters:
            e.export(span)

    def flush(self, timeout_s: float = 5.0) -> bool:
        ok = True
        for e in self.exporters:
            fl = getattr(e, "flush", None)
            if fl is not None:
                ok = bool(fl(timeout_s)) and ok
        return ok


class OtlpSpanExporter:
    """Batch spans to an OTLP/HTTP collector (/v1/traces, JSON encoding)
    from a daemon thread; drops on failure (telemetry is best-effort)."""

    def __init__(self, endpoint: str, service_name: str = "dynamo_tpu",
                 flush_interval_s: float = 2.0, max_batch: int = 256,
                 max_queue: int = 8192):
        import queue

        self.url = endpoint.rstrip("/") + "/v1/traces"
        self.service_name = service_name
        self.flush_interval_s = flush_interval_s
        self.max_batch = max_batch
        # bounded queue is the memory ceiling; overflow drops (counted)
        self._q: "queue.Queue" = queue.Queue(maxsize=max_queue)
        self.dropped = 0  # spans dropped on queue overflow
        self._inflight = 0  # spans popped but not yet POSTed (flush waits)
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def export(self, span: Span) -> None:
        import queue

        try:
            self._q.put_nowait(span)
        except queue.Full:
            # full queue: drop, but keep the evidence — a short-lived
            # worker seeing dropped>0 at shutdown lost tail spans. The
            # FIRST drop warns (once): silent span loss hides exactly the
            # traces an overloaded process most needs; after that the
            # `dynamo_trace_dropped_spans` gauge carries the count.
            self.dropped += 1
            if self.dropped == 1:
                log.warning(
                    "span queue full (maxsize=%d): dropping spans — the "
                    "collector at %s is slow or down; further drops are "
                    "counted on the dropped_spans gauge, not logged",
                    self._q.maxsize, getattr(self, "url", "?"))

    def flush(self, timeout_s: float = 5.0) -> bool:
        """Bounded drain: wait until the batch thread has consumed AND
        posted everything queued at call time (or the timeout expires).
        Called on runtime shutdown so short-lived workers don't exit with
        their tail spans still queued. Returns True when fully drained."""
        deadline = time.monotonic() + max(0.0, timeout_s)
        while self._q.qsize() > 0 or self._inflight > 0:
            if time.monotonic() >= deadline:
                return False
            time.sleep(0.02)
        return True

    @staticmethod
    def _attr(k: str, v: Any) -> Dict[str, Any]:
        if isinstance(v, bool):
            val = {"boolValue": v}
        elif isinstance(v, int):
            val = {"intValue": str(v)}
        elif isinstance(v, float):
            val = {"doubleValue": v}
        else:
            val = {"stringValue": str(v)}
        return {"key": k, "value": val}

    def _wire(self, s: Span) -> Dict[str, Any]:
        out = {
            "traceId": s.context.trace_id,
            "spanId": s.context.span_id,
            "name": s.name,
            "kind": s.kind,  # already the OTLP enum (1=internal, 2=server, 3=client)
            "startTimeUnixNano": str(s.start_ns),
            "endTimeUnixNano": str(s.end_ns),
            "attributes": [self._attr(k, v) for k, v in s.attributes.items()],
        }
        if s.parent_span_id:
            out["parentSpanId"] = s.parent_span_id
        if s.status_error is not None:
            out["status"] = {"code": 2, "message": s.status_error}
        if s.events:
            out["events"] = [
                {
                    "timeUnixNano": str(e["time_ns"]),
                    "name": e["name"],
                    "attributes": [self._attr(k, v)
                                   for k, v in e["attributes"].items()],
                }
                for e in s.events
            ]
        return out

    def _loop(self) -> None:
        import queue
        import urllib.request

        while True:
            batch = [self._q.get()]
            self._inflight = 1
            deadline = time.monotonic() + self.flush_interval_s
            while len(batch) < self.max_batch:
                try:
                    batch.append(
                        self._q.get(timeout=max(0.01, deadline - time.monotonic()))
                    )
                    self._inflight = len(batch)
                except queue.Empty:
                    break
            payload = json.dumps({
                "resourceSpans": [{
                    "resource": {"attributes": [
                        {"key": "service.name",
                         "value": {"stringValue": self.service_name}},
                    ]},
                    "scopeSpans": [{
                        "scope": {"name": "dynamo_tpu"},
                        "spans": [self._wire(s) for s in batch],
                    }],
                }]
            }).encode()
            try:
                req = urllib.request.Request(
                    self.url, data=payload,
                    headers={"Content-Type": "application/json"},
                )
                urllib.request.urlopen(req, timeout=5).read()
            except (OSError, ValueError):
                pass  # collector down / bad endpoint: drop
            finally:
                self._inflight = 0


_exporter = None
_configured = False


def set_exporter(exporter) -> None:
    """Install a span exporter (tests use MemorySpanExporter; production
    configuration happens via DYN_OTLP_ENDPOINT in configure_tracing)."""
    global _exporter, _configured
    _exporter = exporter
    _configured = True


def configure_tracing(service_name: str = "dynamo_tpu") -> None:
    """Idempotent env-driven setup: DYN_OTLP_ENDPOINT enables span export
    (shared with the OTLP log handler endpoint, like the reference);
    DYN_TRACE_RING=N arms the bounded in-process SpanRing (queryable at
    /debug/traces, merged fleet-wide by dump_timeline --trace) with
    DYN_TRACE_KEEP as the probabilistic keep fraction (default 1.0;
    tail-marked traces are always kept). Both may coexist."""
    global _configured
    if _configured:
        return
    _configured = True
    endpoint = os.environ.get("DYN_OTLP_TRACES_ENDPOINT") \
        or os.environ.get("DYN_OTLP_ENDPOINT")
    exporters = []
    try:
        ring_cap = int(os.environ.get("DYN_TRACE_RING", "0"))
    except ValueError:
        ring_cap = 0
    if ring_cap > 0:
        try:
            keep = float(os.environ.get("DYN_TRACE_KEEP", "1.0"))
        except ValueError:
            keep = 1.0
        exporters.append(SpanRing(capacity=ring_cap, keep_prob=keep))
    if endpoint:
        exporters.append(OtlpSpanExporter(endpoint,
                                          service_name=service_name))
    if len(exporters) == 1:
        set_exporter(exporters[0])
    elif exporters:
        set_exporter(MultiExporter(*exporters))


def enabled() -> bool:
    return _exporter is not None


def span_ring() -> Optional[SpanRing]:
    """The installed SpanRing, if any (directly or inside a
    MultiExporter) — the /debug/traces and incident-bundle source."""
    exp = _exporter
    if isinstance(exp, SpanRing):
        return exp
    for e in getattr(exp, "exporters", ()):
        if isinstance(e, SpanRing):
            return e
    return None


def dropped_spans() -> int:
    """Spans lost to bounded-queue overflow across the installed
    exporter(s) — surfaced as a /metrics gauge by worker_common so
    silent span loss is visible without reading logs."""
    exp = _exporter
    total = int(getattr(exp, "dropped", 0) or 0)
    for e in getattr(exp, "exporters", ()):
        total += int(getattr(e, "dropped", 0) or 0)
    return total


def flush_tracing(timeout_s: float = 5.0) -> bool:
    """Drain the installed exporter's span queue (bounded). No-ops (True)
    when tracing is off or the exporter has no buffering. Wired into
    DistributedRuntime.shutdown so short-lived workers keep tail spans."""
    exp = _exporter
    fl = getattr(exp, "flush", None)
    if fl is None:
        return True
    try:
        return bool(fl(timeout_s))
    except Exception:  # pragma: no cover
        log.exception("span flush failed")
        return False


@contextlib.contextmanager
def span(name: str, parent: Optional[str] = None, kind: int = 1,
         attributes: Optional[Dict[str, Any]] = None):
    """Open a span. `parent` is a traceparent string (e.g. from
    ctx.metadata); the yielded span's `.traceparent` is what downstream
    metadata should carry. No exporter installed -> a shared no-op span
    (callers still forward the incoming parent themselves)."""
    if _exporter is None:
        yield NOOP_SPAN
        return
    pctx = parse_traceparent(parent)
    ctx = SpanContext(
        trace_id=pctx.trace_id if pctx else secrets.token_hex(16),
        span_id=secrets.token_hex(8),
        # inherit flags so a tail-keep mark set upstream rides every
        # child traceparent this hop writes downstream
        flags=pctx.flags if pctx else "01",
    )
    s = Span(
        name=name,
        context=ctx,
        parent_span_id=pctx.span_id if pctx else None,
        start_ns=time.time_ns(),
        kind=kind,
        attributes=dict(attributes or {}),
    )
    try:
        yield s
    except BaseException as e:
        # GeneratorExit is the normal close of a streaming consumer and
        # CancelledError is cooperative shutdown — neither is a span error
        if not isinstance(e, (GeneratorExit, asyncio.CancelledError)):
            s.record_error(f"{type(e).__name__}: {e}")
        raise
    finally:
        s.end_ns = time.time_ns()
        try:
            _exporter.export(s)
        except Exception:
            log.exception("span export failed")


def child_traceparent(metadata: Dict[str, Any], s) -> None:
    """Point request metadata at `s` so downstream hops become children.
    With tracing disabled (no-op span) the existing traceparent is left
    for downstream services that DO trace."""
    tp = getattr(s, "traceparent", None)
    if tp is not None:
        metadata["traceparent"] = tp


def record_span(name: str, start_ns: int, end_ns: int,
                parent: Optional[str] = None, kind: int = 1,
                attributes: Optional[Dict[str, Any]] = None,
                ) -> Optional[Span]:
    """Record an already-measured interval as a finished span.

    The worker's phase spine measures durations on the step thread and
    only knows the full story at request finish; promotions in the KV
    prefetcher span several engine ticks. Both reconstruct their spans
    retroactively from (start_ns, end_ns) instead of holding a live span
    open across threads. Inherits trace id and the tail-keep flag from
    `parent`; no exporter installed -> None, zero allocation beyond the
    parse."""
    if _exporter is None:
        return None
    pctx = parse_traceparent(parent)
    ctx = SpanContext(
        trace_id=pctx.trace_id if pctx else secrets.token_hex(16),
        span_id=secrets.token_hex(8),
        flags=pctx.flags if pctx else "01",
    )
    s = Span(
        name=name,
        context=ctx,
        parent_span_id=pctx.span_id if pctx else None,
        start_ns=int(start_ns),
        end_ns=int(end_ns),
        kind=kind,
        attributes=dict(attributes or {}),
    )
    try:
        _exporter.export(s)
    except Exception:
        log.exception("span export failed")
    return s
