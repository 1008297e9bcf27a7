"""Always-on engine flight recorder: a fixed-size ring of per-iteration
records plus an EWMA-based anomaly trigger.

Port of dynamo_tpu/runtime/flight_recorder.py. The engine's step loop
appends ONE `IterationRecord` per dispatched iteration: what the
scheduler composed (decode rows x fused steps, packed prefill chunks and
their tokens, ragged vs padded program, fused vs two dispatches), what it
cost (dispatch + host-sync wall time), and the world around it
(admission queue, KV occupancy per tier, prefetch hits). `append()` runs
on the step thread: no blocking I/O, no locks shared with slow readers;
an anomaly hands a snapshot to a daemon thread with `put_nowait`.
Readers tolerate torn reads (records are immutable once appended).

Anomaly trigger: per-kind EWMA of iteration wall time; an iteration over
`ewma * anomaly_k` (after `anomaly_min_samples`) fires once per
excursion and re-arms after a sub-threshold iteration of its kind. A
fired trigger snapshots the last N records to the dump thread, which
writes them as JSON under `anomaly_dump_dir` and, with
`anomaly_profile_ms` > 0, asks `profile_fn` (the engine's StepProfiler:
the step thread opens the window, so its ranges land in it) for a
`torch.profiler` window (CPU + CUDA) written as a Chrome trace under
`<dump dir>/anomaly_profile`.

Departures from the reference: `compile_variants` / `compile_calls` are
the port's counterparts of XLA's compile-cache counters, the distinct
(dispatch kind, bucket) shapes the runner has dispatched and the
dispatches made (engine/model_runner.py `dispatch_shapes`), since the
port compiles nothing per shape; `ragged` says which program the runner
ran (the reference guesses len(chunks) > 1 for a fused mixed step).
"""

from __future__ import annotations

import json
import logging
import os
import queue
import threading
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, List, Optional

log = logging.getLogger("dynamo_tpu_torch.flight_recorder")


@dataclass(slots=True)
class IterationRecord:
    """One engine iteration, as the scheduler composed and the runner
    executed it. All counters that read "cumulative" are monotonically
    increasing process totals sampled at append time (deltas between
    consecutive records give per-iteration rates)."""

    seq: int               # engine iteration number (monotonic)
    ts: float              # wall clock (time.time()) at iteration start
    wall_s: float          # dispatch + host-sync wall time
    kind: str              # "prefill" | "decode" | "mixed"
    decode_seqs: int       # decode batch rows this iteration
    decode_steps: int      # fused decode steps (T)
    n_chunks: int          # packed prefill chunks served
    chunk_tokens: int      # real prefill tokens served
    charged_tokens: int    # tokens the dispatch was CHARGED for (padding
    #   and bucket round-up included; == chunk_tokens when unknowable)
    ragged: bool           # ragged flat-token program vs padded fallback
    fused: bool            # one fused dispatch vs decode+prefill halves
    n_waiting: int         # admission queue depth after the step
    n_running: int
    kv_usage: float        # G1 device pool occupancy fraction
    g2_blocks: int         # host-tier resident blocks (0 = tier off)
    g3_blocks: int         # disk-tier resident blocks (0 = tier off)
    prefetch_hits: int     # cumulative prefetched-block claims
    compile_variants: int  # cumulative compiled jit variants (all families)
    compile_calls: int     # cumulative jitted calls (calls - variants
    #   growth = compile-cache hits)
    anomaly: bool = False  # this iteration fired the EWMA trigger
    # speculative decoding: mean tokens emitted per speculating row this
    # iteration (accepted drafts + the verified/bonus token; 0.0 when no
    # row speculated) — the per-step multi-token factor the ITL spine
    # divides by, surfaced in the fleet digest
    accepted_per_step: float = 0.0
    # agentic session-tree serving
    guided_rows: int = 0       # constraint-masked decode rows this iteration
    tree_hit_blocks: int = 0   # cumulative blocks served warm by match_prefix
    forks: int = 0             # cumulative fork-on-branch fan-outs
    # causal tracing: trace ids of the requests this iteration served
    # (bounded by the engine at append time) — joins the per-iteration
    # timeline to the distributed span rings and incident bundles
    trace_ids: List[str] = field(default_factory=list)


@dataclass
class _AnomalyDump:
    """Snapshot handed to the writer thread when the trigger fires."""

    fired_ts: float
    trigger: IterationRecord
    ewma_s: float
    k: float
    records: List[IterationRecord] = field(default_factory=list)


class FlightRecorder:
    """Fixed-size iteration ring + EWMA anomaly trigger.

    `capacity <= 0` builds a disabled recorder: `append()` is a no-op
    and every surface reports empty — the A/B knob for the overhead
    bench and the `--recorder-size 0` worker flag."""

    def __init__(
        self,
        capacity: int = 4096,
        *,
        anomaly_k: float = 4.0,        # fire when wall > ewma * k (0 = off)
        anomaly_min_samples: int = 32,  # per-kind warmup before arming
        anomaly_dump_dir: Optional[str] = None,  # None = count, don't dump
        anomaly_dump_last_n: int = 256,
        anomaly_profile_ms: int = 0,   # >0: torch.profiler window per dump
        ewma_alpha: float = 0.05,
    ):
        self.capacity = max(0, int(capacity))
        self.enabled = self.capacity > 0
        self._ring: List[Optional[IterationRecord]] = [None] * self.capacity
        self._n = 0  # total records ever appended
        self.anomaly_k = float(anomaly_k)
        self.anomaly_min_samples = int(anomaly_min_samples)
        self.anomaly_dump_dir = anomaly_dump_dir
        self.anomaly_dump_last_n = int(anomaly_dump_last_n)
        self.anomaly_profile_ms = int(anomaly_profile_ms)
        self._alpha = float(ewma_alpha)
        self._ewma: Dict[str, float] = {}      # kind -> smoothed wall_s
        self._ewma_n: Dict[str, int] = {}      # kind -> samples folded in
        self._armed: Dict[str, bool] = {}      # kind -> trigger re-armed
        self.anomalies_fired = 0
        self.dumps_written = 0
        self.dumps_dropped = 0   # writer queue full at fire time
        # hook failures, counted: a dump that failed to write, an anomaly
        # hook that raised, a profile window that failed or had no opener
        self.failures = {"dump": 0, "hook": 0, "profile": 0}
        self._dump_q: "queue.Queue[_AnomalyDump]" = queue.Queue(maxsize=4)
        self._dump_thread: Optional[threading.Thread] = None
        # metrics are bind-time optional (worker_common re-homes them onto
        # the status-port hierarchy); None until bound
        self._m_anomalies = None
        self._m_failures = None
        # anomaly-fire hooks (incident capture arming): called on the STEP
        # thread with the triggering record — handlers must be hand-off
        # cheap (put_nowait into their own queue), never blocking I/O
        self._anomaly_hooks: List[Any] = []
        # the anomaly profile window's opener: fn(ms, out_dir, tag) ->
        # Future of the trace path (the engine binds its StepProfiler)
        self.profile_fn = None
        self.profiles_written = 0
        self.last_profile: Optional[str] = None

    def on_anomaly(self, cb) -> None:
        """Register cb(rec: IterationRecord) fired when the EWMA trigger
        trips. Runs on the engine step thread — the handler must hand off
        (the same rule as append: hand off, never block)."""
        self._anomaly_hooks.append(cb)

    def bind_metrics(self, metrics) -> None:
        """Re-home the fired-dumps counter onto a shared MetricsHierarchy
        (the worker calls this with runtime.metrics at serve time)."""
        node = metrics.child(dynamo_component="flight_recorder")
        self._m_anomalies = node.counter(
            "flight_recorder_anomalies_total",
            "iterations that exceeded the EWMA*k wall-time threshold")
        self._m_failures = {
            what: node.counter("flight_recorder_failures_total",
                               "anomaly dumps, hooks and profile windows that failed",
                               what=what)
            for what in self.failures}

    def _failed(self, what: str, message: str) -> None:
        self.failures[what] += 1
        if self._m_failures is not None:
            self._m_failures[what].inc()
        log.warning(message, exc_info=True)

    # -- hot path (engine step thread: no blocking I/O) --------------------
    def append(self, rec: IterationRecord) -> None:
        if not self.enabled:
            return
        self._record_anomaly(rec)
        self._ring[self._n % self.capacity] = rec
        self._n += 1

    def _record_anomaly(self, rec: IterationRecord) -> None:
        """EWMA threshold check + fire-once-per-excursion bookkeeping.
        Runs on the step thread: the dump itself is handed off via
        put_nowait and written elsewhere."""
        if self.anomaly_k <= 0.0:
            return
        kind = rec.kind
        ewma = self._ewma.get(kind)
        n = self._ewma_n.get(kind, 0)
        if (ewma is not None and n >= self.anomaly_min_samples
                and rec.wall_s > ewma * self.anomaly_k):
            if self._armed.get(kind, True):
                self._armed[kind] = False
                rec.anomaly = True
                self.anomalies_fired += 1
                if self._m_anomalies is not None:
                    self._m_anomalies.inc()
                if self.anomaly_dump_dir:
                    dump = _AnomalyDump(
                        fired_ts=rec.ts, trigger=rec, ewma_s=ewma,
                        k=self.anomaly_k,
                        records=self.snapshot(self.anomaly_dump_last_n),
                    )
                    try:
                        self._dump_q.put_nowait(dump)
                    except queue.Full:
                        self.dumps_dropped += 1
                    self._ensure_dump_thread()
                for hook in self._anomaly_hooks:
                    try:
                        hook(rec)
                    except Exception:
                        self._failed("hook", "anomaly hook failed")
            # anomalous samples do NOT move the EWMA: the baseline keeps
            # tracking steady state so a sustained stall stays anomalous
            return
        self._armed[kind] = True
        if ewma is None:
            self._ewma[kind] = rec.wall_s
        else:
            self._ewma[kind] = ewma + self._alpha * (rec.wall_s - ewma)
        self._ewma_n[kind] = n + 1

    def _ensure_dump_thread(self) -> None:
        if self._dump_thread is None or not self._dump_thread.is_alive():
            self._dump_thread = threading.Thread(
                target=self._dump_loop, name="flight-recorder-dump",
                daemon=True)
            self._dump_thread.start()

    # -- readers / cold path ------------------------------------------------
    def __len__(self) -> int:
        return min(self._n, self.capacity)

    @property
    def total_appended(self) -> int:
        return self._n

    def snapshot(self, last_n: Optional[int] = None) -> List[IterationRecord]:
        """Oldest-to-newest copy of the ring (or its last `last_n`
        records). Tolerates concurrent appends: a record overwritten
        mid-read is simply the newer one."""
        if not self.enabled:
            return []
        n = self._n
        count = min(n, self.capacity)
        if last_n is not None:
            count = min(count, max(0, int(last_n)))
        out: List[IterationRecord] = []
        for i in range(n - count, n):
            rec = self._ring[i % self.capacity]
            if rec is not None:
                out.append(rec)
        return out

    def to_chrome_trace(self, last_n: Optional[int] = None,
                        pid: int = 0) -> Dict[str, Any]:
        return to_chrome_trace(self.snapshot(last_n), pid=pid)

    def stats(self) -> Dict[str, Any]:
        """One-line counters for goodput extras / status surfaces."""
        return {
            "enabled": self.enabled,
            "capacity": self.capacity,
            "appended": self._n,
            "anomalies_fired": self.anomalies_fired,
            "dumps_written": self.dumps_written,
            "dumps_dropped": self.dumps_dropped,
            "profiles_written": self.profiles_written,
            "failures": dict(self.failures),
            "ewma_s": {k: round(v, 6) for k, v in self._ewma.items()},
        }

    # -- dump plane (daemon thread: blocking I/O is fine here) --------------
    def _dump_loop(self) -> None:
        while True:
            try:
                dump = self._dump_q.get(timeout=30.0)
            except queue.Empty:
                return  # idle: let the thread die; refired on next anomaly
            try:
                self._write_dump(dump)
                self.dumps_written += 1
            except OSError:
                self._failed("dump", "anomaly dump write failed")
            if self.anomaly_profile_ms > 0:
                self._profile_window()

    def _write_dump(self, dump: _AnomalyDump) -> str:
        os.makedirs(self.anomaly_dump_dir, exist_ok=True)
        path = os.path.join(
            self.anomaly_dump_dir,
            f"flight_dump_{dump.trigger.seq:08d}.json")
        payload = {
            "fired_ts": dump.fired_ts,
            "ewma_s": dump.ewma_s,
            "k": dump.k,
            "trigger_seq": dump.trigger.seq,
            # the trigger record itself: the ring snapshot was taken
            # before the trigger was appended, so it rides separately
            "trigger": asdict(dump.trigger),
            "records": [asdict(r) for r in dump.records],
        }
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(payload, f)
        os.replace(tmp, path)
        return path

    def _profile_window(self) -> None:
        """A torch.profiler window after a dump: the recurring pathology's
        next occurrence lands in a device trace. A window that fails is
        logged and counted as a failure."""
        if self.profile_fn is None:
            self._failed("profile", "anomaly profile window asked for, but no "
                         "profiler is bound")
            return
        prof_dir = os.path.join(self.anomaly_dump_dir or ".", "anomaly_profile")
        try:
            fut = self.profile_fn(self.anomaly_profile_ms, prof_dir, "anomaly")
            path = fut.result(timeout=self.anomaly_profile_ms / 1000.0 + 60.0)
        except Exception:
            self._failed("profile", "anomaly profiler window failed")
            return
        self.profiles_written += 1
        self.last_profile = path


# -- Perfetto / Chrome-trace export -----------------------------------------

# track (tid) layout inside the engine process
_TID_SCHED = 0
_TID_DISPATCH = 1
_TID_SAMPLE = 2
_TID_KV = 3


def to_chrome_trace(records: List[IterationRecord],
                    pid: int = 0) -> Dict[str, Any]:
    """Render iteration records as Chrome-trace JSON (chrome://tracing /
    Perfetto "Open trace file"). Tracks: scheduler (queue counters),
    dispatch (one X slice per iteration), sample (emitted-token counter +
    anomaly instants), kv (tier occupancy counters). Every event carries
    the required ph/ts/pid/name keys; timestamps are wall-clock
    microseconds."""
    events: List[Dict[str, Any]] = [
        {"ph": "M", "ts": 0, "pid": pid, "name": "process_name",
         "args": {"name": "dynamo_tpu_torch engine"}},
    ]
    for tid, tname in ((_TID_SCHED, "scheduler"), (_TID_DISPATCH, "dispatch"),
                       (_TID_SAMPLE, "sample"), (_TID_KV, "kv tiers")):
        events.append({"ph": "M", "ts": 0, "pid": pid, "tid": tid,
                       "name": "thread_name", "args": {"name": tname}})
    for rec in records:
        ts_us = rec.ts * 1e6
        events.append({
            "ph": "X", "ts": ts_us, "dur": max(0.0, rec.wall_s) * 1e6,
            "pid": pid, "tid": _TID_DISPATCH, "name": rec.kind,
            "args": {
                "seq": rec.seq,
                "decode_seqs": rec.decode_seqs,
                "decode_steps": rec.decode_steps,
                "n_chunks": rec.n_chunks,
                "chunk_tokens": rec.chunk_tokens,
                "charged_tokens": rec.charged_tokens,
                "ragged": rec.ragged,
                "fused": rec.fused,
                "compile_variants": rec.compile_variants,
                "compile_calls": rec.compile_calls,
                "trace_ids": list(getattr(rec, "trace_ids", []) or []),
            },
        })
        events.append({
            "ph": "C", "ts": ts_us, "pid": pid, "tid": _TID_SCHED,
            "name": "queue",
            "args": {"waiting": rec.n_waiting, "running": rec.n_running},
        })
        events.append({
            "ph": "C", "ts": ts_us, "pid": pid, "tid": _TID_SAMPLE,
            "name": "scheduled_tokens",
            "args": {"tokens": rec.decode_seqs * rec.decode_steps
                     + rec.chunk_tokens},
        })
        events.append({
            "ph": "C", "ts": ts_us, "pid": pid, "tid": _TID_KV,
            "name": "kv",
            "args": {"g1_usage": rec.kv_usage, "g2_blocks": rec.g2_blocks,
                     "g3_blocks": rec.g3_blocks,
                     "prefetch_hits": rec.prefetch_hits},
        })
        if rec.anomaly:
            events.append({
                "ph": "i", "ts": ts_us, "pid": pid, "tid": _TID_SAMPLE,
                "name": "anomaly", "s": "p",
                "args": {"wall_s": rec.wall_s, "kind": rec.kind},
            })
    return {"traceEvents": events, "displayTimeUnit": "ms"}
