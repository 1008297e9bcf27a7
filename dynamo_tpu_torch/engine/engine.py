"""InferenceEngine: the serving engine as an async generator over requests.

Port of dynamo_tpu/engine/engine.py, reduced to the main path: requests
enter through `generate()` (PreprocessedRequest in, engine-output items
out), a dedicated step thread runs the scheduler/runner loop, and sampled
tokens flow back through per-request asyncio queues. A MixedPlan runs
fused on a card (the decode batch's steps and every packed prefill chunk
in one ragged dispatch plus the decode loop, one token readback) and
unfused on the CPU (decode first, then each chunk), with DYN_FUSED_MIXED
overriding, as in the reference. N-gram speculative decoding
(`spec_ngram`) verifies drafts on the same ragged dispatch: linear drafts
from the host scan (or the device history ring, `spec_device_draft`),
or trees of `spec_branches` candidates, each extra branch a row on a
forked page table. A runner with a draft
model (`ModelRunner(draft_config=...)`) decodes by speculative rounds
(engine/spec_decode.py: gamma draft steps, one target verify pass), keeps
the draft's KV in step with every prefill chunk and import, and runs its
mixed plans unfused.
Disaggregated roles: a "prefill" request parks its KV after the first
token and is pulled by the decode engine (device or host-staged export); a
"decode" request carrying `kv_import` is admitted with its KV and no
prefill. With `host_kv_blocks` evicted prefix pages go to the G2 host pool
and down to the G3 disk tier (`disk_kv_blocks`) and the G4 object tier
(`obj_kv_root`), optionally as the int8 tier codec's blocks
(`kv_tier_quantize`), and are onboarded back, layer group by layer group,
on a prefix hit (the host tier's blocks pinned up to HOST_PINNED_BLOCKS
and copied to the card whole, pageable pages through pinned staging). A
request carrying the router's `kv_remote_host` hint first pulls a peer's
lower-tier blocks into the local host tier (`remote_kv_fetch`, wired by
worker_common; a failed pull recomputes, and pulls stop once they
measure slower than the prefill), and `prefetch` promotes the blocks a
router's `kv_prefetch` hint names before the request arrives
(kvbm/prefetch.py).
Observability (runtime/): one `IterationRecord` a dispatched iteration
goes into the flight recorder (`recorder`, `recorder_size` 0 turns it
off; the anomaly trigger dumps and opens a profile window through
`profiler`, the step thread's StepProfiler); `annotate` ranges mark each
dispatch (engine.decode, engine.mixed, engine.prefill,
engine.spec_verify); a request's `traceparent` yields worker.request and
its queue / kv_onboard / prefill / stream spans at finish; and a
`sanitizer` (or DYN_SAN) guards the warm decode and spec-verify
dispatches with the sync guard, runs the shape tripwire after every
iteration and audits the page pool at stop.
Observers register on the step thread's hooks: `on_fpm` (one
ForwardPassMetrics per iteration, per half of an unfused mixed one),
`on_kv_event` (the device pool's and the host tier's store/remove events,
drained after each iteration) and `on_phases` (each finished request's
latency spine); the served worker publishes the first two on the event
plane.
The sampling extras are the reference's: guided decoding (a byte DFA
compiled per spec, single-flight, lifted to token masks; masks ride the
ragged step, the decode loop's device DFA tables when every schema fits
their budget, else the host `mask_fn` between the loop's steps), logit
bias, logprobs and penalties (rows with either of the last two take the
two-dispatch path, as the reference's `_mixed_fusible` gates them), n > 1
branches forked after the parent's prefill (trunk pages shared, the tail
page copied) and embeddings batched into one `embed` pass.
Multi-LoRA: a request's `adapter` names a slot of the runner's stacked
adapters (`lora_slots`), resolved at admission (an unknown name gets the
reference's "unknown LoRA adapter" error item); the slot rides every
dispatch the sequence takes (prefill, decode, the padded mixed fallback,
n-gram verify, draft-model verify, its n > 1 branches) and seeds its hash
chain, so its prefix cache never crosses adapters. `paused` refuses new
admissions (the rl endpoint's pause). `update_weights(path)` reloads a
params snapshot on the step thread, then flushes what the old weights
computed (`_flush_kv_state`): active sequences end with an error item,
parked and pending-import sequences are dropped, the pools, the prefix
cache and the lower tiers are emptied and the removals published; it
counts `weights_version`. A reload that fails after its first copy
leaves the served tree a mix of two weight sets: the engine flushes as
above and refuses every request (`weights_error`) until a reload
succeeds.
Not ported yet: multimodal input; requests carrying it are refused with
an "error" item, as are guided decoding and logit bias on a draft-model
worker (as in the reference: the speculative verify cannot honor them).
"""

from __future__ import annotations

import asyncio
import contextlib
import hashlib
import logging
import os
import queue as thread_queue
import json
import threading
import time
from dataclasses import dataclass
from typing import Any, AsyncIterator, Dict, List, Optional

import numpy as np
import torch

from dynamo_tpu_torch.engine.kv_pool import KvEvent, NoSpace, PagePool
from dynamo_tpu_torch.engine.model_runner import (
    BucketOverflowError,
    kv_arrays_to_payload,
    kv_payload_incompatible,
    kv_payload_to_arrays,
    kv_quant_arrays_to_payload,
)
from dynamo_tpu_torch.engine.ngram_draft import accept_deterministic, accept_tree
from dynamo_tpu_torch.engine.ngram_draft import propose as ngram_propose
from dynamo_tpu_torch.engine.ngram_draft import propose_tree as ngram_propose_tree
from dynamo_tpu_torch.engine.scheduler import (
    DecodePlan,
    MixedPlan,
    PrefillPlan,
    Scheduler,
    Sequence,
    SeqState,
)
from dynamo_tpu_torch.engine.weights import PartialReload
from dynamo_tpu_torch.frontend.tokenizer import load_tokenizer
from dynamo_tpu_torch.guided import compile_regex, compile_structural
from dynamo_tpu_torch.guided.device_table import build_device_table
from dynamo_tpu_torch.guided.token_mask import TokenLifter
from dynamo_tpu_torch.kvbm.disk_pool import DiskKvPool, TieredKv
from dynamo_tpu_torch.kvbm.host_pool import HostKvPool
from dynamo_tpu_torch.kvbm.object_store import FsBackend, ObjectKvPool
from dynamo_tpu_torch.kvbm.prefetch import PrefetchManager
from dynamo_tpu_torch.kvbm.quant import is_quantized_block
from dynamo_tpu_torch.ops.ragged_paged_attention import RAGGED_MAX_SEGS
from dynamo_tpu_torch.runtime import tracing
from dynamo_tpu_torch.runtime.annotations import StepProfiler, annotate
from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.runtime.flight_recorder import FlightRecorder, IterationRecord
from dynamo_tpu_torch.runtime.sanitizer import Sanitizer, device_gate, env_enabled

log = logging.getLogger("dynamo_tpu_torch.engine")

# per-request ITL sample cap: bounds the spine's memory on long generations
_ITL_CAP = 512

# request fields of features this port does not serve yet: refused up
# front rather than silently ignored
_UNSUPPORTED_FIELDS = ("mm",)

# lower tiers by depth, and their labels on a sequence's onboard_tier
_TIER_ORDER = {"host": 0, "disk": 1, "obj": 2}
_TIER_LABEL = {"host": "G2", "disk": "G3", "obj": "G4"}

# a remote-G2 pull: its time limit, and how long a peer that failed one
# is skipped (the request recomputes instead)
REMOTE_PULL_TIMEOUT_S = 5.0
REMOTE_PULL_BACKOFF_S = 30.0

# at most this many offloaded pages' host blocks are pinned at a time (the
# 3B's: 3.8 GB), as many as the host tier holds pinned when it is built;
# the blocks offloaded past it are pageable
HOST_PINNED_BLOCKS = 2048

_NULL = contextlib.nullcontext()

# cached on a matcher whose schema exceeded the device table budget, so
# the build (and its warning) happens once per matcher
_OVER_BUDGET = object()


@dataclass
class ForwardPassMetrics:
    """Per-iteration engine metrics published for the planner (the
    reference's FPM). The load fields are read when the plan is made."""

    ts: float
    kind: str  # "prefill" | "decode" | "mixed"
    wall_time_s: float
    scheduled_tokens: int
    n_running: int
    n_waiting: int
    kv_usage: float


def engine_output(token_ids: List[int], finish_reason: Optional[str] = None,
                  **extra: Any) -> Dict[str, Any]:
    """One stream item (the reference frontend/protocols.py wire form)."""
    out: Dict[str, Any] = {"token_ids": token_ids, "finish_reason": finish_reason}
    out.update(extra)
    return out


def _unsupported(request: Dict[str, Any]) -> Optional[str]:
    for name in _UNSUPPORTED_FIELDS:
        if request.get(name):
            return name
    annotations = request.get("annotations") or {}
    if annotations.get("disagg") not in (None, "prefill", "decode"):
        return "annotations"
    return None


class GuidedMaskContext:
    """Per-dispatch host state that advances guided DFAs between the
    steps of a fused decode loop: the runner calls `ctx(t, prev_tokens)`
    once per step; it advances a copy of each guided row's DFA state by
    the token that row sampled at step t-1 and returns the [B, V] mask of
    step t. The engine's per-emitted-token `_guided_advance` stays
    authoritative. `pending_advance=True` (the ragged tail: the fed tokens
    were sampled on the device by the ragged step) advances at t = 0
    too. A row whose copy hits EOS or desyncs goes all-allowed for the
    remaining steps; the engine discards tokens past a finish anyway."""

    def __init__(self, B: int, vocab: int, rows, pending_advance: bool = False):
        self.B = int(B)
        self.vocab = int(vocab)
        # row: [batch index, matcher, state copy, alive]
        self.rows = [[int(i), m, int(s), True] for i, m, s in rows]
        self.pending_advance = bool(pending_advance)

    def _row_mask(self, m, state) -> np.ndarray:
        row = m.allowed(state)
        if not row.any():
            # degrade as _guided_mask does: force EOS rather than sample
            # garbage from an unextendable constraint
            row = row.copy()
            eos = m.lifter.eos_id
            if 0 <= eos < row.shape[0]:
                row[eos] = True
        return row

    def __call__(self, t, prev_tokens) -> np.ndarray:
        t = int(t)
        mask = np.ones((self.B, self.vocab), bool)
        for row in self.rows:
            idx, m, state, alive = row
            if not alive:
                continue
            if t > 0 or self.pending_advance:
                tok = int(prev_tokens[idx])
                if tok == m.lifter.eos_id:
                    row[3] = False
                    continue
                try:
                    row[2] = state = m.advance(state, tok)
                except ValueError:
                    # desync: a padding row fed a masked-out token, or the
                    # engine already finished the request
                    row[3] = False
                    continue
            mask[idx] = self._row_mask(m, state)[:self.vocab]
        return mask


class InferenceEngine:
    IDLE_SLEEP_S = 0.002

    def __init__(
        self,
        runner,
        *,
        max_batch: int = 64,
        chunk_size: int = 512,
        decode_steps: int = 4,  # fused decode iterations per plan
        mixed_prefill_tokens: int = 256,  # per-iteration prefill token POOL
        #   while decode runs, fair-shared across packed chunks (0 = strict
        #   prefill-first alternation)
        mixed_prefill_seqs: int = 8,  # max distinct prefills packed
        mixed_min_chunk: int = 16,  # fair-share floor per packed sequence
        spec_ngram: bool = False,  # n-gram speculative decoding: drafts
        #   from each sequence's own history, verified as K+1-token rows
        #   of the ragged dispatch
        spec_k: int = 4,  # draft tokens proposed per sequence per step
        spec_max_tokens: int = 0,  # per-iteration cap on drafted tokens
        #   (0 = bounded only by the mixed pool leftover)
        spec_branches: int = 1,  # tree speculation: candidate drafts a
        #   sequence, each extra one verified on a forked page table
        #   (1 = linear)
        spec_device_draft: bool = False,  # linear drafts from the runner's
        #   device history ring instead of the host scan (off: on the card
        #   the ring's step and readback cost more host time than the scan
        #   of histories that match early; scripts/draft_ring_ab.py)
        host_kv_blocks: int = 0,  # G2 host-tier capacity (0 = disabled)
        disk_kv_blocks: int = 0,  # G3 disk-tier capacity (needs G2)
        disk_kv_root: Optional[str] = None,  # G3 directory (None: a temp dir)
        obj_kv_root: Optional[str] = None,  # G4 object store (a directory,
        #   FsBackend; needs G2)
        kv_tier_quantize: bool = False,  # store demoted G2/G3/G4 blocks as
        #   int8 + per-(token, head) scales (kvbm/quant.py); promotion
        #   dequantizes, or passes through when the pools are int8
        onboard_layer_groups: int = 1,  # stream tier onboarding in this
        #   many contiguous layer groups (FlowKV-style overlap of transfer
        #   with the first layers' compute; 1 = whole-sequence import)
        prefetch: bool = False,  # router-hinted tier promotion ahead of
        #   the request (kvbm/prefetch.py; needs host_kv_blocks > 0)
        prefetch_max_inflight: int = 4,  # concurrent G3/G4 -> G2 reads
        prefetch_bandwidth_mbps: float = 0.0,  # promoted bytes/s (0 = off)
        prefetch_hint_ttl_s: float = 10.0,  # an unserved hint's lifetime
        prefetch_pin_ttl_s: float = 5.0,  # a promoted block's pin lifetime
        tokenizer_spec: str = "byte",  # guided decoding lifts byte DFAs to
        #   token masks against this tokenizer (the frontend's)
        recorder_size: int = 4096,  # flight-recorder ring (0 = off)
        anomaly_k: float = 4.0,  # an iteration over EWMA * k fires a dump
        anomaly_dump_dir: Optional[str] = None,  # None: count, don't dump
        anomaly_dump_last_n: int = 256,  # records a dump writes
        anomaly_profile_ms: int = 0,  # torch.profiler window a dump (0 = off)
        sanitize: Optional[bool] = None,  # the runtime sanitizer (None:
        #   DYN_SAN decides)
        sanitizer: Optional[Sanitizer] = None,  # a prebuilt one (tests)
    ):
        self.runner = runner
        # fused mixed dispatch: on for a card, off for the CPU (the
        # reference fuses wherever the platform is not cpu);
        # DYN_FUSED_MIXED=0/1 overrides for A/Bs
        flag = os.environ.get("DYN_FUSED_MIXED", "").lower()
        if flag in ("1", "true", "on", "yes"):
            self.fused_mixed = True
        elif flag in ("0", "false", "off", "no"):
            self.fused_mixed = False
        else:
            self.fused_mixed = runner.device.type != "cpu"
        # a draft-model runner: speculative decode rounds
        self.has_draft = runner.has_draft
        if self.has_draft:
            # the draft's KV must follow every prefill chunk, which the
            # fused dispatch does not write (the reference's gate)
            self.fused_mixed = False
        self.pool = PagePool(runner.num_pages, runner.page_size)
        # fork-on-branch copies a forked tail page's KV through the runner
        self.pool.copy_hook = runner.copy_pages
        self.onboard_layer_groups = max(1, int(onboard_layer_groups))
        self.kv_tier_quantize = bool(kv_tier_quantize)
        self.host_pool: Optional[TieredKv] = None
        # cross-worker onboarding: worker_common sets an async
        # callable(hint) -> payload that pulls a peer's lower-tier blocks
        # through its kv_host_fetch endpoint (None: off)
        self.remote_kv_fetch = None
        self._remote_fetch_backoff: Dict[int, float] = {}  # peer -> until
        # per-tier EWMA of measured onboard seconds a block (the deepest
        # tier of each chain, and the remote leg)
        self.kv_onboard_ewma: Dict[str, Dict[str, float]] = {}
        # step-thread observers, and the host tier's KV events waiting for
        # the next drain
        self._fpm_listeners: List[Any] = []
        self._kv_listeners: List[Any] = []
        self._phase_listeners: List[Any] = []
        self._host_events: List[KvEvent] = []
        self._plan_load = (0, 0, 0.0)  # (n_running, n_waiting, kv_usage)
        if (disk_kv_blocks > 0 or obj_kv_root) and host_kv_blocks <= 0:
            log.warning("disk/object KV tiers ignored: they spill from the G2 "
                        "host tier; also set host_kv_blocks > 0")
        if host_kv_blocks > 0:
            host = HostKvPool(capacity_blocks=host_kv_blocks,
                              quantize=self.kv_tier_quantize)
            disk = None
            if disk_kv_blocks > 0:
                import tempfile

                disk = DiskKvPool(
                    disk_kv_root or tempfile.mkdtemp(prefix="dyn_kv_g3_"),
                    capacity_blocks=disk_kv_blocks,
                    quantize=self.kv_tier_quantize)
            obj = None
            if obj_kv_root:
                obj = ObjectKvPool(FsBackend(obj_kv_root),
                                   quantize=self.kv_tier_quantize)
                # the router's G4 index hears of each stored block (from
                # the writer or spill thread, through the inbox)
                obj.store_listener = self._on_obj_stored
            self.host_pool = TieredKv(host, disk, obj)
            # an alloc's evicted pages are offloaded as one batch, before
            # the alloc returns them (nothing writes them earlier)
            self.pool.evict_hook = self._offload_page
            self.pool.evict_flush = self._flush_offloads
            self.host_pool.on_evict(self._on_host_evicted)
            # pinned memory for the blocks the host tier fills up with, and
            # the card's side of the largest onboard
            stage = min(runner.max_pages_per_seq, runner.num_pages)
            runner.reserve_host_memory(stage, min(HOST_PINNED_BLOCKS, host_kv_blocks),
                                       HOST_PINNED_BLOCKS, quantize=self.kv_tier_quantize)
        # onboards served at admission: calls, blocks and seconds (get_s:
        # the tier reads, import_s: the enqueued copies and scatters)
        self.onboard_stats = {"onboards": 0, "blocks": 0, "seconds": 0.0,
                              "get_s": 0.0, "import_s": 0.0}
        # device pages offloaded to the host tier, in batches of one alloc's
        # evictions (pending until the alloc flushes them)
        self._offload_pending: List[tuple] = []
        self.offload_stats = {"offloads": 0, "batches": 0, "seconds": 0.0}
        # the lower tiers' recomputes and remote pulls (cost skips: pulls
        # not made because they measured slower than the prefill)
        self.tier_stats = {"onboard_misses": 0, "remote_pulls": 0,
                           "remote_blocks": 0, "remote_failures": 0,
                           "remote_backoff_skips": 0, "remote_cost_skips": 0}
        # prefill seconds a scheduled token, an EWMA over the prefill and
        # mixed steps: the recompute a remote pull is weighed against
        self._prefill_s_per_token: Optional[float] = None
        self.prefetch: Optional[PrefetchManager] = None
        if prefetch and self.host_pool is not None:
            self.prefetch = PrefetchManager(
                self, max_inflight=prefetch_max_inflight,
                bandwidth_mbps=prefetch_bandwidth_mbps,
                hint_ttl_s=prefetch_hint_ttl_s, pin_ttl_s=prefetch_pin_ttl_s)
        elif prefetch:
            log.warning("prefetch requested without a host KV tier "
                        "(host_kv_blocks=0); disabled")
        self.scheduler = Scheduler(
            self.pool,
            max_batch=max_batch,
            chunk_size=chunk_size,
            max_seq_pages=runner.max_pages_per_seq,
            max_seq_tokens=runner.config.max_seq_len,
            decode_steps=decode_steps,
            mixed_prefill_tokens=mixed_prefill_tokens,
            mixed_prefill_seqs=mixed_prefill_seqs,
            mixed_min_chunk=mixed_min_chunk,
            spec_max_tokens=spec_max_tokens,
            # one ragged dispatch samples at most RAGGED_MAX_SEGS rows:
            # budgeting verify tokens to it keeps every verify dispatch
            # inside the gather the registered bucket has
            spec_seg_budget=RAGGED_MAX_SEGS,
            host_tier=self.host_pool,
            host_onboard=(self._onboard_from_host
                          if self.host_pool is not None else None),
        )
        self.spec_k = max(1, int(spec_k))
        # drafts ride the mixed pool's leftover: no pool, no speculation
        self.spec_ngram = bool(spec_ngram) and mixed_prefill_tokens > 0
        if spec_ngram and not self.spec_ngram:
            log.warning("spec_ngram requested with mixed_prefill_tokens=0; "
                        "disabled")
        # tree speculation keeps the host scan (its branches need every
        # match site, the ring gathers one)
        self.spec_branches = max(1, int(spec_branches))
        self._spec_device_draft = bool(spec_device_draft) and self.spec_branches == 1
        self._draft_slots: Dict[str, int] = {}  # rid -> history-ring slot
        self._draft_free: List[int] = []
        self._draft_synced: Dict[str, int] = {}  # rid -> tokens mirrored
        self._draft_D = 0  # the ring's per-step append capacity
        if self.spec_ngram and self._spec_device_draft:
            self._draft_D = runner.ensure_draft_ring(max_batch, self.spec_k)
            self._draft_free = list(range(max_batch))
        self._draft_fallback_warned = False
        self.spec_stats = {"drafted": 0, "accepted": 0, "rejected": 0,
                           "verify_rows": 0, "verify_iters": 0,
                           "spec_emitted": 0, "tree_rows": 0,
                           "tree_switches": 0}
        # the scheduler caps a mixed plan at max_batch decode rows +
        # mixed_prefill_tokens chunk tokens: that sum is a T bucket, so a
        # full mixed iteration never rounds up
        runner.ensure_ragged_bucket(mixed_prefill_tokens + max_batch)
        self._inbox: thread_queue.Queue = thread_queue.Queue()
        self._streams: Dict[str, tuple[asyncio.Queue, asyncio.AbstractEventLoop]] = {}
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._step_counter = 0
        # disaggregation state
        self._parked: Dict[str, tuple] = {}  # rid -> (Sequence, deadline)
        self._kv_pending: List[Sequence] = []  # disagg-decode awaiting space
        self.parked_ttl_s = 60.0
        self._embed_pending: List[tuple] = []  # (tokens, future, loop)
        # guided decoding: the tokenizer-lifted constraint compile cache
        self.tokenizer_spec = tokenizer_spec
        self._guided_lifter = None
        self._guided_cache: Dict[str, Any] = {}
        self._guided_lock = threading.Lock()
        self._lifter_lock = threading.Lock()  # the one TokenLifter build
        # the rl endpoint's admission gate (worker_common): a paused engine
        # refuses new requests, the admitted ones run on; weights_version
        # counts the reloads that succeeded
        self.paused = False
        self.weights_version = 0
        # set while a failed reload has left the weights a mix of old and
        # new leaves: every request is refused with it until one succeeds
        self.weights_error: Optional[str] = None
        # the flight recorder, and the profile windows the step thread
        # opens for it and for the worker's /profile route
        self.profiler = StepProfiler()
        self.recorder = FlightRecorder(
            recorder_size, anomaly_k=anomaly_k, anomaly_dump_dir=anomaly_dump_dir,
            anomaly_dump_last_n=anomaly_dump_last_n,
            anomaly_profile_ms=anomaly_profile_ms)
        self.recorder.profile_fn = self.profiler.request
        self.iterations = 0  # dispatched iterations (one record each)
        if sanitizer is None and (sanitize or (sanitize is None and env_enabled())):
            sanitizer = Sanitizer()
        self.sanitizer = sanitizer
        if sanitizer is not None:
            self._guided_lock = sanitizer.wrap_lock(self._guided_lock,
                                                    "engine.guided_cache")
            self._lifter_lock = sanitizer.wrap_lock(self._lifter_lock, "engine.lifter")
            runner.attach_sanitizer(sanitizer)

    def start(self) -> None:
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="engine-step", daemon=True)
            self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None
        if self.prefetch is not None:
            self.prefetch.stop()
        self.profiler.close()
        if self.sanitizer is not None:
            self.sanitizer.disarm()
            live = (len(self.scheduler.active) + len(self.scheduler.waiting)
                    + len(self._kv_pending))
            self.sanitizer.audit_pool(self.pool, live_seqs=live)

    def _san_scope(self, where: str):
        """The sync guard's scope for a steady-state dispatch (a shared
        nullcontext without a sanitizer)."""
        san = self.sanitizer
        return _NULL if san is None else san.transfer_scope(where)

    async def update_weights(self, path: str) -> int:
        """Swap the served weights for the params snapshot at `path` on the
        step thread (between dispatches), then flush the KV state the old
        weights computed; returns the new weights_version. Pause first for
        a clean cut: sequences still running end with an error item."""
        self.start()
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()
        self._inbox.put(("reload_weights", (path, fut, loop)))
        return await fut

    def _reload_weights(self, path: str) -> int:
        try:
            self.runner.reload_params(path)
        except PartialReload as e:
            self.weights_error = (f"weights incomplete after a failed reload ({e}); "
                                  "serving resumes when a reload succeeds")
            self._flush_kv_state("weights updated mid-flight; retry")
            raise
        self.weights_error = None
        # all cached KV was computed under the old weights: serving it
        # against the new ones would mix the two
        self._flush_kv_state("weights updated mid-flight; retry")
        self.weights_version += 1
        return self.weights_version

    def _flush_kv_state(self, error_message: str) -> None:
        """End every active sequence with an error item, release parked
        entries, drop pending disaggregated imports (their KV bytes are the
        old weights'), zero the pools and forget the prefix cache, empty the
        lower tiers and publish the removals."""
        for seq in list(self.scheduler.active):
            try:
                self._emit(seq, [], "error", error=error_message)
                self.scheduler.abort(seq.request_id)
            except Exception:
                log.exception("failed to fail sequence %s", seq.request_id)
        for rid, (seq, _) in list(self._parked.items()):
            self._parked.pop(rid, None)
            self.scheduler.release_parked(seq)
        pending, self._kv_pending = self._kv_pending, []
        for seq in pending:
            self._emit(seq, [], "error", error=error_message)
        self.runner.reset_kv_pools()
        self.pool.reset()
        if self.host_pool is not None:
            self.host_pool.clear()
        self._publish_kv_events()

    def on_fpm(self, cb) -> None:
        """cb(ForwardPassMetrics) from the step thread."""
        self._fpm_listeners.append(cb)

    def on_kv_event(self, cb) -> None:
        """cb(List[KvEvent]) from the step thread."""
        self._kv_listeners.append(cb)

    def on_phases(self, cb) -> None:
        """cb(phases: Dict[str, float]) from the step thread, once per
        finished request."""
        self._phase_listeners.append(cb)

    # -- guided decoding ---------------------------------------------------
    def _compile_guided(self, spec: Dict[str, Any]):
        """Wire spec -> GuidedMatcher, cached per spec (32 entries). Runs in
        an executor. The lock guards only the lookups and the insert: the
        DFA compile and the per-vocab lift happen outside it, so one slow
        schema never serializes other guided requests; a racing build of
        the same spec keeps the first matcher inserted."""
        key = json.dumps(spec, sort_keys=True)
        with self._guided_lock:
            hit = self._guided_cache.get(key)
            if hit is not None:
                return hit
        kind = spec.get("kind")
        if kind == "regex":
            dfa = compile_regex(spec["pattern"])
        elif kind == "structural":
            dfa = compile_structural(spec)
        else:
            raise ValueError(f"unknown guided kind {kind!r}")
        matcher = self._get_lifter().lift(dfa)
        with self._guided_lock:
            hit = self._guided_cache.get(key)
            if hit is not None:
                return hit  # a racer inserted first; equivalent matcher
            while len(self._guided_cache) >= 32:
                self._guided_cache.pop(next(iter(self._guided_cache)))
            self._guided_cache[key] = matcher
            return matcher

    def _get_lifter(self):
        lifter = self._guided_lifter
        if lifter is not None:
            return lifter
        with self._lifter_lock:
            if self._guided_lifter is None:
                self._guided_lifter = TokenLifter.for_tokenizer(
                    load_tokenizer(self.tokenizer_spec),
                    self.runner.config.vocab_size)
            return self._guided_lifter

    def _guided_mask(self, seq: Sequence) -> Optional[np.ndarray]:
        """The sampling mask of a constrained sequence. An all-False row
        (no token of this vocabulary extends the constraint) degrades to
        force-EOS so the sequence stops instead of emitting garbage."""
        m = seq.guided_m
        if m is None:
            return None
        mask = m.allowed(seq.guided_s)
        if not mask.any():
            log.warning("request %s: no token can extend the constraint from "
                        "state %d; forcing EOS", seq.request_id, seq.guided_s)
            if 0 <= m.lifter.eos_id < len(mask):
                mask = mask.copy()
                mask[m.lifter.eos_id] = True
        return mask

    def _guided_device_plan(self, seqs: List[Sequence]):
        """The device guided plan of a fused multi-step dispatch: (tables,
        row entries, pending) for the runner's `_guided_op`, or None when
        any constrained row's schema is over the device table budget (the
        whole batch then keeps the host mask_fn). Tables build once per
        matcher and stay cached on it."""
        tables: List[Any] = []
        index: Dict[int, int] = {}
        rows: List[Any] = [None] * len(seqs)
        for i, s in enumerate(seqs):
            m = s.guided_m
            if m is None:
                continue
            tab = getattr(m, "_device_table", None)
            if tab is None:
                tab = build_device_table(m)
                if tab is None:
                    tab = _OVER_BUDGET
                    log.warning("guided schema exceeds the device DFA table "
                                "budget (DYN_GUIDED_DEVICE_MAX_ELEMS); batches "
                                "containing it keep the host mask callback")
                m._device_table = tab  # the matcher's lifetime
            if tab is _OVER_BUDGET:
                return None
            ti = index.get(tab.uid)
            if ti is None:
                ti = len(tables)
                index[tab.uid] = ti
                tables.append(tab)
            rows[i] = (ti, int(s.guided_s))
        if not tables:
            return None
        return (tables, rows, False)

    def _guided_step_masks(self, seqs: List[Sequence], T: int,
                           pending: bool = False) -> Dict[str, Any]:
        """The runner keywords of a T-step dispatch over `seqs` with
        guided rows: the rows' current masks [n, V] (step 0), and for
        the later steps the device plan, else the host callback."""
        rows = [i for i, s in enumerate(seqs) if s.guided_m is not None]
        if not rows:
            return {}
        vocab = seqs[rows[0]].guided_m.lifter.vocab_size
        masks = np.ones((len(seqs), vocab), bool)
        for i in rows:
            masks[i] = self._guided_mask(seqs[i])
        kw: Dict[str, Any] = {"masks": masks}
        if T > 1:
            gdev = self._guided_device_plan(seqs)
            if gdev is not None:
                kw["guided_dev"] = gdev
            else:
                kw["mask_fn"] = GuidedMaskContext(
                    len(seqs), vocab,
                    [(i, seqs[i].guided_m, seqs[i].guided_s) for i in rows],
                    pending_advance=pending)
        return kw

    def _guided_advance(self, seq: Sequence, token: int) -> None:
        """Advance a sequence's DFA past an accepted token. A desync
        (impossible while masks are honored) drops the constraint and
        logs rather than failing the batch."""
        m = seq.guided_m
        if m is None or token == m.lifter.eos_id:
            return
        try:
            seq.guided_s = m.advance(seq.guided_s, int(token))
        except ValueError as e:
            log.error("request %s: %s; constraint dropped", seq.request_id, e)
            seq.guided_m = None

    # -- AsyncEngine protocol ----------------------------------------------
    async def generate(self, request: Dict[str, Any], context: Context) -> AsyncIterator[Any]:
        self.start()
        loop = asyncio.get_running_loop()
        out: asyncio.Queue = asyncio.Queue()
        rid = context.id
        if self.paused:
            yield engine_output([], "error",
                                error="worker paused (weight update in progress)")
            return
        if self.weights_error is not None:
            yield engine_output([], "error", error=self.weights_error)
            return
        bad = _unsupported(request)
        if bad is not None:
            yield engine_output([], "error",
                                error=f"{bad} is not supported by this worker yet")
            return
        annotations = request.get("annotations") or {}
        if annotations.get("kind") == "embedding":
            fut: asyncio.Future = loop.create_future()
            self._inbox.put(("embed", (
                [int(t) for t in request.get("token_ids") or [0]], fut, loop)))
            vec = await fut
            yield {"embedding": vec, "finish_reason": "stop", "token_ids": []}
            return
        seq = Sequence(
            request_id=rid,
            prompt=[int(t) for t in request.get("token_ids") or [0]],
            sampling=request.get("sampling") or {},
            stop=request.get("stop") or {},
            arrival=time.monotonic(),
            disagg=annotations.get("disagg"),
            kv_import=request.get("kv_import"),
            adapter=request.get("adapter") or None,
            guided=request.get("guided"),
            logit_bias=request.get("logit_bias"),
        )
        if seq.adapter:
            try:
                seq.adapter_idx = self.runner.adapter_slot(seq.adapter)
            except KeyError:
                yield engine_output([], "error",
                                    error=f"unknown LoRA adapter {seq.adapter!r}")
                return
        # latency spine: upstream hops (the disagg adapter's KV fetch)
        # stamped their durations into ctx.metadata["phases"]
        upstream = context.metadata.get("phases")
        if isinstance(upstream, dict):
            seq.phases.update({k: float(v) for k, v in upstream.items()
                               if isinstance(v, (int, float))})
        # the hop this request arrived under: the worker's spans are
        # rebuilt under it from the spine at finish
        tp = context.metadata.get("traceparent")
        if isinstance(tp, str):
            seq.tp = tp
        # n > 1: fork after prefill (the trunk KV shared copy-on-write, so
        # n choices cost one prefill); disaggregated roles stream one
        if seq.disagg is None:
            seq.n_branches = max(1, min(16, int(seq.sampling.get("n") or 1)))
        if seq.logit_bias and (self.has_draft or not getattr(
                self.runner, "supports_logit_bias", False)):
            # a dropped ban is a safety bug: refuse rather than sample the
            # unbiased distribution (the speculative verify has no bias)
            yield engine_output([], "error",
                                error="logit_bias is unsupported on this worker")
            return
        if seq.guided and self.has_draft:
            # the speculative verify cannot honor per-token masks
            yield engine_output([], "error", error=(
                "guided decoding is unsupported on a speculative-decoding worker"))
            return
        if seq.guided:
            try:
                seq.guided_m = await loop.run_in_executor(
                    None, self._compile_guided, seq.guided)
                seq.guided_s = seq.guided_m.start
                # a disaggregated decode continuation: the prefill worker
                # generated the prompt's last N tokens under this
                # constraint; replay them through this DFA copy
                n_adv = int(request.get("guided_advanced") or 0)
                for t in seq.prompt[len(seq.prompt) - n_adv:] if n_adv else []:
                    seq.guided_s = seq.guided_m.advance(seq.guided_s, int(t))
            except Exception as e:
                yield engine_output([], "error",
                                    error=f"guided decoding spec rejected: {e}")
                return
        # reject prompts that can NEVER be admitted (more pages than the
        # pool/per-seq cap): they would wait forever and block the queue
        PS = self.pool.page_size
        cap_tokens = min(self.scheduler.max_seq_pages, self.pool.num_pages) * PS
        if self.scheduler.max_seq_tokens:
            cap_tokens = min(cap_tokens, self.scheduler.max_seq_tokens)
        if len(seq.prompt) + 1 > cap_tokens:
            yield engine_output([], "error", error=(
                f"prompt of {len(seq.prompt)} tokens exceeds this worker's "
                f"KV capacity ({cap_tokens - 1} tokens)"))
            return
        remote = request.get("kv_remote_host")
        if remote and self.host_pool is not None and self.remote_kv_fetch is not None:
            # pull the peer's lower-tier blocks into the local host tier
            # before admission; the inbox is FIFO, so the import lands
            # before the scheduler sees the request
            await self._pull_remote_host(remote)
        self._streams[rid] = (out, loop)
        if seq.disagg == "decode" and seq.kv_import is not None:
            self._inbox.put(("add_kv", seq))
        else:
            self._inbox.put(("add", seq))
        finished = False
        n_done = 0
        try:
            while True:
                if context.is_stopped:
                    return
                get = asyncio.create_task(out.get())
                stop_wait = asyncio.create_task(context.wait_stopped())
                done, pending = await asyncio.wait(
                    {get, stop_wait}, return_when=asyncio.FIRST_COMPLETED)
                for t in pending:
                    t.cancel()
                if get not in done:
                    return
                item = get.result()
                yield item
                if item.get("finish_reason"):
                    # a branched request streams one finish per choice and
                    # ends when every branch has finished
                    n_done += 1
                    if n_done >= seq.n_branches:
                        finished = True
                        return
        finally:
            # runs on normal end, cancel, AND consumer break/close
            self._streams.pop(rid, None)
            if not finished:
                self._inbox.put(("abort", rid))

    # -- step loop (dedicated thread) --------------------------------------
    def _loop(self) -> None:
        device = getattr(self.runner, "device", None)
        if device is not None and device.type == "cuda":
            # launches from this thread go to this device's current stream
            torch.cuda.set_device(device)
        log.info("engine step loop started")
        while not self._stop.is_set():
            self._loop_once()
        log.info("engine step loop stopped")

    def _drain_inbox(self) -> None:
        while True:
            try:
                op, arg = self._inbox.get_nowait()
            except thread_queue.Empty:
                break
            if op in ("add", "add_kv") and self.weights_error is not None:
                # queued before a reload failed mid-copy
                self._emit(arg, [], "error", error=self.weights_error)
            elif op == "add":
                self.scheduler.add(arg)
            elif op == "abort":
                self.scheduler.abort(arg)
                # forked branches live under derived ids: an abort of the
                # parent's stream tears them down too
                for bid in [s.request_id for s in list(self.scheduler.active)
                            + list(self.scheduler.waiting) if s.branch_of == arg]:
                    self.scheduler.abort(bid)
                parked = self._parked.pop(arg, None)
                if parked is not None:
                    self.scheduler.release_parked(parked[0])
                self._kv_pending = [s for s in self._kv_pending
                                    if s.request_id != arg]
            elif op == "add_kv":
                self._kv_pending.append(arg)
            elif op == "export":
                rid, discard, fut, loop = arg
                self._reply(fut, loop, self._export_parked, rid, discard)
            elif op == "export_meta":
                rid, fut, loop = arg
                self._reply(fut, loop, self._export_meta, rid)
            elif op == "export_chunk":
                rid, start, n, last, fut, loop = arg
                self._reply(fut, loop, self._export_chunk, rid, start, n, last)
            elif op == "export_device":
                rid, fut, loop = arg
                self._reply(fut, loop, self._export_parked_device, rid)
            elif op == "embed":
                if self.weights_error is not None:
                    _, fut, loop = arg
                    loop.call_soon_threadsafe(_set_future_exc, fut,
                                              RuntimeError(self.weights_error))
                else:
                    self._embed_pending.append(arg)
            elif op == "call":
                fn, args, fut, loop = arg
                self._reply(fut, loop, fn, *args)
            elif op == "host_export":
                hashes, fut, loop = arg
                self._reply(fut, loop, self._host_export, hashes)
            elif op == "host_import":
                self._host_import(*arg)
            elif op == "prefetch":
                if self.prefetch is not None:
                    self.prefetch.on_hint(arg)
            elif op == "prefetch_disk":
                if self.prefetch is not None:
                    self.prefetch.on_disk_read(*arg)
            elif op == "prefetch_obj":
                if self.prefetch is not None:
                    self.prefetch.on_obj_read(*arg)
            elif op == "obj_event":
                h, parent = arg
                self._host_events.append(KvEvent("store", [h], parent, tier="obj"))
            elif op == "reload_weights":
                path, fut, loop = arg
                self._reply(fut, loop, self._reload_weights, path)
        self._admit_kv_pending()
        self._expire_parked()
        self._run_embeds()
        if self.prefetch is not None:
            self.prefetch.tick()

    def _run_embeds(self) -> None:
        """Every pending embedding request in one encoder pass."""
        if not self._embed_pending:
            return
        batch, self._embed_pending = self._embed_pending, []
        try:
            vecs = self.runner.embed([t for t, _, _ in batch])
        except Exception as e:
            log.exception("embed batch failed")
            for _, fut, loop in batch:
                loop.call_soon_threadsafe(_set_future_exc, fut, e)
            return
        for i, (_, fut, loop) in enumerate(batch):
            loop.call_soon_threadsafe(_set_future, fut, vecs[i].tolist())

    def _reply(self, fut, loop, fn, *args) -> None:
        """Run an op on the step thread (the only thread that touches this
        runner's pools and adapters) and resolve the caller's future with
        its result, or with its exception."""
        try:
            value = fn(*args)
        except Exception as e:
            log.exception("step-thread op %s failed", getattr(fn, "__name__", fn))
            loop.call_soon_threadsafe(_set_future_exc, fut, e)
            return
        loop.call_soon_threadsafe(_set_future, fut, value)

    def _loop_once(self) -> None:
        # an armed sync guard is process-wide: device work of every step
        # thread takes the gate, one iteration at a time (and the idle
        # sleep outside it); a requested profiler window opens or closes
        # at the iteration's edge
        with device_gate():
            self.profiler.tick()
            idle = self._step_once()
        if idle:
            time.sleep(self.IDLE_SLEEP_S)

    def _step_once(self) -> bool:
        """One iteration: drain the inbox, plan, dispatch, publish and
        record. Returns True when there is nothing to do (the caller
        sleeps)."""
        self._drain_inbox()
        self._propose_drafts()
        plan = self.scheduler.step_plan()
        if plan is None:
            return not self.scheduler.has_work()
        sch = self.scheduler
        self._plan_load = (
            sum(1 for s in sch.active if s.state == SeqState.RUNNING),
            len(sch.waiting), self.pool.usage())
        t0 = time.monotonic()
        t_start, ts_wall = t0, time.time()
        rst = self.runner.stats
        ragged0 = rst["ragged_mixed_dispatches"] + rst["ragged_verify_dispatches"]
        # the iteration's composition for its flight record; each branch
        # fills in what it served
        rinfo = {"decode_seqs": 0, "decode_steps": 0, "n_chunks": 0,
                 "chunk_tokens": 0, "fused": False,
                 "spec_rows": 0, "spec_emitted": 0}
        dseqs = (plan.decode.seqs if isinstance(plan, MixedPlan)
                 else [] if isinstance(plan, PrefillPlan) else plan.seqs)
        rinfo["guided_rows"] = sum(1 for s in dseqs if s.guided_m is not None)
        decode_done = False
        try:
            if isinstance(plan, PrefillPlan):
                with annotate("engine.prefill"):
                    self._run_prefill_inner(plan)
                kind, n_tok = "prefill", len(plan.chunk)
                rinfo.update(n_chunks=1, chunk_tokens=len(plan.chunk))
            elif isinstance(plan, MixedPlan):
                fused = self._mixed_fusible(plan)
                # the decode half: verify rows (with the chunks when fused),
                # else the fused dispatch, else plain decode first, so ITL
                # never waits behind prompt processing. A verify that
                # returns None shed its drafts (bucket overflow).
                chunk_logits = None
                drafted = sum(len(s.spec_draft) for s in dseqs)
                if drafted:
                    chunk_logits = self._run_spec_verify(
                        plan.decode, plan.prefills if fused else [], rinfo)
                steps = 1
                if chunk_logits is None:
                    drafted, steps = 0, plan.decode.n_steps
                    if fused:
                        chunk_logits = self._run_mixed_dispatch(plan)
                    else:
                        self._run_decode(plan.decode)
                rinfo.update(decode_seqs=len(dseqs), decode_steps=steps)
                # decode tokens are emitted: from here on a failure only
                # fails the prefill sequences
                decode_done = True
                if fused:
                    served = plan.prefills[:len(chunk_logits)]
                    self._finish_packed_prefills(served, chunk_logits)
                    # one dispatch ran both halves: one "mixed" FPM
                    kind = "mixed"
                    n_chunk_tok = sum(len(p.chunk) for p in served)
                    n_tok = len(dseqs) * steps + drafted + n_chunk_tok
                    rinfo.update(n_chunks=len(served), chunk_tokens=n_chunk_tok,
                                 fused=True)
                else:
                    # the halves publish separately, so observers fitting
                    # per-kind step times keep clean samples
                    t1 = time.monotonic()
                    self._publish_fpm("decode", t1 - t0, len(dseqs) + drafted)
                    with annotate("engine.prefill_packed"):
                        for p in plan.prefills:
                            self._run_prefill_inner(p)
                    kind, t0 = "prefill", t1
                    n_tok = sum(len(p.chunk) for p in plan.prefills)
                    rinfo.update(n_chunks=len(plan.prefills), chunk_tokens=n_tok)
            else:
                drafted = sum(len(s.spec_draft) for s in plan.seqs)
                steps = 1
                if not drafted or self._run_spec_verify(plan, [], rinfo) is None:
                    drafted, steps = 0, plan.n_steps
                    self._run_decode(plan)
                kind, n_tok = "decode", len(plan.seqs) + drafted
                rinfo.update(decode_seqs=len(plan.seqs), decode_steps=steps)
        except Exception:
            # one bad step must fail ITS sequences, never kill the step
            # thread. A mixed step whose decode half already completed only
            # fails its prefill sequences.
            if isinstance(plan, PrefillPlan):
                seqs = [plan.seq]
            elif isinstance(plan, MixedPlan):
                pseqs = [p.seq for p in plan.prefills]
                seqs = pseqs if decode_done else list(plan.decode.seqs) + pseqs
            else:
                seqs = plan.seqs
            log.exception("engine step failed; erroring %d sequence(s)", len(seqs))
            for seq in seqs:
                try:
                    self._emit(seq, [], "error")
                    self.scheduler.abort(seq.request_id)
                except Exception:
                    log.exception("failed to fail sequence %s", seq.request_id)
            return False
        if self.sanitizer is not None:
            # arms the sync guard and freezes the dispatch families after
            # warm-up; growth past that is reported
            self.sanitizer.note_step(self.runner)
        self._publish_fpm(kind, time.monotonic() - t0, n_tok)
        self._publish_kv_events()
        rinfo["ragged"] = (rst["ragged_mixed_dispatches"]
                           + rst["ragged_verify_dispatches"]) > ragged0
        self._record_iteration(ts_wall, time.monotonic() - t_start,
                               "mixed" if isinstance(plan, MixedPlan) else kind, rinfo)
        return False

    def _record_iteration(self, ts: float, wall: float, kind: str,
                          rinfo: Dict[str, Any]) -> None:
        """Assemble and append this iteration's flight record (step thread;
        field reads only)."""
        self.iterations += 1
        rec = self.recorder
        if not rec.enabled:
            return
        sch = self.scheduler
        g2 = g3 = 0
        if self.host_pool is not None:
            g2 = len(self.host_pool.host)
            if self.host_pool.disk is not None:
                g3 = len(self.host_pool.disk)
        variants = calls = 0
        for fam in self.runner._families.values():
            variants += fam.variants
            calls += fam.calls
        trace_ids: List[str] = []
        if tracing.enabled():
            # bounded join key: the traces this iteration served
            for s in sch.active[:8]:
                pctx = tracing.parse_traceparent(s.tp)
                if pctx is not None and pctx.trace_id not in trace_ids:
                    trace_ids.append(pctx.trace_id)
        rec.append(IterationRecord(
            seq=self._step_counter, ts=ts, wall_s=wall, kind=kind,
            decode_seqs=rinfo["decode_seqs"], decode_steps=rinfo["decode_steps"],
            n_chunks=rinfo["n_chunks"], chunk_tokens=rinfo["chunk_tokens"],
            charged_tokens=rinfo["chunk_tokens"], ragged=rinfo["ragged"],
            fused=rinfo["fused"], n_waiting=len(sch.waiting),
            n_running=sum(1 for s in sch.active if s.state == SeqState.RUNNING),
            kv_usage=self.pool.usage(), g2_blocks=g2, g3_blocks=g3,
            prefetch_hits=(self.prefetch.stats["hits"]
                           if self.prefetch is not None else 0),
            compile_variants=variants, compile_calls=calls,
            accepted_per_step=(rinfo["spec_emitted"] / rinfo["spec_rows"]
                               if rinfo["spec_rows"] else 0.0),
            guided_rows=rinfo["guided_rows"],
            tree_hit_blocks=self.pool.match_hit_blocks, forks=self.pool.forks,
            trace_ids=trace_ids))

    def _publish_fpm(self, kind: str, wall: float, n_tok: int) -> None:
        if kind in ("prefill", "mixed") and n_tok > 0:
            e = self._prefill_s_per_token
            per_tok = wall / n_tok
            self._prefill_s_per_token = per_tok if e is None else 0.25 * per_tok + 0.75 * e
        n_running, n_waiting, kv_usage = self._plan_load
        m = ForwardPassMetrics(ts=time.time(), kind=kind, wall_time_s=wall,
                               scheduled_tokens=n_tok, n_running=n_running,
                               n_waiting=n_waiting, kv_usage=kv_usage)
        for cb in self._fpm_listeners:
            try:
                cb(m)
            except Exception:
                log.exception("fpm listener failed")

    def _publish_kv_events(self) -> None:
        events = self.pool.drain_events() + self._host_events
        self._host_events = []
        if not events:
            return
        for cb in self._kv_listeners:
            try:
                cb(events)
            except Exception:
                log.exception("kv listener failed")

    def _run_prefill_inner(self, plan: PrefillPlan) -> None:
        seq = plan.seq
        logits = self.runner.prefill(
            plan.chunk, plan.start_pos, seq.pages, prior_len=plan.start_pos,
            adapter=seq.adapter_idx)
        if self.has_draft and seq.disagg != "prefill":
            # the draft's KV in step with the target's (a disaggregated
            # prefill worker exports none: the decode side rebuilds it)
            self.runner.draft_prefill(plan.chunk, plan.start_pos, seq.pages,
                                      prior_len=plan.start_pos)
        self.scheduler.complete_prefill(plan)
        self._finish_prefill(plan, logits)

    def _finish_prefill(self, plan: PrefillPlan, logits) -> None:
        """On the last chunk: sample the first token (under the guided
        mask and the bias, with penalties and the logprob report when
        asked), fork the branches of an n > 1 request, then park
        (disaggregated prefill) or start the sequence RUNNING."""
        seq = plan.seq
        if not plan.is_last_chunk:
            return
        bias1 = None
        rows = _batch_biases([seq], self.runner)
        if rows is not None:
            bias1 = rows[0]
        mask1 = self._guided_mask(seq)
        first_lp = None
        n_lp1 = _batch_logprobs([seq])
        pen = _batch_penalties([seq])
        if n_lp1 >= 0 or pen:
            token, first_lp = self.runner.sample_one_ex(
                logits, _sampling_params([seq]), self._next_step(),
                history=list(seq.tokens) if pen else None,
                n_logprobs=n_lp1, mask=mask1, bias=bias1)
        else:
            token = self.runner.sample_one(
                logits, _sampling_params([seq]), self._next_step(),
                mask=mask1, bias=bias1)
        # fork before the parent's DFA advance: each branch samples its
        # own first token from these logits under the same state
        if (seq.n_branches > 1 and seq.branch_of is None
                and seq.disagg is None and not seq.branches_spawned):
            self._fork_branches(seq, logits, mask1, bias1)
        self._guided_advance(seq, token)
        lp = [_first_lp_entry(first_lp, seq)] if first_lp is not None else None
        if seq.disagg == "prefill":
            # disagg: first token + transfer handle; the pages stay held
            # for the decode engine's pull
            self.scheduler.park(seq)
            self._parked[seq.request_id] = (
                seq, time.monotonic() + self.parked_ttl_s)
            self._emit(seq, [token], "prefill_complete", logprobs=lp,
                       kv_transfer={"request_id": seq.request_id,
                                    "prompt_len": len(seq.prompt),
                                    "first_token": token})
            return
        reason = self.scheduler.complete_decode(seq, token, advance_computed=False)
        if reason == "stop":
            self._emit(seq, [], reason)
        else:
            self._emit(seq, [token], reason, logprobs=lp)

    def _fork_branches(self, seq: Sequence, logits, mask1, bias1) -> None:
        """Fan a just-prefilled sequence out into n_branches siblings. Each
        shares the parent's complete trunk pages by reference (the pool
        copies only the partial tail page, through copy_pages), inherits
        the pre-advance DFA state, and samples its own first token from
        the parent's prefill logits: one prefill serves n choices. A
        branch that gets no pages or no batch slot emits an indexed error
        item; the parent and the other branches go on."""
        seq.branches_spawned = True  # a preempted parent must not fork again
        n_shared = seq.computed_len // self.pool.page_size
        for k in range(1, seq.n_branches):
            branch = Sequence(
                request_id=f"{seq.request_id}#b{k}",
                prompt=list(seq.prompt),
                sampling=dict(seq.sampling),
                stop=seq.stop,
                arrival=seq.arrival,
                adapter=seq.adapter,
                adapter_idx=seq.adapter_idx,
                logit_bias=seq.logit_bias,
                guided=seq.guided,
                guided_m=seq.guided_m,
                guided_s=seq.guided_s,
                branch_of=seq.request_id,
                branch_index=k,
            )
            if branch.sampling.get("seed") is not None:
                # the frontend fan-out's choice seeds: seeded branches
                # diverge deterministically
                branch.sampling["seed"] = int(branch.sampling["seed"]) + k
            try:
                pages = self.pool.fork_table(seq.pages, n_shared)
            except NoSpace:
                self._emit(branch, [], "error",
                           error="no KV pages free to fork this choice")
                continue
            if not self.scheduler.adopt_branch(branch, seq, pages):
                self._emit(branch, [], "error",
                           error="no batch slot free to fork this choice")
                continue
            tok = self.runner.sample_one(
                logits, _sampling_params([branch]), self._next_step(),
                mask=mask1, bias=bias1)
            self._guided_advance(branch, tok)
            reason = self.scheduler.complete_decode(branch, tok,
                                                    advance_computed=False)
            self._emit(branch, [tok] if reason != "stop" else [], reason)

    def _finish_packed_prefills(self, prefills: List[PrefillPlan],
                                chunk_logits) -> None:
        """Bookkeeping for chunks whose KV landed in a shared dispatch,
        with per-chunk isolation: one chunk failing errors only its own
        sequence, not its siblings or the emitted decode half."""
        for pplan, logits in zip(prefills, chunk_logits):
            try:
                self.scheduler.complete_prefill(pplan)
                self._finish_prefill(pplan, logits)
            except Exception:
                log.exception("packed chunk bookkeeping failed; erroring %s",
                              pplan.seq.request_id)
                try:
                    self._emit(pplan.seq, [], "error")
                    self.scheduler.abort(pplan.seq.request_id)
                except Exception:
                    log.exception("failed to fail sequence %s",
                                  pplan.seq.request_id)

    def _run_decode(self, plan: DecodePlan) -> None:
        """The steady-state decode dispatch: a profiler range and the
        sync guard."""
        with annotate("engine.decode"):
            with self._san_scope("decode"):
                self._run_decode_inner(plan)

    def _run_decode_inner(self, plan: DecodePlan) -> None:
        """plan.n_steps decode iterations with on-device token feedback (one
        host sync per plan), with the batch's guided masks, bias rows,
        penalties and logprob report."""
        seqs = plan.seqs
        T = plan.n_steps
        step0 = self._step_counter + 1
        if self.has_draft:
            if _batch_logprobs(seqs) < 0 and not _batch_penalties(seqs):
                self._run_draft_decode(seqs, T, step0)
                return
            # the speculative verify has no logprob report or count
            # tables: this batch decodes plainly (its draft KV skips these
            # positions, which costs acceptance later, never correctness)
            if not self._draft_fallback_warned:
                self._draft_fallback_warned = True
                log.warning("logprobs/penalties are incompatible with "
                            "speculative verification; falling back to "
                            "plain decode")
        self._step_counter += T
        kw = self._guided_step_masks(seqs, T)
        if "guided_dev" in kw or "mask_fn" in kw:
            del kw["masks"]  # the tables or the callback give every step's
        biases = _batch_biases(seqs, self.runner)
        if biases is not None:
            kw["biases"] = biases
        sampled, lp = self.runner.decode_multi_ex(
            T, [s.tokens[-1] for s in seqs], [s.computed_len for s in seqs],
            [s.pages for s in seqs], _sampling_params(seqs), step0,
            n_logprobs=_batch_logprobs(seqs),
            histories=([list(s.tokens) for s in seqs]
                       if _batch_penalties(seqs) else None),
            prompt_lens=[s.n_prompt0 for s in seqs],
            adapters=[s.adapter_idx for s in seqs], **kw)
        for i, seq in enumerate(seqs):
            self._commit(seq, sampled[i, :T], lp, i)

    def _run_draft_decode(self, seqs: List[Sequence], T: int, step0: int) -> None:
        """The draft-model path of a T-step decode plan: R = T // (gamma +
        1) speculative rounds, each emitting 1..gamma+1 tokens a sequence.
        Under gamma + 1 steps of budget gamma shrinks to T - 1 rather than
        falling back to plain decode, whose steps would leave holes in the
        draft's pool (gamma 0 is plain decode plus the draft's KV)."""
        gamma = self.runner.spec_gamma
        if T < gamma + 1:
            gamma, R = T - 1, 1
        else:
            R = T // (gamma + 1)
        self._step_counter += R
        toks, counts = self.runner.spec_decode_multi(
            R, [s.tokens[-1] for s in seqs], [s.computed_len for s in seqs],
            [s.pages for s in seqs], _sampling_params(seqs), step0, gamma=gamma,
            adapters=[s.adapter_idx for s in seqs])
        for i, seq in enumerate(seqs):
            self._commit(seq, [int(t) for r in range(R)
                               for t in toks[i, r, :int(counts[i, r])]])
        # every row-round verifies gamma drafts and emits counts tokens
        rounds = len(seqs) * R
        accepted = int(counts[:len(seqs)].sum()) - rounds
        st = self.spec_stats
        st["verify_iters"] += R
        st["verify_rows"] += rounds
        st["drafted"] += rounds * gamma
        st["accepted"] += accepted
        st["rejected"] += rounds * gamma - accepted
        st["spec_emitted"] += accepted + rounds

    def _commit(self, seq: Sequence, tokens, lp=None, row: int = 0) -> None:
        """Append decoded tokens until one finishes the sequence (the rest
        are discarded), advancing its DFA past each, and emit what was
        committed with its logprob entries (`lp`, the batch's report, row
        `row`)."""
        emit: List[int] = []
        entries: List[Dict[str, Any]] = []
        reason = None
        for j, token in enumerate(tokens):
            token = int(token)
            reason = self.scheduler.complete_decode(seq, token)
            if not reason:
                self._guided_advance(seq, token)
            if reason != "stop":
                emit.append(token)
                if lp is not None and seq.sampling.get("logprobs") is not None:
                    entries.append(_lp_entry(lp, row, j, seq))
            if reason:
                break
        self._emit(seq, emit, reason, logprobs=entries or None)

    # -- fused mixed dispatch ----------------------------------------------
    def _mixed_fusible(self, plan: MixedPlan) -> bool:
        """Whether a MixedPlan runs as one fused dispatch: the switch, and
        the reference's gates for what the fused step does not carry.
        Guided or biased decode rows fuse only on the ragged step (the
        padded fallback has no mask or bias); logprobs and penalties in
        the decode batch, and a biased chunk, keep the two-dispatch
        path."""
        if not self.fused_mixed:
            return False
        seqs = plan.decode.seqs
        if any(s.guided_m is not None or s.logit_bias for s in seqs):
            if (not getattr(self.runner, "guided_fused", False)
                    or not self.runner._use_ragged(len(seqs), len(plan.prefills))):
                return False
        if _batch_logprobs(seqs) >= 0 or _batch_penalties(seqs):
            return False
        return not any(p.seq.logit_bias for p in plan.prefills)

    def _run_mixed_dispatch(self, plan: MixedPlan):
        """The fused dispatch and its decode half's bookkeeping. A pack
        the runner cannot shape sheds its newest chunk and retries; shed
        chunks were never completed, so the scheduler plans them again
        next iteration. Guided rows sample step 0 under the ragged step's
        masks and the later steps under the device tables or the host
        callback, pending: step 0's tokens are sampled on the device.
        Returns the served chunks' last-token logits, one row per chunk
        from the front of plan.prefills."""
        seqs = plan.decode.seqs
        T = plan.decode.n_steps
        tokens = [s.tokens[-1] for s in seqs]
        positions = [s.computed_len for s in seqs]
        tables = [s.pages for s in seqs]
        step0 = self._step_counter + 1
        self._step_counter += T
        kw = self._guided_step_masks(seqs, T, pending=True)
        biases = _batch_biases(seqs, self.runner)
        if biases is not None:
            kw["biases"] = biases
        kw["adapters"] = [s.adapter_idx for s in seqs]
        prefills = list(plan.prefills)
        while True:
            try:
                with annotate("engine.mixed"):
                    sampled, chunk_logits = self.runner.decode_multi_with_prefills(
                        T, tokens, positions, tables, _sampling_params(seqs),
                        step0, _chunks(prefills), **kw)
                break
            except BucketOverflowError as e:
                if len(prefills) <= 1:
                    raise  # even one chunk fits no shape
                shed = prefills.pop()
                log.warning("mixed pack overflows runner buckets (%s); "
                            "deferring chunk of %s to the next iteration",
                            e, shed.seq.request_id)
        for i, seq in enumerate(seqs):
            self._commit(seq, sampled[i, :T])
        return chunk_logits

    # -- speculative decoding (n-gram drafts + ragged verify) ---------------
    def _propose_drafts(self) -> None:
        """This iteration's drafts, proposed before step_plan so the
        scheduler can charge them against the mixed pool. Guided and biased
        rows never draft: they ride the verify dispatch as one-token rows
        under their mask and bias while the others speculate. Logprobs or
        penalties anywhere in the batch pause speculation for all of it:
        the verify step has no logprob report or count tables. Tree mode
        (spec_branches > 1) takes the host scan's candidates; linear
        drafts come from the host scan, or from one device ring step
        under spec_device_draft."""
        running = [s for s in self.scheduler.active if s.state == SeqState.RUNNING]
        for s in running:
            s.spec_draft = []
            s.spec_tree = []
        if not self.spec_ngram or not running:
            return
        if _batch_logprobs(running) >= 0 or _batch_penalties(running):
            return
        free = [s for s in running if s.guided_m is None and not s.logit_bias]
        if self.spec_branches > 1:
            for s in free:
                # siblings come clipped to the primary's length
                tree = ngram_propose_tree(s.tokens, self.spec_k, self.spec_branches)
                if tree:
                    s.spec_draft, s.spec_tree = tree[0], tree[1:]
            return
        if self._spec_device_draft and free:
            drafts = self._device_draft(free)
            for s in free:
                s.spec_draft = drafts[s.request_id]
        else:
            for s in free:
                s.spec_draft = ngram_propose(s.tokens, self.spec_k)

    def _device_draft(self, seqs: List[Sequence]) -> Dict[str, List[int]]:
        """One device ring step for every drafting row: each row's tokens
        committed since its last proposal are appended to its slot's
        history and k tokens are proposed a slot, with one staging copy
        and one readback. Returns rid -> draft, equal to
        ngram_draft.propose while the history fits the ring's window. The
        ring has max_batch slots and the batch never exceeds max_batch
        rows, so once the slots of rows gone are handed back every row
        has one."""
        live = {s.request_id for s in seqs}
        for rid in [r for r in self._draft_slots if r not in live]:
            # finished, preempted or no longer drafting rows hand their
            # slot back; a row that drafts again resets a fresh one
            self._draft_free.append(self._draft_slots.pop(rid))
            self._draft_synced.pop(rid, None)
        updates: List[tuple] = []
        for s in seqs:
            rid = s.request_id
            slot = self._draft_slots.get(rid)
            delta = len(s.tokens) - self._draft_synced.get(rid, 0)
            if slot is None:
                slot = self._draft_free.pop()
                self._draft_slots[rid] = slot
                delta = -1  # a fresh slot: reset below
            if delta < 0 or delta > self._draft_D:
                self.runner.draft_ring_reset(slot, s.tokens)
            elif delta:
                updates.append((slot, s.tokens[-delta:]))
            self._draft_synced[rid] = len(s.tokens)
        drafts, n_prop = self.runner.draft_step(updates, self.spec_k)
        return {s.request_id: drafts[slot][:int(n_prop[slot])].tolist()
                for s in seqs for slot in (self._draft_slots[s.request_id],)}

    def _run_spec_verify(self, dplan: DecodePlan, prefills, rinfo=None):
        """One ragged dispatch verifying every speculating row's draft (a
        K+1-token segment: the last real token and the draft) beside the
        plain decode rows and, when fused, the packed prefill chunks.
        Guided and biased rows (never drafting) verify one position under
        their mask and bias. Acceptance emits target samples through the
        first mismatch (and the bonus token on a full match), so greedy
        output equals plain decode. Rejected drafts' KV lies past
        computed_len and is overwritten later.

        A tree's extra branches are rows of their own on page tables
        forked from the owner's (the committed trunk shared, the tail
        fresh), after every primary row, with the owner's sampling
        entries; `accept_tree` walks them, the winning fork's table is
        adopted before the tokens are committed, and every other fork is
        released. A fork the pool cannot give sheds the row's remaining
        branches. Returns the chunks' last-token logits, or None when the
        runner cannot shape the dispatch (the drafts are dropped, every
        fork released, and the caller runs the plain path). `rinfo`, the
        iteration's flight-record composition, gets the speculating rows
        and the tokens they emitted."""
        seqs = dplan.seqs
        drafts = [list(s.spec_draft) for s in seqs]
        trees = [list(s.spec_tree) for s in seqs]
        for s in seqs:
            s.spec_draft = []  # consumed (or shed) either way
            s.spec_tree = []
        tokens = [s.tokens[-1] for s in seqs]
        positions = [s.computed_len for s in seqs]
        tables = [s.pages for s in seqs]
        slots = [s.adapter_idx for s in seqs]
        sp = _sampling_params(seqs)
        branch_rows: List[List[int]] = [[] for _ in seqs]
        forks: List[List[Optional[List[int]]]] = [[] for _ in seqs]
        PS = self.pool.page_size
        for i, s in enumerate(seqs):
            for b in (trees[i] if drafts[i] else []):
                try:
                    fork = self.pool.fork_table(s.pages, s.computed_len // PS)
                except NoSpace:
                    break  # pool pressure: shed the remaining branches
                branch_rows[i].append(len(tokens))
                forks[i].append(fork)
                tokens.append(s.tokens[-1])
                positions.append(s.computed_len)
                tables.append(fork)
                slots.append(s.adapter_idx)
                drafts.append([int(t) for t in b])
                for key in sp:
                    sp[key].append(sp[key][i])
            trees[i] = trees[i][:len(forks[i])]

        def release_forks(i: int) -> None:
            for f in forks[i]:
                if f is not None:
                    self.pool.release(f)
            forks[i] = []

        step0 = self._next_step()
        kw: Dict[str, Any] = {}
        masks = {i: self._guided_mask(s) for i, s in enumerate(seqs)
                 if s.guided_m is not None}
        if masks:
            kw["masks"] = masks
        brows = _batch_biases(seqs, self.runner)
        if brows is not None:
            kw["biases"] = {i: brows[i] for i, s in enumerate(seqs) if s.logit_bias}
        kw["adapters"] = slots
        try:
            with annotate("engine.spec_verify"):
                with self._san_scope("spec_verify"):
                    rows, chunk_logits = self.runner.verify_spec(
                        tokens, positions, tables, drafts, sp, step0,
                        chunks=_chunks(prefills), **kw)
        except BucketOverflowError as e:
            for i in range(len(seqs)):
                release_forks(i)  # nothing was committed to them
            log.warning("spec verify overflows runner buckets (%s); dropping "
                        "this iteration's drafts", e)
            return None
        except BaseException:
            for i in range(len(seqs)):
                release_forks(i)
            raise
        n_drafted = sum(len(d) for d in drafts[:len(seqs)])
        accepted = emitted_spec = switches = 0
        for i, seq in enumerate(seqs):
            if forks[i]:
                emitted, winner = accept_tree(
                    [drafts[i]] + trees[i],
                    [rows[i]] + [rows[r] for r in branch_rows[i]])
                if winner > 0:
                    # the winning fork's fresh tail holds the accepted
                    # suffix's KV: adopt its table before committing (the
                    # trunk is shared, so the swap moves one reference)
                    old = seq.pages
                    seq.pages = forks[i][winner - 1]
                    forks[i][winner - 1] = None
                    self.pool.release(old)
                    switches += 1
                release_forks(i)
            else:
                emitted = accept_deterministic(drafts[i], rows[i])
            if drafts[i]:
                accepted += len(emitted) - 1
                emitted_spec += len(emitted)
            self._commit(seq, emitted)
        st = self.spec_stats
        st["verify_iters"] += 1
        st["verify_rows"] += sum(1 for d in drafts[:len(seqs)] if d)
        st["drafted"] += n_drafted
        st["accepted"] += accepted
        st["rejected"] += n_drafted - accepted
        st["spec_emitted"] += emitted_spec
        st["tree_rows"] += sum(len(r) for r in branch_rows)
        st["tree_switches"] += switches
        if rinfo is not None:
            rinfo["spec_rows"] = sum(1 for d in drafts[:len(seqs)] if d)
            rinfo["spec_emitted"] = emitted_spec
        return chunk_logits

    def _next_step(self) -> int:
        self._step_counter += 1
        return self._step_counter

    # -- disaggregation: decode-side admission ------------------------------
    def _kv_layout_mismatch(self, payload: Dict[str, Any]) -> Optional[str]:
        """Non-None when a host-staged payload can't be imported into the
        local pool: another wire layout version, page geometry
        (L, PS, Hk, D) or element type. Device payloads are same-process
        buffers and never re-sliced."""
        if payload.get("device"):
            return None
        parts = payload.get("chunks") or ([payload] if payload.get("data") else [])
        for p in parts:
            if not p.get("k"):
                continue
            bad = kv_payload_incompatible(p, self.runner.kv_page_shape,
                                          self.runner.kv_wire_dtype)
            if bad:
                return bad
        return None

    def _admit_kv_pending(self) -> None:
        """Disagg-decode sequences: admit + import transferred KV pages."""
        still: List[Sequence] = []
        for seq in self._kv_pending:
            bad = self._kv_layout_mismatch(seq.kv_import or {})
            if bad:
                # checked before admit_with_kv marks the prompt computed:
                # fall back to local prefill (recompute), never adopt
                # mis-shaped bytes
                log.warning("P->D KV payload rejected (%s); recomputing %s "
                            "locally", bad, seq.request_id)
                seq.kv_import = None
                self.scheduler.add(seq)
                continue
            try:
                self._admit_one_kv(seq, still)
            except Exception:
                # a malformed transfer payload fails THIS request, not the
                # step thread (this runs from _drain_inbox)
                log.exception("KV import failed; erroring %s", seq.request_id)
                try:
                    self._emit(seq, [], "error")
                    self.scheduler.abort(seq.request_id)
                except Exception:
                    log.exception("failed to fail sequence %s", seq.request_id)
        self._kv_pending = still

    def _admit_one_kv(self, seq: Sequence, still: List[Sequence]) -> None:
        seq.tokens = list(seq.prompt)
        seq.n_prompt0 = len(seq.prompt)
        if not self.scheduler.admit_with_kv(seq):
            still.append(seq)
            return
        t0 = time.monotonic()
        payload = seq.kv_import or {}
        seq.kv_import = None
        PS = self.pool.page_size
        # the prompt's last token is the prefill-sampled one: its KV is
        # written by the first decode step
        n_kv_pages = (len(seq.prompt) - 1 + PS - 1) // PS
        ns = seq.n_shared_pages
        target = seq.pages[ns:n_kv_pages]
        if target and payload.get("device"):
            # colocated transfer: staged buffers are already on the device
            self.runner.import_pages_device(target, ns, payload["k"], payload["v"])
        elif target and payload.get("chunks"):
            # chunked host-staged transfer: each chunk covers global pages
            # [offset, offset+n); skip the prefix-cache-shared span
            for ch in payload["chunks"]:
                off, n = int(ch.get("offset", 0)), int(ch["n_pages"])
                lo, hi = max(off, ns), min(off + n, n_kv_pages)
                if lo >= hi or not ch.get("data"):
                    continue
                self.runner.import_pages(seq.pages[lo:hi], lo - off, ch)
        elif target and payload.get("data"):
            self.runner.import_pages(target, ns, payload)
        if self.has_draft:
            # the transfer carries the target's KV only: rebuild the
            # draft's by draft prefill, after the prefix-shared pages
            # (whose draft KV the sequence that filled them wrote)
            toks = seq.prompt[:-1]
            chunk = self.scheduler.chunk_size
            for start in range(ns * PS, len(toks), chunk):
                self.runner.draft_prefill(toks[start:start + chunk], start,
                                          seq.pages, prior_len=start)
        seq.phases["kv_import_s"] = time.monotonic() - t0

    # -- disaggregation: prefill-side export (step thread) -------------------
    def _expire_parked(self) -> None:
        if not self._parked:
            return
        now = time.monotonic()
        for rid in [r for r, (s, dl) in self._parked.items() if dl < now]:
            seq, _ = self._parked.pop(rid)
            self.scheduler.release_parked(seq)

    def _n_prompt_pages(self, seq: Sequence) -> int:
        """Pages a parked prompt's KV occupies (export side). The import
        side takes ceil((len-1)/PS) of the decode prompt, which is one
        token longer (the first token, whose KV the decode step writes)."""
        return (len(seq.prompt) + self.pool.page_size - 1) // self.pool.page_size

    def _export_parked_device(self, rid: str):
        """Colocated P→D: gather the parked pages into device buffers on
        THIS engine's step thread; the decode engine scatters them on its
        own. Both launch on the device's current stream, so the scatter
        runs behind the gather."""
        entry = self._parked.pop(rid, None)
        if entry is None:
            return None
        seq, _ = entry
        n = self._n_prompt_pages(seq)
        try:
            k, v = self.runner.export_pages_device(seq.pages[:n])
        finally:
            self.scheduler.release_parked(seq)
        return {"device": True, "k": k, "v": v, "n_pages": n}

    def _export_meta(self, rid: str) -> Optional[int]:
        """Page count of a parked request (no pop: the stream export reads
        chunk by chunk while the request stays parked)."""
        entry = self._parked.get(rid)
        return None if entry is None else self._n_prompt_pages(entry[0])

    def _export_chunk(self, rid: str, start: int, n: int, last: bool):
        """Export pages [start, start+n) of a parked request; `last` pops
        and releases. Runs between steps, so chunk reads interleave with
        this engine's other work."""
        entry = self._parked.get(rid)
        if entry is None:
            return None
        seq, _ = entry
        # an actively-consumed transfer must not expire between chunks
        self._parked[rid] = (seq, time.monotonic() + self.parked_ttl_s)
        try:
            payload = self.runner.export_pages(seq.pages[start:start + n])
        finally:
            if last:
                self._parked.pop(rid, None)
                self.scheduler.release_parked(seq)
        payload["offset"] = start
        # importers check coverage against this before trusting the stream
        # (a truncated transfer must recompute, never half-import)
        payload["total_pages"] = self._n_prompt_pages(seq)
        return payload

    def _export_parked(self, rid: str, discard: bool = False):
        entry = self._parked.pop(rid, None)
        if entry is None:
            return None
        seq, _ = entry
        try:
            if discard:
                return None
            return self.runner.export_pages(seq.pages[:self._n_prompt_pages(seq)])
        finally:
            self.scheduler.release_parked(seq)

    async def _step_thread_call(self, op: str, *args):
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()
        self._inbox.put((op, (*args, fut, loop)))
        return await fut

    async def call_on_step_thread(self, fn, *args):
        """fn(*args) run on the step thread between steps (a LoRA slot
        written while no dispatch reads the tree); its result."""
        self.start()
        return await self._step_thread_call("call", fn, args)

    async def export_parked_kv_device(self, request_id: str):
        """Device-resident parked-KV export: a same-process decode engine
        imports the gathered buffers without a host round trip."""
        return await self._step_thread_call("export_device", request_id)

    async def export_parked_kv(self, request_id: str,
                               discard: bool = False) -> Optional[Dict[str, Any]]:
        """Pull a parked request's KV pages (the device read runs on the
        step thread between steps); releases the parked pages.
        discard=True releases without reading (early-finished requests)."""
        return await self._step_thread_call("export", request_id, discard)

    async def export_parked_kv_stream(self, request_id: str, chunk_pages: int = 16):
        """Chunked parked-KV export: the decode side pulls KV in bounded
        pieces, each read on the step thread between steps. Yields payload
        dicts carrying "offset" and "total_pages"."""
        total = await self._step_thread_call("export_meta", request_id)
        if total is None:
            return
        chunk_pages = max(1, int(chunk_pages))
        for start in range(0, total, chunk_pages):
            n = min(chunk_pages, total - start)
            payload = await self._step_thread_call(
                "export_chunk", request_id, start, n, start + n >= total)
            if payload is None:  # parked entry expired mid-stream
                return
            yield payload

    # -- KVBM tiers: the asyncio side ---------------------------------------
    async def export_host_blocks(self, hashes: List[int]) -> Dict[str, Any]:
        """Serve a peer's cross-worker onboarding pull: the lower-tier
        read runs on the step thread (the pools are its state)."""
        return await self._step_thread_call("host_export", [int(h) for h in hashes])

    async def _pull_remote_host(self, hint: Dict[str, Any]) -> None:
        """Best-effort remote-G2 pull, as the reference's: a peer's blocks
        into the local host tier before admission. A failure recomputes;
        a peer that failed is skipped for REMOTE_PULL_BACKOFF_S."""
        hashes = [int(h) for h in hint.get("hashes") or []]
        parents = list(hint.get("parents") or [])
        if not hashes or len(parents) != len(hashes):
            return
        if self.host_pool.match(hashes) >= len(hashes):
            return  # already local (the prefetch hint pulled them)
        peer = int(hint.get("instance") or 0)
        now = time.monotonic()
        if now < self._remote_fetch_backoff.get(peer, 0.0):
            self.tier_stats["remote_backoff_skips"] += 1
            return
        if not self._remote_pull_pays():
            self.tier_stats["remote_cost_skips"] += 1
            return
        t0 = time.perf_counter()
        try:
            payload = await asyncio.wait_for(self.remote_kv_fetch(hint),
                                             timeout=REMOTE_PULL_TIMEOUT_S)
        except Exception as e:
            self._remote_fetch_backoff[peer] = now + REMOTE_PULL_BACKOFF_S
            self.tier_stats["remote_failures"] += 1
            log.info("remote host-tier pull failed (%s); recomputing", e)
            return
        n = int((payload or {}).get("n") or 0)
        if n <= 0:
            return
        self.tier_stats["remote_pulls"] += 1
        self.tier_stats["remote_blocks"] += n
        # the peer-pull leg of the transfer cost (the blocks then onboard
        # from the local G2), and per link class when the router gave one
        elapsed = time.perf_counter() - t0
        self._note_onboard([], n, elapsed, tier="remote")
        link = hint.get("link")
        if link in ("ici", "dcn"):
            self._note_onboard([], n, elapsed, tier=f"remote_{link}")
        self._inbox.put(("host_import", (hashes[:n], parents[:n], payload)))

    def _remote_pull_pays(self) -> bool:
        """Whether a remote-G2 pull is expected to beat recomputing its
        blocks: the pulls' measured seconds a block plus the local
        onboard's, against a page of the prefill's measured seconds a
        token. Pull until both are measured. (The reference always pulls,
        and leaves the weighing to the router's tier costs.)"""
        pull = self.kv_onboard_ewma.get("remote")
        per_tok = self._prefill_s_per_token
        if pull is None or per_tok is None:
            return True
        onboard = self.kv_onboard_ewma.get("host", {}).get("s_per_block", 0.0)
        return pull["s_per_block"] + onboard <= per_tok * self.pool.page_size

    async def prefetch_hint_async(self, hint: Dict[str, Any]) -> bool:
        """The router's `kv_prefetch` hint: promote the hinted blocks
        before the request arrives. A hint with a `remote` leg first pulls
        the peer's blocks into the local host tier (the inbox is FIFO, so
        the import lands before the promotion looks for it)."""
        if self.prefetch is None:
            return False
        remote = hint.get("remote")
        if remote and self.remote_kv_fetch is not None:
            await self._pull_remote_host(remote)
        self._inbox.put(("prefetch", hint))
        return True

    # -- KVBM tiers (step-thread callbacks) ---------------------------------
    def _offload_page(self, page: int, block_hash: int, parent: Optional[int]) -> None:
        """A device page being evicted: its KV goes to the host tier when
        the evicting alloc flushes (`_flush_offloads`)."""
        self._offload_pending.append((page, block_hash, parent))

    def _flush_offloads(self) -> None:
        """The evicted pages of one alloc → the host tier in one batch:
        one gather a pool, one copy a block into host memory the tier
        keeps (pinned up to the runner's cap), one wait."""
        pending, self._offload_pending = self._offload_pending, []
        if not pending:
            return
        t0 = time.perf_counter()
        blocks = self.runner.export_page_blocks([p for p, _, _ in pending],
                                                quantize=self.kv_tier_quantize)
        for (_, h, parent), (k, v) in zip(pending, blocks):
            self.host_pool.host.put_block(h, parent, k, v)
            self._host_events.append(KvEvent("store", [h], parent, tier="host"))
        st = self.offload_stats
        st["offloads"] += len(pending)
        st["batches"] += 1
        st["seconds"] += time.perf_counter() - t0

    def _on_host_evicted(self, hashes: List[int]) -> None:
        self._host_events.append(KvEvent("remove", hashes, tier="host"))
        if self.host_pool.obj is not None:
            # the terminal tier is G4: the block left the shared store's
            # index too, so the router's obj_index residency goes with it
            self._host_events.append(KvEvent("remove", hashes, tier="obj"))

    def _on_obj_stored(self, block_hash: int, parent: Optional[int]) -> None:
        """G4 store_listener, possibly on the writer or spill thread: the
        event goes to the step thread through the inbox."""
        self._inbox.put(("obj_event", (block_hash, parent)))

    def _host_export(self, hashes: List[int]) -> Dict[str, Any]:
        """A peer's pull: the leading run of `hashes` resident in this
        worker's lower tiers, as a dense wire payload with "n" blocks."""
        out: Dict[str, Any] = {"n": 0}
        if self.host_pool is None or not hashes:
            return out
        n = self.host_pool.match(hashes)
        if not n:
            return out
        try:
            k, v = self.host_pool.get(hashes[:n])
        except Exception:
            # an eviction race (KeyError) or a G3/G4 read error: fail the
            # export, never the step thread
            log.warning("host export failed; replying empty", exc_info=True)
            return out
        if k is None:
            # a block whose data is gone: advertising it would spread
            # phantom residency
            return out
        out["n"] = n
        out.update(kv_arrays_to_payload(k, v))
        return out

    def _host_import(self, hashes: List[int], parents: List[Optional[int]],
                     payload: Dict[str, Any]) -> None:
        """Blocks pulled from a peer land in the local G2 (admission then
        onboards them as any host-tier hit), with host store events.
        Geometry and dtype are checked here, at ingest: a mismatched
        peer's blocks are dropped and the request recomputes."""
        if self.host_pool is None or not hashes:
            return
        try:
            arrays = kv_payload_to_arrays(payload, self.runner.kv_page_shape,
                                          self.runner.kv_wire_dtype)
        except Exception:
            log.warning("peer KV payload rejected; recomputing", exc_info=True)
            self.tier_stats["remote_failures"] += 1
            return
        if arrays is None:
            return
        k, v = arrays
        self.host_pool.put(hashes, parents, k, v)
        self._host_events.append(
            KvEvent("store", list(hashes), parents[0] if parents else None,
                    tier="host"))

    def _onboard_from_host(self, pages: List[int], hashes: List[int],
                           seq: Optional[Sequence] = None) -> bool:
        """Lower-tier blocks → device pages during admission, imported in
        `onboard_layer_groups` layer slabs (runner.import_page_tensors:
        pinned blocks copied whole, others staged). Returns False when a matched
        block left the tiers or has no data (the scheduler then recomputes
        instead of trusting a partial import). A quantizing tier's all-G2
        chain crosses as codes and scales (int8 pools store them, dense
        pools dequantize them on the device); the measured time feeds the
        per-tier EWMA."""
        if self.prefetch is not None:
            # blocks still mid-promotion arrived late: this import wins
            self.prefetch.note_sync_onboard(hashes)
        tiers = self.host_pool.residency(hashes)
        if seq is not None and tiers:
            # the deepest rung dominates the transfer and labels it
            deepest = max(tiers, key=lambda t: _TIER_ORDER.get(t, -1))
            seq.onboard_tier = _TIER_LABEL.get(deepest, deepest)
        groups = self.onboard_layer_groups
        t0 = time.perf_counter()
        try:
            payload = self._native_quant_payload(hashes, tiers)
            blocks = None if payload is not None else self.host_pool.get_blocks(hashes)
        except KeyError:
            log.info("lower-tier block evicted before onboard; recomputing")
            self.tier_stats["onboard_misses"] += 1
            return False
        if payload is None and blocks is None:
            # a block whose data is gone (a deleted G4 object)
            log.info("lower-tier block has no data; recomputing")
            self.tier_stats["onboard_misses"] += 1
            return False
        t1 = time.perf_counter()
        if payload is not None:
            self.runner.import_pages(pages, 0, payload, layer_groups=groups)
        else:
            self.runner.import_page_tensors(pages, [b[0] for b in blocks],
                                            [b[1] for b in blocks],
                                            layer_groups=groups)
        t2 = time.perf_counter()
        st = self.onboard_stats
        st["onboards"] += 1
        st["blocks"] += len(hashes)
        st["seconds"] += t2 - t0
        st["get_s"] += t1 - t0  # tier reads (and dequantization)
        st["import_s"] += t2 - t1  # the enqueued copies and scatters
        self._note_onboard(tiers, len(hashes), t2 - t0)
        return True

    def _native_quant_payload(self, hashes: List[int], tiers: List[str]):
        """The codes + scales payload when the whole chain is in G2 and the
        tier quantizes: int8 pools adopt them as they are, dense pools
        dequantize them on the device (the reference dequantizes on the
        host; the bytes are the same). Else None (the dense path). Raises
        KeyError on an eviction race."""
        if not self.host_pool.host.quantize:
            return None
        if any(t != "host" for t in tiers):
            return None
        blocks = [self.host_pool.host.get_block_raw(h) for h in hashes]
        if not blocks or not all(is_quantized_block(k) and is_quantized_block(v)
                                 for k, v in blocks):
            return None
        return kv_quant_arrays_to_payload(
            [k["q"] for k, _ in blocks], [k["s"] for k, _ in blocks],
            [v["q"] for _, v in blocks], [v["s"] for _, v in blocks])

    def _note_onboard(self, tiers: List[str], n_blocks: int, elapsed_s: float,
                      tier: Optional[str] = None) -> None:
        """Fold one measured onboard into the per-tier seconds-a-block
        EWMA (alpha 0.25), charged to the chain's deepest tier."""
        if tier is None:
            tier = "host"
            for t in tiers:
                if _TIER_ORDER.get(t, -1) > _TIER_ORDER[tier]:
                    tier = t
        per_block = elapsed_s / max(1, n_blocks)
        e = self.kv_onboard_ewma.get(tier)
        if e is None:
            self.kv_onboard_ewma[tier] = {"s_per_block": per_block, "n": n_blocks}
            return
        alpha = 0.25
        e["s_per_block"] = alpha * per_block + (1 - alpha) * e["s_per_block"]
        e["n"] += n_blocks

    # -- emission ----------------------------------------------------------
    def _emit(self, seq: Sequence, token_ids: List[int], finish: Optional[str],
              logprobs: Optional[List[Dict[str, Any]]] = None,
              **extra: Any) -> None:
        if logprobs:
            extra["logprobs"] = logprobs
        if token_ids:
            now = time.monotonic()
            if "ttft_s" not in seq.phases:
                if seq.arrival:
                    seq.phases["ttft_s"] = max(0.0, now - seq.arrival)
            elif seq.t_last_emit and len(seq.itl) < _ITL_CAP:
                # a multi-token group contributes one ITL sample per token
                per = max(0.0, now - seq.t_last_emit) / len(token_ids)
                n = min(len(token_ids), _ITL_CAP - len(seq.itl))
                seq.itl.extend([per] * n)
            seq.t_last_emit = now
        item = engine_output(token_ids, finish, **extra)
        if finish:
            # the final item carries the request's phase spine downstream
            phases: Dict[str, Any] = dict(seq.phases)
            if seq.arrival:
                phases["e2e_s"] = max(0.0, time.monotonic() - seq.arrival)
            if seq.itl:
                phases["itl_s"] = list(seq.itl)
            pctx = tracing.parse_traceparent(seq.tp)
            if pctx is not None:
                # the trace id rides the spine, so digests join their
                # aggregates back to traces
                phases["trace_id"] = pctx.trace_id
                self._emit_worker_spans(seq, phases, finish)
            item["phases"] = phases
            for cb in self._phase_listeners:
                try:
                    cb(phases)
                except Exception:
                    log.exception("phase listener failed")
        if seq.branch_of is not None or seq.n_branches > 1:
            # branched choices share the parent's stream; the index says
            # which choice an item belongs to
            item.setdefault("index", seq.branch_index)
        entry = self._streams.get(seq.branch_of or seq.request_id)
        if entry is None:
            return
        out, loop = entry
        loop.call_soon_threadsafe(out.put_nowait, item)

    def _emit_worker_spans(self, seq: Sequence, phases: Dict[str, Any],
                           finish: str) -> None:
        """The worker's spans, rebuilt at finish from the phase spine:
        worker.request under the hop the request arrived with, and its
        queue, kv_onboard (labelled with the tier), prefill and stream
        children, cut back from now by the spine's durations and clamped
        into the request's interval."""
        if not tracing.enabled():
            return
        e2e = float(phases.get("e2e_s") or 0.0)
        if e2e <= 0.0:
            return
        end_ns = time.time_ns()
        t0 = end_ns - int(e2e * 1e9)
        root = tracing.record_span(
            "worker.request", t0, end_ns, parent=seq.tp,
            attributes={"request.id": seq.request_id, "finish_reason": finish,
                        "n_tokens": len(seq.tokens),
                        "preemptions": seq.n_preemptions})
        if root is None:
            return
        wtp = root.traceparent
        qw = max(0.0, float(phases.get("queue_wait_s") or 0.0))
        ob = max(0.0, float(phases.get("kv_onboard_s") or 0.0))
        ttft = max(qw + ob, float(phases.get("ttft_s") or 0.0))
        cut = [min(end_ns, t0 + int(x * 1e9)) for x in (qw, qw + ob, ttft)]
        attrs = {"request.id": seq.request_id}
        tracing.record_span("worker.queue", t0, cut[0], parent=wtp, attributes=attrs)
        if ob > 0.0:
            tracing.record_span("worker.kv_onboard", cut[0], cut[1], parent=wtp,
                                attributes=dict(attrs, **{
                                    "kv.tier": seq.onboard_tier or "G2"}))
        tracing.record_span("worker.prefill", cut[1], cut[2], parent=wtp,
                            attributes=attrs)
        tracing.record_span("worker.stream", cut[2], end_ns, parent=wtp,
                            attributes=dict(attrs, n_itl_samples=len(seq.itl)))


def _set_future(fut: asyncio.Future, value) -> None:
    if not fut.done():
        fut.set_result(value)


def _set_future_exc(fut: asyncio.Future, exc: Exception) -> None:
    if not fut.done():
        fut.set_exception(exc)


def _stable_seed(request_id: str) -> int:
    """Process-independent sampling seed (Python's hash() is salted)."""
    d = hashlib.blake2b(request_id.encode(), digest_size=4).digest()
    return int.from_bytes(d, "big") & 0x7FFFFFFF


def _chunks(prefills: List[PrefillPlan]) -> List[Dict[str, Any]]:
    """The runner's chunk records for packed prefill plans."""
    return [{"tokens": p.chunk, "start": p.start_pos, "table": p.seq.pages,
             "prior": p.start_pos, "adapter": p.seq.adapter_idx} for p in prefills]


def _sampling_params(seqs: List[Sequence]) -> Dict[str, list]:
    """Plain host lists; the runner turns them into device tensors."""
    return {
        "temperature": [float(s.sampling.get("temperature", 1.0)) for s in seqs],
        "top_k": [int(s.sampling.get("top_k", 0)) for s in seqs],
        "top_p": [float(s.sampling.get("top_p", 1.0)) for s in seqs],
        "seeds": [
            (s.sampling.get("seed") if s.sampling.get("seed") is not None
             else _stable_seed(s.request_id))
            for s in seqs
        ],
        "rep": [float(s.sampling.get("repetition_penalty", 1.0)) for s in seqs],
        "freq": [float(s.sampling.get("frequency_penalty", 0.0)) for s in seqs],
        "presence": [float(s.sampling.get("presence_penalty", 0.0)) for s in seqs],
    }


def _batch_biases(seqs: List[Sequence], runner) -> Optional[np.ndarray]:
    """[n, V] f32 additive logit-bias rows, or None when no sequence has
    one (ids outside the vocabulary are ignored: the wire is
    untrusted). A sequence's row is built once and kept on it."""
    if not any(s.logit_bias for s in seqs):
        return None
    V = runner.config.vocab_size
    rows = np.zeros((len(seqs), V), np.float32)
    for i, s in enumerate(seqs):
        if not s.logit_bias:
            continue
        cached = getattr(s, "_bias_row", None)
        if cached is None or cached.shape[0] != V:
            cached = np.zeros(V, np.float32)
            for tok, b in s.logit_bias:
                if 0 <= int(tok) < V:
                    cached[int(tok)] = float(b)
            s._bias_row = cached  # constant for the sequence's lifetime
        rows[i] = cached
    return rows


def _batch_penalties(seqs: List[Sequence]) -> bool:
    """Whether any sequence asked for a repetition, frequency or presence
    penalty (the history upload and the count tables switch on)."""
    return any(
        float(s.sampling.get("repetition_penalty", 1.0)) != 1.0
        or float(s.sampling.get("frequency_penalty", 0.0)) != 0.0
        or float(s.sampling.get("presence_penalty", 0.0)) != 0.0
        for s in seqs)


def _batch_logprobs(seqs: List[Sequence]) -> int:
    """The batch's top-N report width (-1: nobody asked), bucketed to the
    reference's menu (0, 5, 20); each sequence's entries are trimmed to
    its own N."""
    want = [int(s.sampling.get("logprobs") or 0)
            for s in seqs if s.sampling.get("logprobs") is not None]
    if not want:
        return -1
    mx = max(want)
    for b in (0, 5, 20):
        if mx <= b:
            return b
    return 20


def _first_lp_entry(first_lp, seq: Sequence) -> Dict[str, Any]:
    """The first token's logprob record, trimmed to the sequence's N."""
    n = int(seq.sampling.get("logprobs") or 0)
    return {"logprob": first_lp[0], "top_ids": first_lp[1][:n],
            "top_logprobs": first_lp[2][:n]}


def _lp_entry(lp, i: int, j: int, seq: Sequence) -> Dict[str, Any]:
    """Row i, step j of the decode loop's report, trimmed to the
    sequence's N."""
    tok_lp, ids, vals = lp
    n = int(seq.sampling.get("logprobs") or 0)
    return {"logprob": float(tok_lp[i, j]),
            "top_ids": [int(t) for t in ids[i, j, :n]],
            "top_logprobs": [float(v) for v in vals[i, j, :n]]}
