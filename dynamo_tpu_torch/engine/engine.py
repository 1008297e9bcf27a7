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
and are onboarded back, layer group by layer group, on a prefix hit.
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
Not ported yet: LoRA, multimodal input, remote host-tier pulls and the
G3/G4 tiers; requests asking for those are refused with an "error" item,
as are guided decoding and logit bias on a draft-model worker (as in the
reference: the speculative verify cannot honor them).
"""

from __future__ import annotations

import asyncio
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
from dynamo_tpu_torch.frontend.tokenizer import load_tokenizer
from dynamo_tpu_torch.guided import compile_regex, compile_structural
from dynamo_tpu_torch.guided.device_table import build_device_table
from dynamo_tpu_torch.guided.token_mask import TokenLifter
from dynamo_tpu_torch.kvbm.host_pool import HostKvPool
from dynamo_tpu_torch.ops.ragged_paged_attention import RAGGED_MAX_SEGS
from dynamo_tpu_torch.runtime.context import Context

log = logging.getLogger("dynamo_tpu_torch.engine")

# per-request ITL sample cap: bounds the spine's memory on long generations
_ITL_CAP = 512

# request fields of features this port does not serve yet: refused up
# front rather than silently ignored
_UNSUPPORTED_FIELDS = ("adapter", "mm", "kv_remote_host")

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
        onboard_layer_groups: int = 1,  # stream tier onboarding in this
        #   many contiguous layer groups (FlowKV-style overlap of transfer
        #   with the first layers' compute; 1 = whole-sequence import)
        tokenizer_spec: str = "byte",  # guided decoding lifts byte DFAs to
        #   token masks against this tokenizer (the frontend's)
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
        self.host_pool: Optional[HostKvPool] = None
        # step-thread observers, and the host tier's KV events waiting for
        # the next drain
        self._fpm_listeners: List[Any] = []
        self._kv_listeners: List[Any] = []
        self._phase_listeners: List[Any] = []
        self._host_events: List[KvEvent] = []
        self._plan_load = (0, 0, 0.0)  # (n_running, n_waiting, kv_usage)
        if host_kv_blocks > 0:
            self.host_pool = HostKvPool(capacity_blocks=host_kv_blocks)
            self.pool.evict_hook = self._offload_page
            self.host_pool.on_evict(self._on_host_evicted)
        # G2 onboards served at admission: calls, blocks and seconds
        self.onboard_stats = {"onboards": 0, "blocks": 0, "seconds": 0.0,
                              "get_s": 0.0, "wire_s": 0.0, "import_s": 0.0}
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
            guided=request.get("guided"),
            logit_bias=request.get("logit_bias"),
        )
        # latency spine: upstream hops (the disagg adapter's KV fetch)
        # stamped their durations into ctx.metadata["phases"]
        upstream = context.metadata.get("phases")
        if isinstance(upstream, dict):
            seq.phases.update({k: float(v) for k, v in upstream.items()
                               if isinstance(v, (int, float))})
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
            if op == "add":
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
                self._embed_pending.append(arg)
        self._admit_kv_pending()
        self._expire_parked()
        self._run_embeds()

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
        """Run an export op on the step thread (the only thread that
        touches this runner's pools) and resolve the caller's future with
        its result, or with its exception."""
        try:
            value = fn(*args)
        except Exception as e:
            log.exception("KV export failed")
            loop.call_soon_threadsafe(_set_future_exc, fut, e)
            return
        loop.call_soon_threadsafe(_set_future, fut, value)

    def _loop_once(self) -> None:
        self._drain_inbox()
        self._propose_drafts()
        plan = self.scheduler.step_plan()
        if plan is None:
            if not self.scheduler.has_work():
                time.sleep(self.IDLE_SLEEP_S)
            return
        sch = self.scheduler
        self._plan_load = (
            sum(1 for s in sch.active if s.state == SeqState.RUNNING),
            len(sch.waiting), self.pool.usage())
        t0 = time.monotonic()
        decode_done = False
        try:
            if isinstance(plan, PrefillPlan):
                self._run_prefill_inner(plan)
                kind, n_tok = "prefill", len(plan.chunk)
            elif isinstance(plan, MixedPlan):
                fused = self._mixed_fusible(plan)
                dseqs = plan.decode.seqs
                # the decode half: verify rows (with the chunks when fused),
                # else the fused dispatch, else plain decode first, so ITL
                # never waits behind prompt processing. A verify that
                # returns None shed its drafts (bucket overflow).
                chunk_logits = None
                drafted = sum(len(s.spec_draft) for s in dseqs)
                if drafted:
                    chunk_logits = self._run_spec_verify(
                        plan.decode, plan.prefills if fused else [])
                steps = 1
                if chunk_logits is None:
                    drafted, steps = 0, plan.decode.n_steps
                    if fused:
                        chunk_logits = self._run_mixed_dispatch(plan)
                    else:
                        self._run_decode_inner(plan.decode)
                # decode tokens are emitted: from here on a failure only
                # fails the prefill sequences
                decode_done = True
                if fused:
                    served = plan.prefills[:len(chunk_logits)]
                    self._finish_packed_prefills(served, chunk_logits)
                    # one dispatch ran both halves: one "mixed" FPM
                    kind = "mixed"
                    n_tok = (len(dseqs) * steps + drafted
                             + sum(len(p.chunk) for p in served))
                else:
                    # the halves publish separately, so observers fitting
                    # per-kind step times keep clean samples
                    t1 = time.monotonic()
                    self._publish_fpm("decode", t1 - t0, len(dseqs) + drafted)
                    for p in plan.prefills:
                        self._run_prefill_inner(p)
                    kind, t0 = "prefill", t1
                    n_tok = sum(len(p.chunk) for p in plan.prefills)
            else:
                drafted = sum(len(s.spec_draft) for s in plan.seqs)
                if not drafted or self._run_spec_verify(plan, []) is None:
                    drafted = 0
                    self._run_decode_inner(plan)
                kind, n_tok = "decode", len(plan.seqs) + drafted
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
            return
        self._publish_fpm(kind, time.monotonic() - t0, n_tok)
        self._publish_kv_events()

    def _publish_fpm(self, kind: str, wall: float, n_tok: int) -> None:
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
            plan.chunk, plan.start_pos, seq.pages, prior_len=plan.start_pos)
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
            prompt_lens=[s.n_prompt0 for s in seqs], **kw)
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
            [s.pages for s in seqs], _sampling_params(seqs), step0, gamma=gamma)
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
        prefills = list(plan.prefills)
        while True:
            try:
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

    def _run_spec_verify(self, dplan: DecodePlan, prefills):
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
        fork released, and the caller runs the plain path)."""
        seqs = dplan.seqs
        drafts = [list(s.spec_draft) for s in seqs]
        trees = [list(s.spec_tree) for s in seqs]
        for s in seqs:
            s.spec_draft = []  # consumed (or shed) either way
            s.spec_tree = []
        tokens = [s.tokens[-1] for s in seqs]
        positions = [s.computed_len for s in seqs]
        tables = [s.pages for s in seqs]
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
        try:
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

    # -- KVBM G2 tier (step-thread callbacks) -------------------------------
    def _offload_page(self, page: int, block_hash: int, parent: Optional[int]) -> None:
        """Device page being evicted → copy its KV to the host tier."""
        k, v = kv_payload_to_arrays(self.runner.export_pages([page]))
        self.host_pool.put([block_hash], [parent], k, v)
        self._host_events.append(KvEvent("store", [block_hash], parent, tier="host"))

    def _on_host_evicted(self, hashes: List[int]) -> None:
        self._host_events.append(KvEvent("remove", hashes, tier="host"))

    def _onboard_from_host(self, pages: List[int], hashes: List[int],
                           seq: Optional[Sequence] = None) -> bool:
        """Host-tier blocks → device pages during admission, imported in
        `onboard_layer_groups` layer slabs. Returns False when a matched
        block was evicted between match and get: the scheduler then
        recomputes instead of trusting a partial import."""
        t0 = time.perf_counter()
        try:
            k, v = self.host_pool.get(hashes)
        except KeyError:
            log.info("host-tier block evicted before onboard; recomputing")
            return False
        if seq is not None:
            seq.onboard_tier = "G2"
        t1 = time.perf_counter()
        payload = kv_arrays_to_payload(k, v)
        t2 = time.perf_counter()
        self.runner.import_pages(pages, 0, payload,
                                 layer_groups=self.onboard_layer_groups)
        t3 = time.perf_counter()
        st = self.onboard_stats
        st["onboards"] += 1
        st["blocks"] += len(hashes)
        st["seconds"] += t3 - t0
        st["get_s"] += t1 - t0  # host blocks stacked
        st["wire_s"] += t2 - t1  # stacked pages to wire bytes
        st["import_s"] += t3 - t2  # bytes to device pages
        return True

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
             "prior": p.start_pos} for p in prefills]


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
