"""InferenceEngine: the serving engine as an async generator over requests.

Port of dynamo_tpu/engine/engine.py, reduced to the main path: requests
enter through `generate()` (PreprocessedRequest in, engine-output items
out), a dedicated step thread runs the scheduler/runner loop, and sampled
tokens flow back through per-request asyncio queues. A MixedPlan runs
fused on a card (the decode batch's steps and every packed prefill chunk
in one ragged dispatch plus the decode loop, one token readback) and
unfused on the CPU (decode first, then each chunk), with DYN_FUSED_MIXED
overriding, as in the reference. Linear n-gram speculative decoding
(`spec_ngram`) verifies host-proposed drafts on the same ragged dispatch.
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
Not ported yet: tree and draft-model speculation, guided decoding,
logprobs, penalties, logit bias, n > 1 branches, LoRA, multimodal input,
remote host-tier pulls and the G3/G4 tiers; requests asking for those are
refused with an "error" item.
"""

from __future__ import annotations

import asyncio
import hashlib
import logging
import os
import queue as thread_queue
import threading
import time
from dataclasses import dataclass
from typing import Any, AsyncIterator, Dict, List, Optional

import torch

from dynamo_tpu_torch.engine.kv_pool import KvEvent, PagePool
from dynamo_tpu_torch.engine.model_runner import (
    BucketOverflowError,
    kv_arrays_to_payload,
    kv_payload_incompatible,
    kv_payload_to_arrays,
)
from dynamo_tpu_torch.engine.ngram_draft import accept_deterministic
from dynamo_tpu_torch.engine.ngram_draft import propose as ngram_propose
from dynamo_tpu_torch.engine.scheduler import (
    DecodePlan,
    MixedPlan,
    PrefillPlan,
    Scheduler,
    Sequence,
    SeqState,
)
from dynamo_tpu_torch.kvbm.host_pool import HostKvPool
from dynamo_tpu_torch.ops.ragged_paged_attention import RAGGED_MAX_SEGS
from dynamo_tpu_torch.runtime.context import Context

log = logging.getLogger("dynamo_tpu_torch.engine")

# per-request ITL sample cap: bounds the spine's memory on long generations
_ITL_CAP = 512

# request fields and sampling options of features this port does not
# serve yet: refused up front rather than silently ignored
_UNSUPPORTED_FIELDS = ("guided", "logit_bias", "adapter", "mm",
                       "kv_remote_host")
_UNSUPPORTED_SAMPLING = {"logprobs": None, "repetition_penalty": 1.0,
                         "frequency_penalty": 0.0, "presence_penalty": 0.0,
                         "n": 1}


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
    if (annotations.get("disagg") not in (None, "prefill", "decode")
            or annotations.get("kind") == "embedding"):
        return "annotations"
    sampling = request.get("sampling") or {}
    for name, neutral in _UNSUPPORTED_SAMPLING.items():
        if sampling.get(name) not in (None, neutral):
            return f"sampling.{name}"
    return None


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
        host_kv_blocks: int = 0,  # G2 host-tier capacity (0 = disabled)
        onboard_layer_groups: int = 1,  # stream tier onboarding in this
        #   many contiguous layer groups (FlowKV-style overlap of transfer
        #   with the first layers' compute; 1 = whole-sequence import)
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
        self.pool = PagePool(runner.num_pages, runner.page_size)
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
        self.spec_stats = {"drafted": 0, "accepted": 0, "rejected": 0,
                           "verify_rows": 0, "verify_iters": 0,
                           "spec_emitted": 0}
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
        seq = Sequence(
            request_id=rid,
            prompt=[int(t) for t in request.get("token_ids") or [0]],
            sampling=request.get("sampling") or {},
            stop=request.get("stop") or {},
            arrival=time.monotonic(),
            disagg=annotations.get("disagg"),
            kv_import=request.get("kv_import"),
        )
        # latency spine: upstream hops (the disagg adapter's KV fetch)
        # stamped their durations into ctx.metadata["phases"]
        upstream = context.metadata.get("phases")
        if isinstance(upstream, dict):
            seq.phases.update({k: float(v) for k, v in upstream.items()
                               if isinstance(v, (int, float))})
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
        self._admit_kv_pending()
        self._expire_parked()

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
                # of the reference's fusibility gates only the switch
                # applies: requests with guided decoding, logit bias,
                # logprobs, penalties, LoRA or multimodal input, which the
                # fused dispatch does not carry, are refused at admission
                fused = self.fused_mixed
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
        self.scheduler.complete_prefill(plan)
        self._finish_prefill(plan, logits)

    def _finish_prefill(self, plan: PrefillPlan, logits) -> None:
        """On the last chunk: sample the first token and start the
        sequence RUNNING."""
        seq = plan.seq
        if not plan.is_last_chunk:
            return
        token = self.runner.sample_one(
            logits, _sampling_params([seq]), self._next_step())
        if seq.disagg == "prefill":
            # disagg: first token + transfer handle; the pages stay held
            # for the decode engine's pull
            self.scheduler.park(seq)
            self._parked[seq.request_id] = (
                seq, time.monotonic() + self.parked_ttl_s)
            self._emit(seq, [token], "prefill_complete", kv_transfer={
                "request_id": seq.request_id,
                "prompt_len": len(seq.prompt),
                "first_token": token,
            })
            return
        reason = self.scheduler.complete_decode(seq, token, advance_computed=False)
        self._emit(seq, [token] if reason != "stop" else [], reason)

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
        host sync per plan)."""
        seqs = plan.seqs
        T = plan.n_steps
        step0 = self._step_counter + 1
        self._step_counter += T
        sampled = self.runner.decode_multi(
            T, [s.tokens[-1] for s in seqs], [s.computed_len for s in seqs],
            [s.pages for s in seqs], _sampling_params(seqs), step0,
        )
        for i, seq in enumerate(seqs):
            self._commit(seq, sampled[i, :T])

    def _commit(self, seq: Sequence, tokens) -> None:
        """Append decoded tokens until one finishes the sequence (the rest
        are discarded) and emit what was committed."""
        emit: List[int] = []
        reason = None
        for token in tokens:
            token = int(token)
            reason = self.scheduler.complete_decode(seq, token)
            if reason != "stop":
                emit.append(token)
            if reason:
                break
        self._emit(seq, emit, reason)

    # -- fused mixed dispatch ----------------------------------------------
    def _run_mixed_dispatch(self, plan: MixedPlan):
        """The fused dispatch and its decode half's bookkeeping. A pack
        the runner cannot shape sheds its newest chunk and retries; shed
        chunks were never completed, so the scheduler plans them again
        next iteration. Returns the served chunks' last-token logits, one
        row per chunk from the front of plan.prefills."""
        seqs = plan.decode.seqs
        T = plan.decode.n_steps
        tokens = [s.tokens[-1] for s in seqs]
        positions = [s.computed_len for s in seqs]
        tables = [s.pages for s in seqs]
        step0 = self._step_counter + 1
        self._step_counter += T
        prefills = list(plan.prefills)
        while True:
            try:
                sampled, chunk_logits = self.runner.decode_multi_with_prefills(
                    T, tokens, positions, tables, _sampling_params(seqs),
                    step0, _chunks(prefills))
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
        scheduler can charge them against the mixed pool: the host n-gram
        scan over each running sequence's own tokens."""
        for s in self.scheduler.active:
            if s.state == SeqState.RUNNING:
                s.spec_draft = (ngram_propose(s.tokens, self.spec_k)
                                if self.spec_ngram else [])

    def _run_spec_verify(self, dplan: DecodePlan, prefills):
        """One ragged dispatch verifying every speculating row's draft (a
        K+1-token segment: the last real token and the draft) beside the
        plain decode rows and, when fused, the packed prefill chunks.
        Acceptance emits target samples through the first mismatch (and
        the bonus token on a full match), so greedy output equals plain
        decode. Rejected drafts' KV lies past computed_len and is
        overwritten later. Returns the chunks' last-token logits, or None
        when the runner cannot shape the dispatch (the drafts are dropped
        and the caller runs the plain path)."""
        seqs = dplan.seqs
        drafts = [list(s.spec_draft) for s in seqs]
        for s in seqs:
            s.spec_draft = []  # consumed (or shed) either way
        step0 = self._next_step()
        try:
            rows, chunk_logits = self.runner.verify_spec(
                [s.tokens[-1] for s in seqs], [s.computed_len for s in seqs],
                [s.pages for s in seqs], drafts, _sampling_params(seqs),
                step0, chunks=_chunks(prefills))
        except BucketOverflowError as e:
            log.warning("spec verify overflows runner buckets (%s); dropping "
                        "this iteration's drafts", e)
            return None
        n_drafted = sum(len(d) for d in drafts)
        accepted = emitted_spec = 0
        for seq, draft, row in zip(seqs, drafts, rows):
            emitted = accept_deterministic(draft, row)
            if draft:
                accepted += len(emitted) - 1
                emitted_spec += len(emitted)
            self._commit(seq, emitted)
        st = self.spec_stats
        st["verify_iters"] += 1
        st["verify_rows"] += sum(1 for d in drafts if d)
        st["drafted"] += n_drafted
        st["accepted"] += accepted
        st["rejected"] += n_drafted - accepted
        st["spec_emitted"] += emitted_spec
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
              **extra: Any) -> None:
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
        entry = self._streams.get(seq.request_id)
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
    }
