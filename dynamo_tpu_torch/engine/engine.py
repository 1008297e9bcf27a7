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
Not ported yet: tree and draft-model speculation, guided decoding,
logprobs, penalties, logit bias, n > 1 branches, LoRA, multimodal input,
KV tiers and disaggregation; requests asking for those are refused with
an "error" item.
"""

from __future__ import annotations

import asyncio
import hashlib
import logging
import os
import queue as thread_queue
import threading
import time
from typing import Any, AsyncIterator, Dict, List, Optional

import torch

from dynamo_tpu_torch.engine.kv_pool import PagePool
from dynamo_tpu_torch.engine.model_runner import BucketOverflowError
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
from dynamo_tpu_torch.ops.ragged_paged_attention import RAGGED_MAX_SEGS
from dynamo_tpu_torch.runtime.context import Context

log = logging.getLogger("dynamo_tpu_torch.engine")

# per-request ITL sample cap: bounds the spine's memory on long generations
_ITL_CAP = 512

# request fields and sampling options of features this port does not
# serve yet: refused up front rather than silently ignored
_UNSUPPORTED_FIELDS = ("guided", "logit_bias", "adapter", "mm", "kv_import",
                       "kv_remote_host")
_UNSUPPORTED_SAMPLING = {"logprobs": None, "repetition_penalty": 1.0,
                         "frequency_penalty": 0.0, "presence_penalty": 0.0,
                         "n": 1}


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
    if annotations.get("disagg") or annotations.get("kind") == "embedding":
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
        seq = Sequence(
            request_id=rid,
            prompt=[int(t) for t in request.get("token_ids") or [0]],
            sampling=request.get("sampling") or {},
            stop=request.get("stop") or {},
            arrival=time.monotonic(),
        )
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

    def _loop_once(self) -> None:
        self._drain_inbox()
        self._propose_drafts()
        plan = self.scheduler.step_plan()
        if plan is None:
            if not self.scheduler.has_work():
                time.sleep(self.IDLE_SLEEP_S)
            return
        decode_done = False
        try:
            if isinstance(plan, PrefillPlan):
                self._run_prefill_inner(plan)
            elif isinstance(plan, MixedPlan):
                # of the reference's fusibility gates only the switch
                # applies: requests with guided decoding, logit bias,
                # logprobs, penalties, LoRA or multimodal input, which the
                # fused dispatch does not carry, are refused at admission
                fused = self.fused_mixed
                # the decode half: verify rows (with the chunks when fused),
                # else the fused dispatch, else plain decode first, so ITL
                # never waits behind prompt processing. A verify that
                # returns None shed its drafts (bucket overflow).
                chunk_logits = None
                if any(s.spec_draft for s in plan.decode.seqs):
                    chunk_logits = self._run_spec_verify(
                        plan.decode, plan.prefills if fused else [])
                if chunk_logits is None and fused:
                    chunk_logits = self._run_mixed_dispatch(plan)
                if chunk_logits is None:
                    self._run_decode_inner(plan.decode)
                # decode tokens are emitted: from here on a failure only
                # fails the prefill sequences
                decode_done = True
                if fused:
                    self._finish_packed_prefills(
                        plan.prefills[:len(chunk_logits)], chunk_logits)
                else:
                    for p in plan.prefills:
                        self._run_prefill_inner(p)
            elif (not any(s.spec_draft for s in plan.seqs)
                  or self._run_spec_verify(plan, []) is None):
                self._run_decode_inner(plan)
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

    # -- emission ----------------------------------------------------------
    def _emit(self, seq: Sequence, token_ids: List[int], finish: Optional[str]) -> None:
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
        item = engine_output(token_ids, finish)
        if finish:
            # the final item carries the request's phase spine downstream
            phases: Dict[str, Any] = dict(seq.phases)
            if seq.arrival:
                phases["e2e_s"] = max(0.0, time.monotonic() - seq.arrival)
            if seq.itl:
                phases["itl_s"] = list(seq.itl)
            item["phases"] = phases
        entry = self._streams.get(seq.request_id)
        if entry is None:
            return
        out, loop = entry
        loop.call_soon_threadsafe(out.put_nowait, item)


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
