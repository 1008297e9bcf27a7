"""InferenceEngine: the serving engine as an async generator over requests.

Port of dynamo_tpu/engine/engine.py, reduced to the main path: requests
enter through `generate()` (PreprocessedRequest in, engine-output items
out), a dedicated step thread runs the scheduler/runner loop, and sampled
tokens flow back through per-request asyncio queues. A MixedPlan runs
unfused, decode first and then each prefill chunk (the reference's
DYN_FUSED_MIXED=0 path). Not ported yet: the fused mixed dispatch,
speculative decoding, guided decoding, logprobs, penalties, logit bias,
n > 1 branches, LoRA, multimodal input, KV tiers and disaggregation;
requests asking for those are refused with an "error" item.
"""

from __future__ import annotations

import asyncio
import hashlib
import logging
import queue as thread_queue
import threading
import time
from typing import Any, AsyncIterator, Dict, List, Optional

import torch

from dynamo_tpu_torch.engine.kv_pool import PagePool
from dynamo_tpu_torch.engine.scheduler import (
    DecodePlan,
    MixedPlan,
    PrefillPlan,
    Scheduler,
    Sequence,
)
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
    # the reference engine's defaults, which its worker keeps: 4 fused
    # decode steps per plan, a 256-token prefill pool fair-shared over up
    # to 8 chunks of at least 16 tokens while decode runs
    DECODE_STEPS = 4
    MIXED_PREFILL_TOKENS = 256
    MIXED_PREFILL_SEQS = 8
    MIXED_MIN_CHUNK = 16
    IDLE_SLEEP_S = 0.002

    def __init__(self, runner, *, max_batch: int = 64, chunk_size: int = 512):
        self.runner = runner
        self.pool = PagePool(runner.num_pages, runner.page_size)
        self.scheduler = Scheduler(
            self.pool,
            max_batch=max_batch,
            chunk_size=chunk_size,
            max_seq_pages=runner.max_pages_per_seq,
            max_seq_tokens=runner.config.max_seq_len,
            decode_steps=self.DECODE_STEPS,
            mixed_prefill_tokens=self.MIXED_PREFILL_TOKENS,
            mixed_prefill_seqs=self.MIXED_PREFILL_SEQS,
            mixed_min_chunk=self.MIXED_MIN_CHUNK,
        )
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
                # decode first: ITL never waits behind prompt processing
                self._run_decode_inner(plan.decode)
                decode_done = True
                for p in plan.prefills:
                    self._run_prefill_inner(p)
            else:
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

    def _run_decode_inner(self, plan: DecodePlan) -> None:
        """plan.n_steps decode iterations with on-device token feedback (one
        host sync per plan). Tokens sampled past a stop are discarded."""
        seqs = plan.seqs
        T = plan.n_steps
        step0 = self._step_counter + 1
        self._step_counter += T
        sampled = self.runner.decode_multi(
            T, [s.tokens[-1] for s in seqs], [s.computed_len for s in seqs],
            [s.pages for s in seqs], _sampling_params(seqs), step0,
        )
        for i, seq in enumerate(seqs):
            emit: List[int] = []
            reason = None
            for j in range(T):
                token = int(sampled[i, j])
                reason = self.scheduler.complete_decode(seq, token)
                if reason != "stop":
                    emit.append(token)
                if reason:
                    break
            self._emit(seq, emit, reason)

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
