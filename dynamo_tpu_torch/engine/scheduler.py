"""Continuous-batching scheduler with chunked prefill, prefix-cache reuse,
and recompute-preemption.

Pure host logic, copied from dynamo_tpu/engine/scheduler.py. A
sequence's hash chain is seeded by `request_seed(adapter, mm_seed)` (its
LoRA adapter and multimodal content each fork the lineage), so equal
tokens under different adapters never share cache blocks, here or in the
lower KV tiers, which key on the same hashes. Fork-on-branch (`adopt_branch`,
n > 1 sampling) and the guided and logit-bias fields are in. Disaggregation (park,
release_parked, admit_with_kv) and the G2 host-tier continuation of
`_try_allocate` are in. Speculative drafts stay, linear and tree: the
engine proposes them before planning, the scheduler trims them to the
mixed token pool and the ragged dispatch's sampled rows (a tree's extra
branches shed first), and reserves their KV slots. What stays
plans exactly as the reference does, so both engines see the same
PrefillPlan / DecodePlan / MixedPlan sequence for the same requests.

Invariants:
- `computed_len` = tokens whose KV is in the pool. While RUNNING,
  computed_len == len(tokens) - 1 (the newest sampled token's KV is written
  by the next decode step).
- prefix-matched pages are complete and shared (read-only); writes happen
  only at positions >= computed_len, which always land on unshared pages.
"""

from __future__ import annotations

import logging
import time
from collections import deque
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Dict, List, Optional

from dynamo_tpu_torch.engine.kv_pool import NoSpace, PagePool
from dynamo_tpu_torch.tokens.hashing import block_hashes, hash_block, request_seed

log = logging.getLogger("dynamo_tpu_torch.engine.scheduler")


class SeqState(Enum):
    WAITING = "waiting"
    PREFILL = "prefill"
    RUNNING = "running"
    FINISHED = "finished"


def _chain_seed(seq: "Sequence") -> Optional[int]:
    """The hash chain's seed: LoRA adapters and multimodal content each
    fork the block lineage (K/V depend on them)."""
    return request_seed(seq.adapter, seq.mm_seed)


@dataclass
class Sequence:
    request_id: str
    prompt: List[int]
    sampling: Dict[str, Any]
    stop: Dict[str, Any]
    arrival: float = 0.0
    # disaggregation roles: None = aggregated; "prefill" = compute KV + the
    # first token, then park; "decode" = KV arrives by transfer, no prefill
    disagg: Optional[str] = None
    kv_import: Any = None  # page payload for disagg-decode admission
    adapter: Optional[str] = None  # LoRA adapter name (None = base model)
    adapter_idx: int = 0  # its slot, resolved by the engine at admission
    mm_seed: Optional[int] = None  # multimodal content hash (chain seed)
    logit_bias: Any = None  # [[token_id, bias], ...] (OpenAI logit_bias)
    # guided decoding: wire spec (dict), compiled GuidedMatcher, DFA state
    guided: Any = None
    guided_m: Any = None
    guided_s: int = 0
    state: SeqState = SeqState.WAITING
    tokens: List[int] = field(default_factory=list)  # prompt + generated
    pages: List[int] = field(default_factory=list)
    computed_len: int = 0
    n_shared_pages: int = 0  # leading pages from prefix-cache hits
    hash_chain: List[int] = field(default_factory=list)  # registered block hashes
    finish_reason: Optional[str] = None
    n_preemptions: int = 0
    n_prompt0: int = 0  # original prompt length (preemption rewrites prompt)
    # latency spine: phase durations attached to the final emitted item
    phases: Dict[str, float] = field(default_factory=dict)
    itl: List[float] = field(default_factory=list)  # bounded ITL samples
    t_last_emit: float = 0.0  # monotonic time of the last token emission
    # deepest KV tier the admission onboard touched ("G2")
    onboard_tier: Optional[str] = None
    # the traceparent of the hop this request arrived under: the engine
    # rebuilds the worker's spans from the phase spine under it at finish
    tp: Optional[str] = None
    # speculative decoding: draft tokens proposed for THIS iteration
    # (engine sets before step_plan; the scheduler trims them to the
    # mixed token budget; the engine consumes and clears after verify)
    spec_draft: List[int] = field(default_factory=list)
    # tree speculation: extra candidate branches beyond spec_draft (branch
    # 0), each verified as its own row on a forked page table; charged
    # len + 1 tokens each and shed before the primary draft is trimmed
    spec_tree: List[List[int]] = field(default_factory=list)
    # fork-on-branch (n > 1 sampling): the parent carries n_branches; each
    # forked sibling carries branch_of=<parent request_id> and its choice
    # index, and shares the parent's trunk pages copy-on-write
    n_branches: int = 1
    branch_of: Optional[str] = None
    branch_index: int = 0
    # set once the parent's first prefill forked (or failed to fork) its
    # siblings: a preempted parent re-prefills and must not fork again
    branches_spawned: bool = False

    @property
    def n_generated(self) -> int:
        return len(self.tokens) - self.n_prompt0


@dataclass
class PrefillPlan:
    seq: Sequence
    chunk: List[int]
    start_pos: int
    is_last_chunk: bool


@dataclass
class DecodePlan:
    seqs: List[Sequence]
    n_steps: int = 1  # fused decode iterations (multi-step decode)


@dataclass
class MixedPlan:
    """One engine iteration that co-schedules the running decode batch
    with a token-budgeted set of prefill chunks from distinct PREFILL
    sequences (combined length capped at `mixed_prefill_tokens`). Decode
    runs first; the engine fuses both halves into one dispatch where it
    can (InferenceEngine.fused_mixed)."""

    prefills: List[PrefillPlan]
    decode: DecodePlan


class Scheduler:
    def __init__(
        self,
        pool: PagePool,
        *,
        max_batch: int = 64,
        chunk_size: int = 512,
        max_seq_pages: int = 128,
        enable_prefix_cache: bool = True,
        decode_steps: int = 1,
        mixed_prefill_tokens: int = 256,
        mixed_prefill_seqs: int = 8,
        mixed_min_chunk: int = 16,
        host_tier=None,  # HostKvPool-like: .match(hashes) -> n
        host_onboard=None,  # cb(pages, hashes, seq=None) -> bool (G2→G1)
        max_seq_tokens: int = 0,  # model context length (0 = page cap only)
        spec_max_tokens: int = 0,  # per-iteration cap on speculative
        #   draft tokens (0 = bounded by the mixed pool leftover alone)
        spec_seg_budget: int = 0,  # sampled-row slots one ragged dispatch
        #   offers (decode rows + chunks + verify tokens); 0 = unbounded
    ):
        self.pool = pool
        self.max_batch = max_batch
        self.chunk_size = chunk_size
        self.max_seq_pages = max_seq_pages
        # page capacity bounds what fits; max_seq_len bounds what the rope
        # table makes numerically meaningful
        self.max_seq_tokens = int(max_seq_tokens or 0)
        self.enable_prefix_cache = enable_prefix_cache
        self.decode_steps = decode_steps
        # co-scheduling budget: the POOL of prefill tokens per iteration
        # while decode work exists, fair-shared across up to
        # `mixed_prefill_seqs` PREFILL sequences (0 = strict prefill-first)
        self.mixed_prefill_tokens = mixed_prefill_tokens
        self.mixed_prefill_seqs = max(1, mixed_prefill_seqs)
        self.mixed_min_chunk = max(1, mixed_min_chunk)
        self.spec_max_tokens = max(0, spec_max_tokens)
        self.spec_seg_budget = max(0, spec_seg_budget)
        self.host_tier = host_tier
        self.host_onboard = host_onboard
        self.waiting: deque[Sequence] = deque()
        self.active: List[Sequence] = []
        # prompt tokens served from the prefix cache instead of prefilled
        self.reused_prefix_tokens = 0

    # -- API ---------------------------------------------------------------
    def add(self, seq: Sequence) -> None:
        seq.tokens = list(seq.prompt)
        seq.n_prompt0 = len(seq.prompt)
        self.waiting.append(seq)

    def abort(self, request_id: str) -> None:
        for s in self.active:
            if s.request_id == request_id:
                self._finish(s, "cancelled")
                return
        for s in list(self.waiting):
            if s.request_id == request_id:
                s.state = SeqState.FINISHED
                s.finish_reason = "cancelled"
                self.waiting.remove(s)
                return

    def has_work(self) -> bool:
        return bool(self.waiting or self.active)

    def step_plan(self) -> Optional[PrefillPlan | DecodePlan | MixedPlan]:
        """Admit what fits, then plan this iteration's work: a lone
        prefill chunk while nothing decodes, else the whole running batch
        decodes and a token-budgeted set of prefill chunks rides along."""
        self._admit()
        prefill_seqs = [s for s in self.active if s.state == SeqState.PREFILL]
        prefill_seq = prefill_seqs[0] if prefill_seqs else None
        running = [s for s in self.active if s.state == SeqState.RUNNING]
        if prefill_seq is not None and (
            not running or self.mixed_prefill_tokens <= 0
        ):
            return self._plan_prefill(prefill_seq)
        if not running:
            return None
        # fuse up to decode_steps iterations, bounded by the per-seq budget
        # remaining (max_tokens / context cap) so fused steps aren't wasted
        cap = self.max_seq_pages * self.pool.page_size
        if self.max_seq_tokens:
            cap = min(cap, self.max_seq_tokens)
        n_steps = self.decode_steps
        for s in running:
            budget = min(
                cap - s.computed_len,
                int((s.stop or {}).get("max_tokens", 1 << 30)) - s.n_generated,
            )
            n_steps = min(n_steps, max(1, budget))
        # prefill chunks claim the pool first: verify rows are charged from
        # its leftover only
        pplans = self._plan_prefills(prefill_seqs) if prefill_seq else []
        self._trim_spec(running, pplans, cap)
        if sum(self._spec_cost(s) for s in running):
            # a verify dispatch already advances speculating rows by up to
            # K+1: no fused multi-step decode beside it
            n_steps = 1
        running = self._ensure_decode_capacity(running, lookahead=n_steps)
        if not running:
            if prefill_seq is not None:
                return self._plan_prefill(prefill_seq)
            return None
        if prefill_seq is None:
            return DecodePlan(running, n_steps)
        return MixedPlan(prefills=pplans, decode=DecodePlan(running, n_steps))

    @staticmethod
    def _spec_cost(s: Sequence) -> int:
        """Charged verify tokens for one sequence: its primary draft's
        tokens (the +1 verify position is the row's own decode slot) and
        every token of every extra tree branch (a branch row has no decode
        slot: all len(b) + 1 of its entries are extra tokens and sampled
        rows)."""
        return len(s.spec_draft) + sum(len(b) + 1 for b in s.spec_tree)

    def _trim_spec(
        self, running: List[Sequence], pplans: List[PrefillPlan], cap: int
    ) -> None:
        """Fit this iteration's draft tokens to the budgets that keep the
        verify dispatch inside the registered T bucket: drafted tokens
        charge the `mixed_prefill_tokens` pool after the prefill chunks
        (the verified +1 token per row is the row's own decode slot), the
        optional per-iteration cap, and the ragged dispatch's sampled-row
        slots. Per sequence, a draft is also clipped to the page/context
        cap and to the tokens the request may still generate."""
        if self.mixed_prefill_tokens <= 0:
            for s in running:
                s.spec_draft = []
                s.spec_tree = []
            return
        left = self.mixed_prefill_tokens - sum(len(p.chunk) for p in pplans)
        if self.spec_max_tokens:
            left = min(left, self.spec_max_tokens)
        seg_left = None
        if self.spec_seg_budget:
            # one sampled-row slot per decode row and per chunk; each
            # drafted token needs one more (its verify position is gathered)
            seg_left = self.spec_seg_budget - len(running) - len(pplans)
        for s in running:
            if not s.spec_draft:
                s.spec_tree = []  # branches never ride without a primary
                continue
            take = min(len(s.spec_draft), max(0, left))
            if seg_left is not None:
                take = min(take, max(0, seg_left))
            # KV for fed draft tokens lands at computed_len+1 .. +take
            take = min(take, max(0, cap - s.computed_len - 1))
            remaining = (
                int((s.stop or {}).get("max_tokens", 1 << 30)) - s.n_generated
            )
            take = min(take, max(0, remaining))
            if take < len(s.spec_draft):
                # the primary draft itself is trimmed: branches are
                # optional work, shed them all first
                s.spec_tree = []
            s.spec_draft = s.spec_draft[:take]
            left -= take
            if seg_left is not None:
                seg_left -= take
            # extra branches (propose_tree clips each to the primary, whose
            # page capacity is the fork's): len(b) + 1 tokens and sampled
            # rows each (and a ragged segment); whole branches shed when
            # the leftover cannot carry them
            kept: List[List[int]] = []
            for b in s.spec_tree:
                cost = len(b) + 1
                if cost > max(0, left) or (
                        seg_left is not None and cost > max(0, seg_left)):
                    continue
                kept.append(b)
                left -= cost
                if seg_left is not None:
                    seg_left -= cost
            s.spec_tree = kept

    # -- admission ---------------------------------------------------------
    def _admit(self) -> None:
        while self.waiting and len(self.active) < self.max_batch:
            seq = self.waiting[0]
            if not self._try_allocate(seq):
                break
            self.waiting.popleft()
            self.active.append(seq)
            seq.state = SeqState.PREFILL
            if seq.arrival and "queue_wait_s" not in seq.phases:
                seq.phases["queue_wait_s"] = max(
                    0.0, time.monotonic() - seq.arrival)

    def _try_allocate(self, seq: Sequence) -> bool:
        PS = self.pool.page_size
        prompt = seq.prompt
        matched_pages: List[int] = []
        hashes: List[int] = []
        use_cache = self.enable_prefix_cache and seq.n_preemptions == 0
        max_shared = (len(prompt) - 1) // PS
        if use_cache:
            matched_pages, hashes = self.pool.match_prefix(prompt, _chain_seed(seq))
            # never share the page containing the final prompt token: its
            # logits must be recomputed, so cap the match below it
            while len(matched_pages) > max_shared:
                self.pool.release([matched_pages.pop()])
                hashes.pop()

        # G2 host-tier continuation: blocks beyond the device match that the
        # host pool holds get onboarded into freshly-allocated pages
        host_n = 0
        host_hashes: List[int] = []
        if use_cache and self.host_tier is not None and self.host_onboard is not None:
            candidates = block_hashes(prompt, PS, _chain_seed(seq))[
                len(matched_pages):max_shared]
            host_n = self.host_tier.match(candidates)
            host_hashes = candidates[:host_n]

        match_len = len(matched_pages) * PS
        # pages for the rest of the prompt plus the first generated token
        need = -(-(len(prompt) + 1) // PS) - len(matched_pages)
        try:
            fresh = self.pool.alloc(need)
        except NoSpace:
            self.pool.release(matched_pages)
            return False

        if host_n:
            t_onboard = time.monotonic()
            if self.host_onboard(fresh[:host_n], host_hashes, seq):
                # latency spine: lower-tier KV promotion paid at admission
                seq.phases["kv_onboard_s"] = (
                    seq.phases.get("kv_onboard_s", 0.0)
                    + (time.monotonic() - t_onboard))
                parent = hashes[-1] if hashes else _chain_seed(seq)
                for page, h in zip(fresh[:host_n], host_hashes):
                    canonical = self.pool.register(page, h, parent)
                    if canonical != page:  # raced with another registration
                        self.pool._ref_inc(canonical)
                        self.pool.release([page])
                        fresh[fresh.index(page)] = canonical
                    parent = h
                hashes = hashes + host_hashes
                match_len = (len(matched_pages) + host_n) * PS

        seq.pages = matched_pages + fresh
        seq.n_shared_pages = len(matched_pages)
        seq.hash_chain = hashes
        seq.computed_len = match_len
        self.reused_prefix_tokens += match_len
        return True

    # -- prefill -----------------------------------------------------------
    def _plan_prefill(
        self, seq: Sequence, max_tokens: Optional[int] = None
    ) -> PrefillPlan:
        start = seq.computed_len
        budget = self.chunk_size if max_tokens is None else min(
            self.chunk_size, max(1, max_tokens)
        )
        end = min(len(seq.prompt), start + budget)
        return PrefillPlan(
            seq=seq,
            chunk=seq.prompt[start:end],
            start_pos=start,
            is_last_chunk=end == len(seq.prompt),
        )

    def _plan_prefills(self, cands: List[Sequence]) -> List[PrefillPlan]:
        """Fair-share the `mixed_prefill_tokens` pool across up to
        `mixed_prefill_seqs` PREFILL sequences, oldest first: each gets
        at least `mixed_min_chunk` tokens and at most its equal share of
        what is left."""
        plans: List[PrefillPlan] = []
        left = self.mixed_prefill_tokens
        for i, seq in enumerate(cands):
            if left <= 0 or len(plans) >= self.mixed_prefill_seqs:
                break
            slots = min(len(cands) - i, self.mixed_prefill_seqs - len(plans))
            share = max(self.mixed_min_chunk, left // max(1, slots))
            plan = self._plan_prefill(seq, max_tokens=min(share, left))
            if plan.chunk:
                plans.append(plan)
                left -= len(plan.chunk)
        return plans

    def complete_prefill(self, plan: PrefillPlan) -> None:
        seq = plan.seq
        seq.computed_len += len(plan.chunk)
        self._register_complete_pages(seq)
        if plan.is_last_chunk:
            seq.state = SeqState.RUNNING

    def park(self, seq: Sequence) -> None:
        """Disagg-prefill: KV computed; hold pages (still ref'd) for the
        decode worker's pull, out of the active set."""
        seq.state = SeqState.FINISHED
        seq.finish_reason = "prefill_complete"
        if seq in self.active:
            self.active.remove(seq)

    def release_parked(self, seq: Sequence) -> None:
        self.pool.release(seq.pages)
        seq.pages = []

    def admit_with_kv(self, seq: Sequence) -> bool:
        """Disagg-decode admission: allocate pages for the full (computed)
        prompt; the caller imports transferred KV into the non-shared pages
        and the sequence starts RUNNING with no prefill pass.

        The prompt's last token is the prefill-sampled token whose KV is
        *not* yet computed, so computed_len = len(prompt) - 1."""
        if len(self.active) >= self.max_batch:
            return False
        if not self._try_allocate(seq):
            return False
        seq.computed_len = len(seq.prompt) - 1
        seq.state = SeqState.RUNNING
        self.active.append(seq)
        self._register_complete_pages(seq)
        return True

    # -- decode ------------------------------------------------------------
    def adopt_branch(self, branch: Sequence, parent: Sequence,
                     pages: List[int]) -> bool:
        """Admit a fork-on-branch sibling straight into the running batch.
        The caller already fork_table'd the parent's pages (the trunk
        shared by reference, the partial tail page copied), so the branch
        starts where the parent is: same computed KV, same hash chain, one
        prefill-sampled token away from its first decode step."""
        if len(self.active) >= self.max_batch:
            self.pool.release(pages)
            return False
        branch.tokens = list(parent.tokens)
        branch.n_prompt0 = parent.n_prompt0
        branch.pages = pages
        branch.computed_len = parent.computed_len
        branch.n_shared_pages = parent.n_shared_pages
        branch.hash_chain = list(parent.hash_chain)
        branch.state = SeqState.RUNNING
        self.active.append(branch)
        return True

    def _ensure_decode_capacity(
        self, running: List[Sequence], lookahead: int = 1
    ) -> List[Sequence]:
        """Each running seq needs page slots for positions computed_len ..
        computed_len+lookahead-1 (a speculating row: its draft length + 1);
        on pool exhaustion preempt the youngest sequences
        (recompute-style)."""
        survivors: List[Sequence] = []
        for seq in running:
            if seq.state != SeqState.RUNNING:  # preempted by an earlier turn
                continue
            last_pos = seq.computed_len + max(
                lookahead, len(seq.spec_draft) + 1) - 1
            while True:
                need = last_pos // self.pool.page_size + 1 - len(seq.pages)
                if need <= 0:
                    survivors.append(seq)
                    break
                try:
                    seq.pages.extend(self.pool.alloc(need))
                    survivors.append(seq)
                    break
                except NoSpace:
                    victim = self._pick_victim(exclude=seq)
                    if victim is None:
                        self._preempt(seq)
                        break
                    self._preempt(victim)
                    if victim in survivors:
                        survivors.remove(victim)
        return survivors

    def _pick_victim(self, exclude: Sequence) -> Optional[Sequence]:
        for seq in reversed(self.active):  # youngest first
            if seq is not exclude and seq.state == SeqState.RUNNING:
                return seq
        return None

    def _preempt(self, seq: Sequence) -> None:
        log.info("preempting %s (recompute)", seq.request_id)
        self.pool.release(seq.pages)
        seq.pages = []
        seq.hash_chain = []
        seq.computed_len = 0
        seq.n_preemptions += 1
        seq.state = SeqState.WAITING
        seq.spec_draft = []  # stale drafts must not ride the re-admission
        seq.spec_tree = []
        # re-admit with prompt = all tokens so far (already-emitted ones are
        # not re-emitted; generation resumes with the next sampled token)
        seq.prompt = list(seq.tokens)
        self.active.remove(seq)
        self.waiting.appendleft(seq)

    def complete_decode(
        self, seq: Sequence, new_token: int, advance_computed: bool = True
    ) -> Optional[str]:
        """Append a sampled token; returns finish_reason if the engine-level
        stop fires. advance_computed=True for decode steps (the step wrote
        the fed token's KV at position computed_len); False for the token
        sampled from prefill logits (its KV is written by the next decode
        step)."""
        if advance_computed:
            seq.computed_len += 1
        seq.tokens.append(new_token)
        self._register_complete_pages(seq)

        stop = seq.stop or {}
        reason = None
        if (
            not stop.get("ignore_eos")
            and new_token in (stop.get("stop_ids") or [])
            and seq.n_generated > int(stop.get("min_tokens") or 0)
        ):
            reason = "stop"
        elif seq.n_generated >= int(stop.get("max_tokens", 1 << 30)):
            reason = "length"
        elif len(seq.tokens) >= self.max_seq_pages * self.pool.page_size:
            reason = "length"
        elif self.max_seq_tokens and len(seq.tokens) >= self.max_seq_tokens:
            reason = "length"
        if reason:
            self._finish(seq, reason)
        return reason

    def _finish(self, seq: Sequence, reason: str) -> None:
        seq.state = SeqState.FINISHED
        seq.finish_reason = reason
        self.pool.release(seq.pages)
        seq.pages = []
        seq.spec_draft = []
        seq.spec_tree = []
        if seq in self.active:
            self.active.remove(seq)

    # -- prefix registration ----------------------------------------------
    def _register_complete_pages(self, seq: Sequence) -> None:
        """Register pages that became complete (content-addressed) so other
        requests can share them."""
        if not self.enable_prefix_cache:
            return
        PS = self.pool.page_size
        n_complete = min(seq.computed_len // PS, len(seq.pages))
        while len(seq.hash_chain) < n_complete:
            i = len(seq.hash_chain)
            parent = seq.hash_chain[-1] if seq.hash_chain else _chain_seed(seq)
            h = hash_block(parent, seq.tokens[i * PS : (i + 1) * PS])
            canonical = self.pool.register(seq.pages[i], h, parent)
            if canonical != seq.pages[i]:
                # another seq registered this block first; swap to the
                # canonical page and free ours
                self.pool._ref_inc(canonical)
                self.pool.release([seq.pages[i]])
                seq.pages[i] = canonical
            seq.hash_chain.append(h)
