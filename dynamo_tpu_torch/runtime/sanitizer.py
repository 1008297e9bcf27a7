"""Runtime sanitizer: cheap invariant checks for serving.

Port of dynamo_tpu/runtime/sanitizer.py, armed with ``DYN_SAN=1`` or the
worker's ``--sanitize``:

- **sync guard** — wraps the steady-state decode and spec-verify
  dispatches (and nothing else: prefill and mixed stay unguarded, as in
  the reference) in ``torch.cuda.set_sync_debug_mode("error")`` once the
  engine is warm, restoring the previous mode on exit, so an implicit
  device-to-host sync that creeps into the step loop fails at the
  offending line. Known sync points run inside named
  :meth:`Sanitizer.allow_transfer` scopes checked against the
  reference's allowlist (``DEFAULT_ALLOWLIST``), which drop to
  ``"default"`` for their body; an unknown label is itself a violation.
  What the mode sees: syncs PyTorch issues (``.item()``, ``.cpu()`` /
  ``.tolist()`` / ``.numpy()`` of a CUDA tensor, a blocking host-to-device
  ``.to(device)`` / ``copy_`` from pageable or pinned memory,
  ``nonzero``, ``torch.cuda.synchronize`` and ``Stream.synchronize``).
  What it does not see: a ``cudaMemcpy`` or a synchronize inside one of
  the port's own ctypes kernel libraries, and ``Event.synchronize``.
  The mode is process-wide, not per thread (unlike ``jax.transfer_guard``),
  so while any sanitizer in the process has armed the guard, device work
  runs under one process-wide gate (:func:`device_gate`): each engine's
  step thread takes it for an iteration, and the first gated iteration
  waits for the iterations that began before the arming to end. No other
  thread of a worker touches the card while serving (kv_fetch exports,
  tier onboards and offloads, prefetch promotions and rl calls all run on
  a step thread through its inbox), so a guarded window never overlaps
  another thread's sync and a violation is always the guarded step
  thread's own.
- **shape tripwire** — the port's counterpart of the recompile tripwire:
  after ``warmup_steps`` iterations the runner's dispatch families
  (``ModelRunner._families``: distinct (kind, bucket) shapes per
  dispatch kind) are frozen; a new family or a new shape in a
  steady-state family afterwards is a violation. Families whose buckets
  follow the admitted load (``ADMISSION_FAMILIES``: prompt lengths,
  batch sizes, packs) are counted and logged, not fatal: the card
  compiles nothing per shape today. A kernel library built by
  ops/_build.py after warm-up is a violation too: a first-use ``nvcc``
  mid-serving stalls the step thread for seconds.
- **layout check** — at the warm transition, every param and KV pool of
  the runner must still sit on the runner's device with the dtype it was
  placed with (``ModelRunner.layout_table``); under tensor parallelism
  also with the shape the split rule declares for its rank and cut, on
  every rank (a mirrored runner's ``rank_layout_problems`` runs the same
  check on each follower).
- **lock-order recorder**, **asyncio watchdog**, **task audit** and
  **page-pool audit** — copies of the reference's.

Violations raise :class:`SanitizerViolation` when ``strict``, or
accumulate on :attr:`Sanitizer.violations` for ``report()``.
"""

from __future__ import annotations

import asyncio
import contextlib
import logging
import os
import threading
from typing import Any, Dict, Iterable, List, Optional, Tuple

log = logging.getLogger("dynamo_tpu_torch.runtime.sanitizer")


class SanitizerViolation(RuntimeError):
    """An invariant the sanitizer enforces was broken (strict mode)."""


#: Every sanctioned sync site, by label: the reference's set, unchanged.
#: A sync found inside a guarded dispatch that none of these names is a
#: finding to remove, not a label to add.
DEFAULT_ALLOWLIST = frozenset({
    "decode_staging",    # per-dispatch int pack + token h2d (model_runner)
    "spec_staging",      # draft-loop tok/pos/table staging
    "verify_staging",    # ragged verify flat-token + metadata staging
    "sampling_staging",  # SamplingParams host->device rows
    "token_readback",    # the ONE bulk d2h sync per fused dispatch
    "draft_readback",    # device n-gram ring proposal d2h (one per spec
                         # iteration, replacing the host history scan)
    "embed_readback",    # request-boundary embedding .tolist
    "kv_tier_io",        # G2/G3 onboarding / offload block copies
    "weight_reload",     # RL weight swap (paused engine, not steady state)
})

#: Dispatch families whose buckets follow the admitted load: a prompt
#: length, a decode batch size, a pack of chunks, a verify's token count.
#: A new bucket after warm-up is counted and logged once, never a
#: violation (the reference's "forward" rule, widened: the card compiles
#: nothing per shape). Steady-state families (the draft-model rounds and
#: the draft ring, whose shapes the engine fixes at construction) stay
#: frozen.
ADMISSION_FAMILIES = frozenset({"prefill", "mixed_padded", "decode",
                                "ragged", "verify"})

# process-wide: set_sync_debug_mode is global, so armed guards count here
# (under _COND) and device work takes one gate while any is armed
_ARMED = [0]
_COND = threading.Condition(threading.Lock())


class _DeviceGate:
    """The process-wide device gate. While any sanitizer has armed its
    sync guard, an iteration holds the gate's lock from start to end, and
    the first gated iteration waits for every iteration that began before
    the arming (without the gate) to end: a guarded window never overlaps
    another thread's device work. Unarmed, an iteration only counts
    itself in flight. Re-entry on a thread is a no-op."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._ungated = 0  # iterations in flight that began unarmed
        self._local = threading.local()

    def __enter__(self) -> "_DeviceGate":
        loc = self._local
        depth = getattr(loc, "depth", 0)
        loc.depth = depth + 1
        if depth:
            return self
        with _COND:
            loc.gated = bool(_ARMED[0])
            if not loc.gated:
                self._ungated += 1
                return self
        self._lock.acquire()
        with _COND:
            while self._ungated:
                _COND.wait()
        return self

    def __exit__(self, *exc) -> None:
        loc = self._local
        loc.depth -= 1
        if loc.depth:
            return
        if loc.gated:
            self._lock.release()
            return
        with _COND:
            self._ungated -= 1
            if not self._ungated:
                _COND.notify_all()


_GATE = _DeviceGate()


def device_gate() -> _DeviceGate:
    """The process-wide device gate (:class:`_DeviceGate`): the engine's
    step thread enters it for each iteration, so one thread's guarded
    window never overlaps another's sync."""
    return _GATE


def env_enabled() -> bool:
    return os.environ.get("DYN_SAN", "").lower() in ("1", "true", "on", "yes")


def from_env(**kwargs) -> Optional["Sanitizer"]:
    """Build a Sanitizer iff DYN_SAN is set (the worker default)."""
    return Sanitizer(**kwargs) if env_enabled() else None


def _cuda():
    """torch when a CUDA device is there, else None (the guard no-ops on
    the CPU). Imported lazily: the sanitizer's module stays torch-free
    for processes that never arm it."""
    import torch

    return torch if torch.cuda.is_available() else None


def _is_sync_error(e: BaseException) -> bool:
    msg = str(e).lower()
    return "synchroniz" in msg


def tensor_rows(prefix: str, tree) -> Iterable[Tuple[str, Any]]:
    """(path, tensor) of every tensor leaf of a params or pool tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tensor_rows(f"{prefix}{k}/", v)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tensor_rows(f"{prefix}{i}/", v)
    elif hasattr(tree, "device") and hasattr(tree, "dtype"):
        yield prefix.rstrip("/"), tree


def layout_problems(rows) -> Tuple[int, List[str]]:
    """(rows checked, problems) of a runner's layout table: each live
    tensor against the (device, dtype) it was placed with and, where the
    row declares one (a tensor-parallel rank's: shape, rank, cut dim), its
    shape."""
    checked, out = 0, []
    for name, t, placed in rows:
        checked += 1
        device, dtype = placed[:2]
        if t.device != device or t.dtype != dtype:
            out.append(f"{name}: live {t.device}/{t.dtype} diverges from the "
                       f"placed {device}/{dtype}")
        if len(placed) > 2 and tuple(t.shape) != tuple(placed[2]):
            shape, rank, dim = placed[2:5]
            out.append(f"{name} on rank {rank}: live shape {tuple(t.shape)} is not "
                       f"the declared {tuple(shape)} (cut dim {dim})")
    return checked, out


class _TrackedLock:
    """Lock proxy recording acquisition order into the owning Sanitizer.

    Supports the context-manager protocol plus acquire/release/locked so
    it drops in for `threading.Lock` at every engine call site. Non-
    blocking and timeout acquires record only on success.
    """

    __slots__ = ("_lock", "name", "_san")

    def __init__(self, lock, name: str, san: "Sanitizer"):
        self._lock = lock
        self.name = name
        self._san = san

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._lock.acquire(blocking, timeout)
        if got:
            self._san._note_acquire(self.name)
        return got

    def release(self) -> None:
        self._san._note_release(self.name)
        self._lock.release()

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()


class Sanitizer:
    def __init__(
        self,
        *,
        strict: bool = True,
        allowlist: Iterable[str] = DEFAULT_ALLOWLIST,
        transfer_guard: bool = True,
        warmup_steps: int = 16,
        watchdog_interval_s: float = 0.05,
        watchdog_lag_s: float = 0.25,
    ):
        self.strict = strict
        self.allowlist = frozenset(allowlist)
        self.transfer_guard = transfer_guard
        self.warmup_steps = warmup_steps
        self.watchdog_interval_s = watchdog_interval_s
        self.watchdog_lag_s = watchdog_lag_s
        self.violations: List[Dict[str, Any]] = []
        self._vlock = threading.Lock()  # guards violations (multi-thread)
        # shape tripwire
        self._steps = 0
        self._warm = False
        self._warm_variants: Dict[str, int] = {}
        self._warm_builds: Optional[int] = None
        # the sync guard: this sanitizer's armed flag (counted process-wide
        # in _ARMED) and the threads inside a guarded window
        self._armed = False
        self._scope = threading.local()
        # lock-order recorder: name -> {successor: thread} edges; held
        # stacks are per thread
        self._edges: Dict[str, Dict[str, str]] = {}
        self._held = threading.local()
        self._graph_lock = threading.Lock()
        # watchdog
        self._watchdog_task: Optional[asyncio.Task] = None
        self.loop_lag_max_s = 0.0
        self.counters: Dict[str, int] = {
            "steps": 0, "allowed_transfers": 0, "lock_acquires": 0,
            "guarded_dispatches": 0,
        }

    # -- violations --------------------------------------------------------
    def _violation(self, kind: str, message: str) -> None:
        with self._vlock:
            self.violations.append({"kind": kind, "message": message})
        if self.strict:
            raise SanitizerViolation(f"[{kind}] {message}")
        log.warning("sanitizer violation [%s]: %s", kind, message)

    def ok(self) -> bool:
        return not self.violations

    def report(self) -> Dict[str, Any]:
        return {
            "ok": self.ok(),
            "violations": list(self.violations),
            "steps": self._steps,
            "warm": self._warm,
            "loop_lag_max_ms": round(self.loop_lag_max_s * 1e3, 3),
            "counters": dict(self.counters),
        }

    # -- sync guard ----------------------------------------------------------
    def _arm(self) -> None:
        if not self._armed and self.transfer_guard:
            self._armed = True
            with _COND:
                _ARMED[0] += 1

    def disarm(self) -> None:
        """Drop this sanitizer's hold on the process-wide gate (engine
        stop)."""
        if self._armed:
            self._armed = False
            with _COND:
                _ARMED[0] -= 1

    @contextlib.contextmanager
    def transfer_scope(self, where: str = "step"):
        """Sync debug mode "error" for the duration (warm engine on a CUDA
        device only: warm-up iterations stage and build freely). A sync
        inside records a "transfer" violation and re-raises PyTorch's
        error: the dispatch it broke cannot be completed, and the engine's
        per-step error handling fails the affected sequences."""
        torch = _cuda() if (self.transfer_guard and self._warm) else None
        if torch is None:
            yield
            return
        self.counters["guarded_dispatches"] += 1
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        self._scope.where = where
        self._scope.torch = torch
        try:
            yield
        except SanitizerViolation:
            raise
        except Exception as e:
            if _is_sync_error(e):
                with self._vlock:
                    self.violations.append({
                        "kind": "transfer",
                        "message": f"implicit sync in {where}: {e}",
                    })
                log.error("sanitizer: implicit sync in %s: %s", where, e)
            raise
        finally:
            self._scope.where = None
            torch.cuda.set_sync_debug_mode(prev)

    @contextlib.contextmanager
    def allow_transfer(self, label: str):
        """Named escape hatch for a known sync point: drops the mode to
        "default" for the body inside a guarded window. Labels outside the
        allowlist are violations: the allowlist is the reviewed budget of
        sanctioned syncs, not a convenience."""
        if label not in self.allowlist:
            self._violation(
                "allowlist",
                f"transfer scope {label!r} is not in the sanitizer "
                f"allowlist; add it to DEFAULT_ALLOWLIST with its reason, "
                "or remove the sync",
            )
            yield  # non-strict: record, then let it run
            return
        self.counters["allowed_transfers"] += 1
        if getattr(self._scope, "where", None) is None:
            yield
            return
        torch = self._scope.torch
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("default")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(prev)

    # -- layout check --------------------------------------------------------
    def check_layouts(self, runner: Any) -> int:
        """Every row of the runner's layout table (ModelRunner.layout_table:
        name, live tensor, the (device, dtype) it was placed with) must
        still match: a param or pool moved or re-cast after placement
        means a copy is hiding in the path that produced it. Runners
        without a table no-op. Returns the rows checked."""
        table_fn = getattr(runner, "layout_table", None)
        if table_fn is None:
            return 0
        checked, problems = layout_problems(table_fn())
        remote = getattr(runner, "rank_layout_problems", None)
        if remote is not None:  # the followers' own tables
            for n, probs in remote():
                checked += n
                problems += probs
        for msg in problems:
            self._violation("layout", msg)
        self.counters["layout_checked"] = checked
        return checked

    # -- shape tripwire ------------------------------------------------------
    def mark_warm(self) -> None:
        self._warm = True
        self._arm()

    def note_step(self, runner: Any = None) -> None:
        """Called once per engine iteration (step thread). Arms the sync
        guard and freezes the dispatch-family baseline after
        `warmup_steps`; later growth in a steady-state family, a new
        family, or a kernel library built since is a violation."""
        self._steps += 1
        self.counters["steps"] = self._steps
        fams = getattr(runner, "_families", None)
        variants = (
            {name: fam.variants for name, fam in fams.items()} if fams else {}
        )
        builds = _nvcc_builds() if runner is not None else None
        if not self._warm:
            if self._steps >= self.warmup_steps:
                self.mark_warm()
                self._warm_variants = variants
                self._warm_builds = builds
                # warm-path entry: params and pools are placed for good
                if runner is not None:
                    self.check_layouts(runner)
            return
        if builds is not None and self._warm_builds is not None \
                and builds > self._warm_builds:
            base, self._warm_builds = self._warm_builds, builds
            self._violation(
                "kernel_build",
                f"{builds - base} kernel librar(ies) built by nvcc after "
                f"warm-up (step {self._steps}): a first-use build stalls "
                "the step thread for seconds")
        for name, n in variants.items():
            base = self._warm_variants.get(name)
            # update the baseline BEFORE reporting so a non-strict run
            # logs each leak once instead of every subsequent step
            self._warm_variants[name] = n
            if name in ADMISSION_FAMILIES:
                if base is not None and n > base:
                    self.counters["admission_recompiles"] = (
                        self.counters.get("admission_recompiles", 0) + 1
                    )
                    log.info(
                        "admission-boundary family %r grew %d->%d shapes "
                        "(step %d): a new bucket of the admitted load",
                        name, base, n, self._steps,
                    )
                continue
            if base is None:
                self._violation(
                    "recompile",
                    f"new dispatch family {name!r} appeared after warmup "
                    f"(step {self._steps})",
                )
            elif n > base:
                self._violation(
                    "recompile",
                    f"dispatch family {name!r} grew {base}->{n} shapes "
                    f"after warmup (step {self._steps}): shape churn in "
                    "the steady-state loop",
                )

    # -- lock-order recorder -----------------------------------------------
    def wrap_lock(self, lock, name: str) -> _TrackedLock:
        return _TrackedLock(lock, name, self)

    def _held_stack(self) -> List[str]:
        st = getattr(self._held, "stack", None)
        if st is None:
            st = self._held.stack = []
        return st

    def _note_acquire(self, name: str) -> None:
        self.counters["lock_acquires"] += 1
        st = self._held_stack()
        if st:
            outer = st[-1]
            if outer != name:
                with self._graph_lock:
                    fresh = name not in self._edges.setdefault(outer, {})
                    if fresh:
                        self._edges[outer][name] = (
                            threading.current_thread().name
                        )
                        cycle = self._find_cycle(name, outer)
                    else:
                        cycle = None
                if fresh and cycle:
                    self._violation(
                        "lock_order",
                        "lock acquisition order cycle: "
                        + " -> ".join(cycle)
                        + f" (edge {outer!r} -> {name!r} closed it on "
                        f"thread {threading.current_thread().name!r})",
                    )
        st.append(name)

    def _note_release(self, name: str) -> None:
        st = self._held_stack()
        # out-of-order release is legal (threading allows it); drop the
        # newest matching entry
        for i in range(len(st) - 1, -1, -1):
            if st[i] == name:
                del st[i]
                break

    def _find_cycle(self, start: str, target: str) -> Optional[List[str]]:
        """Path start ->* target in the held-before graph (caller holds
        _graph_lock); with the new target->start edge that is a cycle."""
        path: List[str] = []
        seen = set()

        def dfs(node: str) -> bool:
            if node == target:
                path.append(node)
                return True
            if node in seen:
                return False
            seen.add(node)
            for nxt in self._edges.get(node, {}):
                if dfs(nxt):
                    path.append(node)
                    return True
            return False

        if dfs(start):
            path.reverse()  # start ... target; closing edge returns to start
            return path + [start]
        return None

    # -- asyncio watchdog --------------------------------------------------
    def start_watchdog(self) -> asyncio.Task:
        """Start the event-loop lag sampler (call from the serving loop).
        Plain create_task retained on self — deliberately NOT
        spawn_tracked, so audit_tasks never reports the watchdog
        itself."""
        if self._watchdog_task is None or self._watchdog_task.done():
            self._watchdog_task = asyncio.get_running_loop().create_task(
                self._watch(), name="dyn-san-watchdog"
            )
        return self._watchdog_task

    async def stop_watchdog(self) -> None:
        t = self._watchdog_task
        if t is not None and not t.done():
            t.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await t
        self._watchdog_task = None

    async def _watch(self) -> None:
        loop = asyncio.get_running_loop()
        interval = self.watchdog_interval_s
        while True:
            t0 = loop.time()
            await asyncio.sleep(interval)
            lag = loop.time() - t0 - interval
            if lag > self.loop_lag_max_s:
                self.loop_lag_max_s = lag
            if lag > self.watchdog_lag_s:
                # a gauge, not a failure: lag has benign causes (cold
                # imports, CI noise) — record without raising even in
                # strict mode
                with self._vlock:
                    self.violations.append({
                        "kind": "loop_lag",
                        "message": f"event loop stalled {lag*1e3:.0f} ms "
                                   f"(threshold {self.watchdog_lag_s*1e3:.0f} ms)",
                    })
                log.warning("sanitizer: event loop stalled %.0f ms", lag * 1e3)

    def audit_tasks(self) -> List[str]:
        """Leaked fire-and-forget audit (shutdown): every spawn_tracked
        task should be done once its owner stopped. Returns the leaked
        task names (and files a violation if any)."""
        from dynamo_tpu_torch.runtime import tasks as _tasks

        leaked = sorted(
            t.get_name() for t in _tasks._TRACKED if not t.done()
        )
        if leaked:
            self._violation(
                "leaked_task",
                f"{len(leaked)} tracked task(s) still running at audit: "
                + ", ".join(leaked[:8]),
            )
        return leaked

    # -- page-pool audit ---------------------------------------------------
    def audit_pool(self, pool, live_seqs: int = 0) -> None:
        """PagePool partition/refcount invariants at request teardown or
        engine stop. fork_table-aware: forked pages legitimately carry
        ref > 1; what must never happen is a page in two states at once,
        a non-positive refcount, or allocated pages with no live
        sequence to own them."""
        free = set(pool.free)
        refd = set(pool.ref)
        cached = set(pool.cached)
        overlap = (free & refd) | (free & cached) | (refd & cached)
        if overlap:
            self._violation(
                "pool",
                f"pages in two states at once: {sorted(overlap)[:8]}",
            )
        missing = set(range(pool.num_pages)) - free - refd - cached
        if missing:
            self._violation(
                "pool",
                f"pages lost from the pool (not free/ref/cached): "
                f"{sorted(missing)[:8]}",
            )
        bad_ref = {p: c for p, c in pool.ref.items() if c <= 0}
        if bad_ref:
            self._violation(
                "pool", f"non-positive refcounts: {bad_ref}"
            )
        if live_seqs == 0 and refd:
            self._violation(
                "pool",
                f"{len(refd)} page(s) still referenced with no live "
                f"sequences — leaked at teardown: {sorted(refd)[:8]}",
            )
        for h, p in pool.by_hash.items():
            if pool.hash_of.get(p) != h:
                self._violation(
                    "pool",
                    f"hash index desync: by_hash[{h}]={p} but "
                    f"hash_of[{p}]={pool.hash_of.get(p)}",
                )
        stray_pins = set(pool.pinned) - set(pool.by_hash)
        if stray_pins:
            self._violation(
                "pool",
                f"pinned hashes with no registered page: "
                f"{sorted(stray_pins)[:8]}",
            )



def _nvcc_builds() -> Optional[int]:
    """Kernel libraries ops/_build.py has compiled in this process (None
    when the module was never imported: nothing can have been built)."""
    import sys

    mod = sys.modules.get("dynamo_tpu_torch.ops._build")
    return None if mod is None else int(mod.nvcc_builds[0])


def selftest() -> bool:
    """Cheap in-process self-check: lock-cycle detection, allowlist
    rejection, the violation plumbing and the layout check."""
    san = Sanitizer(strict=False, transfer_guard=False)
    a = san.wrap_lock(threading.Lock(), "A")
    b = san.wrap_lock(threading.Lock(), "B")
    with a:
        with b:
            pass
    with b:
        with a:
            pass
    assert any(v["kind"] == "lock_order" for v in san.violations), \
        "lock cycle not detected"
    n = len(san.violations)
    with san.allow_transfer("not_a_real_label"):
        pass
    assert any(v["kind"] == "allowlist" for v in san.violations[n:]), \
        "allowlist breach not detected"
    strict = Sanitizer(strict=True)
    try:
        strict._violation("selftest", "must raise")
    except SanitizerViolation:
        pass
    else:
        raise AssertionError("strict mode did not raise")

    class _T:
        def __init__(self, device, dtype):
            self.device, self.dtype = device, dtype

    class _Runner:
        def layout_table(self):
            return [("params/good", _T("cpu", "bf16"), ("cpu", "bf16")),
                    ("params/drifted", _T("cpu", "f32"), ("cpu", "bf16"))]

    lay = Sanitizer(strict=False, transfer_guard=False)
    assert lay.check_layouts(object()) == 0, "table-less runner must no-op"
    assert lay.check_layouts(_Runner()) == 2
    bad = [v for v in lay.violations if v["kind"] == "layout"]
    assert len(bad) == 1 and "params/drifted" in bad[0]["message"], \
        "layout drift not detected"
    return True
