"""The port's runtime sanitizer (dynamo_tpu_torch/runtime/sanitizer.py), on
the CPU.

- the reference's own cases (tests/test_sanitizer.py) against the port's
  module: env arming, the self-test, the allowlist (the reference's set,
  unchanged), the shape tripwire (the recompile tripwire's counterpart,
  with the admission families counted, not fatal), the lock-order
  recorder, the asyncio watchdog and task audit, the page-pool audit, and
  a strict sanitizer riding the tiny engine with zero violations and
  byte-identical streams;
- the sync guard's mode handling, with torch.cuda's sync-debug functions
  spied on (there is no card here): a warm scope sets "error" and
  restores the previous mode, an allow scope drops to "default" inside
  it, a sync error inside is recorded and re-raised, a cold or guard-off
  sanitizer sets nothing; the process-wide device gate while armed;
- a kernel library built after warm-up is a violation.
"""

import asyncio
import threading
import time

import pytest
import torch

from dynamo_tpu_torch.engine.engine import InferenceEngine
from dynamo_tpu_torch.engine.kv_pool import PagePool
from dynamo_tpu_torch.engine.model_runner import ModelRunner
from dynamo_tpu_torch.models.config import get_config
from dynamo_tpu_torch.ops import _build
from dynamo_tpu_torch.runtime import sanitizer as san_mod
from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.runtime.sanitizer import (
    ADMISSION_FAMILIES,
    DEFAULT_ALLOWLIST,
    Sanitizer,
    SanitizerViolation,
    device_gate,
    env_enabled,
    from_env,
    selftest,
)


def _kinds(san):
    return [v["kind"] for v in san.violations]


def test_env_arming(monkeypatch):
    monkeypatch.delenv("DYN_SAN", raising=False)
    assert not env_enabled() and from_env() is None
    for val in ("1", "true", "ON", "yes"):
        monkeypatch.setenv("DYN_SAN", val)
        assert env_enabled()
    san = from_env(strict=False)
    assert isinstance(san, Sanitizer) and san.strict is False
    monkeypatch.setenv("DYN_SAN", "0")
    assert from_env() is None


def test_selftest_is_green():
    assert selftest() is True


def test_default_allowlist_is_the_reference_set():
    from dynamo_tpu.runtime.sanitizer import DEFAULT_ALLOWLIST as REF

    assert DEFAULT_ALLOWLIST == REF
    assert {"prefill", "mixed_padded"} <= ADMISSION_FAMILIES
    assert not {"spec_decode", "draft_ring"} & ADMISSION_FAMILIES


@pytest.mark.parametrize("strict", [False, True])
def test_allow_transfer_unknown_label_is_violation(strict):
    san = Sanitizer(strict=strict, transfer_guard=False)
    if strict:
        with pytest.raises(SanitizerViolation):
            with san.allow_transfer("sneaky_new_sync"):
                pass
    else:
        with san.allow_transfer("sneaky_new_sync"):
            pass
    assert _kinds(san) == ["allowlist"]
    assert "sneaky_new_sync" in san.violations[0]["message"]


class _SyncSpy:
    """torch.cuda's sync-debug mode, recorded (no card here)."""

    def __init__(self, monkeypatch):
        self.mode = "default"
        self.calls = []
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: self.mode)
        monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", self.set)

    def set(self, mode):
        self.calls.append(mode)
        self.mode = mode


def test_guard_sets_and_restores_the_sync_mode(monkeypatch):
    spy = _SyncSpy(monkeypatch)
    san = Sanitizer(strict=True, warmup_steps=0)
    san.mark_warm()
    try:
        with san.transfer_scope("decode"):
            assert spy.mode == "error"
            with san.allow_transfer("token_readback"):
                assert spy.mode == "default"
            assert spy.mode == "error"
        assert spy.mode == "default"
        assert spy.calls == ["error", "default", "error", "default"]
        assert san.counters["guarded_dispatches"] == 1
        assert san.counters["allowed_transfers"] == 1
        # outside a guarded window an allow scope sets nothing
        with san.allow_transfer("decode_staging"):
            pass
        assert spy.calls == ["error", "default", "error", "default"]
        # a previous non-default mode comes back after the window
        spy.mode = "warn"
        with san.transfer_scope("spec_verify"):
            assert spy.mode == "error"
        assert spy.mode == "warn"
        assert san.ok()
    finally:
        san.disarm()


def test_guard_records_a_sync_and_reraises(monkeypatch):
    spy = _SyncSpy(monkeypatch)
    san = Sanitizer(strict=False, warmup_steps=0)
    san.mark_warm()
    try:
        with pytest.raises(RuntimeError, match="synchronizing"):
            with san.transfer_scope("decode"):
                raise RuntimeError("called a synchronizing CUDA operation")
        assert _kinds(san) == ["transfer"]
        assert "decode" in san.violations[0]["message"]
        assert spy.mode == "default"  # restored on the way out
        # an error of another kind passes through unrecorded
        with pytest.raises(ValueError):
            with san.transfer_scope("decode"):
                raise ValueError("not a sync")
        assert _kinds(san) == ["transfer"]
    finally:
        san.disarm()


@pytest.mark.parametrize("how", ["cold", "guard_off", "no_card"])
def test_guard_is_a_noop_when_cold_off_or_without_a_card(monkeypatch, how):
    spy = _SyncSpy(monkeypatch)
    if how == "no_card":
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    san = Sanitizer(strict=True, transfer_guard=how != "guard_off", warmup_steps=0)
    if how != "cold":
        san.mark_warm()
    try:
        with san.transfer_scope("decode"):
            pass
        assert spy.calls == [] and san.counters["guarded_dispatches"] == 0
    finally:
        san.disarm()


def test_device_gate_serializes_threads_while_armed():
    """While a sanitizer has armed its guard, device_gate() is one
    process-wide lock: two step threads never overlap inside it. Off,
    threads pass through it together."""
    assert san_mod._ARMED[0] == 0
    def enter():
        with device_gate():
            pass

    with device_gate():  # unarmed: another thread is not held back
        t = threading.Thread(target=enter)
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
    san = Sanitizer(strict=True, warmup_steps=0)
    san.mark_warm()
    inside, overlap = [0], [0]
    old = __import__("sys").getswitchinterval()
    __import__("sys").setswitchinterval(1e-5)
    try:
        assert san_mod._ARMED[0] == 1

        def step():
            for _ in range(400):
                with device_gate():
                    inside[0] += 1
                    if inside[0] > 1:
                        overlap[0] += 1
                    time.sleep(0)
                    inside[0] -= 1

        threads = [threading.Thread(target=step) for _ in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert overlap[0] == 0
    finally:
        __import__("sys").setswitchinterval(old)
        san.disarm()
    assert san_mod._ARMED[0] == 0


def test_device_gate_waits_for_an_iteration_begun_unarmed():
    """An iteration that entered the gate before any guard was armed runs
    without it; once a guard arms, the next gated iteration (and so any
    guarded window) waits until that iteration has ended. Nested entries
    on one thread pass through."""
    began, release, log = threading.Event(), threading.Event(), []

    def unarmed_iteration():
        with device_gate():
            began.set()
            release.wait(10)
            log.append("unarmed ended")

    a = threading.Thread(target=unarmed_iteration)
    a.start()
    assert began.wait(10)
    san = Sanitizer(strict=True, warmup_steps=0)
    san.mark_warm()  # armed while `a` is mid-iteration

    def gated_iteration():
        with device_gate():
            with device_gate():  # re-entry: no deadlock
                log.append("gated began")

    b = threading.Thread(target=gated_iteration)
    try:
        b.start()
        b.join(timeout=0.3)
        assert b.is_alive() and log == []  # held back by `a`
        release.set()
        a.join(timeout=10)
        b.join(timeout=10)
        assert not a.is_alive() and not b.is_alive()
        assert log == ["unarmed ended", "gated began"]
    finally:
        release.set()
        san.disarm()
    assert san_mod._ARMED[0] == 0


class _Fam:
    def __init__(self, variants):
        self.variants = variants
        self.calls = 0


class _FakeRunner:
    def __init__(self):
        self._families = {"draft_ring": _Fam(2), "prefill": _Fam(3)}


def test_shape_tripwire_fires_once_per_leak():
    san = Sanitizer(strict=False, transfer_guard=False, warmup_steps=2)
    r = _FakeRunner()
    san.note_step(r)
    assert not san.report()["warm"]
    san.note_step(r)  # reaches warmup_steps: the baseline freezes here
    assert san.report()["warm"]
    san.note_step(r)
    assert san.ok()
    r._families["draft_ring"].variants = 3  # churn after warm-up
    san.note_step(r)
    assert _kinds(san) == ["recompile"]
    assert "2->3" in san.violations[0]["message"]
    san.note_step(r)  # the baseline moved: the same leak reports once
    assert len(san.violations) == 1
    r._families["spec_decode"] = _Fam(1)  # a whole new family after warm-up
    san.note_step(r)
    assert _kinds(san) == ["recompile", "recompile"]
    assert "spec_decode" in san.violations[1]["message"]


def test_shape_tripwire_strict_raises_and_familyless_runner_noop():
    san = Sanitizer(strict=True, transfer_guard=False, warmup_steps=1)
    r = _FakeRunner()
    san.note_step(r)
    r._families["draft_ring"].variants += 1
    with pytest.raises(SanitizerViolation, match="recompile"):
        san.note_step(r)

    class _NoFamilies:
        pass

    san2 = Sanitizer(strict=True, transfer_guard=False, warmup_steps=1)
    for _ in range(8):
        san2.note_step(_NoFamilies())
    assert san2.ok() and san2.report()["steps"] == 8


@pytest.mark.parametrize("family", sorted(ADMISSION_FAMILIES))
def test_shape_tripwire_counts_admission_families(family):
    san = Sanitizer(strict=True, transfer_guard=False, warmup_steps=1)
    r = _FakeRunner()
    r._families[family] = _Fam(2)
    san.note_step(r)
    r._families[family].variants = 3  # a new bucket of the admitted load
    san.note_step(r)
    assert san.ok()
    assert san.counters["admission_recompiles"] == 1
    r._families["draft_ring"].variants += 1  # steady-state growth: fatal
    with pytest.raises(SanitizerViolation, match="recompile"):
        san.note_step(r)


def test_kernel_build_after_warmup_is_a_violation(monkeypatch):
    monkeypatch.setattr(_build, "nvcc_builds", [5])
    san = Sanitizer(strict=False, transfer_guard=False, warmup_steps=1)
    r = _FakeRunner()
    san.note_step(r)  # warm: 5 builds so far
    san.note_step(r)
    assert san.ok()
    _build.nvcc_builds[0] += 1  # a first-use nvcc mid-serving
    san.note_step(r)
    assert _kinds(san) == ["kernel_build"]
    san.note_step(r)
    assert len(san.violations) == 1


def test_lock_cycle_detected_with_full_path():
    san = Sanitizer(strict=False, transfer_guard=False)
    a = san.wrap_lock(threading.Lock(), "engine.guided_cache")
    b = san.wrap_lock(threading.Lock(), "engine.lifter")
    with a, b:
        pass
    with a, b:
        pass
    assert san.ok()
    with b, a:  # the opposite order closes the cycle
        pass
    v = [v for v in san.violations if v["kind"] == "lock_order"]
    assert len(v) == 1
    assert "engine.guided_cache -> engine.lifter -> engine.guided_cache" in v[0]["message"]


def test_lock_cycle_three_nodes_and_strict_raise():
    san = Sanitizer(strict=True, transfer_guard=False)
    a = san.wrap_lock(threading.Lock(), "A")
    b = san.wrap_lock(threading.Lock(), "B")
    c = san.wrap_lock(threading.Lock(), "C")
    with a, b:
        pass
    with b, c:
        pass
    with pytest.raises(SanitizerViolation, match="A -> B -> C -> A"):
        with c:
            a.acquire()
    a.release()


def test_tracked_lock_is_drop_in():
    san = Sanitizer(strict=True, transfer_guard=False)
    lk = san.wrap_lock(threading.Lock(), "L")
    assert lk.acquire(blocking=False)
    assert lk.locked()
    assert not lk.acquire(blocking=False)
    lk.release()
    assert not lk.locked()
    assert san.counters["lock_acquires"] == 1


async def test_watchdog_lag_is_a_gauge_not_a_failure():
    san = Sanitizer(strict=True, transfer_guard=False,
                    watchdog_interval_s=0.01, watchdog_lag_s=0.05)
    san.start_watchdog()
    await asyncio.sleep(0.03)
    time.sleep(0.2)  # stall the loop past the threshold
    await asyncio.sleep(0.05)
    await san.stop_watchdog()
    assert san.loop_lag_max_s > 0.05
    assert "loop_lag" in _kinds(san)


async def test_leaked_task_audit_names_the_leak():
    from dynamo_tpu_torch.runtime.tasks import spawn_tracked

    san = Sanitizer(strict=False, transfer_guard=False)
    ev = asyncio.Event()

    async def hang():
        await ev.wait()

    t = spawn_tracked(hang(), name="unit-leaked-task")
    await asyncio.sleep(0)
    try:
        assert "unit-leaked-task" in san.audit_tasks()
        assert _kinds(san) == ["leaked_task"]
    finally:
        ev.set()
        await t
    assert Sanitizer(strict=True).audit_tasks() == []


async def test_watchdog_itself_never_audits_as_leak():
    san = Sanitizer(strict=True, transfer_guard=False, watchdog_interval_s=0.01)
    san.start_watchdog()
    await asyncio.sleep(0.03)
    assert san.audit_tasks() == []
    await san.stop_watchdog()


def test_pool_audit_clean_and_leak_at_teardown():
    pool = PagePool(8, 4)
    san = Sanitizer(strict=False, transfer_guard=False)
    san.audit_pool(pool, live_seqs=0)
    assert san.ok()
    pages = pool.alloc(2)
    san.audit_pool(pool, live_seqs=1)
    assert san.ok()
    san.audit_pool(pool, live_seqs=0)
    assert _kinds(san) == ["pool"]
    assert "leaked at teardown" in san.violations[0]["message"]
    pool.release(pages)


def test_pool_audit_hash_desync_and_stray_pin():
    pool = PagePool(8, 4)
    san = Sanitizer(strict=False, transfer_guard=False)
    pool.by_hash[1234] = 5
    pool.pinned.add(999)
    san.audit_pool(pool, live_seqs=0)
    msgs = " | ".join(v["message"] for v in san.violations)
    assert _kinds(san).count("pool") >= 2
    assert "desync" in msgs and "pinned" in msgs


def test_pool_audit_partition_overlap():
    pool = PagePool(8, 4)
    pages = pool.alloc(1)
    pool.free.append(pages[0])
    san = Sanitizer(strict=False, transfer_guard=False)
    san.audit_pool(pool, live_seqs=1)
    assert any("two states" in v["message"] for v in san.violations)


def test_layouts_checked_at_warmup_and_drift_reported():
    runner = ModelRunner(get_config("tiny"), device="cpu", num_pages=32,
                         page_size=4, max_pages_per_seq=8)
    san = Sanitizer(strict=False, transfer_guard=False, warmup_steps=1)
    assert san.check_layouts(runner) == len(list(runner.layout_table())) > 4
    assert san.ok()
    runner.params["norm_f"] = runner.params["norm_f"].to(torch.float64)
    san.check_layouts(runner)
    assert _kinds(san) == ["layout"] and "params/norm_f" in san.violations[0]["message"]


@pytest.fixture(scope="module")
def tiny_runner():
    return ModelRunner(get_config("tiny"), device="cpu", num_pages=64, page_size=4,
                       max_pages_per_seq=16, decode_buckets=(1, 2, 4, 8),
                       prefill_buckets=(8, 16, 32))


def _req(prompt, max_tokens=6):
    return {"token_ids": prompt, "sampling": {"temperature": 0.0, "seed": 0},
            "stop": {"max_tokens": max_tokens, "stop_ids": []}}


async def _collect(engine, req):
    toks = []
    async for item in engine.generate(req, Context()):
        toks.extend(item["token_ids"])
    return toks


async def test_sanitizer_on_engine_clean_and_off_path_byte_identical(tiny_runner, monkeypatch):
    monkeypatch.delenv("DYN_SAN", raising=False)
    prompts = [[5, 6, 7, 8, 9], [9, 8, 7, 6, 5], [1, 2, 3, 4, 5]]
    eng_off = InferenceEngine(tiny_runner, max_batch=8, chunk_size=16)
    assert eng_off.sanitizer is None
    eng_off.start()
    try:
        baseline = [await _collect(eng_off, _req(p)) for p in prompts]
    finally:
        eng_off.stop()
    assert all(len(t) == 6 for t in baseline)
    san = Sanitizer(strict=True, warmup_steps=3)
    eng_on = InferenceEngine(tiny_runner, max_batch=8, chunk_size=16, sanitizer=san)
    assert eng_on.sanitizer is san
    eng_on.start()
    try:
        await _collect(eng_on, _req([4, 4, 4, 4, 4]))
        guarded = [await _collect(eng_on, _req(p)) for p in prompts]
    finally:
        eng_on.stop()  # the strict pool audit too
    assert guarded == baseline
    rep = san.report()
    assert rep["ok"], rep
    assert rep["warm"] and rep["steps"] > 3
    assert san.counters["allowed_transfers"] > 0 and san.counters["layout_checked"] > 4
    assert san_mod._ARMED[0] == 0  # the stopped engine disarmed
    tiny_runner.attach_sanitizer(None)


async def test_sanitize_flag_builds_engine_sanitizer(tiny_runner):
    eng = InferenceEngine(tiny_runner, max_batch=4, chunk_size=16, sanitize=True)
    try:
        assert eng.sanitizer is not None and eng.sanitizer.strict is True
        assert tiny_runner._sanitizer is eng.sanitizer
    finally:
        eng.stop()
        tiny_runner.attach_sanitizer(None)
