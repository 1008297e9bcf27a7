"""Profiler ranges and profile windows.

Port of dynamo_tpu/runtime/annotations.py. `annotate(name)` marks
a named range on the profiler timeline: `torch.profiler.record_function`
(the range lands in a torch.profiler trace next to the kernels it
launched) plus `torch.cuda.nvtx.range` on a CUDA machine. It is gated,
as in the reference, by `DYN_ENABLE_JAX_TRACE=1` (the reference's
switch is kept so a deployment's environment carries over; one cached
env read), and is also on while a profile window is open, so every
window holds the engine's ranges. Off, it returns one shared
nullcontext.

torch has no profiler server to start (the reference's
`start_profiler_server`); instead `StepProfiler` opens `torch.profiler`
windows (CPU + CUDA activity) on request and writes each as a Chrome
trace. The window is opened and closed by the thread that calls
`tick()`, the engine's step thread at an iteration boundary, so the
step thread's ranges land in it whichever thread asked (the worker's
`GET /profile?ms=N` on the asyncio loop, the flight recorder's anomaly
dump thread): a range opened on another thread than the profiler's is
not recorded. CUDA activity is recorded process-wide.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import functools
import logging
import os
import threading
import time
from typing import List, Optional

log = logging.getLogger("dynamo_tpu_torch.annotations")

_TRUTHY = {"1", "true", "on", "yes"}

# a profile window is open somewhere in this process: ranges are recorded
_WINDOW_OPEN = [False]


@functools.lru_cache(maxsize=1)
def _enabled() -> bool:
    # cached: the step loop calls annotate() per plan; the switch is a
    # deployment decision (tests reset it with _enabled.cache_clear())
    return os.environ.get("DYN_ENABLE_JAX_TRACE", "").lower() in _TRUTHY


@functools.lru_cache(maxsize=1)
def _nvtx() -> bool:
    import torch

    return torch.cuda.is_available()


_NULL = contextlib.nullcontext()


def annotate(name: str):
    """Context manager marking a named range (record_function takes a
    name only: the reference's metadata kwargs have no counterpart)."""
    if not (_enabled() or _WINDOW_OPEN[0]):
        return _NULL
    return _Range(name)


class _Range:
    __slots__ = ("name", "_rf", "_nv")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        import torch

        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        self._nv = _nvtx()
        if self._nv:
            torch.cuda.nvtx.range_push(self.name)
        return self

    def __exit__(self, *exc):
        import torch

        if self._nv:
            torch.cuda.nvtx.range_pop()
        self._rf.__exit__(*exc)
        return False


def _activities() -> list:
    import torch
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


def _trace_path(out_dir: str, tag: str) -> str:
    os.makedirs(out_dir, exist_ok=True)
    return os.path.join(out_dir, f"{tag}_{time.strftime('%Y%m%d-%H%M%S')}"
                                 f"_{time.monotonic_ns() % 10**9:09d}.json")


class _Window:
    __slots__ = ("ms", "out_dir", "tag", "future", "prof", "deadline")

    def __init__(self, ms: int, out_dir: str, tag: str):
        self.ms = ms
        self.out_dir = out_dir
        self.tag = tag
        self.future: concurrent.futures.Future = concurrent.futures.Future()
        self.prof = None
        self.deadline = 0.0


class StepProfiler:
    """torch.profiler windows opened and closed by the thread calling
    `tick()`. `request(ms, out_dir)` queues a window from any thread and
    returns a Future of the Chrome trace's path (or the exception the
    window raised). One window at a time; later requests wait their
    turn. `opened` / `written` / `failed` count windows (a failed one's
    future holds its exception)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._queue: List[_Window] = []
        self._open: Optional[_Window] = None
        self.opened = 0
        self.written = 0
        self.failed = 0

    @property
    def pending(self) -> bool:
        return bool(self._queue) or self._open is not None

    def request(self, ms: int, out_dir: str, tag: str = "profile"
                ) -> concurrent.futures.Future:
        w = _Window(max(1, int(ms)), out_dir, tag)
        with self._lock:
            self._queue.append(w)
        return w.future

    def tick(self) -> None:
        """Open the next window or close the open one when its time is up
        (step thread, at an iteration boundary)."""
        if not self._queue and self._open is None:
            return
        w = self._open
        if w is not None:
            if time.monotonic() < w.deadline:
                return
            self._close(w)
            return
        with self._lock:
            w = self._queue.pop(0) if self._queue else None
        if w is None:
            return
        from torch.profiler import profile

        try:
            w.prof = profile(activities=_activities())
            w.prof.__enter__()
        except Exception as e:
            self.failed += 1
            w.future.set_exception(e)
            return
        _WINDOW_OPEN[0] = True
        w.deadline = time.monotonic() + w.ms / 1000.0
        self._open = w
        self.opened += 1

    def _close(self, w: _Window) -> None:
        self._open = None
        _WINDOW_OPEN[0] = False
        try:
            w.prof.__exit__(None, None, None)
            path = _trace_path(w.out_dir, w.tag)
            w.prof.export_chrome_trace(path)
        except Exception as e:
            self.failed += 1
            w.future.set_exception(e)
            return
        self.written += 1
        w.future.set_result(path)

    def close(self) -> None:
        """Finish the open window now and fail the queued ones (engine
        stop)."""
        if self._open is not None:
            self._close(self._open)
        with self._lock:
            queued, self._queue = self._queue, []
        for w in queued:
            w.future.set_exception(RuntimeError("profiler stopped"))
