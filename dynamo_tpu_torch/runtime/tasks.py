"""Tracked fire-and-forget task spawning.

Port of dynamo_tpu/runtime/tasks.py. `asyncio.create_task` keeps only a
weak reference to the task: a fire-and-forget spawn whose return value is
dropped can be garbage-collected mid-flight, silently cancelling the
coroutine, and an exception it raises is never observed. `spawn_tracked`
retains a strong reference until the task finishes and logs uncaught
exceptions through the spawning module's logger at done-callback time.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Coroutine, Optional, Set

log = logging.getLogger("dynamo_tpu_torch.runtime.tasks")

# strong refs for tasks nobody else retains; discarded on completion
_TRACKED: Set[asyncio.Task] = set()


def spawn_tracked(
    coro: Coroutine,
    *,
    name: Optional[str] = None,
    logger: Optional[logging.Logger] = None,
) -> asyncio.Task:
    """Spawn `coro` fire-and-forget, safely.

    Retains the task until it completes and logs any uncaught exception
    (CancelledError excluded — cancellation is how owners stop these).
    Losses stay losses: callers that need the result should await the
    returned task instead of dropping it.
    """
    task = asyncio.create_task(coro, name=name)
    _TRACKED.add(task)
    task_log = logger or log

    def _done(t: asyncio.Task) -> None:
        _TRACKED.discard(t)
        if t.cancelled():
            return
        exc = t.exception()
        if exc is not None:
            task_log.warning(
                "background task %s failed: %r",
                t.get_name(), exc, exc_info=exc,
            )

    task.add_done_callback(_done)
    return task

