"""Streaming engine protocol.

Port of dynamo_tpu/runtime/engine.py (the reference AsyncEngine trait): an
engine maps a request to an async stream of response items. A worker's
handler is an engine served over the request plane.
"""

from __future__ import annotations

import inspect
from typing import Any, AsyncIterator, Awaitable, Callable, Protocol, runtime_checkable

from dynamo_tpu_torch.runtime.context import Context

EngineStream = AsyncIterator[Any]


@runtime_checkable
class AsyncEngine(Protocol):
    """generate(request, context) -> async iterator of response items."""

    def generate(self, request: Any, context: Context) -> EngineStream:  # pragma: no cover
        ...


class FnEngine:
    """Wrap an async-generator function (request, context) -> stream as an engine."""

    def __init__(self, fn: Callable[[Any, Context], EngineStream]):
        self._fn = fn

    def generate(self, request: Any, context: Context) -> EngineStream:
        return self._fn(request, context)


class UnaryEngine:
    """Wrap an async function returning a single value as a one-item stream."""

    def __init__(self, fn: Callable[[Any, Context], Awaitable[Any]]):
        self._fn = fn

    async def generate(self, request: Any, context: Context) -> EngineStream:
        yield await self._fn(request, context)


def as_engine(obj: Any) -> AsyncEngine:
    """Coerce a handler (engine / async-gen fn / coroutine fn) to AsyncEngine."""
    if hasattr(obj, "generate"):
        return obj
    if inspect.isasyncgenfunction(obj):
        return FnEngine(obj)
    if inspect.iscoroutinefunction(obj):
        return UnaryEngine(obj)
    raise TypeError(f"cannot make AsyncEngine from {obj!r}")


class EchoEngine:
    """Token-echo test engine (mirror of reference lib/llm/src/engines.rs:77):
    streams back each element of request["token_ids"] (or characters of
    request["text"]) one item at a time. Used for frontend/runtime e2e tests
    with no model."""

    async def generate(self, request: Any, context: Context) -> EngineStream:
        if isinstance(request, dict) and "token_ids" in request:
            for t in request["token_ids"]:
                context.raise_if_killed()
                if context.is_stopped:
                    return
                yield {"token_ids": [t]}
        elif isinstance(request, dict) and "text" in request:
            for ch in request["text"]:
                context.raise_if_killed()
                if context.is_stopped:
                    return
                yield {"text": ch}
        else:
            yield request
