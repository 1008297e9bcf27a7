"""Request context with cancellation lifecycle.

Analog of the reference's `AsyncEngineContext` (lib/runtime/src/engine.rs:116-130):
every request carries an id, propagated metadata, and a two-stage stop
lifecycle — `stop_generating` (graceful: finish the current token, emit a
final chunk) and `kill` (immediate abandon).
"""

from __future__ import annotations

import asyncio
import time
import uuid
from typing import Any, Dict, Optional


class CancellationError(Exception):
    """Raised inside engine streams when the context has been killed."""


class Context:
    """Per-request metadata + cancellation token hierarchy.

    Contexts form a tree: child contexts are stopped/killed when their
    parent is (mirrors the reference's cancellation-token hierarchy,
    lib/runtime/src/utils/graceful_shutdown.rs).
    """

    def __init__(
        self,
        request_id: Optional[str] = None,
        metadata: Optional[Dict[str, Any]] = None,
        parent: Optional["Context"] = None,
    ):
        self.id: str = request_id or uuid.uuid4().hex
        self.metadata: Dict[str, Any] = dict(metadata or {})
        self.created_at: float = time.monotonic()
        self._stop = asyncio.Event()
        self._kill = asyncio.Event()
        self._parent = parent
        self._children: list[Context] = []
        if parent is not None:
            parent._children.append(self)
            # inherit state if the parent was stopped/killed before we existed
            if parent.is_killed:
                self._kill.set()
                self._stop.set()
            elif parent.is_stopped:
                self._stop.set()

    # -- lifecycle ---------------------------------------------------------
    def stop_generating(self) -> None:
        """Graceful stop: engines should finish the in-flight step and end."""
        self._stop.set()
        for c in self._children:
            c.stop_generating()

    def kill(self) -> None:
        """Hard stop: abandon the stream immediately."""
        self._kill.set()
        self._stop.set()
        for c in self._children:
            c.kill()

    @property
    def is_stopped(self) -> bool:
        return self._stop.is_set() or (self._parent is not None and self._parent.is_stopped)

    @property
    def is_killed(self) -> bool:
        return self._kill.is_set() or (self._parent is not None and self._parent.is_killed)

    def raise_if_killed(self) -> None:
        if self.is_killed:
            raise CancellationError(f"request {self.id} killed")

    async def wait_stopped(self) -> None:
        await self._stop.wait()

    def child(self, request_id: Optional[str] = None) -> "Context":
        return Context(request_id=request_id or self.id, metadata=self.metadata, parent=self)

    # -- wire form ---------------------------------------------------------
    def to_headers(self) -> Dict[str, Any]:
        """Serializable subset propagated across the request plane."""
        return {"request_id": self.id, "metadata": self.metadata}

    @classmethod
    def from_headers(cls, headers: Dict[str, Any]) -> "Context":
        return cls(
            request_id=headers.get("request_id"),
            metadata=headers.get("metadata") or {},
        )

    def __repr__(self) -> str:  # pragma: no cover
        return f"Context(id={self.id!r}, stopped={self.is_stopped}, killed={self.is_killed})"
