"""One request's timeline, for the frontend's metrics.

Port of `RequestTiming` from dynamo_tpu/frontend/request_trace.py; the
JSONL trace sink (`RequestTracer`) is not ported.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional


class RequestTiming:
    def __init__(self, request_id: str, model: str, kind: str, isl: int):
        self.request_id = request_id
        self.model = model
        self.kind = kind
        self.isl = isl
        self.start = time.monotonic()
        self.first_token_at: Optional[float] = None
        self.osl = 0
        self.finish_reason: Optional[str] = None

    def on_tokens(self, n: int) -> None:
        if n > 0 and self.first_token_at is None:
            self.first_token_at = time.monotonic()
        self.osl += n

    def fields(self, **extra: Any) -> Dict[str, Any]:
        now = time.monotonic()
        return {
            "request_id": self.request_id,
            "model": self.model,
            "kind": self.kind,
            "isl": self.isl,
            "osl": self.osl,
            "ttft_s": (self.first_token_at - self.start) if self.first_token_at else None,
            "total_s": now - self.start,
            "finish_reason": self.finish_reason,
            **extra,
        }
