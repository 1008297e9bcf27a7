"""Per-request timelines and the JSONL trace sink.

Port of dynamo_tpu/frontend/request_trace.py: `RequestTiming` (one
request's timeline, for the frontend's metrics) and `RequestTracer`, a
JSONL sink enabled by the frontend's `--request-trace PATH` or
DYN_REQUEST_TRACE: one JSON object per completed request (timings,
token counts, finish reason, `ts`), replayable by a benchmark.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, Optional


class RequestTracer:
    def __init__(self, path: Optional[str] = None):
        self.path = path or os.environ.get("DYN_REQUEST_TRACE")
        self._lock = threading.Lock()
        self._fh = open(self.path, "a") if self.path else None

    @property
    def enabled(self) -> bool:
        return self._fh is not None

    def record(self, **fields: Any) -> None:
        if self._fh is None:
            return
        fields.setdefault("ts", time.time())
        with self._lock:
            self._fh.write(json.dumps(fields) + "\n")
            self._fh.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


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
