"""Logging setup.

Port of dynamo_tpu/runtime/logging_util.py: `DYN_LOG=debug` or per-module
filters (`DYN_LOG=info,dynamo_tpu_torch.router=debug`), `DYN_LOG_JSONL=1`
for JSON-lines records, and `DYN_OTLP_ENDPOINT=http://collector:4318`
ships records to an OpenTelemetry collector over OTLP/HTTP JSON
(/v1/logs) from a daemon thread on urllib. `configure_logging` also
configures span export (runtime/tracing.py `configure_tracing`); the
worker's and the frontend's `main` call it first.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time

_CONFIGURED = False


class JsonlFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        out = {
            "ts": time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime(record.created))
            + f".{int(record.msecs):03d}Z",
            "level": record.levelname,
            "target": record.name,
            "message": record.getMessage(),
        }
        if record.exc_info:
            out["exception"] = self.formatException(record.exc_info)
        for k in ("request_id", "component", "endpoint"):
            v = getattr(record, k, None)
            if v is not None:
                out[k] = v
        return json.dumps(out)


def configure_logging(default_level: str = "info") -> None:
    """Idempotent; call from every entrypoint."""
    global _CONFIGURED
    if _CONFIGURED:
        return
    _CONFIGURED = True

    spec = os.environ.get("DYN_LOG", default_level)
    parts = [p.strip() for p in spec.split(",") if p.strip()]
    root_level = "info"
    module_levels = {}
    for p in parts:
        if "=" in p:
            mod, lvl = p.split("=", 1)
            module_levels[mod] = lvl
        else:
            root_level = p

    handler = logging.StreamHandler(sys.stderr)
    if os.environ.get("DYN_LOG_JSONL", "").lower() in ("1", "true", "on", "yes"):
        handler.setFormatter(JsonlFormatter())
    else:
        handler.setFormatter(
            logging.Formatter("%(asctime)s %(levelname).1s %(name)s: %(message)s", "%H:%M:%S")
        )
    root = logging.getLogger()
    root.addHandler(handler)
    root.setLevel(root_level.upper())
    for mod, lvl in module_levels.items():
        logging.getLogger(mod).setLevel(lvl.upper())

    otlp = os.environ.get("DYN_OTLP_ENDPOINT")
    if otlp:
        root.addHandler(OtlpLogHandler(otlp))

    # span export rides the same env configuration (reference logging.rs
    # wires logs and traces through one OTLP pipeline)
    from dynamo_tpu_torch.runtime.tracing import configure_tracing

    configure_tracing()


_SEVERITY = {"DEBUG": 5, "INFO": 9, "WARNING": 13, "ERROR": 17, "CRITICAL": 21}


class OtlpLogHandler(logging.Handler):
    """Ship log records to an OTLP/HTTP collector (/v1/logs, JSON
    encoding). Batched and posted from a daemon thread so logging never
    blocks the serving path; drops on collector failure (telemetry is
    best-effort)."""

    def __init__(self, endpoint: str, service_name: str = "dynamo_tpu",
                 flush_interval_s: float = 2.0, max_batch: int = 512):
        super().__init__()
        self.url = endpoint.rstrip("/") + "/v1/logs"
        self.service_name = service_name
        self.flush_interval_s = flush_interval_s
        self.max_batch = max_batch
        import queue
        import threading

        self._q: "queue.Queue" = queue.Queue(maxsize=8192)
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def emit(self, record: logging.LogRecord) -> None:
        import queue

        # no logging in here: a log call from the log exporter recurses
        # straight back into emit
        try:
            wire = {
                "timeUnixNano": str(int(record.created * 1e9)),
                "severityNumber": _SEVERITY.get(record.levelname, 9),
                "severityText": record.levelname,
                "body": {"stringValue": record.getMessage()},
                "attributes": [
                    {"key": "target",
                     "value": {"stringValue": record.name}},
                ],
            }
        except Exception:
            self.handleError(record)  # bad format args: stderr, not a raise
            return
        try:
            self._q.put_nowait(wire)
        except queue.Full:
            pass  # full queue: drop

    def _loop(self) -> None:
        import queue
        import urllib.request

        while True:
            batch = [self._q.get()]
            deadline = time.monotonic() + self.flush_interval_s
            while len(batch) < self.max_batch:
                try:
                    batch.append(self._q.get(timeout=max(0.01, deadline - time.monotonic())))
                except queue.Empty:
                    break
            payload = json.dumps(
                {
                    "resourceLogs": [
                        {
                            "resource": {"attributes": [
                                {"key": "service.name",
                                 "value": {"stringValue": self.service_name}},
                            ]},
                            "scopeLogs": [{"scope": {}, "logRecords": batch}],
                        }
                    ]
                }
            ).encode()
            try:
                req = urllib.request.Request(
                    self.url, data=payload,
                    headers={"Content-Type": "application/json"},
                )
                urllib.request.urlopen(req, timeout=5).read()
            except (OSError, ValueError):
                # collector down / bad endpoint: telemetry drops, serving
                # unaffected (no logging here — it would feed back into
                # this exporter's own queue)
                pass
