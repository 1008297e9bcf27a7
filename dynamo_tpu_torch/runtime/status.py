"""Per-process status server: /live, /health, /metrics and the debug
routes on a side port of a worker or the frontend.

Port of dynamo_tpu/runtime/status.py `StatusServer`. The machine with the
card has no aiohttp, so it serves HTTP/1.1 with the port's own request
reader (frontend/http.py). Routes, as the reference's:

- ``GET /live``, ``GET /health`` (the registered checks; 503 when one
  fails), ``GET /metrics`` (the runtime's metrics in Prometheus text,
  with ``dynamo_tracing_dropped_spans`` while tracing is on);
- ``GET /debug/timeline?last_n=N``: the flight recorder as Chrome-trace
  JSON (404 without a timeline source);
- ``GET /debug/traces?trace_id=&last_n=``: the span ring (404 unless
  ``DYN_TRACE_RING`` armed it);
- ``GET /debug/<name>``: each `add_debug` source, fn(query) -> JSON;
- and any `add_route` handler (the worker's ``GET /profile?ms=N``).
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Awaitable, Callable, Dict, Optional
from urllib.parse import parse_qsl

from dynamo_tpu_torch.frontend.http import (
    HttpError,
    HttpService,
    Response,
    _error,
    _Reader,
    json_response,
    read_body,
    read_request,
)
from dynamo_tpu_torch.runtime import tracing

log = logging.getLogger("dynamo_tpu_torch.status")

Query = Dict[str, str]


class StatusServer:
    def __init__(self, runtime, port: int = 0, host: str = "0.0.0.0"):
        self.runtime = runtime
        self.host = host
        self.port = port
        self._checks: Dict[str, Callable[[], bool]] = {}
        self._timeline: Optional[Callable[[Optional[int]], dict]] = None
        self._debug: Dict[str, Callable[[Query], dict]] = {}
        self._routes: Dict[str, Callable[[Query], Awaitable[Response]]] = {}
        self._started_at = time.time()
        self._server: Optional[asyncio.AbstractServer] = None

    def add_check(self, name: str, fn: Callable[[], bool]) -> None:
        self._checks[name] = fn

    def add_timeline(self, fn: Callable[[Optional[int]], dict]) -> None:
        """The /debug/timeline source: fn(last_n) -> Chrome-trace dict."""
        self._timeline = fn

    def add_debug(self, name: str, fn: Callable[[Query], dict]) -> None:
        """A GET /debug/<name> JSON source: fn(query params) -> payload."""
        self._debug[name] = fn

    def add_route(self, path: str, fn: Callable[[Query], Awaitable[Response]]) -> None:
        """A GET route answered by an async fn(query params) -> Response."""
        self._routes[path] = fn

    async def start(self) -> str:
        self._server = await asyncio.start_server(self._handle_conn, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        return f"http://{self.host}:{self.port}"

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    async def _handle_conn(self, stream_reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        reader = _Reader(stream_reader)
        try:
            while True:
                try:
                    req = await read_request(reader)
                    if req is None:
                        return
                    req.body = await read_body(reader, req, writer)
                except HttpError as e:
                    if not reader.eof:
                        await HttpService._write(
                            writer, _error(e.status, str(e), "invalid_request_error"), False)
                    return
                keep = req.keep_alive
                await HttpService._write(writer, await self._answer(req), keep)
                if not keep:
                    return
        except (ConnectionError, OSError):
            pass  # the client went away
        finally:
            writer.close()

    async def _answer(self, req) -> Response:
        path, _, qs = req.path.partition("?")
        query = dict(parse_qsl(qs))
        if req.method != "GET":
            return _error(405, f"{req.method} not allowed", "invalid_request_error")
        try:
            if path == "/live":
                return json_response({"live": True,
                                      "uptime_s": time.time() - self._started_at})
            if path == "/health":
                return self._health()
            if path == "/metrics":
                return self._metrics()
            if path == "/debug/timeline":
                return self._debug_timeline(query)
            if path == "/debug/traces":
                return self._debug_traces(query)
            route = self._routes.get(path)
            if route is not None:
                return await route(query)
            if path.startswith("/debug/") and path[len("/debug/"):] in self._debug:
                return json_response(self._debug[path[len("/debug/"):]](query))
        except Exception as e:  # a debug source failed: report, keep serving
            log.warning("status route %s failed", path, exc_info=True)
            return json_response({"error": str(e)}, status=500)
        return _error(404, f"no route {path}", "not_found")

    def _health(self) -> Response:
        results = {}
        healthy = True
        for name, fn in self._checks.items():
            try:
                ok = bool(fn())
            except Exception:
                log.warning("health check %s raised", name, exc_info=True)
                ok = False
            results[name] = ok
            healthy = healthy and ok
        return json_response(
            {"status": "healthy" if healthy else "unhealthy", "checks": results},
            status=200 if healthy else 503)

    def _metrics(self) -> Response:
        if tracing.enabled():
            # silent span loss must be visible: the exporters' cumulative
            # drop count rides every scrape
            self.runtime.metrics.gauge(
                "tracing_dropped_spans",
                "spans dropped by the bounded trace exporter queue/ring",
            ).set(tracing.dropped_spans())
        return Response(self.runtime.metrics.render(),
                        content_type="text/plain; charset=utf-8")

    def _debug_traces(self, query: Query) -> Response:
        ring = tracing.span_ring()
        if ring is None:
            return json_response(
                {"error": "span ring not armed (set DYN_TRACE_RING)"}, status=404)
        try:
            last_n = int(query.get("last_n", 0))
        except ValueError:
            last_n = 0
        payload = ring.payload(trace_id=query.get("trace_id") or None, last_n=last_n)
        payload["dropped_spans"] = tracing.dropped_spans()
        return json_response(payload)

    def _debug_timeline(self, query: Query) -> Response:
        if self._timeline is None:
            return json_response({"error": "no timeline source on this process"},
                                 status=404)
        try:
            last_n = int(query.get("last_n", 0)) or None
        except ValueError:
            last_n = None
        return json_response(self._timeline(last_n))
