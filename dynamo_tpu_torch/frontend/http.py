"""OpenAI-compatible HTTP frontend on asyncio streams.

Port of dynamo_tpu/frontend/http.py `HttpService`. The machine with the
card has no aiohttp, so this module speaks HTTP/1.1 itself on
`asyncio.start_server`: keep-alive connections, request bodies by
Content-Length or chunked transfer (and `Expect: 100-continue`), JSON
answers with a Content-Length, and server-sent events in chunked
transfer. What goes on the wire inside that framing is the reference's:
the JSON bodies (`json.dumps`), the SSE lines (`data: {json}\\n\\n`, then
`data: [DONE]\\n\\n`) and the error shape.

Routes: GET /health, /live, /ready, /metrics, /v1/models,
/v1/models/{model}; POST /v1/completions and /v1/chat/completions, unary
and streamed (`stream_options.include_usage`), with the busy-threshold
503, the `x-dynamo-worker-instance-id` pin, `traceparent` passed on in
the request metadata, and X-Request-Id on streams; the logprob reports
(a streamed report's entries held until a chunk is sent) and tool-call
parsing of a chat with tools (frontend/tool_calls.py; a streamed one is
buffered and sent as one tool_calls delta), as the reference's; POST
/v1/embeddings, routed straight to the workers. A client that closes
its connection before its answer is complete kills the request and
closes the chain's stream at once, which frees the worker's pages.
Preprocessing runs inline (the reference offloads large prompts to a
compute pool). Not ported: /v1/responses, the Anthropic routes, batch
and files, realtime, the gRPC KServe frontend and SO_REUSEPORT workers.
`trace_path` (or DYN_REQUEST_TRACE) writes each finished request's
timeline as a JSONL record (frontend/request_trace.py `RequestTracer`).
"""

from __future__ import annotations

import asyncio
import http
import json
import logging
import random
import time
import uuid
from typing import Any, Dict, List, Optional, Tuple
from urllib.parse import unquote

from dynamo_tpu_torch.frontend.request_trace import RequestTiming, RequestTracer
from dynamo_tpu_torch.frontend.service import ModelManager, ModelWatcher
from dynamo_tpu_torch.frontend.tool_calls import parse_tool_calls
from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.runtime.request_plane import RequestPlaneError

log = logging.getLogger("dynamo_tpu_torch.http")

MAX_LINE = 64 * 1024  # request line, header line or chunk-size line
MAX_HEADERS = 128
MAX_BODY = 16 * 1024 * 1024
KEEPALIVE_S = 75.0  # idle keep-alive connections close after this


class HttpError(Exception):
    """A malformed request: answered with `status` and the connection
    closed."""

    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status


class _Reader:
    """A StreamReader with a pushback buffer: the disconnect watch of a
    request in flight reads ahead, and bytes it reads (a pipelined next
    request) go back in front of the stream."""

    def __init__(self, reader: asyncio.StreamReader):
        self._reader = reader
        self._buf = bytearray()
        self.eof = False

    async def _fill(self) -> None:
        data = await self._reader.read(65536)
        if not data:
            self.eof = True
            raise HttpError(400, "connection closed mid-request")
        self._buf += data

    async def readline(self) -> bytes:
        while True:
            i = self._buf.find(b"\n")
            if i >= 0:
                line = bytes(self._buf[:i + 1])
                del self._buf[:i + 1]
                return line
            if len(self._buf) > MAX_LINE:
                raise HttpError(431, "line too long")
            await self._fill()

    async def readexactly(self, n: int) -> bytes:
        while len(self._buf) < n:
            await self._fill()
        data = bytes(self._buf[:n])
        del self._buf[:n]
        return data

    async def wait_closed(self) -> None:
        """Returns when the peer closes its side; bytes that arrive before
        are kept for the next request."""
        while True:
            data = await self._reader.read(65536)
            if not data:
                self.eof = True
                return
            self._buf += data


class Request:
    def __init__(self, method: str, path: str, version: str,
                 headers: Dict[str, str], body: bytes):
        self.method = method
        self.path = path
        self.version = version
        self.headers = headers  # names lower-cased
        self.body = body

    @property
    def keep_alive(self) -> bool:
        conn = self.headers.get("connection", "").lower()
        if self.version == "HTTP/1.0":
            return conn == "keep-alive"
        return conn != "close"


class Response:
    """A complete answer: status, body bytes and content type."""

    def __init__(self, body: bytes, status: int = 200,
                 content_type: str = "application/json; charset=utf-8",
                 headers: Optional[Dict[str, str]] = None):
        self.body = body
        self.status = status
        self.content_type = content_type
        self.headers = headers or {}


def json_response(obj: Any, status: int = 200) -> Response:
    return Response(json.dumps(obj).encode(), status)


def _error(status: int, message: str, err_type: str) -> Response:
    return json_response({"error": {"message": message, "type": err_type, "code": status}},
                         status)


def _head(status: int, headers: List[Tuple[str, str]]) -> bytes:
    lines = [f"HTTP/1.1 {status} {http.HTTPStatus(status).phrase}"]
    lines += [f"{k}: {v}" for k, v in headers]
    return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")


class SseWriter:
    """Server-sent events in chunked transfer: each event is one chunk."""

    def __init__(self, writer: asyncio.StreamWriter):
        self._writer = writer

    async def write(self, data: bytes) -> None:
        self._writer.write(b"%x\r\n%s\r\n" % (len(data), data))
        await self._writer.drain()

    async def send(self, payload: Dict[str, Any]) -> None:
        await self.write(f"data: {json.dumps(payload)}\n\n".encode())

    async def end(self) -> None:
        self._writer.write(b"0\r\n\r\n")
        await self._writer.drain()


async def read_request(reader: _Reader) -> Optional[Request]:
    """One request off the connection, or None at a clean close between
    requests."""
    try:
        line = await reader.readline()
    except HttpError:
        if reader.eof:
            return None
        raise
    while line in (b"\r\n", b"\n"):  # tolerate blank lines between requests
        line = await reader.readline()
    try:
        method, target, version = line.decode("latin-1").split()
    except ValueError:
        raise HttpError(400, "malformed request line") from None
    if not version.startswith("HTTP/1."):
        raise HttpError(505, f"unsupported version {version}")
    headers: Dict[str, str] = {}
    while True:
        h = await reader.readline()
        if h in (b"\r\n", b"\n"):
            break
        if len(headers) >= MAX_HEADERS:
            raise HttpError(431, "too many headers")
        name, sep, value = h.decode("latin-1").partition(":")
        if not sep:
            raise HttpError(400, "malformed header line")
        name = name.strip().lower()
        value = value.strip()
        headers[name] = f"{headers[name]}, {value}" if name in headers else value
    return Request(method.upper(), target, version, headers, b"")


async def read_body(reader: _Reader, req: Request, writer: asyncio.StreamWriter) -> bytes:
    te = req.headers.get("transfer-encoding", "").lower()
    length = req.headers.get("content-length")
    if not te and length is None:
        return b""
    if req.headers.get("expect", "").lower() == "100-continue":
        writer.write(b"HTTP/1.1 100 Continue\r\n\r\n")
        await writer.drain()
    if te:
        if te != "chunked":
            raise HttpError(501, f"transfer-encoding {te} not supported")
        parts, total = [], 0
        while True:
            size_line = (await reader.readline()).split(b";")[0].strip()
            try:
                size = int(size_line, 16)
            except ValueError:
                raise HttpError(400, "malformed chunk size") from None
            if size == 0:
                while (await reader.readline()) not in (b"\r\n", b"\n"):
                    pass  # trailers
                return b"".join(parts)
            total += size
            if total > MAX_BODY:
                raise HttpError(413, "request body too large")
            parts.append(await reader.readexactly(size))
            await reader.readline()  # the chunk's CRLF
    try:
        n = int(length)
    except ValueError:
        raise HttpError(400, "malformed content-length") from None
    if n < 0:
        raise HttpError(400, "malformed content-length")
    if n > MAX_BODY:
        raise HttpError(413, "request body too large")
    return await reader.readexactly(n)


def _request_context(req: Request, model: str) -> Context:
    """The request's Context: an `x-dynamo-worker-instance-id` header (hex)
    pins the worker, and a `traceparent` rides in the metadata."""
    md: Dict[str, Any] = {"model": model}
    tgt = req.headers.get("x-dynamo-worker-instance-id")
    if tgt:
        try:
            md["target_instance"] = int(tgt, 16)
        except ValueError:
            # an explicit target must fail loudly, never silently re-route
            raise _BadRequest(json_response({"error": {
                "message": f"invalid x-dynamo-worker-instance-id {tgt!r} "
                           "(hex instance id expected)",
                "type": "invalid_request_error"}}, 400)) from None
    traceparent = req.headers.get("traceparent")
    if traceparent:
        md["traceparent"] = traceparent
    return Context(metadata=md)


class _BadRequest(Exception):
    def __init__(self, response: Response):
        super().__init__(response.status)
        self.response = response


class HttpService:
    def __init__(
        self,
        runtime,
        manager: Optional[ModelManager] = None,
        watcher: Optional[ModelWatcher] = None,
        host: str = "127.0.0.1",
        port: int = 8080,
        busy_threshold: int = 0,  # max in-flight requests per model (0 = off)
        trace_path: Optional[str] = None,  # JSONL request trace (RequestTracer)
    ):
        self.runtime = runtime
        self.tracer = RequestTracer(trace_path)
        self.manager = manager or ModelManager()
        self.watcher = watcher or ModelWatcher(runtime, self.manager)
        self.host = host
        self.port = port
        self.busy_threshold = busy_threshold
        self._in_flight: Dict[str, int] = {}
        self._server: Optional[asyncio.AbstractServer] = None
        self._conns: set = set()  # open connection writers
        self._busy: set = set()  # connections with a request in flight
        self._draining = False
        self._routes = {
            ("GET", "/health"): self.health,
            ("GET", "/live"): self.live,
            ("GET", "/ready"): self.ready,
            ("GET", "/metrics"): self.metrics,
            ("GET", "/v1/models"): self.list_models,
            ("POST", "/v1/completions"): self.completions,
            ("POST", "/v1/chat/completions"): self.chat_completions,
            ("POST", "/v1/embeddings"): self.embeddings,
        }

    def inflight_inc(self, model: str) -> None:
        """The busy-threshold count and the frontend_in_flight gauge move
        together."""
        self._in_flight[model] = self._in_flight.get(model, 0) + 1
        self.runtime.metrics.gauge("frontend_in_flight", "in-flight requests",
                                   model=model).inc()

    def inflight_dec(self, model: str) -> None:
        self._in_flight[model] = max(0, self._in_flight.get(model, 1) - 1)
        self.runtime.metrics.gauge("frontend_in_flight", "in-flight requests",
                                   model=model).dec()

    # -- lifecycle ---------------------------------------------------------
    async def start(self) -> str:
        await self.watcher.start()
        self._server = await asyncio.start_server(self._handle_conn, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        log.info("HTTP frontend on http://%s:%d", self.host, self.port)
        return f"http://{self.host}:{self.port}"

    async def stop(self, drain_timeout: float = 30.0) -> None:
        """Stop accepting, let requests in flight finish (up to
        `drain_timeout`), then close every connection and the model
        chains."""
        self._draining = True
        if self._server is not None:
            self._server.close()
        loop = asyncio.get_running_loop()
        deadline = loop.time() + drain_timeout
        while self._busy and loop.time() < deadline:
            await asyncio.sleep(0.05)
        for w in list(self._conns):
            w.close()
        if self._server is not None:
            await self._server.wait_closed()
        await self.watcher.stop()
        self.tracer.close()

    # -- connections -------------------------------------------------------
    async def _handle_conn(self, stream_reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        reader = _Reader(stream_reader)
        self._conns.add(writer)
        try:
            while not self._draining:
                try:
                    req = await asyncio.wait_for(read_request(reader), KEEPALIVE_S)
                    if req is None:
                        return
                    req.body = await read_body(reader, req, writer)
                except HttpError as e:
                    if not reader.eof:
                        await self._write(writer, _error(e.status, str(e), "invalid_request_error"),
                                          keep_alive=False)
                    return
                except asyncio.TimeoutError:
                    return
                self._busy.add(writer)
                try:
                    keep = await self._serve(req, reader, writer)
                finally:
                    self._busy.discard(writer)
                if not keep or reader.eof:
                    return
        except (ConnectionError, OSError):
            pass  # the client went away
        finally:
            self._conns.discard(writer)
            writer.close()

    async def _serve(self, req: Request, reader: _Reader,
                     writer: asyncio.StreamWriter) -> bool:
        """Answer one request while watching for the client to close its
        side: a client gone mid-answer cancels the handler. Returns
        whether the connection stays open."""
        keep = req.keep_alive and not self._draining
        handler = asyncio.create_task(self._dispatch(req, writer, keep))
        gone = asyncio.create_task(reader.wait_closed())
        try:
            done, _ = await asyncio.wait({handler, gone},
                                         return_when=asyncio.FIRST_COMPLETED)
        finally:
            if not handler.done():
                # the client closed its side: stop generating now
                handler.cancel()
            gone.cancel()
            results = await asyncio.gather(handler, gone, return_exceptions=True)
        if isinstance(results[0], BaseException):
            if not isinstance(results[0], asyncio.CancelledError):
                raise results[0]
            return False
        return keep

    async def _dispatch(self, req: Request, writer: asyncio.StreamWriter,
                        keep: bool) -> None:
        path = req.path.split("?", 1)[0]
        route = self._routes.get((req.method, path))
        if route is None and req.method == "GET" and path.startswith("/v1/models/"):
            resp = await self.get_model(unquote(path[len("/v1/models/"):]))
        elif route is None:
            known = {p for _, p in self._routes}
            status = 405 if path in known else 404
            resp = Response(f"{status}: {http.HTTPStatus(status).phrase}".encode(),
                            status, "text/plain; charset=utf-8")
        else:
            try:
                resp = await route(req, writer, keep)
            except (ConnectionError, OSError):
                raise  # the client went away
            except Exception as e:  # the request's boundary: report, keep serving
                log.exception("%s %s failed", req.method, path)
                resp = _error(500, str(e), "internal_error")
        if resp is not None:
            await self._write(writer, resp, keep)

    @staticmethod
    async def _write(writer: asyncio.StreamWriter, resp: Response, keep_alive: bool) -> None:
        headers = [("Content-Type", resp.content_type),
                   ("Content-Length", str(len(resp.body))), *resp.headers.items()]
        if not keep_alive:
            headers.append(("Connection", "close"))
        writer.write(_head(resp.status, headers) + resp.body)
        await writer.drain()

    # -- ops endpoints -----------------------------------------------------
    async def health(self, req, writer, keep) -> Response:
        return json_response({"status": "healthy", "models": self.manager.list_models()})

    async def live(self, req, writer, keep) -> Response:
        return json_response({"live": True})

    async def ready(self, req, writer, keep) -> Response:
        ok = bool(self.manager.models)
        return json_response({"ready": ok}, status=200 if ok else 503)

    async def metrics(self, req, writer, keep) -> Response:
        return Response(self.runtime.metrics.render(), content_type="text/plain; charset=utf-8")

    # -- model endpoints ---------------------------------------------------
    async def list_models(self, req, writer, keep) -> Response:
        return json_response({
            "object": "list",
            "data": [{"id": name, "object": "model", "created": int(time.time()),
                      "owned_by": "dynamo_tpu"}
                     for name in self.manager.list_models()],
        })

    async def get_model(self, name: str) -> Response:
        if name not in self.manager.models:
            return _error(404, f"model {name!r} not found", "model_not_found")
        return json_response({"id": name, "object": "model", "owned_by": "dynamo_tpu"})

    # -- embeddings ----------------------------------------------------------
    async def embeddings(self, req, writer, keep) -> Response:
        """OpenAI embeddings: each input tokenized (no BOS) and sent
        straight to the workers (no detokenizer or migration), all at
        once, so the engine batches them into one pass."""
        try:
            body = json.loads(req.body)
        except ValueError:
            return _error(400, "invalid JSON body", "invalid_request_error")
        if not isinstance(body, dict):
            return _error(400, "the JSON body must be an object", "invalid_request_error")
        model = body.get("model")
        try:
            entry = self.manager.get(model)
        except KeyError:
            return _error(404, f"model {model!r} not found", "model_not_found")
        inputs = body.get("input")
        if isinstance(inputs, str):
            inputs = [inputs]
        if not isinstance(inputs, list) or not inputs:
            return _error(400, "input must be a string or non-empty list",
                          "invalid_request_error")
        if all(isinstance(x, int) for x in inputs):
            inputs = [inputs]  # one token-id prompt
        token_lists = [entry.preprocessor.tokenize_prompt(x, add_bos=False)
                       if isinstance(x, str) else [int(t) for t in x]
                       for x in inputs]
        n_tokens = sum(len(t) for t in token_lists)
        try:
            contexts = [_request_context(req, model) for _ in token_lists]
        except _BadRequest as e:
            return e.response

        async def one(token_ids, ctx):
            request = {"token_ids": token_ids, "annotations": {"kind": "embedding"},
                       "model": model}
            async for item in entry.client.generate(request, ctx):
                if "embedding" in item:
                    return item["embedding"]
                if item.get("finish_reason"):
                    break
            return None

        try:
            vecs = await asyncio.gather(*[one(t, c) for t, c in zip(token_lists, contexts)])
        except Exception as e:  # the request's boundary: report, keep serving
            log.exception("embedding request failed")
            return _error(500, str(e), "internal_error")
        if any(v is None for v in vecs):
            return _error(500, "worker returned no embedding", "internal_error")
        return json_response({
            "object": "list",
            "data": [{"object": "embedding", "index": i, "embedding": v}
                     for i, v in enumerate(vecs)],
            "model": model,
            "usage": {"prompt_tokens": n_tokens, "total_tokens": n_tokens},
        })

    # -- inference endpoints -----------------------------------------------
    async def chat_completions(self, req, writer, keep) -> Optional[Response]:
        return await self._run_inference(req, writer, keep, kind="chat")

    async def completions(self, req, writer, keep) -> Optional[Response]:
        return await self._run_inference(req, writer, keep, kind="completions")

    async def _run_inference(self, req: Request, writer, keep: bool,
                             kind: str) -> Optional[Response]:
        try:
            body = json.loads(req.body)
        except ValueError:  # JSONDecodeError and undecodable bytes
            return _error(400, "invalid JSON body", "invalid_request_error")
        if not isinstance(body, dict):
            return _error(400, "the JSON body must be an object", "invalid_request_error")
        model = body.get("model")
        try:
            entry = self.manager.get(model)
        except KeyError:
            return _error(404, f"model {model!r} not found", "model_not_found")
        # busy-threshold load shedding
        if self.busy_threshold and self._in_flight.get(model, 0) >= self.busy_threshold:
            return _error(503, "server busy, retry later", "server_busy")
        pre_fn = (entry.preprocessor.preprocess_chat if kind == "chat"
                  else entry.preprocessor.preprocess_completions)
        try:
            preprocessed = pre_fn(body)
        except ValueError as e:
            return _error(400, str(e), "invalid_request_error")
        if "priority" in body:
            # the admission queue's class (0 = most urgent), opt-in
            try:
                preprocessed["priority"] = int(body["priority"])
            except (TypeError, ValueError):
                return _error(400, "priority must be an integer", "invalid_request_error")
        try:
            ctx = _request_context(req, model)
        except _BadRequest as e:
            return e.response
        rid = f"{'chatcmpl' if kind == 'chat' else 'cmpl'}-{uuid.uuid4().hex[:24]}"
        stream = bool(body.get("stream", False))
        created = int(time.time())
        try:
            n_choices = max(1, int(body.get("n") or 1))
        except (TypeError, ValueError):
            return _error(400, "n must be an integer", "invalid_request_error")
        if n_choices > 1 and stream:
            return _error(400, "streaming with n>1 is not supported", "invalid_request_error")
        if n_choices > 16:
            return _error(400, "n is capped at 16", "invalid_request_error")

        timing = RequestTiming(ctx.id, model, kind, len(preprocessed["token_ids"]))
        # n generations charge n units of load
        for _ in range(n_choices):
            self.inflight_inc(model)
        m = self.runtime.metrics
        try:
            if stream:
                include_usage = bool((body.get("stream_options") or {}).get("include_usage"))
                await self._stream_response(writer, keep, entry, preprocessed, ctx, rid,
                                            model, created, kind, timing, include_usage)
                return None
            return await self._unary_response(entry, preprocessed, ctx, rid, model,
                                              created, kind, timing, n=n_choices)
        except asyncio.CancelledError:
            ctx.kill()  # the client disconnected
            raise
        finally:
            for _ in range(n_choices):
                self.inflight_dec(model)
            if self.tracer.enabled:
                self.tracer.record(**timing.fields(stream=stream))
            f = timing.fields()
            m.counter("frontend_requests_total", "completed requests", model=model,
                      finish=str(f["finish_reason"] or "none")).inc()
            m.counter("frontend_output_tokens_total", "generated tokens",
                      model=model).inc(max(0, f["osl"]))
            m.histogram("frontend_request_duration_seconds", "request wall time",
                        model=model).observe(f["total_s"])
            if f["ttft_s"] is not None:
                m.histogram("frontend_ttft_seconds", "time to first token",
                            model=model).observe(f["ttft_s"])

    async def _stream_response(self, writer, keep, entry, preprocessed, ctx, rid, model,
                               created, kind, timing, include_usage) -> None:
        headers = [("Content-Type", "text/event-stream"), ("Cache-Control", "no-cache"),
                   ("X-Request-Id", ctx.id), ("Transfer-Encoding", "chunked")]
        if not keep:
            headers.append(("Connection", "close"))
        writer.write(_head(200, headers))
        sse = SseWriter(writer)
        obj = "chat.completion.chunk" if kind == "chat" else "text_completion"
        tokenizer = entry.preprocessor.tokenizer
        n_out = 0
        # a chat with tools is buffered: the call markup parses only whole,
        # and clients expect tool_calls deltas, not markup fragments
        buffer_tools = kind == "chat" and (preprocessed.get("annotations") or {}).get("tools")
        buffered: List[str] = []
        tools_flushed = False
        # logprob entries of items whose chunk was not sent yet (an empty
        # text delta) ride on the next chunk sent
        lp_hold_ids: List[int] = []
        lp_hold: List[Dict[str, Any]] = []
        sent_text_len = 0

        async def flush_tools(finish_reason) -> None:
            nonlocal tools_flushed
            tools_flushed = True
            content, calls = parse_tool_calls("".join(buffered))
            if calls:
                delta = {"tool_calls": [{**c, "index": i} for i, c in enumerate(calls)]}
                if content:
                    delta["content"] = content
                chunk = _chat_chunk(rid, model, created, delta, "tool_calls")
            else:
                chunk = _chat_chunk(rid, model, created,
                                    {"content": content} if content else {}, finish_reason)
            if lp_hold:
                chunk["choices"][0]["logprobs"] = _format_logprobs(
                    tokenizer, kind, lp_hold_ids, lp_hold)
            await sse.send(chunk)

        try:
            if kind == "chat":
                await sse.send(_chat_chunk(rid, model, created, {"role": "assistant"}, None))
            async for item in entry.chain.generate(preprocessed, ctx):
                text = item.get("text", "")
                finish = item.get("finish_reason")
                n = len(item.get("token_ids") or [])
                n_out += n
                timing.on_tokens(n)
                if finish:
                    timing.finish_reason = finish
                if item.get("logprobs"):
                    lp_hold_ids.extend(item.get("token_ids") or [])
                    lp_hold.extend(item["logprobs"])
                if buffer_tools:
                    buffered.append(text)
                    if finish:
                        await flush_tools(finish)
                        break
                    continue
                if text or finish:
                    chunk_lp = None
                    if lp_hold:
                        chunk_lp = _format_logprobs(tokenizer, kind, lp_hold_ids,
                                                    lp_hold, offset0=sent_text_len)
                        lp_hold_ids, lp_hold = [], []
                    sent_text_len += len(text)
                    if kind == "chat":
                        chunk = _chat_chunk(rid, model, created,
                                            {"content": text} if text else {}, finish)
                        if chunk_lp is not None:
                            chunk["choices"][0]["logprobs"] = chunk_lp
                    else:
                        choice = {"index": 0, "text": text, "finish_reason": finish}
                        if chunk_lp is not None:
                            choice["logprobs"] = chunk_lp
                        chunk = {"id": rid, "object": obj, "created": created,
                                 "model": model, "choices": [choice]}
                    await sse.send(chunk)
                if finish:
                    break
            if buffer_tools and not tools_flushed:
                # the stream ended without a finish: the buffered text
                # still reaches the client
                await flush_tools("stop")
            if include_usage:
                # one last chunk with EMPTY choices carrying the totals
                n_prompt = len(preprocessed["token_ids"])
                await sse.send({"id": rid, "object": obj, "created": created,
                                "model": model, "choices": [],
                                "usage": {"prompt_tokens": n_prompt,
                                          "completion_tokens": n_out,
                                          "total_tokens": n_prompt + n_out}})
            await sse.write(b"data: [DONE]\n\n")
        except (ConnectionError, asyncio.CancelledError):
            ctx.kill()  # client disconnected
            raise
        except Exception as e:  # the headers went out: report in band
            if isinstance(e, RequestPlaneError) and e.code in ("queue_full", "queue_timeout"):
                await sse.send({"error": {"message": str(e), "type": "server_overloaded"}})
            else:
                log.exception("stream failed for %s", rid)
                await sse.send({"error": {"message": str(e), "type": "internal_error"}})
        finally:
            ctx.stop_generating()
        await sse.end()

    async def _unary_response(self, entry, preprocessed, ctx, rid, model, created, kind,
                              timing, n=1) -> Response:
        try:
            if n == 1:
                body = await generate_unary_body(entry, preprocessed, ctx, rid, model,
                                                  created, kind, timing=timing)
            else:
                body = await self._unary_choices(entry, preprocessed, ctx, rid, model,
                                                 created, kind, timing, n)
        except RequestPlaneError as e:
            if e.code in ("queue_full", "queue_timeout"):
                # the router's admission queue refused: 429, not 500
                return _error(429, str(e), "server_overloaded")
            log.exception("request %s failed", rid)
            return _error(500, str(e), "internal_error")
        except Exception as e:  # the request's boundary: report, keep serving
            log.exception("request %s failed", rid)
            return _error(500, str(e), "internal_error")
        return json_response(body)

    @staticmethod
    async def _unary_choices(entry, preprocessed, ctx, rid, model, created, kind,
                             timing, n) -> Dict[str, Any]:
        """OpenAI n > 1: n generations with seeds derived from the
        request's (greedy requests give identical choices)."""
        base_seed = (preprocessed.get("sampling") or {}).get("seed")
        if base_seed is None:
            base_seed = random.getrandbits(31)

        async def one(i):
            req_i = dict(preprocessed)
            req_i["sampling"] = dict(preprocessed.get("sampling") or {})
            req_i["sampling"]["seed"] = int(base_seed) + i
            return await generate_unary_body(entry, req_i, ctx.child(f"{ctx.id}-c{i}"),
                                             rid, model, created, kind,
                                             timing=timing if i == 0 else None)

        tasks = [asyncio.ensure_future(one(i)) for i in range(n)]
        try:
            bodies = await asyncio.gather(*tasks)
        except BaseException:
            # one failed choice must not leave its siblings generating
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)
            raise
        body = bodies[0]
        choices, completion_tokens = [], 0
        for i, b in enumerate(bodies):
            c = b["choices"][0]
            c["index"] = i
            choices.append(c)
            completion_tokens += b["usage"]["completion_tokens"]
        body["choices"] = choices
        n_prompt = body["usage"]["prompt_tokens"]
        body["usage"] = {"prompt_tokens": n_prompt, "completion_tokens": completion_tokens,
                         "total_tokens": n_prompt + completion_tokens}
        # choice 0's tokens were counted live; fold in the others'
        timing.on_tokens(completion_tokens - bodies[0]["usage"]["completion_tokens"])
        return body


async def generate_unary_body(entry, preprocessed, ctx, rid, model, created, kind,
                              timing=None) -> Dict[str, Any]:
    """Run one request through the serving chain and assemble the OpenAI
    unary body. Raises on failure (an engine error item included)."""
    text_parts = []
    finish = None
    n_prompt = len(preprocessed["token_ids"])
    n_out = 0
    lp_tokens: List[int] = []  # token ids with logprob entries (aligned)
    lp_entries: List[Dict[str, Any]] = []
    try:
        async for item in entry.chain.generate(preprocessed, ctx):
            if item.get("finish_reason") == "error":
                raise RuntimeError(item.get("error") or "engine error")
            text_parts.append(item.get("text", ""))
            n_out += len(item.get("token_ids") or [])
            if item.get("logprobs"):
                lp_tokens.extend(item.get("token_ids") or [])
                lp_entries.extend(item["logprobs"])
            if timing is not None:
                timing.on_tokens(len(item.get("token_ids") or []))
            if item.get("finish_reason"):
                finish = item["finish_reason"]
                if timing is not None:
                    timing.finish_reason = finish
                break
    finally:
        ctx.stop_generating()
    text = "".join(text_parts)
    usage = {"prompt_tokens": n_prompt, "completion_tokens": n_out,
             "total_tokens": n_prompt + n_out}
    if kind == "chat":
        message: Dict[str, Any] = {"role": "assistant", "content": text}
        if (preprocessed.get("annotations") or {}).get("tools"):
            content, calls = parse_tool_calls(text)
            if calls:
                message = {"role": "assistant", "content": content or None,
                           "tool_calls": calls}
                finish = "tool_calls"
        body = {"id": rid, "object": "chat.completion", "created": created,
                "model": model,
                "choices": [{"index": 0, "message": message,
                             "finish_reason": finish or "stop"}],
                "usage": usage}
    else:
        body = {"id": rid, "object": "text_completion", "created": created,
                "model": model,
                "choices": [{"index": 0, "text": text, "finish_reason": finish or "stop"}],
                "usage": usage}
    if lp_entries:
        body["choices"][0]["logprobs"] = _format_logprobs(
            entry.preprocessor.tokenizer, kind, lp_tokens, lp_entries)
    return body


def _format_logprobs(tokenizer, kind: str, token_ids, entries,
                     offset0: int = 0) -> Dict[str, Any]:
    """Engine logprob records as the OpenAI shape: per-token content
    entries for chat, parallel arrays for completions. `entries` align
    1:1 with `token_ids`; `offset0` seeds text_offset for a streamed
    chunk (offsets accumulate over the whole completion)."""

    def tok_str(tid: int) -> str:
        try:
            return tokenizer.decode([tid])
        except Exception:
            return f"<{tid}>"

    if kind == "chat":
        return {"content": [
            {"token": tok_str(tid), "logprob": e["logprob"], "bytes": None,
             "top_logprobs": [{"token": tok_str(i), "logprob": v, "bytes": None}
                              for i, v in zip(e["top_ids"], e["top_logprobs"])]}
            for tid, e in zip(token_ids, entries)]}
    offset = offset0
    tokens, token_logprobs, top_logprobs, text_offset = [], [], [], []
    for tid, e in zip(token_ids, entries):
        s = tok_str(tid)
        tokens.append(s)
        token_logprobs.append(e["logprob"])
        top: Dict[str, float] = {}
        for i, v in zip(e["top_ids"], e["top_logprobs"]):
            # the first (highest) value wins where ids decode alike
            top.setdefault(tok_str(i), v)
        top_logprobs.append(top)
        text_offset.append(offset)
        offset += len(s)
    return {"tokens": tokens, "token_logprobs": token_logprobs,
            "top_logprobs": top_logprobs, "text_offset": text_offset}


def _chat_chunk(rid, model, created, delta, finish) -> Dict[str, Any]:
    return {"id": rid, "object": "chat.completion.chunk", "created": created,
            "model": model,
            "choices": [{"index": 0, "delta": delta, "finish_reason": finish}]}
