"""TCP/msgpack request plane.

Port of dynamo_tpu/runtime/request_plane.py: PushEndpoint ingress,
multiplexed client connections, PushRouter egress and the in-process
plane. Frames are length-prefixed msgpack maps, written by
`runtime/codec.py` byte for byte as the reference writes them, so a port
server answers a reference client and the other way round:
  client→server: {"t":"req","id",...,"endpoint","headers","payload"}
                 {"t":"cancel","id"}       (graceful stop_generating)
                 {"t":"kill","id"}         (hard kill)
  server→client: {"t":"item","id","data"} ...  {"t":"done","id"}
                 {"t":"err","id","msg","code"}

Connections are MULTIPLEXED: many id-tagged request streams interleave on
one TCP connection; a small per-address connection set fans out streams by
least-streams-first, so hundreds of concurrent requests ride a handful of
sockets. The native frame splitter, the NATS plane and the per-hop tracing
spans are not ported yet; a `traceparent` in the request metadata rides
the headers untouched.
"""

from __future__ import annotations

import asyncio
import logging
import random
import struct
import time
from typing import Any, AsyncIterator, Dict, Optional, Tuple

from dynamo_tpu_torch.runtime import codec
from dynamo_tpu_torch.runtime.context import CancellationError, Context
from dynamo_tpu_torch.runtime.engine import AsyncEngine
from dynamo_tpu_torch.runtime.tasks import spawn_tracked

log = logging.getLogger("dynamo_tpu_torch.request_plane")

_LEN = struct.Struct(">I")
MAX_FRAME = 256 * 1024 * 1024


class RequestPlaneError(Exception):
    """Transport-level failure; carries a code used by migration and
    failover classification: cannot_connect, disconnected, draining,
    no_endpoint, no_instances, no_target, cancelled, engine, protocol."""

    def __init__(self, msg: str, code: str = "internal"):
        super().__init__(msg)
        self.code = code


def frame_bytes(obj: Dict[str, Any]) -> bytes:
    """One length-prefixed frame: the only copy of a large bytes value is
    this join."""
    parts = codec.pack_parts(obj)
    n = sum(len(p) for p in parts)
    if n > MAX_FRAME:
        raise RequestPlaneError(f"frame too large: {n}", code="protocol")
    return b"".join([_LEN.pack(n), *parts])


async def _send_frame(writer: asyncio.StreamWriter, obj: Dict[str, Any]) -> None:
    writer.write(frame_bytes(obj))
    await writer.drain()


async def _recv_frame(reader: asyncio.StreamReader) -> Optional[Dict[str, Any]]:
    try:
        # the idle wait between frames: blocking here forever is the
        # contract, and peer death surfaces as IncompleteReadError
        hdr = await reader.readexactly(4)
    except (asyncio.IncompleteReadError, ConnectionResetError):
        return None
    (n,) = _LEN.unpack(hdr)
    if n > MAX_FRAME:
        raise RequestPlaneError(f"frame too large: {n}", code="protocol")
    try:
        body = await reader.readexactly(n)
    except (asyncio.IncompleteReadError, ConnectionResetError):
        return None
    try:
        return codec.unpackb(body)
    except ValueError as e:
        raise RequestPlaneError(f"malformed frame: {e}", code="protocol") from None


class PushEndpoint:
    """Server side: serves one AsyncEngine per endpoint path on a TCP port.
    One server instance hosts every endpoint a process serves."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self.host = host
        self.port = port
        self._engines: Dict[str, AsyncEngine] = {}
        self._server: Optional[asyncio.AbstractServer] = None
        self._active: Dict[str, Context] = {}
        self._conns: set = set()  # open connection writers (for shutdown)
        self._draining = False

    def add_endpoint(self, path: str, engine: AsyncEngine) -> None:
        self._engines[path] = engine

    def remove_endpoint(self, path: str) -> None:
        self._engines.pop(path, None)

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    @property
    def active_requests(self) -> int:
        return len(self._active)

    async def start(self) -> str:
        self._server = await asyncio.start_server(self._handle_conn, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        return self.address

    async def stop(self, drain_timeout: float = 30.0) -> None:
        """Graceful shutdown: refuse new requests, wait for in-flight to
        drain, then kill stragglers."""
        self._draining = True
        if self._server is not None:
            self._server.close()
        loop = asyncio.get_running_loop()
        deadline = loop.time() + drain_timeout
        while self._active and loop.time() < deadline:
            await asyncio.sleep(0.05)
        for ctx in list(self._active.values()):
            ctx.kill()
        # close lingering (e.g. idle pooled) connections, else wait_closed()
        # blocks on parked connection handlers
        for w in list(self._conns):
            w.close()
        if self._server is not None:
            await self._server.wait_closed()

    async def _handle_conn(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        """Single reader loop per connection: `req` frames spawn response
        tasks; `cancel`/`kill` frames route to the matching in-flight
        context."""
        conn_ctxs: Dict[str, Context] = {}
        tasks: set = set()
        wlock = asyncio.Lock()
        self._conns.add(writer)

        async def send(obj: Dict[str, Any]) -> None:
            async with wlock:
                await _send_frame(writer, obj)

        try:
            while True:
                frame = await _recv_frame(reader)
                if frame is None:
                    return
                t = frame.get("t")
                if t == "req":
                    task = asyncio.create_task(self._handle_request(frame, send, conn_ctxs))
                    tasks.add(task)
                    task.add_done_callback(tasks.discard)
                elif t in ("cancel", "kill"):
                    ctx = conn_ctxs.get(frame.get("id"))
                    if ctx is not None:
                        ctx.kill() if t == "kill" else ctx.stop_generating()
        except (ConnectionResetError, BrokenPipeError, RequestPlaneError):
            pass
        finally:
            self._conns.discard(writer)
            for ctx in conn_ctxs.values():
                ctx.kill()  # client went away
            for task in tasks:
                task.cancel()
            writer.close()

    async def _handle_request(self, frame: Dict[str, Any], send,
                              conn_ctxs: Dict[str, Context]) -> None:
        rid = frame["id"]
        path = frame["endpoint"]
        engine = self._engines.get(path)
        if engine is None or self._draining:
            code = "draining" if self._draining else "no_endpoint"
            await send({"t": "err", "id": rid, "msg": f"{code}: {path}", "code": code})
            return
        ctx = Context.from_headers(frame.get("headers") or {})
        self._active[rid] = ctx
        conn_ctxs[rid] = ctx
        stream = engine.generate(frame.get("payload"), ctx)
        try:
            async for item in stream:
                if ctx.is_killed:
                    raise CancellationError(rid)
                await send({"t": "item", "id": rid, "data": item})
            await send({"t": "done", "id": rid})
        except CancellationError:
            try:
                await send({"t": "err", "id": rid, "msg": "killed", "code": "cancelled"})
            except ConnectionError:
                pass
        except ConnectionError:
            ctx.kill()
        except Exception as e:  # engine fault → error frame
            log.exception("engine error on %s", path)
            # a handler-supplied code (a hop re-raising cannot_connect) is
            # kept: the caller's failover classification depends on it
            code = getattr(e, "code", None) or "engine"
            try:
                await send({"t": "err", "id": rid, "msg": str(e), "code": code})
            except ConnectionError:
                pass
        finally:
            # close the engine's stream now, not at garbage collection: its
            # cleanup (an engine abort releasing pages, a kv_fetch discard)
            # runs before the request counts as drained
            aclose = getattr(stream, "aclose", None)
            if aclose is not None:
                await aclose()
            self._active.pop(rid, None)
            conn_ctxs.pop(rid, None)


def _push_sentinel(q: asyncio.Queue, sentinel) -> None:
    try:
        q.put_nowait(sentinel)
    except asyncio.QueueFull:
        try:
            q.get_nowait()
        except asyncio.QueueEmpty:
            pass
        q.put_nowait(sentinel)


def _drain(q: Optional[asyncio.Queue]) -> None:
    """Empty a dead stream's queue so a producer blocked on it wakes."""
    while q is not None:
        try:
            q.get_nowait()
        except asyncio.QueueEmpty:
            break


class _MuxConn:
    """One TCP connection carrying many concurrent id-tagged streams. A
    single reader task demuxes inbound frames into per-stream queues; the
    shared writer is serialized by a lock. Death (EOF, reset, oversized
    frame) fans a disconnect sentinel out to every open stream."""

    _DISCONNECT = object()

    # Per-stream inbound buffer, in frames. Bounded so one slow consumer
    # (or a multi-GB chunked KV pull) applies TCP backpressure through the
    # shared socket instead of materializing in client memory; the cost is
    # head-of-line blocking on that conn once a stream is 16 frames behind.
    STREAM_BUF_FRAMES = 16

    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter,
                 gen: int = 0):
        self._reader = reader
        self._writer = writer
        self._wlock = asyncio.Lock()
        self._streams: Dict[str, asyncio.Queue] = {}
        self.closed = False
        self.gen = gen  # pool dial generation (stale-retry bookkeeping)
        self._reader_task = asyncio.create_task(self._read_loop())

    @property
    def n_streams(self) -> int:
        return len(self._streams)

    def open_stream(self, rid: str) -> asyncio.Queue:
        q: asyncio.Queue = asyncio.Queue(maxsize=self.STREAM_BUF_FRAMES)
        self._streams[rid] = q
        return q

    def close_stream(self, rid: str) -> None:
        _drain(self._streams.pop(rid, None))

    async def send(self, obj: Dict[str, Any]) -> None:
        async with self._wlock:
            await _send_frame(self._writer, obj)

    async def _read_loop(self) -> None:
        try:
            while True:
                frame = await _recv_frame(self._reader)
                if frame is None:
                    break
                # frames for unknown ids (stream abandoned client-side
                # before the server saw the kill) are dropped
                q = self._streams.get(frame.get("id"))
                if q is not None:
                    await q.put(frame)
        except (ConnectionError, asyncio.IncompleteReadError, OSError, RequestPlaneError):
            pass  # peer went away: close() below poisons pending streams
        finally:
            self.close()

    def close(self) -> None:
        if self.closed:
            return
        self.closed = True
        self._writer.close()
        for q in self._streams.values():
            _push_sentinel(q, self._DISCONNECT)

    def shutdown(self) -> None:
        self.close()
        self._reader_task.cancel()


class _ConnPool:
    """Per-address set of multiplexed connections. Streams land on the
    live connection with the fewest open streams; a new connection is
    dialed only when every existing one is at `STREAMS_PER_CONN`, up to
    `MAX_CONNS` (beyond that, streams stack on the least-loaded socket)."""

    MAX_CONNS = 8
    STREAMS_PER_CONN = 32
    CONNECT_TIMEOUT_S = 5.0

    def __init__(self):
        self._conns: Dict[str, list] = {}
        self._dial_locks: Dict[str, asyncio.Lock] = {}
        self._gen: Dict[str, int] = {}  # per-address dial generation

    async def _dial(self, address: str):
        gen = self._gen.get(address, 0) + 1
        if address.startswith("inproc://"):
            # one-process plane: the "dial" is a registry lookup
            ep = _INPROC_ENDPOINTS.get(address)
            if ep is None:
                raise RequestPlaneError(
                    f"cannot connect to {address}: endpoint gone", code="cannot_connect")
            conn = _InprocMuxConn(address, ep, gen=gen)
        else:
            host, port = address.rsplit(":", 1)
            try:
                reader, writer = await asyncio.wait_for(
                    asyncio.open_connection(host, int(port)), self.CONNECT_TIMEOUT_S)
            except (OSError, asyncio.TimeoutError) as e:
                raise RequestPlaneError(f"cannot connect to {address}: {e}",
                                        code="cannot_connect") from None
            conn = _MuxConn(reader, writer, gen=gen)
        self._gen[address] = gen
        self._conns.setdefault(address, []).append(conn)
        return conn

    def _best_live(self, address: str, gen_floor: int = -1):
        conns = self._conns.get(address, [])
        live = [c for c in conns if not c.closed]
        if len(live) != len(conns):
            self._conns[address] = live
        cands = [c for c in live if c.gen > gen_floor]
        if not cands:
            return None
        best = min(cands, key=lambda c: c.n_streams)
        if best.n_streams < self.STREAMS_PER_CONN or len(live) >= self.MAX_CONNS:
            return best
        return None

    async def acquire(self, address: str, rid: str, after=None) -> Tuple[Any, asyncio.Queue, bool]:
        """Returns (conn, stream queue, pooled) with stream `rid` already
        registered, so concurrent acquires see each other's load.

        `after` marks a stale-retry (that conn just died, e.g. the server
        restarted under a pooled socket): only connections dialed after it
        qualify, while simultaneous retries still share a few new dials."""
        gen_floor = after.gen if after is not None else -1
        best = self._best_live(address, gen_floor)
        if best is not None:
            return best, best.open_stream(rid), after is None
        lock = self._dial_locks.setdefault(address, asyncio.Lock())
        async with lock:
            best = self._best_live(address, gen_floor)
            if best is not None:
                return best, best.open_stream(rid), after is None
            conn = await self._dial(address)
            return conn, conn.open_stream(rid), False

    def close(self) -> None:
        for conns in self._conns.values():
            for c in conns:
                c.shutdown()
        self._conns.clear()


class RemoteEngine:
    """Client side: an AsyncEngine whose generate() pushes the request to a
    remote instance and yields the streamed response items."""

    def __init__(self, pool: _ConnPool, address: str, endpoint_path: str):
        self._pool = pool
        self.address = address
        self.endpoint_path = endpoint_path

    async def generate(self, request: Any, context: Context) -> AsyncIterator[Any]:
        """Stream the remote response. If a *pooled* connection turns out
        stale (server restarted since it was dialed) and nothing has been
        yielded yet, retry once on a fresh connection."""
        conn, q, pooled = await self._pool.acquire(self.address, context.id)
        yielded = False
        while True:
            try:
                async for item in self._stream_once(conn, q, request, context):
                    yielded = True
                    yield item
                return
            except RequestPlaneError as e:
                if pooled and not yielded and e.code == "disconnected":
                    conn, q, pooled = await self._pool.acquire(
                        self.address, context.id, after=conn)
                    continue
                raise

    async def _stream_once(self, conn, q: asyncio.Queue, request: Any,
                           context: Context) -> AsyncIterator[Any]:
        rid = context.id
        canceller: Optional[asyncio.Task] = None
        finished = False
        try:
            await conn.send({"t": "req", "id": rid, "endpoint": self.endpoint_path,
                             "headers": context.to_headers(), "payload": request})

            # propagate stop/kill to the server even while blocked on recv
            async def _forward_cancel():
                await context.wait_stopped()
                try:
                    await conn.send({"t": "kill" if context.is_killed else "cancel",
                                     "id": rid})
                except (ConnectionResetError, BrokenPipeError, OSError):
                    pass

            canceller = asyncio.create_task(_forward_cancel())
            while True:
                frame = await q.get()
                if frame is _MuxConn._DISCONNECT:
                    raise RequestPlaneError(f"disconnected from {self.address}",
                                            code="disconnected")
                t = frame.get("t")
                if t == "item":
                    yield frame["data"]
                elif t == "done":
                    finished = True
                    return
                elif t == "err":
                    finished = True  # server already ended this stream
                    raise RequestPlaneError(frame.get("msg", "remote error"),
                                            code=frame.get("code", "engine"))
        except (ConnectionResetError, BrokenPipeError, OSError) as e:
            conn.close()  # writer failed mid-frame: poison the whole conn
            finished = True
            raise RequestPlaneError(f"connection lost to {self.address}: {e}",
                                    code="disconnected") from None
        finally:
            if canceller is not None:
                canceller.cancel()
            conn.close_stream(rid)
            if not finished and not conn.closed:
                # stream abandoned mid-flight (consumer stopped iterating):
                # the shared socket stays open, so tell the server to stop
                async def _bg_kill():
                    try:
                        await conn.send({"t": "kill", "id": rid})
                    except (ConnectionError, OSError):
                        log.debug("kill for abandoned stream %s not delivered", rid)

                spawn_tracked(_bg_kill(), logger=log)


class RouterMode:
    ROUND_ROBIN = "round_robin"
    RANDOM = "random"
    DIRECT = "direct"
    P2C = "p2c"  # power-of-two-choices by outstanding requests
    LEAST_LOADED = "least_loaded"


class PushRouter:
    """Client-side fan-out over the live instance set of an endpoint
    (round robin, random, direct, power-of-two-choices, least loaded). The
    instance set is kept by a discovery watch (EndpointClient). Load-aware
    modes rank instances by this router's own count of outstanding
    requests; the worker-published load signal and the device-capacity
    weights of the reference wait for the KV router."""

    # how long a transport-failed instance is avoided: discovery lease
    # expiry is the authoritative removal; this bridges the gap so retries
    # do not re-pick a corpse before the lease lapses
    SICK_COOLDOWN_S = 5.0
    # transport failures that put an instance into the failure cache
    SICK_CODES = ("cannot_connect", "disconnected", "connection_timeout", "draining")

    def __init__(self, endpoint_path: str, mode: str = RouterMode.ROUND_ROBIN):
        self.endpoint_path = endpoint_path
        self.mode = mode
        self._pool = _ConnPool()
        self._instances: Dict[int, str] = {}  # instance_id -> address
        self._rr = 0
        self._inflight: Dict[int, int] = {}  # instance_id -> outstanding reqs
        self._sick: Dict[int, float] = {}  # instance_id -> retry-after

    def update_instance(self, instance_id: int, address: Optional[str]) -> None:
        if address is None:
            self._instances.pop(instance_id, None)
            self._inflight.pop(instance_id, None)
            self._sick.pop(instance_id, None)
        else:
            self._instances[instance_id] = address

    def mark_sick(self, instance_id: int, cooldown: Optional[float] = None) -> None:
        """Record a transport failure: selection avoids this instance for
        `cooldown` seconds (unless nothing else is available)."""
        self._sick[instance_id] = time.monotonic() + (
            cooldown if cooldown is not None else self.SICK_COOLDOWN_S)

    def sick_instances(self) -> set:
        """Instances currently in their failure cooldown."""
        now = time.monotonic()
        for iid, until in list(self._sick.items()):
            if until <= now:
                del self._sick[iid]
        return set(self._sick)

    def load_of(self, instance_id: int) -> float:
        return float(self._inflight.get(instance_id, 0))

    def _pick(self, instance_id: Optional[int] = None) -> Tuple[int, str]:
        if not self._instances:
            raise RequestPlaneError(f"no instances for {self.endpoint_path}",
                                    code="no_instances")
        if instance_id is not None:
            addr = self._instances.get(instance_id)
            if addr is None:
                raise RequestPlaneError(f"instance {instance_id:x} not found",
                                        code="cannot_connect")
            return instance_id, addr
        if self.mode == RouterMode.DIRECT:
            raise RequestPlaneError("direct routing mode requires a target instance_id",
                                    code="no_target")
        ids = sorted(self._instances)
        sick = self.sick_instances()
        if sick:
            healthy = [i for i in ids if i not in sick]
            if healthy:  # all-sick: keep trying rather than failing hard
                ids = healthy
        if self.mode == RouterMode.RANDOM:
            iid = random.choice(ids)
        elif self.mode == RouterMode.P2C:
            a, b = random.choice(ids), random.choice(ids)
            iid = a if self.load_of(a) <= self.load_of(b) else b
        elif self.mode == RouterMode.LEAST_LOADED:
            # round-robin tiebreak so equal-load instances share work
            self._rr += 1
            n = len(ids)
            iid = min((ids[(self._rr + i) % n] for i in range(n)), key=self.load_of)
        else:  # round robin default
            iid = ids[self._rr % len(ids)]
            self._rr += 1
        return iid, self._instances[iid]

    def engine_for(self, instance_id: Optional[int] = None) -> RemoteEngine:
        _, addr = self._pick(instance_id)
        return RemoteEngine(self._pool, addr, self.endpoint_path)

    async def generate(self, request: Any, context: Context) -> AsyncIterator[Any]:
        t_route = time.monotonic()
        iid, addr = self._pick(context.metadata.get("target_instance"))
        # report the choice so wrappers (session affinity) can pin to it
        context.metadata["routed_instance"] = iid
        ph = context.metadata.setdefault("phases", {})
        ph["route_s"] = ph.get("route_s", 0.0) + (time.monotonic() - t_route)
        engine = RemoteEngine(self._pool, addr, self.endpoint_path)
        self._inflight[iid] = self._inflight.get(iid, 0) + 1
        try:
            async for item in engine.generate(request, context):
                yield item
        except RequestPlaneError as e:
            if e.code in self.SICK_CODES:
                # dead/unreachable replica: cool it down so a retry lands
                # on a healthy one
                self.mark_sick(iid)
            raise
        finally:
            left = self._inflight.get(iid, 1) - 1
            if left > 0:
                self._inflight[iid] = left
            else:
                self._inflight.pop(iid, None)

    def close(self) -> None:
        self._pool.close()


# ---------------------------------------------------------------------------
# In-proc request plane
# ---------------------------------------------------------------------------
# One process, many runtimes, no listener socket: the same frames, the same
# per-stream bounded queues and the same disconnect / draining /
# cannot_connect codes as TCP, but the "socket" is a registry lookup and
# the "wire" is a msgpack round trip.

_INPROC_ENDPOINTS: Dict[str, "InprocPushEndpoint"] = {}
_INPROC_NEXT = [0]


def reset_inproc() -> None:
    """Test helper: drop every registered in-proc endpoint."""
    _INPROC_ENDPOINTS.clear()


def _wire(obj: Dict[str, Any]) -> Dict[str, Any]:
    """msgpack round trip: the in-proc plane keeps TCP serialization
    semantics (tuples become lists, payloads are copies, non-serializable
    values fail here), so no state is shared with the server by accident."""
    return codec.unpackb(codec.packb(obj))


class InprocPushEndpoint(PushEndpoint):
    """Request-plane server for one-process fleets: the same
    `_handle_request` machinery as the TCP plane, addressed by an
    `inproc://` registry key."""

    def __init__(self):
        super().__init__()
        _INPROC_NEXT[0] += 1
        self._address = f"inproc://rp-{_INPROC_NEXT[0]}"
        self._inproc_conns: set = set()

    @property
    def address(self) -> str:
        return self._address

    async def start(self) -> str:
        _INPROC_ENDPOINTS[self._address] = self
        return self._address

    async def stop(self, drain_timeout: float = 30.0) -> None:
        """Graceful: deregister (new dials fail), drain in-flight, kill
        stragglers, then cut surviving conns."""
        self._draining = True
        _INPROC_ENDPOINTS.pop(self._address, None)
        loop = asyncio.get_running_loop()
        deadline = loop.time() + drain_timeout
        while self._active and loop.time() < deadline:
            await asyncio.sleep(0.05)
        for ctx in list(self._active.values()):
            ctx.kill()
        for conn in list(self._inproc_conns):
            conn.close()


class _InprocMuxConn:
    """Client half of the in-proc plane: the `_MuxConn` surface where "the
    socket" is a direct `_handle_request` task on the server endpoint.
    Per-stream queues stay bounded, so backpressure matches TCP."""

    STREAM_BUF_FRAMES = _MuxConn.STREAM_BUF_FRAMES

    def __init__(self, address: str, endpoint: InprocPushEndpoint, gen: int = 0):
        self.address = address
        self.gen = gen
        self.closed = False
        self._ep = endpoint
        self._streams: Dict[str, asyncio.Queue] = {}
        self._ctxs: Dict[str, Context] = {}
        self._tasks: set = set()
        endpoint._inproc_conns.add(self)

    @property
    def n_streams(self) -> int:
        return len(self._streams)

    def open_stream(self, rid: str) -> asyncio.Queue:
        q: asyncio.Queue = asyncio.Queue(maxsize=self.STREAM_BUF_FRAMES)
        self._streams[rid] = q
        return q

    def close_stream(self, rid: str) -> None:
        _drain(self._streams.pop(rid, None))

    async def send(self, obj: Dict[str, Any]) -> None:
        if self.closed:
            raise ConnectionResetError(f"in-proc conn to {self.address} closed")
        t = obj.get("t")
        if t == "req":
            if _INPROC_ENDPOINTS.get(self.address) is not self._ep:
                # endpoint vanished or restarted under us: dead socket
                self.close()
                raise ConnectionResetError(f"{self.address} is gone")
            task = asyncio.create_task(
                self._ep._handle_request(_wire(obj), self._respond, self._ctxs))
            self._tasks.add(task)
            task.add_done_callback(self._tasks.discard)
        elif t in ("cancel", "kill"):
            ctx = self._ctxs.get(obj.get("id"))
            if ctx is not None:
                ctx.kill() if t == "kill" else ctx.stop_generating()

    async def _respond(self, obj: Dict[str, Any]) -> None:
        """Server→client frame delivery (the handler's `send`)."""
        if self.closed:
            raise ConnectionResetError(f"in-proc conn to {self.address} closed")
        q = self._streams.get(obj.get("id"))
        if q is not None:
            await q.put(_wire(obj))

    def close(self) -> None:
        if self.closed:
            return
        self.closed = True
        self._ep._inproc_conns.discard(self)
        for q in self._streams.values():
            _push_sentinel(q, _MuxConn._DISCONNECT)
        # the client side is gone: kill its in-flight server contexts the
        # way a broken socket's handler teardown would
        for ctx in list(self._ctxs.values()):
            ctx.kill()

    def shutdown(self) -> None:
        self.close()
