"""Event plane: pub/sub for KV events and forward-pass metrics (FPM).

Port of dynamo_tpu/runtime/event_plane.py: the `EventPublisher` /
`EventSubscriber` interface, the in-process bus, and in place of the
reference's brokerless ZMQ PUB/SUB (the machine with the card has no
pyzmq) a brokerless TCP pub/sub on asyncio with the same topology: each
publisher listens on its own port and advertises `tcp://host:port` in its
instance metadata; subscribers connect to every live publisher.

Wire format: a subscriber sends one frame {"subscribe": [prefixes]} (empty
= every subject); the publisher then sends each matching event as one
frame [subject, payload]. Frames are the request plane's: a 4-byte
big-endian length and a msgpack body written by `runtime/codec.py`, and
the payloads are the reference's msgpack payloads. A ZMQ subscriber
cannot read this plane, nor this subscriber a ZMQ publisher. As with ZMQ
PUB, events for a subscriber that falls `SEND_HWM` frames behind are
dropped, and events published before a subscriber connects are not seen.
"""

from __future__ import annotations

import asyncio
import logging
import socket
from typing import Any, AsyncIterator, Dict, List, Optional, Set, Tuple

from dynamo_tpu_torch.runtime import codec
from dynamo_tpu_torch.runtime.request_plane import (
    RequestPlaneError,
    _recv_frame,
    frame_bytes,
)

log = logging.getLogger("dynamo_tpu_torch.event_plane")

# well-known subjects (the reference's router/protocols.py names)
KV_EVENT_SUBJECT = "kv_events"
FPM_SUBJECT = "fpm"


class EventPublisher:
    """Publish (subject, payload) events. Implementations: Tcp, InProc."""

    @property
    def address(self) -> str:
        raise NotImplementedError

    async def publish(self, subject: str, payload: Any) -> None:
        raise NotImplementedError

    async def close(self) -> None:
        pass


class EventSubscriber:
    """Subscribe to subjects across a dynamic set of publisher addresses."""

    def connect(self, address: str) -> None:
        raise NotImplementedError

    def disconnect(self, address: str) -> None:
        raise NotImplementedError

    async def events(self) -> AsyncIterator[Tuple[str, Any]]:
        raise NotImplementedError
        yield  # pragma: no cover

    async def close(self) -> None:
        pass


def _matches(subjects: Optional[Set[str]], subject: str) -> bool:
    return not subjects or any(subject.startswith(s) for s in subjects)


# --------------------------------------------------------------------------
# TCP transport (default, brokerless)
# --------------------------------------------------------------------------


class _Subscription:
    """One connected subscriber: its prefixes and a bounded send queue
    drained by a writer task."""

    def __init__(self, subjects: Set[str], hwm: int):
        self.subjects = subjects
        self.queue: asyncio.Queue = asyncio.Queue(maxsize=hwm)
        self.dropped = 0


class TcpEventPublisher(EventPublisher):
    SEND_HWM = 100_000  # frames queued per subscriber before dropping

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        # bind now, so the address is known before the first publish (the
        # reference's ZMQ bind is synchronous too); accept on the loop
        self._sock = socket.create_server((host, port))
        self._address = f"tcp://{host}:{self._sock.getsockname()[1]}"
        self._subs: Set[_Subscription] = set()
        self._writers: Set[asyncio.StreamWriter] = set()
        self._server: Optional[asyncio.AbstractServer] = None
        self._serving = asyncio.get_running_loop().create_task(self._serve())

    @property
    def address(self) -> str:
        return self._address

    async def _serve(self) -> None:
        self._server = await asyncio.start_server(self._on_conn, sock=self._sock)

    async def _on_conn(self, reader: asyncio.StreamReader,
                       writer: asyncio.StreamWriter) -> None:
        self._writers.add(writer)
        sub = reading = None
        try:
            hello = await _recv_frame(reader)
            if not isinstance(hello, dict):
                return
            sub = _Subscription(set(hello.get("subscribe") or []), self.SEND_HWM)
            self._subs.add(sub)
            reading = asyncio.create_task(reader.read())  # EOF = peer gone
            while True:
                frame = asyncio.create_task(sub.queue.get())
                done, _ = await asyncio.wait({frame, reading},
                                             return_when=asyncio.FIRST_COMPLETED)
                if frame not in done:
                    frame.cancel()
                    return
                writer.write(frame.result())
                await writer.drain()
        except (ConnectionError, OSError, RequestPlaneError):
            pass
        finally:
            self._subs.discard(sub)
            if reading is not None:
                reading.cancel()
            self._writers.discard(writer)
            writer.close()

    async def publish(self, subject: str, payload: Any) -> None:
        if not self._subs:
            return
        frame = frame_bytes([subject, payload])
        for sub in list(self._subs):
            if _matches(sub.subjects, subject):
                try:
                    sub.queue.put_nowait(frame)
                except asyncio.QueueFull:
                    sub.dropped += 1

    async def close(self) -> None:
        self._serving.cancel()
        if self._server is not None:
            self._server.close()
        self._sock.close()
        for w in list(self._writers):
            w.close()  # each subscriber's handler ends at its EOF


class TcpEventSubscriber(EventSubscriber):
    """Connects to each publisher address it is given, resubscribing after
    a dropped connection (as a ZMQ SUB reconnects)."""

    RECONNECT_S = 0.2

    def __init__(self, subjects: Optional[List[str]] = None):
        self._subjects = list(subjects or [])
        self._queue: asyncio.Queue = asyncio.Queue()
        self._conns: Dict[str, asyncio.Task] = {}

    def connect(self, address: str) -> None:
        if address not in self._conns:
            self._conns[address] = asyncio.get_running_loop().create_task(
                self._follow(address))

    def disconnect(self, address: str) -> None:
        task = self._conns.pop(address, None)
        if task is not None:
            task.cancel()

    async def _follow(self, address: str) -> None:
        host, port = address.removeprefix("tcp://").rsplit(":", 1)
        while True:
            writer = None
            try:
                reader, writer = await asyncio.open_connection(host, int(port))
                writer.write(frame_bytes({"subscribe": self._subjects}))
                await writer.drain()
                while True:
                    frame = await _recv_frame(reader)
                    if frame is None:
                        break
                    subject, payload = frame
                    self._queue.put_nowait((subject, payload))
            except (ConnectionError, OSError, RequestPlaneError, ValueError):
                pass
            finally:
                if writer is not None:
                    writer.close()
            await asyncio.sleep(self.RECONNECT_S)

    async def events(self) -> AsyncIterator[Tuple[str, Any]]:
        while True:
            yield await self._queue.get()

    async def close(self) -> None:
        for address in list(self._conns):
            self.disconnect(address)


# --------------------------------------------------------------------------
# In-proc transport (tests)
# --------------------------------------------------------------------------


class _InProcBus:
    """Process-wide registry of inproc publishers keyed by address."""

    buses: Dict[str, "_InProcBus"] = {}
    _next_id = 0

    def __init__(self):
        self.subscribers: List[Tuple[Optional[Set[str]], asyncio.Queue]] = []

    @classmethod
    def create(cls) -> Tuple[str, "_InProcBus"]:
        cls._next_id += 1
        addr = f"inproc://bus-{cls._next_id}"
        bus = cls()
        cls.buses[addr] = bus
        return addr, bus

    @classmethod
    def reset(cls) -> None:
        cls.buses.clear()


class InProcEventPublisher(EventPublisher):
    def __init__(self):
        self._address, self._bus = _InProcBus.create()

    @property
    def address(self) -> str:
        return self._address

    async def publish(self, subject: str, payload: Any) -> None:
        payload = codec.unpackb(codec.packb(payload))
        for subjects, q in self._bus.subscribers:
            if _matches(subjects, subject):
                q.put_nowait((subject, payload))

    async def close(self) -> None:
        _InProcBus.buses.pop(self._address, None)


class InProcEventSubscriber(EventSubscriber):
    def __init__(self, subjects: Optional[List[str]] = None):
        self._subjects: Optional[Set[str]] = set(subjects) if subjects else None
        self._queue: asyncio.Queue = asyncio.Queue()
        self._connected: Set[str] = set()

    def connect(self, address: str) -> None:
        bus = _InProcBus.buses.get(address)
        if bus is not None and address not in self._connected:
            bus.subscribers.append((self._subjects, self._queue))
            self._connected.add(address)

    def disconnect(self, address: str) -> None:
        bus = _InProcBus.buses.get(address)
        if bus is not None:
            bus.subscribers = [(s, q) for s, q in bus.subscribers if q is not self._queue]
        self._connected.discard(address)

    async def events(self) -> AsyncIterator[Tuple[str, Any]]:
        while True:
            yield await self._queue.get()


def make_publisher(transport: str = "tcp", host: str = "127.0.0.1") -> EventPublisher:
    if transport == "tcp":
        return TcpEventPublisher(host)
    if transport == "inproc":
        return InProcEventPublisher()
    raise ValueError(f"unknown event transport {transport!r} (expected tcp or inproc)")


def make_subscriber(transport: str = "tcp",
                    subjects: Optional[List[str]] = None) -> EventSubscriber:
    if transport == "tcp":
        return TcpEventSubscriber(subjects)
    if transport == "inproc":
        return InProcEventSubscriber(subjects)
    raise ValueError(f"unknown event transport {transport!r} (expected tcp or inproc)")
