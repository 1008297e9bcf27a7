"""DistributedRuntime: the top-level runtime handle.

Port of dynamo_tpu/runtime/distributed.py: owns the discovery client, the
request-plane server (one TCP listener, or one in-process endpoint,
hosting every endpoint this process serves), the event plane and the
metrics root, and offers the Namespace → Component → Endpoint builder used
by workers (`endpoint.serve(engine)`) and clients (`endpoint.client()`).
Request planes "tcp" (default) and "inproc"; the NATS plane is not ported.
"""

from __future__ import annotations

import asyncio
import logging
import os
from typing import Any, Dict, List, Optional

from dynamo_tpu_torch.runtime.component import (
    EndpointAddress,
    Instance,
    TransportKind,
    new_instance_id,
)
from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.runtime.discovery import DiscoveryBackend, make_discovery
from dynamo_tpu_torch.runtime.engine import as_engine
from dynamo_tpu_torch.runtime.event_plane import (
    EventPublisher,
    EventSubscriber,
    make_publisher,
    make_subscriber,
)
from dynamo_tpu_torch.runtime.metrics import make_metrics
from dynamo_tpu_torch.runtime.request_plane import (
    InprocPushEndpoint,
    PushEndpoint,
    PushRouter,
    RouterMode,
)

log = logging.getLogger("dynamo_tpu_torch.runtime")


class DistributedRuntime:
    HEARTBEAT_S = 2.0

    def __init__(
        self,
        discovery: Optional[DiscoveryBackend] = None,
        discovery_backend: Optional[str] = None,
        event_transport: Optional[str] = None,
        host: Optional[str] = None,
        request_plane: Optional[str] = None,  # "tcp" (default) | "inproc"
        **discovery_kw,
    ):
        self.discovery = discovery or make_discovery(discovery_backend, **discovery_kw)
        self.event_transport = event_transport or os.environ.get("DYN_EVENT_PLANE", "tcp")
        self.host = host or os.environ.get("DYN_TCP_HOST", "127.0.0.1")
        self.metrics = make_metrics()
        # the server advertises a self-describing address (host:port or
        # inproc://...), so clients need no mode flag
        self.request_plane = (
            request_plane or os.environ.get("DYN_REQUEST_PLANE", "tcp")).lower()
        if self.request_plane == "inproc":
            self.server: PushEndpoint = InprocPushEndpoint()
        elif self.request_plane == "tcp":
            self.server = PushEndpoint(host=self.host)
        else:
            raise ValueError(f"unknown request plane {self.request_plane!r} "
                             "(expected tcp or inproc)")
        self._server_started = False
        self._served: List[Instance] = []
        self._event_publisher: Optional[EventPublisher] = None
        self._hb_task: Optional[asyncio.Task] = None
        self._closed = False

    # -- builders ---------------------------------------------------------
    def namespace(self, name: str) -> "Namespace":
        return Namespace(self, name)

    def endpoint(self, path: str) -> "Endpoint":
        addr = EndpointAddress.parse(path)
        return Namespace(self, addr.namespace).component(addr.component).endpoint(addr.endpoint)

    # -- event plane ------------------------------------------------------
    def event_publisher(self) -> EventPublisher:
        """This process's publisher, created on first use; its address is
        advertised in instance metadata (brokerless topology)."""
        if self._event_publisher is None:
            self._event_publisher = make_publisher(self.event_transport, self.host)
        return self._event_publisher

    def event_subscriber(self, subjects: Optional[List[str]] = None) -> EventSubscriber:
        return make_subscriber(self.event_transport, subjects)

    # -- serving ----------------------------------------------------------
    async def _ensure_server(self) -> None:
        if not self._server_started:
            # flag BEFORE the await (rolled back on failure): a second
            # caller arriving during start() must not double-start
            self._server_started = True
            try:
                await self.server.start()
            except BaseException:
                self._server_started = False
                raise
        if self._hb_task is None:
            self._hb_task = asyncio.create_task(self._heartbeat_loop())

    async def _heartbeat_loop(self) -> None:
        while not self._closed:
            try:
                await self.discovery.heartbeat()
            except OSError:
                log.exception("discovery heartbeat failed")
            await asyncio.sleep(self.HEARTBEAT_S)

    async def serve_endpoint(
        self,
        path: str,
        handler: Any,
        metadata: Optional[Dict[str, Any]] = None,
        instance_id: Optional[int] = None,
    ) -> Instance:
        """Serve `handler` (AsyncEngine or async fn) at `ns/comp/ep`,
        registering an Instance in discovery."""
        await self._ensure_server()
        engine = as_engine(handler)
        addr = EndpointAddress.parse(path)
        self.server.add_endpoint(path, engine)
        inst = Instance(
            namespace=addr.namespace,
            component=addr.component,
            endpoint=addr.endpoint,
            instance_id=instance_id if instance_id is not None else new_instance_id(),
            transport=(TransportKind.INPROC if self.request_plane == "inproc"
                       else TransportKind.TCP),
            address=self.server.address,
            metadata=metadata or {},
        )
        await self.discovery.register(inst)
        self._served.append(inst)
        log.info("serving %s as instance %x at %s", path, inst.instance_id, inst.address)
        return inst

    # -- clients ----------------------------------------------------------
    def client(self, path: str, mode: str = RouterMode.ROUND_ROBIN) -> "EndpointClient":
        return EndpointClient(self, path, mode)

    # -- shutdown ---------------------------------------------------------
    async def shutdown(self, drain_timeout: float = 30.0) -> None:
        """Unregister every served instance (clients stop picking it),
        drain in-flight requests up to `drain_timeout`, then close."""
        self._closed = True
        for inst in self._served:
            try:
                await self.discovery.unregister(inst)
            except OSError:
                log.debug("unregister %x failed during shutdown (lease expiry "
                          "reclaims it)", inst.instance_id, exc_info=True)
        self._served.clear()
        if self._hb_task is not None:
            self._hb_task.cancel()
        if self._server_started:
            await self.server.stop(drain_timeout)
        if self._event_publisher is not None:
            await self._event_publisher.close()
        await self.discovery.close()


class Namespace:
    def __init__(self, runtime: DistributedRuntime, name: str):
        self.runtime = runtime
        self.name = name
        self.metrics = runtime.metrics.child(dynamo_namespace=name)

    def component(self, name: str) -> "Component":
        return Component(self, name)


class Component:
    def __init__(self, namespace: Namespace, name: str):
        self.namespace = namespace
        self.name = name
        self.metrics = namespace.metrics.child(dynamo_component=name)

    def endpoint(self, name: str) -> "Endpoint":
        return Endpoint(self, name)


class Endpoint:
    def __init__(self, component: Component, name: str):
        self.component = component
        self.name = name
        self.metrics = component.metrics.child(dynamo_endpoint=name)

    @property
    def path(self) -> str:
        return f"{self.component.namespace.name}/{self.component.name}/{self.name}"

    @property
    def runtime(self) -> DistributedRuntime:
        return self.component.namespace.runtime

    async def serve(self, handler: Any, metadata: Optional[Dict[str, Any]] = None,
                    instance_id: Optional[int] = None) -> Instance:
        return await self.runtime.serve_endpoint(
            self.path, handler, metadata=metadata, instance_id=instance_id)

    def client(self, mode: str = RouterMode.ROUND_ROBIN) -> "EndpointClient":
        return self.runtime.client(self.path, mode)


class EndpointClient:
    """Client handle for one endpoint: watches discovery, keeps the
    PushRouter's instance set current, exposes generate() / direct(). The
    instance set shrinks on lease expiry or unregister and grows on
    discovery."""

    def __init__(self, runtime: DistributedRuntime, path: str,
                 mode: str = RouterMode.ROUND_ROBIN):
        self.runtime = runtime
        self.path = path
        addr = EndpointAddress.parse(path)
        self._prefix = f"services/{addr.namespace}/{addr.component}/{addr.endpoint}/"
        self.router = PushRouter(path, mode)
        self._watch_task: Optional[asyncio.Task] = None
        self._ready = asyncio.Event()
        self.instances: Dict[int, Instance] = {}

    async def start(self) -> "EndpointClient":
        if self._watch_task is None:
            self._watch_task = asyncio.create_task(self._watch())
        return self

    async def _watch(self) -> None:
        async for ev in self.runtime.discovery.watch(self._prefix):
            inst = ev.instance
            if ev.kind == "put":
                self.instances[inst.instance_id] = inst
                self.router.update_instance(inst.instance_id, inst.address)
                self._ready.set()
            else:
                self.instances.pop(inst.instance_id, None)
                self.router.update_instance(inst.instance_id, None)

    async def wait_ready(self, timeout: float = 10.0) -> None:
        await self.start()
        await asyncio.wait_for(self._ready.wait(), timeout)

    async def generate(self, request: Any, context: Optional[Context] = None):
        """Push to an instance chosen by the router mode; async iterator of
        response items."""
        async for item in self.router.generate(request, context or Context()):
            yield item

    async def direct(self, request: Any, instance_id: int,
                     context: Optional[Context] = None):
        """Push to a specific instance."""
        engine = self.router.engine_for(instance_id)
        async for item in engine.generate(request, context or Context()):
            yield item

    async def close(self) -> None:
        if self._watch_task is not None:
            self._watch_task.cancel()
        self.router.close()
