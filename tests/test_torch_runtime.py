"""The port's distributed runtime (dynamo_tpu_torch/runtime): the
reference's tests/test_runtime.py cases against it (echo, routing,
cancellation and abandonment, error codes, draining, stale pooled
connections, multiplexing, discovery leases, the failure cooldown), the
TCP event plane that stands in for ZMQ, and a reference client and server
talking to the port's over one socket. Every socket binds port 0 and every
wait is bounded by asyncio.wait_for; nothing asserts on durations."""

import asyncio
import os
import time

import pytest

from dynamo_tpu.runtime.discovery import FileDiscovery as RefFileDiscovery
from dynamo_tpu.runtime.distributed import DistributedRuntime as RefRuntime
from dynamo_tpu.runtime.engine import EchoEngine as RefEchoEngine
from dynamo_tpu_torch.runtime.component import Instance, TransportKind
from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.runtime.discovery import FileDiscovery, MemDiscovery
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.engine import EchoEngine, as_engine
from dynamo_tpu_torch.runtime.event_plane import (
    TcpEventPublisher,
    make_publisher,
    make_subscriber,
)
from dynamo_tpu_torch.runtime.metrics import make_metrics
from dynamo_tpu_torch.runtime.request_plane import (
    PushRouter,
    RequestPlaneError,
    RouterMode,
    reset_inproc,
)

T = 30  # bound on every awaited scenario, seconds


@pytest.fixture(autouse=True)
def _fresh_registries():
    yield
    MemDiscovery.reset()
    reset_inproc()


def _rt(realm, plane="tcp"):
    return DistributedRuntime(discovery=MemDiscovery(realm=realm),
                              event_transport="inproc", request_plane=plane)


async def _pair(realm, engine, plane="tcp", path="ns/w/gen", iid=None):
    """A worker runtime serving `engine` and a client runtime's ready
    client of it, through the Namespace → Component → Endpoint builders."""
    wrt = _rt(realm, plane)
    ns, comp, ep = path.split("/")
    await wrt.namespace(ns).component(comp).endpoint(ep).serve(engine, instance_id=iid)
    crt = _rt(realm, plane)
    client = crt.endpoint(path).client()
    await client.wait_ready()
    return wrt, crt, client


async def _close(client, *runtimes):
    await client.close()
    for rt in runtimes:
        await rt.shutdown(drain_timeout=1)


# -- discovery --------------------------------------------------------------


def _inst(iid=1, ep="generate"):
    return Instance(namespace="ns", component="worker", endpoint=ep, instance_id=iid,
                    transport=TransportKind.TCP, address="127.0.0.1:1")


async def test_mem_discovery_register_list_watch():
    d = MemDiscovery(realm="t1")
    await d.register(_inst(1))
    seen = []

    async def watcher():
        async for ev in d.watch("services/ns/worker/generate/"):
            seen.append((ev.kind, ev.instance.instance_id))
            if len(seen) == 3:
                return

    task = asyncio.create_task(watcher())
    while not d._realm.watchers:
        await asyncio.sleep(0.01)
    await d.register(_inst(2))
    await d.unregister(_inst(1))
    await asyncio.wait_for(task, T)
    assert seen == [("put", 1), ("put", 2), ("delete", 1)]
    assert {i.instance_id for i in await d.list_instances()} == {2}


async def test_file_discovery_roundtrip_and_lease_expiry(tmp_path):
    d = FileDiscovery(str(tmp_path), lease_ttl=5.0, poll_interval=0.05)
    inst = _inst(7)
    await d.register(inst)
    assert [i.instance_id for i in await d.list_instances()] == [7]
    # a record whose mtime is older than the lease is dead
    f = d._file(inst.path)
    old = time.time() - 60
    os.utime(f, (old, old))
    assert await d.list_instances() == []
    # the heartbeat refreshes the lease
    await d.heartbeat()
    assert [i.instance_id for i in await d.list_instances()] == [7]
    # a record removed from outside is re-registered by the heartbeat
    f.unlink()
    await d.heartbeat()
    assert [i.instance_id for i in await d.list_instances()] == [7]


async def test_file_discovery_reads_reference_records(tmp_path):
    """Both packages write one record layout on one root."""
    ref = RefFileDiscovery(str(tmp_path), lease_ttl=10)
    from dynamo_tpu.runtime.component import Instance as RefInstance

    await ref.register(RefInstance(namespace="ns", component="c", endpoint="e",
                                   instance_id=3, address="127.0.0.1:9",
                                   metadata={"k": [1, 2]}))
    port = FileDiscovery(str(tmp_path))
    await port.register(_inst(4))
    got = {i.instance_id: i for i in await port.list_instances()}
    assert got[3].metadata == {"k": [1, 2]} and got[3].address == "127.0.0.1:9"
    assert {i.instance_id for i in await ref.list_instances()} == {3, 4}


# -- request plane ------------------------------------------------------------


@pytest.mark.parametrize("plane", ["tcp", "inproc"])
async def test_echo_engine(plane):
    async def run():
        wrt, crt, client = await _pair("e2e", EchoEngine(), plane)
        out = [item["token_ids"][0] async for item in client.generate({"token_ids": [1, 2, 3]})]
        await _close(client, crt, wrt)
        return out

    assert await asyncio.wait_for(run(), T) == [1, 2, 3]


async def test_direct_routing_and_round_robin():
    class TagEngine:
        def __init__(self, tag):
            self.tag = tag

        async def generate(self, request, context):
            yield {"tag": self.tag}

    async def run():
        rt1, rt2, crt = _rt("rr"), _rt("rr"), _rt("rr")
        await rt1.serve_endpoint("ns/w/gen", TagEngine("a"), instance_id=11)
        await rt2.serve_endpoint("ns/w/gen", TagEngine("b"), instance_id=22)
        client = crt.client("ns/w/gen", RouterMode.ROUND_ROBIN)
        await client.wait_ready()
        while len(client.instances) < 2:
            await asyncio.sleep(0.01)
        tags = [item["tag"] for _ in range(4) async for item in client.generate({})]
        direct = [item async for item in client.direct({}, 22)]
        await _close(client, crt, rt1, rt2)
        return tags, direct

    tags, direct = await asyncio.wait_for(run(), T)
    assert sorted(tags) == ["a", "a", "b", "b"]  # round robin alternates
    assert direct == [{"tag": "b"}]


class SlowEngine:
    """1000 items 5 ms apart unless stopped; records what it saw."""

    def __init__(self):
        self.stopped = []

    async def generate(self, request, context):
        for i in range(1000):
            if context.is_stopped:
                self.stopped.append(i)
                return
            yield {"i": i}
            await asyncio.sleep(0.005)


async def test_slow_stream_cancellation():
    engine = SlowEngine()

    async def run():
        wrt, crt, client = await _pair("c", engine)
        ctx = Context()
        got = []
        async for item in client.generate({}, ctx):
            got.append(item["i"])
            if len(got) == 3:
                ctx.stop_generating()
        await _close(client, crt, wrt)
        return got

    got = await asyncio.wait_for(run(), T)
    assert 3 <= len(got) < 1000 and got == list(range(len(got)))
    assert len(engine.stopped) == 1  # the server's stream saw the stop


async def test_stream_abandon_kills_only_that_stream():
    """Abandoning one stream on a shared connection stops its server
    handler (kill frame) without disturbing the other stream."""

    async def run():
        wrt, crt, client = await _pair("mux2", SlowEngine())

        async def abandoner():
            agen = client.generate({}).__aiter__()
            await agen.__anext__()
            await agen.aclose()  # walk away mid-stream

        async def survivor():
            got = 0
            async for _ in client.generate({}):
                got += 1
                if got == 20:
                    break
            return got

        res = await asyncio.gather(abandoner(), survivor())
        assert len(client.router._pool._conns[wrt.server.address]) == 1
        while wrt.server.active_requests:
            await asyncio.sleep(0.02)
        await _close(client, crt, wrt)
        return res[1]

    assert await asyncio.wait_for(run(), T) == 20


class CodeError(Exception):
    code = "cannot_connect"


@pytest.mark.parametrize("fault,code", [
    ("engine", "engine"), ("coded", "cannot_connect"), ("no_endpoint", "no_endpoint")])
async def test_errors_propagate_with_codes(fault, code):
    class BadEngine:
        async def generate(self, request, context):
            yield {"ok": 1}
            raise (CodeError("hop failed") if fault == "coded" else ValueError("boom"))

    async def run():
        wrt, crt, client = await _pair("err", BadEngine())
        if fault == "no_endpoint":
            wrt.server.remove_endpoint("ns/w/gen")
        items = []
        with pytest.raises(RequestPlaneError) as ei:
            async for item in client.generate({}):
                items.append(item)
        await _close(client, crt, wrt)
        return items, ei.value.code

    items, got = await asyncio.wait_for(run(), T)
    assert got == code
    assert items == ([] if fault == "no_endpoint" else [{"ok": 1}])


@pytest.mark.parametrize("plane", ["tcp", "inproc"])
async def test_draining_rejects_new_requests(plane):
    async def run():
        wrt, crt, client = await _pair("d", EchoEngine(), plane)
        wrt.server._draining = True
        with pytest.raises(RequestPlaneError) as ei:
            async for _ in client.generate({"token_ids": [1]}):
                pass
        wrt.server._draining = False
        await _close(client, crt, wrt)
        return ei.value.code

    assert await asyncio.wait_for(run(), T) == "draining"


async def test_shutdown_with_idle_pooled_connection_does_not_hang():
    async def run():
        wrt, crt, client = await _pair("sd", EchoEngine())
        async for _ in client.generate({"token_ids": [1]}):
            pass
        # the connection is now idle in the client pool
        await wrt.shutdown(drain_timeout=0.5)
        await client.close()
        await crt.shutdown()

    await asyncio.wait_for(run(), T)


async def test_stale_pooled_connection_retries_on_fresh_socket():
    async def run():
        rt1, crt, client = await _pair("st", EchoEngine(), iid=5)
        async for _ in client.generate({"token_ids": [1]}):
            pass
        # restart the server on the same port: the pooled conn goes stale
        port = rt1.server.port
        await rt1.server.stop(drain_timeout=0.2)
        rt2 = _rt("st")
        rt2.server.port = port
        await rt2.serve_endpoint("ns/w/gen", EchoEngine(), instance_id=5)
        out = [i async for i in client.generate({"token_ids": [9]})]
        await _close(client, crt, rt2)
        return out

    assert await asyncio.wait_for(run(), T) == [{"token_ids": [9]}]


async def test_200_streams_over_few_sockets():
    """200 concurrent streams interleave over at most max_conns (8)
    connections, each completing in order."""

    class StreamEngine:
        async def generate(self, request, context):
            for i in range(3):
                await asyncio.sleep(0.001)
                yield {"n": request["n"], "i": i}

    async def run():
        wrt, crt, client = await _pair("mux", StreamEngine())

        async def one(n):
            got = [item async for item in client.generate({"n": n})]
            return [it["i"] for it in got] == [0, 1, 2] and all(it["n"] == n for it in got)

        ok = await asyncio.gather(*(one(n) for n in range(200)))
        n_conns = sum(len(v) for v in client.router._pool._conns.values())
        n_server = len(wrt.server._conns)
        await _close(client, crt, wrt)
        return ok, n_conns, n_server

    ok, n_conns, n_server = await asyncio.wait_for(run(), T)
    assert all(ok) and 0 < n_conns <= 8 and n_server <= 8


async def test_as_engine_coercions():
    async def gen_fn(request, context):
        yield request + 1

    async def unary_fn(request, context):
        return request * 2

    ctx = Context()
    assert [x async for x in as_engine(gen_fn).generate(1, ctx)] == [2]
    assert [x async for x in as_engine(unary_fn).generate(3, ctx)] == [6]


def test_push_router_sick_cooldown():
    """mark_sick removes an instance from selection for its cooldown,
    falls back to sick instances when nothing else is live, and expiry
    restores it."""
    r = PushRouter("ns/c/e", RouterMode.ROUND_ROBIN)
    r.update_instance(1, "127.0.0.1:1")
    r.update_instance(2, "127.0.0.1:2")
    r.mark_sick(1, cooldown=60)
    assert {r._pick()[0] for _ in range(6)} == {2}
    r.mark_sick(2, cooldown=60)  # ALL sick: keep routing, don't fail
    assert {r._pick()[0] for _ in range(6)} == {1, 2}
    r.mark_sick(1, cooldown=0)  # expired
    r.mark_sick(2, cooldown=0)
    assert r.sick_instances() == set()
    r.mark_sick(1, cooldown=60)
    r.update_instance(1, None)  # departure clears sickness state
    assert r.sick_instances() == set()


@pytest.mark.parametrize("mode", [RouterMode.P2C, RouterMode.LEAST_LOADED])
def test_load_aware_modes_prefer_the_lighter_instance(mode):
    r = PushRouter("ns/c/e", mode)
    r.update_instance(1, "127.0.0.1:1")
    r.update_instance(2, "127.0.0.1:2")
    r._inflight = {1: 10, 2: 0}
    picks = [r._pick()[0] for _ in range(50)]
    # p2c picks the heavier one only when both draws land on it
    assert picks.count(2) > picks.count(1)
    if mode == RouterMode.LEAST_LOADED:
        assert set(picks) == {2}


async def test_failed_hop_marks_the_instance_sick():
    async def run():
        wrt, crt, client = await _pair("sick", EchoEngine(), iid=9)
        await wrt.shutdown(drain_timeout=0)  # the listener is gone
        client.router.update_instance(9, wrt.server.address)
        with pytest.raises(RequestPlaneError) as ei:
            async for _ in client.generate({"token_ids": [1]}):
                pass
        sick = client.router.sick_instances()
        await _close(client, crt)
        return ei.value.code, sick

    code, sick = await asyncio.wait_for(run(), T)
    assert code in PushRouter.SICK_CODES and sick == {9}


# -- event plane --------------------------------------------------------------


async def test_tcp_event_plane_filters_subjects_and_resubscribes():
    async def run():
        pub = make_publisher("tcp")
        sub = make_subscriber("tcp", ["kv"])
        sub.connect(pub.address)
        while not pub._subs:
            await asyncio.sleep(0.01)
        await pub.publish("fpm", {"x": 1})
        await pub.publish("kv_events", {"events": [1, b"\x00" * 5000]})
        it = sub.events().__aiter__()
        first = await it.__anext__()
        # the publisher restarts on the same port: the subscriber reconnects
        port = int(pub.address.rsplit(":", 1)[1])
        await pub.close()
        pub2 = TcpEventPublisher(port=port)
        while not pub2._subs:
            await asyncio.sleep(0.02)
        await pub2.publish("kv_events", {"n": 2})
        second = await it.__anext__()
        await sub.close()
        await pub2.close()
        return first, second

    first, second = await asyncio.wait_for(run(), T)
    assert first == ("kv_events", {"events": [1, b"\x00" * 5000]})
    assert second == ("kv_events", {"n": 2})


def test_simple_metrics_render():
    m = make_metrics("ns").child(dynamo_component="c")
    m.counter("requests").inc(2)
    h = m.histogram("request_phase_seconds", phase="ttft")
    h.observe(0.5)
    h.observe(1.5)
    text = m.render().decode()
    assert 'dynamo_requests{dynamo_component="c",dynamo_endpoint="",dynamo_namespace="ns"} 2.0' in text
    assert "dynamo_request_phase_seconds_count{" in text and "} 2" in text


# -- across the wire against the reference runtime -----------------------------


@pytest.mark.parametrize("server", ["port", "reference"])
async def test_echo_across_packages(tmp_path, server):
    """A reference client calls a port server, and a port client a
    reference server, over TCP and file discovery on one root."""

    async def run():
        port_rt = DistributedRuntime(discovery=FileDiscovery(str(tmp_path), poll_interval=0.05),
                                     event_transport="inproc")
        ref_rt = RefRuntime(discovery=RefFileDiscovery(str(tmp_path), poll_interval=0.05),
                            event_transport="inproc")
        srv, cli = (port_rt, ref_rt) if server == "port" else (ref_rt, port_rt)
        await srv.serve_endpoint("ns/w/gen", EchoEngine() if server == "port"
                                 else RefEchoEngine())
        client = cli.client("ns/w/gen")
        await client.wait_ready(timeout=T)
        out = [i async for i in client.generate({"token_ids": [5, 6, (1 << 40), -3]})]
        text = [i async for i in client.generate({"text": "hé"})]
        await client.close()
        await cli.shutdown(drain_timeout=1)
        await srv.shutdown(drain_timeout=1)
        return out, text

    out, text = await asyncio.wait_for(run(), T)
    assert out == [{"token_ids": [t]} for t in (5, 6, 1 << 40, -3)]
    assert text == [{"text": "h"}, {"text": "é"}]
