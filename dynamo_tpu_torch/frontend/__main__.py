"""`python -m dynamo_tpu_torch.frontend`: the OpenAI-compatible HTTP
frontend of the port.

Port of dynamo_tpu/frontend/__main__.py `parse_args` and `async_main`:
discovers workers through their model cards, builds the serving chain per
model and serves HTTP:

    python -m dynamo_tpu_torch.frontend --router-mode kv --http-port 8080 \\
        --discovery-backend file --discovery-root DIR

prints "frontend serving at http://HOST:PORT" once it listens, and on
SIGTERM or SIGINT stops accepting, lets the requests in flight finish and
exits 0. `--status-port P` serves /live, /health, /metrics,
/debug/traces (with DYN_TRACE_RING set), /debug/fleet (a FleetObserver
over every worker's digest publisher, windowed by `--digest-window`
seconds) and /debug/routing (`?rid=` one request's decisions, `?last_n=`),
and binds the observer's measured onboard costs as the KV routers' tier
prices; `--request-trace PATH` writes a JSONL record per request. The SLO
engine, planner actuation, the gRPC frontend, router replica sync,
session affinity and SO_REUSEPORT workers are not ported yet.
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import signal

from dynamo_tpu_torch.frontend.http import HttpService
from dynamo_tpu_torch.frontend.service import ROUTER_MODES, ModelManager, ModelWatcher
from dynamo_tpu_torch.router.queue import AdmissionConfig
from dynamo_tpu_torch.router.scheduling import KvRouterConfig
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.event_plane import FLEET_DIGEST_SUBJECT
from dynamo_tpu_torch.runtime.fleet_observer import FleetObserver, routing_debug_payload
from dynamo_tpu_torch.runtime.logging_util import configure_logging
from dynamo_tpu_torch.runtime.status import StatusServer
from dynamo_tpu_torch.runtime.tasks import spawn_tracked

log = logging.getLogger("dynamo_tpu_torch.frontend.cli")


def parse_args(argv=None):
    p = argparse.ArgumentParser("dynamo_tpu_torch.frontend")
    p.add_argument("--http-host", default="0.0.0.0")
    p.add_argument("--http-port", type=int, default=8080,
                   help="0 binds a free port (printed in the serving line)")
    p.add_argument("--router-mode", default="round_robin", choices=list(ROUTER_MODES),
                   help="worker selection: the request plane's modes, or kv "
                        "(KV-cache-aware, from the workers' KV events)")
    p.add_argument("--migration-limit", type=int, default=3)
    p.add_argument("--disagg-min-prefill-tokens", type=int, default=256,
                   help="prompts at least this long go to prefill workers when present")
    p.add_argument("--busy-threshold", type=int, default=0,
                   help="shed load (503) above this many in-flight requests per model")
    p.add_argument("--router-busy-blocks", type=int, default=0,
                   help="kv mode: queue requests once every worker carries "
                        "this many charged KV blocks (0 = no queue)")
    p.add_argument("--router-queue-depth", type=int, default=256,
                   help="waiting requests beyond this are rejected with 429")
    p.add_argument("--router-queue-timeout", type=float, default=30.0,
                   help="queued longer than this is rejected with 429")
    p.add_argument("--router-temperature", type=float, default=0.0,
                   help="kv mode: softmax temperature over -cost (0 = argmin)")
    p.add_argument("--kv-overlap-score-weight", type=float, default=1.0,
                   help="kv mode: scale on the prefix-overlap credit (> 1 "
                        "cache-greedier, < 1 load-flatter)")
    p.add_argument("--no-kv-events", action="store_true",
                   help="kv mode, approximate: no KV event subscription; cache "
                        "state predicted from routed requests with a TTL")
    p.add_argument("--discovery-backend", default=None,
                   help="mem | file (default: DYN_DISCOVERY_BACKEND or mem)")
    p.add_argument("--discovery-root", default=None,
                   help="file discovery: the shared directory of records")
    p.add_argument("--request-trace", default=None,
                   help="JSONL per-request trace path (also DYN_REQUEST_TRACE)")
    p.add_argument("--status-port", type=int, default=0,
                   help="serve /live /health /metrics /debug/fleet /debug/routing "
                        "on this side port (0 = off); starts the fleet digest "
                        "observer")
    p.add_argument("--digest-window", type=float, default=60.0,
                   help="fleet observer aggregation window in seconds")
    return p.parse_args(argv)


async def start_fleet_status(runtime, manager: ModelManager, watcher: ModelWatcher,
                             port: int, window_s: float):
    """The frontend's status server: a FleetObserver subscribed to every
    worker's digest publisher as it registers (and forgetting it when it
    goes), bound as the KV routers' tier-cost source, with /debug/fleet
    and /debug/routing. Returns (server, observer, watch task)."""
    observer = FleetObserver(runtime.event_subscriber([FLEET_DIGEST_SUBJECT]),
                             window_s=window_s)
    await observer.start()
    # the KV routers price the lower tiers by the workers' measured
    # onboard seconds a block, the prior until a digest carries one
    watcher.tier_cost_source = observer.onboard_costs

    async def watch_digests() -> None:
        async for ev in runtime.discovery.watch("services/"):
            addr = (ev.instance.metadata or {}).get("digest_publisher")
            if ev.kind == "put" and addr:
                observer.connect_publisher(addr)
            elif ev.kind == "delete":
                # a dead worker's rows go now, not after the window ages
                # them out
                observer.forget_instance(ev.instance.instance_id)

    # a watch that fails is logged, not silent
    task = spawn_tracked(watch_digests(), name="fleet-digest-watch", logger=log)

    def fleet_view(q):
        win = q.get("window_s")
        return observer.fleet(window_s=float(win) if win else None)

    def routing_view(q):
        try:
            last_n = int(q.get("last_n", 64))
        except ValueError:
            last_n = 64
        return routing_debug_payload(manager.routing_audits(), rid=q.get("rid"),
                                     last_n=last_n)

    status = StatusServer(runtime, port=port)
    status.add_debug("fleet", fleet_view)
    status.add_debug("routing", routing_view)
    await status.start()
    return status, observer, task


async def async_main(args) -> None:
    kw = {}
    if args.discovery_root:
        kw["root"] = args.discovery_root
    runtime = DistributedRuntime(discovery_backend=args.discovery_backend, **kw)
    manager = ModelManager()
    admission = None
    if args.router_busy_blocks > 0:
        admission = AdmissionConfig(busy_blocks=args.router_busy_blocks,
                                    max_depth=args.router_queue_depth,
                                    max_wait_s=args.router_queue_timeout)
    watcher = ModelWatcher(
        runtime, manager, router_mode=args.router_mode,
        migration_limit=args.migration_limit,
        disagg_min_prefill_tokens=args.disagg_min_prefill_tokens,
        admission_config=admission,
        router_config=KvRouterConfig(temperature=args.router_temperature,
                                     overlap_weight=args.kv_overlap_score_weight),
        router_kv_events=not args.no_kv_events,
    )
    svc = HttpService(runtime, manager, watcher, host=args.http_host,
                      port=args.http_port, busy_threshold=args.busy_threshold,
                      trace_path=args.request_trace)
    fleet = None
    if args.status_port:
        fleet = await start_fleet_status(runtime, manager, watcher, args.status_port,
                                         args.digest_window)
        print(f"status server at port {fleet[0].port} (/debug/fleet, /debug/routing)",
              flush=True)
    url = await svc.start()
    print(f"frontend serving at {url}", flush=True)
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGTERM, signal.SIGINT):
        loop.add_signal_handler(sig, stop.set)
    try:
        await stop.wait()
        print("draining...", flush=True)
    finally:
        await svc.stop()
        if fleet is not None:
            status, observer, task = fleet
            task.cancel()
            await observer.stop()
            await status.stop()
        await runtime.shutdown()


def main(argv=None) -> None:
    configure_logging()
    asyncio.run(async_main(parse_args(argv)))


if __name__ == "__main__":
    main()
