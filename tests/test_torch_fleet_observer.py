"""The port's fleet observability plane (dynamo_tpu_torch/runtime/
fleet_observer.py) and the KV router's measured tier costs, on the CPU.

- the reference's own cases (tests/test_fleet_observer.py, less the SLO
  engine's, which is not ported) against the port's module: the
  mergeable histograms, DigestBuilder, the FleetObserver's windowing,
  dedup and churn, the fleet payload, the publish-to-observer round trip
  (in-process and on the port's TCP event plane), the routing audit ring
  and its debug payload, and the selector's per-candidate audit;
- parity: a port digest built from the same phase spines and FPMs as the
  reference DigestBuilder's equals its payload in every field but the
  clock reading `ts`, encodes to the same bytes through the port's codec
  and msgpack, and the reference FleetObserver ingests it;
- the tier-cost feed: the port engine's G2 onboard reaches its digest as
  `kv_onboard_ewma`, a FleetObserver that ingested it serves it as
  `onboard_costs`, and a KvRouter bound to that prices G2 by the
  measured value (the audit's credit source says "measured") where an
  unbound one uses the prior.
"""

import asyncio
import types

import msgpack
import pytest

from dynamo_tpu.runtime import fleet_observer as ref_fo
from dynamo_tpu_torch.engine.engine import InferenceEngine
from dynamo_tpu_torch.engine.model_runner import ModelRunner
from dynamo_tpu_torch.models.config import get_config
from dynamo_tpu_torch.router.protocols import OverlapScores
from dynamo_tpu_torch.router.scheduling import KvRouterConfig, WorkerSelector
from dynamo_tpu_torch.router.sequences import ActiveSequences
from dynamo_tpu_torch.runtime import codec
from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.runtime.event_plane import (
    InProcEventPublisher,
    InProcEventSubscriber,
    TcpEventPublisher,
    TcpEventSubscriber,
)
from dynamo_tpu_torch.runtime.fleet_observer import (
    FLEET_DIGEST_SUBJECT,
    HIST_BOUNDS,
    HIST_NBOUNDS,
    DigestBuilder,
    DigestPublisher,
    FleetObserver,
    RoutingAudit,
    hist_count,
    hist_frac_over,
    hist_observe,
    hist_quantile,
    merge_hist,
    new_hist,
    routing_debug_payload,
)
from dynamo_tpu_torch.runtime.metrics import SimpleMetrics


def _hist_of(values):
    h = new_hist()
    for v in values:
        hist_observe(h, v)
    return h


def test_histogram_layout_is_the_reference():
    assert HIST_BOUNDS == ref_fo.HIST_BOUNDS and HIST_NBOUNDS == ref_fo.HIST_NBOUNDS
    assert FLEET_DIGEST_SUBJECT == ref_fo.FLEET_DIGEST_SUBJECT


def test_hist_observe_bucketing():
    h = _hist_of([0.0, 0.0001, 0.00025])
    assert h[0] == 3
    h = new_hist()
    hist_observe(h, 1e9)
    assert h[HIST_NBOUNDS] == 1 and hist_count(h) == 1


@pytest.mark.parametrize("val", [0.0007, 0.013, 0.9])
def test_hist_quantile_brackets_true_value(val):
    h = _hist_of([val] * 100)
    for q in (0.5, 0.95, 0.99):
        est = hist_quantile(h, q)
        assert est is not None and val / 2.0 <= est <= val * 2.0, (val, q, est)
        assert est == ref_fo.hist_quantile(h, q)


def test_hist_quantile_empty_and_order():
    assert hist_quantile(new_hist(), 0.5) is None
    h = _hist_of([0.001] * 90 + [1.0] * 10)
    assert hist_quantile(h, 0.5) < 0.01 < hist_quantile(h, 0.99)


def test_merge_hist_elementwise_and_version_skew():
    a = _hist_of([0.001] * 5)
    b = _hist_of([0.001] * 3 + [1.0] * 2)
    assert hist_count(merge_hist(list(a), b)) == 10
    merged2 = merge_hist(new_hist(), [1, 2, 3])
    assert merged2[:3] == [1, 2, 3] and hist_count(merged2) == 6


def test_hist_frac_over():
    assert hist_frac_over(new_hist(), 0.1) is None
    h = _hist_of([0.001] * 75 + [1.0] * 25)
    assert abs(hist_frac_over(h, 0.02) - 0.25) < 0.01
    assert hist_frac_over(h, HIST_BOUNDS[-1] * 4) == 0.0


class _Fpm:
    def __init__(self, kind, scheduled_tokens=0, wall_time_s=0.0,
                 n_running=0, n_waiting=0, kv_usage=0.0):
        self.kind = kind
        self.scheduled_tokens = scheduled_tokens
        self.wall_time_s = wall_time_s
        self.n_running = n_running
        self.n_waiting = n_waiting
        self.kv_usage = kv_usage


def test_digest_builder_phases_and_counters():
    b = DigestBuilder(0xabc, dp_rank=1)
    b.observe_phases({"ttft_s": 0.2, "itl_s": [0.01, 0.02, 0.03], "e2e_s": 0.5,
                      "ignored_s": 9.9})
    b.observe_fpm(_Fpm("prefill", scheduled_tokens=128))
    b.observe_fpm(_Fpm("decode", scheduled_tokens=8, wall_time_s=0.004,
                       n_running=3, n_waiting=1, kv_usage=0.25))
    d = b.build(period_s=2.0)
    assert d["worker"] == [0xabc, 1] and d["seq"] == 1 and d["period_s"] == 2.0
    assert hist_count(d["phases"]["ttft"]) == 1
    assert hist_count(d["phases"]["itl"]) == 3
    assert "ignored" not in d["phases"]
    assert d["counters"] == {"requests": 1, "decode_tokens": 8, "prefill_tokens": 128,
                             "decode_iters": 1, "decode_wall_s": 0.004}
    assert d["queue"] == {"n_running": 3, "n_waiting": 1, "kv_usage": 0.25}
    d2 = b.build(period_s=2.0)
    assert d2["seq"] == 2 and d2["phases"] == {} and d2["counters"]["requests"] == 0


def test_digest_builder_engine_probe_is_getattr_guarded():
    d = DigestBuilder(1).build(engine=types.SimpleNamespace(), period_s=1.0)
    assert d["kv"] == {"g1_usage": 0.0, "g2_blocks": 0, "g3_blocks": 0}
    assert "prefetch" not in d and "compile" not in d and "spec" not in d


async def test_failed_publishes_and_probes_are_counted():
    """A publish that raises and an engine probe that raises are counted
    (on the publisher and builder, and on the bound metrics) and logged;
    the digest still builds without the failed block."""

    class BrokenPub:
        address = "inproc://broken"

        async def publish(self, subject, payload):
            raise ConnectionError("event plane down")

    class BrokenRunner:
        def compile_stats(self):
            raise RuntimeError("probe broke")

    m = SimpleMetrics()
    builder = DigestBuilder(3)
    dp = DigestPublisher(builder, BrokenPub(),
                         engine=types.SimpleNamespace(runner=BrokenRunner()), period_s=5.0)
    dp.bind_metrics(m)
    await dp.publish_once()
    await dp.publish_once()
    assert dp.published == 0 and dp.publish_failures == 2
    assert builder.probe_failures == 2
    text = m.render().decode()
    assert "dynamo_digest_publish_failures_total{" in text and "} 2.0" in text
    lines = [ln for ln in text.splitlines()
             if ln.startswith("dynamo_digest_probe_failures_total{")]
    assert lines and lines[0].endswith(" 2.0")
    assert "compile" not in builder.build(engine=types.SimpleNamespace(runner=BrokenRunner()))


def test_digest_builder_samples_spec_stats():
    eng = types.SimpleNamespace(spec_stats={
        "drafted": 20, "accepted": 14, "rejected": 6, "verify_rows": 5,
        "verify_iters": 3, "spec_emitted": 19})
    d = DigestBuilder(1).build(engine=eng, period_s=1.0)
    assert d["spec"]["drafted"] == 20
    assert d["spec"]["accept_rate"] == 14 / 20
    assert d["spec"]["accepted_per_step"] == 19 / 5
    quiet = types.SimpleNamespace(spec_stats=dict.fromkeys(eng.spec_stats, 0))
    assert "spec" not in DigestBuilder(2).build(engine=quiet)


def _digest(worker, seq, ts=1000.0, itl=None, counters=None):
    phases = {}
    if itl is not None:
        phases["itl"] = _hist_of(itl)
    d = {"worker": list(worker), "seq": seq, "ts": ts, "period_s": 2.0,
         "phases": phases, "queue": {"n_running": 1, "n_waiting": 0, "kv_usage": 0.1}}
    if counters:
        d["counters"] = counters
    return d


def test_ingest_drops_duplicates_and_late_arrivals():
    obs = FleetObserver(None, window_s=60.0)
    assert obs.ingest(_digest((1, 0), seq=1, itl=[0.01] * 4), now=0.0)
    assert obs.ingest(_digest((1, 0), seq=2, itl=[0.01] * 4), now=1.0)
    assert not obs.ingest(_digest((1, 0), seq=2, itl=[0.01] * 4), now=2.0)
    assert not obs.ingest(_digest((1, 0), seq=1, itl=[0.01] * 4), now=3.0)
    assert obs.received == 2 and obs.dropped_stale == 2
    assert hist_count(obs.phase_hists(now=5.0)["itl"]) == 8
    assert obs.ingest(_digest((2, 0), seq=1), now=4.0)


def test_clock_skew_does_not_corrupt_percentiles():
    obs = FleetObserver(None, window_s=60.0)
    obs.ingest(_digest((1, 0), seq=1, ts=1e12, itl=[0.01] * 50), now=100.0)
    obs.ingest(_digest((2, 0), seq=1, ts=-5000.0, itl=[0.01] * 50), now=101.0)
    obs.ingest(_digest((3, 0), seq=1, ts=2000.0, itl=[0.01] * 50), now=102.0)
    view = obs.fleet(now=110.0)
    assert view["n_workers"] == 3
    ph = view["fleet"]["phases"]["itl"]
    assert ph["n"] == 150
    assert 0.005 < ph["p50_s"] < 0.02 and 0.005 < ph["p99_s"] < 0.02


def test_worker_death_mid_window_then_ages_out():
    obs = FleetObserver(None, window_s=10.0)
    obs.ingest(_digest((1, 0), seq=1, itl=[0.01] * 8), now=0.0)
    obs.ingest(_digest((2, 0), seq=1, itl=[0.01] * 8), now=0.0)
    obs.ingest(_digest((2, 0), seq=2, itl=[0.01] * 8), now=5.0)
    assert obs.workers(now=8.0) == [(1, 0), (2, 0)]
    assert hist_count(obs.phase_hists(now=8.0)["itl"]) == 24
    assert obs.workers(now=12.0) == [(2, 0)]
    assert obs.workers(now=45.0) == []
    assert (1, 0) not in obs._digests
    assert obs.ingest(_digest((1, 0), seq=1), now=46.0)


def test_forget_instance_drops_ghost_load_immediately():
    obs = FleetObserver(None, window_s=10.0)
    obs.ingest(_digest((1, 0), seq=1, itl=[0.01] * 8), now=0.0)
    obs.ingest(_digest((1, 1), seq=1, itl=[0.01] * 8), now=0.0)
    obs.ingest(_digest((2, 0), seq=1, itl=[0.01] * 8), now=0.0)
    assert obs.forget_instance(1) == 2
    assert obs.workers(now=1.0) == [(2, 0)]
    assert hist_count(obs.phase_hists(now=1.0)["itl"]) == 8
    assert obs.forget_instance(1) == 0 and obs.forget_instance(999) == 0
    assert obs.ingest(_digest((1, 0), seq=1, itl=[0.01] * 8), now=2.0)
    assert obs.workers(now=3.0) == [(1, 0), (2, 0)]


def test_lossy_digest_plane_under_churn():
    obs = FleetObserver(None, window_s=20.0)
    w1, w2 = (1, 0), (2, 0)
    for seq, now in ((1, 0.0), (3, 2.0), (5, 4.0)):
        assert obs.ingest(_digest(w1, seq=seq, itl=[0.01] * 4), now=now)
    assert obs.ingest(_digest(w2, seq=1, itl=[0.01] * 4), now=1.0)
    assert obs.ingest(_digest(w2, seq=2, itl=[0.01] * 4), now=3.0)
    assert not obs.ingest(_digest(w2, seq=2, itl=[0.01] * 4), now=3.1)
    assert not obs.ingest(_digest(w2, seq=1, itl=[0.01] * 4), now=5.0)
    assert obs.received == 5 and obs.dropped_stale == 2
    assert hist_count(obs.phase_hists(now=6.0)["itl"]) == 20
    assert obs.ingest(_digest(w2, seq=3, itl=[0.01] * 4), now=10.0)
    assert obs.workers(now=30.0) == [w2]
    assert obs.workers(now=70.0) == []
    assert obs.ingest(_digest(w1, seq=1, itl=[0.01] * 4), now=70.0)
    assert w1 in obs.workers(now=71.0)


def test_fleet_payload_shape():
    obs = FleetObserver(None, window_s=60.0)
    obs.ingest(_digest((0xab, 1), seq=1, itl=[0.01] * 10,
                       counters={"requests": 2, "decode_tokens": 20, "prefill_tokens": 64,
                                 "decode_iters": 10, "decode_wall_s": 0.1}), now=0.0)
    obs.ingest(_digest((0xab, 1), seq=2, itl=[0.01] * 10,
                       counters={"requests": 3, "decode_tokens": 30, "prefill_tokens": 0,
                                 "decode_iters": 10, "decode_wall_s": 0.1}), now=1.0)
    view = obs.fleet(now=2.0)
    row = view["workers"]["ab.1"]
    assert row["digests"] == 2 and row["last_seq"] == 2
    assert row["counters"]["requests"] == 5 and row["counters"]["decode_tokens"] == 50
    assert row["phases"]["itl"]["n"] == 20
    assert view["received"] == 2 and view["dropped_stale"] == 0
    assert obs.fleet(now=2.0, window_s=1.5)["workers"]["ab.1"]["digests"] == 1


def test_fleet_row_surfaces_latest_spec_block():
    obs = FleetObserver(None, window_s=60.0)
    d1 = _digest((1, 0), seq=1)
    d1["spec"] = {"drafted": 8, "accepted": 5, "rejected": 3, "verify_iters": 2,
                  "accept_rate": 0.625, "accepted_per_step": 3.5}
    obs.ingest(d1, now=0.0)
    obs.ingest(_digest((1, 0), seq=2), now=1.0)
    row = obs.fleet(now=2.0)["workers"]["1.0"]
    assert row["spec"]["drafted"] == 8 and row["spec"]["accepted_per_step"] == 3.5
    obs.ingest(_digest((2, 0), seq=1), now=1.5)
    assert obs.fleet(now=2.0)["workers"]["2.0"]["spec"] == {}


def test_window_digests_adapter_surface():
    obs = FleetObserver(None, window_s=60.0)
    obs.ingest(_digest((1, 0), seq=1), now=0.0)
    obs.ingest(_digest((1, 0), seq=2), now=30.0)
    assert [d["seq"] for d in obs.window_digests(now=35.0, window_s=10.0)[(1, 0)]] == [2]


@pytest.mark.parametrize("transport", ["inproc", "tcp"])
async def test_digest_publish_to_observer_roundtrip(transport):
    if transport == "inproc":
        pub, sub = InProcEventPublisher(), InProcEventSubscriber([FLEET_DIGEST_SUBJECT])
    else:
        pub, sub = TcpEventPublisher(), TcpEventSubscriber([FLEET_DIGEST_SUBJECT])
    builder = DigestBuilder(7, dp_rank=0)
    dp = DigestPublisher(builder, pub, period_s=5.0)  # manual publishes
    obs = FleetObserver(sub, window_s=60.0)
    obs.connect_publisher(dp.address)
    await obs.start()
    try:
        for _ in range(200):  # a TCP subscriber connects asynchronously
            if transport == "inproc" or getattr(pub, "_subs", None):
                break
            await asyncio.sleep(0.01)
        builder.observe_phases({"ttft_s": 0.1, "itl_s": [0.01, 0.02]})
        await dp.publish_once()
        await dp.publish_once()  # an empty window is still a digest
        for _ in range(300):
            if obs.received >= 2:
                break
            await asyncio.sleep(0.01)
        assert obs.received == 2 and dp.published == 2
        view = obs.fleet()
        assert view["workers"]["7.0"]["phases"]["ttft"]["n"] == 1
        assert view["fleet"]["phases"]["itl"]["n"] == 2
    finally:
        await obs.stop()
        await dp.stop(flush=False)
        await sub.close()
        await pub.close()


def test_routing_audit_ring_bounds_and_rid_join():
    audit = RoutingAudit(capacity=8)
    for i in range(20):
        audit.record(f"req-{i}", "kv", [i, 0],
                     candidates=[{"worker": [i, 0], "chosen": True}], overlap_blocks=i)
    assert len(audit) == 8 and audit.recorded == 20
    assert [e["rid"] for e in audit.query(last_n=2)] == ["req-18", "req-19"]
    hits = audit.query(rid="req-15")
    assert len(hits) == 1 and hits[0]["overlap_blocks"] == 15 and hits[0]["chosen"] == [15, 0]
    assert audit.query(rid="req-0") == []


def test_routing_debug_payload_merges_routers():
    kv, push = RoutingAudit(), RoutingAudit()
    kv.record("r1", "kv", [1, 0], candidates=[{"worker": [1, 0]}])
    push.record("r1", "round_robin", 2)
    push.record("r2", "round_robin", 3)
    payload = routing_debug_payload({"m/kv": kv, "m/push": push})
    assert payload["n"] == 3 and payload["recorded"] == 3
    assert {d["router"] for d in payload["decisions"]} == {"m/kv", "m/push"}
    ts = [d["ts"] for d in payload["decisions"]]
    assert ts == sorted(ts)
    joined = routing_debug_payload({"m/kv": kv, "m/push": push}, rid="r1")
    assert [d["rid"] for d in joined["decisions"]] == ["r1", "r1"]
    assert routing_debug_payload({"m/kv": kv, "m/push": push}, last_n=1)["n"] == 1


def _select(tier_costs=None):
    sel = WorkerSelector(KvRouterConfig())
    audit = []
    best, overlap = sel.select(
        [(1, 0), (2, 0)], total_blocks=8,
        overlaps=OverlapScores(scores={(1, 0): 4}, total_blocks=8),
        sequences=ActiveSequences(), host_overlaps={(2, 0): 8},
        tier_costs=tier_costs, audit=audit)
    return best, overlap, audit


def test_selector_audit_capture():
    best, overlap, audit = _select()
    assert best in ((1, 0), (2, 0))
    assert len(audit) == 2 and sum(1 for e in audit if e["chosen"]) == 1
    chosen = next(e for e in audit if e["chosen"])
    assert tuple(chosen["worker"]) == best
    for e in audit:
        assert {"worker", "overlap_blocks", "credit", "new_blocks", "cost",
                "chosen", "credit_src"} <= set(e)
        assert e["credit_src"] == {"host": "prior", "remote": "prior", "obj": "prior"}
    # the same breakdown the reference selector records
    from dynamo_tpu.router.protocols import OverlapScores as RefScores
    from dynamo_tpu.router.scheduling import KvRouterConfig as RefConfig
    from dynamo_tpu.router.scheduling import WorkerSelector as RefSelector
    from dynamo_tpu.router.sequences import ActiveSequences as RefSeqs

    ref_audit = []
    RefSelector(RefConfig()).select(
        [(1, 0), (2, 0)], total_blocks=8,
        overlaps=RefScores(scores={(1, 0): 4}, total_blocks=8),
        sequences=RefSeqs(), host_overlaps={(2, 0): 8}, audit=ref_audit)
    assert audit == ref_audit


def _stub_engine():
    """One engine-shaped object both builders sample (a G2 tier with an
    onboard EWMA, prefetch counters, speculation, the prefix tree, the
    recorder and the co-scheduling knobs)."""
    pool_host = type("P", (), {"__len__": lambda self: 3,
                               "stats": {"stored_bytes": 4096, "quant_blocks": 1}})()
    return types.SimpleNamespace(
        host_pool=types.SimpleNamespace(host=pool_host, disk=None, obj=None),
        kv_onboard_ewma={"host": {"s_per_block": 0.00012345678, "n": 7}},
        prefetch=types.SimpleNamespace(stats={"hints": 2, "promoted": 1, "hits": 1}),
        spec_stats={"drafted": 10, "accepted": 6, "rejected": 4, "verify_rows": 4,
                    "verify_iters": 2, "spec_emitted": 10, "tree_rows": 0,
                    "tree_switches": 0},
        pool=types.SimpleNamespace(match_hit_blocks=5, forks=1),
        scheduler=types.SimpleNamespace(reused_prefix_tokens=20, prompt_tokens_total=80,
                                        mixed_prefill_tokens=256, mixed_prefill_seqs=8),
        recorder=types.SimpleNamespace(enabled=True, total_appended=42, anomalies_fired=1),
        spec_k=4, retunes=0)


def _fed(builder):
    builder.observe_phases({"ttft_s": 0.21, "itl_s": [0.011, 0.012, 0.03], "e2e_s": 0.9,
                            "queue_wait_s": 0.004, "route_s": 0.0002,
                            "kv_onboard_s": 0.0031, "trace_id": "ab" * 16})
    builder.observe_phases({"ttft_s": 0.05, "itl_s": [0.02], "e2e_s": 0.1})
    builder.observe_fpm(_Fpm("prefill", scheduled_tokens=64, wall_time_s=0.02))
    builder.observe_fpm(_Fpm("decode", scheduled_tokens=4, wall_time_s=0.006,
                             n_running=2, n_waiting=1, kv_usage=0.5))
    return builder.build(engine=_stub_engine(), period_s=2.0)


def test_digest_payload_matches_the_reference_and_its_wire():
    port = _fed(DigestBuilder(0x1234, dp_rank=0))
    ref = _fed(ref_fo.DigestBuilder(0x1234, dp_rank=0))
    assert abs(port.pop("ts") - ref.pop("ts")) < 60.0  # the clock reading
    assert port == ref
    assert port["kv"]["onboard_ewma"] == {"host": {"s_per_block": 0.000123, "n": 7}}
    port["ts"] = 1760000000.5
    assert codec.packb(port) == msgpack.packb(port)
    assert codec.unpackb(msgpack.packb(port)) == port
    obs = ref_fo.FleetObserver(None, window_s=60.0)
    assert obs.ingest(msgpack.unpackb(codec.packb(port)), now=1.0)
    assert obs.onboard_costs(now=2.0) == {(0x1234, 0): {"host": 0.000123}}
    assert obs.fleet(now=2.0)["workers"]["1234.0"]["phases"]["ttft"]["n"] == 2


def _tier_engine():
    runner = ModelRunner(get_config("tiny"), device="cpu", num_pages=12, page_size=4,
                         max_pages_per_seq=16, decode_buckets=(1, 2, 4),
                         prefill_buckets=(8, 16, 32))
    return InferenceEngine(runner, max_batch=2, chunk_size=32, host_kv_blocks=64)


async def test_onboard_costs_feed_the_router_prices():
    """The G2 onboard's measured seconds a block travel: engine EWMA ->
    digest -> observer -> selector, which then prices G2 as measured."""
    engine = _tier_engine()
    engine.start()
    try:
        async def run(prompt):
            async for item in engine.generate(
                    {"token_ids": prompt, "sampling": {"temperature": 0.0},
                     "stop": {"max_tokens": 2, "stop_ids": []}}, Context()):
                if item.get("finish_reason"):
                    return item
        a = list(range(1, 25))  # 6 pages: evicted by the next prompts
        await run(a)
        await run(list(range(100, 124)))
        await run(list(range(200, 224)))
        await run(a)  # a prefix hit in G2: onboarded
    finally:
        engine.stop()
    assert engine.onboard_stats["onboards"] >= 1
    assert engine.kv_onboard_ewma["host"]["n"] > 0
    builder = DigestBuilder(9)
    digest = builder.build(engine=engine, period_s=1.0)
    measured = digest["kv"]["onboard_ewma"]["host"]["s_per_block"]
    assert digest["kv"]["g2_blocks"] > 0 and measured > 0
    assert digest["recorder"]["appended"] == engine.iterations
    assert set(digest["compile"]) >= {"prefill", "decode"}
    obs = FleetObserver(None, window_s=60.0)
    assert obs.ingest(digest, now=0.0)
    costs = obs.onboard_costs(now=1.0)
    assert costs == {(9, 0): {"host": measured}}
    _, _, audit = _select(tier_costs={(2, 0): costs[(9, 0)]})
    row = next(e for e in audit if e["worker"] == [2, 0])
    assert row["credit_src"]["host"] == "measured"
    cfg = KvRouterConfig()
    assert row["host_credit_w"] == round(cfg.credit_fraction(measured), 3)
    prior = next(e for e in _select()[2] if e["worker"] == [2, 0])
    assert prior["credit_src"]["host"] == "prior"
    assert prior["host_credit_w"] == cfg.host_credit
