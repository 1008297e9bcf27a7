"""The port's hardware profile sweep (dynamo_tpu_torch/planner/hw_profile.py),
on the CPU at a tiny size.

- the reference's own cases (tests/test_hw_profile.py) with a port
  artifact: the sweep times the real runner and round-trips through
  save/load, the reference planner's TpuPerfModel and the mocker's
  SimTiming load the port's artifact, and the reference planner's
  capacity is floored by its fitted capacity;
- the artifact is the reference's schema: the reference's load_profile
  reads it and its profile_fit gives the same keys; every variant
  (attention path x KV quantization) is there with its passes counted;
- `main` writes the artifact and prints the fit.
"""

import asyncio
import json
import time

import pytest

from dynamo_tpu.planner import hw_profile as ref_hw
from dynamo_tpu_torch.planner import hw_profile
from dynamo_tpu_torch.planner.hw_profile import (
    PROFILE_VERSION,
    fit_line,
    load_profile,
    profile_fit,
    run_hw_sweep,
    save_profile,
)

SWEEP = dict(batches=(1, 2, 4), prefill_chunks=(16, 32), page_size=4, num_pages=64,
             max_seq_len=64, decode_steps=4, iters=1, device="cpu")


@pytest.fixture(scope="module")
def profile(tmp_path_factory):
    prof = run_hw_sweep("tiny", kv_quants=(None, "int8"), **SWEEP)
    path = str(tmp_path_factory.mktemp("prof") / "tiny.json")
    save_profile(prof, path)
    return prof, path


def test_sweep_measures_real_engine(profile):
    prof, path = profile
    v = prof["variants"][prof["best_variant"]]
    assert len(v["decode"]) == 3 and len(v["prefill"]) == 2
    assert all(t > 0 for _, t in v["decode"]) and all(t > 0 for _, t in v["prefill"])
    assert v["fit"]["decode_capacity_tok_s"] > 0
    again = load_profile(path)
    assert again["variants"].keys() == prof["variants"].keys()
    assert profile_fit(again) == v["fit"]


def test_artifact_is_the_reference_schema(profile):
    prof, path = profile
    assert prof["version"] == PROFILE_VERSION == ref_hw.PROFILE_VERSION
    assert set(prof["variants"]) == {"kernel", "kernel+kv_int8", "ref", "ref+kv_int8"}
    assert prof["platform"] == "cpu" and prof["device"] == "cpu"
    ref_loaded = ref_hw.load_profile(path)
    for key in prof["variants"]:
        assert ref_hw.profile_fit(ref_loaded, key) == profile_fit(prof, key)
        assert set(ref_hw.profile_fit(ref_loaded, key)) == {
            "decode_base_s", "decode_per_seq_s", "prefill_base_s", "prefill_per_token_s",
            "decode_capacity_tok_s", "prefill_capacity_tok_s"}
    # every variant counts its forward passes: (warmup + iters) x steps a
    # batch, (warmup + iters) a chunk
    for v in prof["variants"].values():
        assert v["passes"] == {"decode": 3 * 2 * 4, "prefill": 2 * 2}


def test_fit_line_matches_the_reference():
    pts = [[1.0, 0.01], [2.0, 0.012], [4.0, 0.0161], [8.0, 0.0239]]
    assert fit_line(pts, 0.5, 0.5) == ref_hw.fit_line(pts, 0.5, 0.5)
    assert fit_line(pts[:1], 0.5, 0.25) == (0.5, 0.25)


def test_perf_model_and_sim_timing_load_profile(profile):
    prof, path = profile
    from dynamo_tpu.mocker.sim import SimTiming
    from dynamo_tpu.planner.profiler import TpuPerfModel

    fit = profile_fit(prof)
    pm = TpuPerfModel.from_profile(path)
    assert pm.decode_base_s == fit["decode_base_s"]
    assert pm.prefill_per_token_s == fit["prefill_per_token_s"]
    t1, t2 = pm.timing_for(1).decode_base_s, pm.timing_for(2).decode_base_s
    assert t2 <= t1
    st = SimTiming.from_profile(prof)
    assert st.decode_base_s == fit["decode_base_s"] and st.dispatch_overhead_s == 0.0


def test_planner_capacity_floored_by_profile(profile, tmp_path):
    prof, path = profile
    from dynamo_tpu.planner.connector import VirtualConnector
    from dynamo_tpu.planner.observer import FpmObserver
    from dynamo_tpu.planner.planner import Planner, PlannerConfig
    from dynamo_tpu.runtime.event_plane import make_subscriber

    def fpm(ts, tokens, worker):
        return {"ts": ts, "kind": "decode", "wall_time_s": 0.02,
                "scheduled_tokens": tokens, "n_running": 4, "n_waiting": 0,
                "kv_usage": 0.5, "worker": [worker, 0]}

    # 8 replicas each trickling a 64th of the measured capacity (an
    # eighth of one replica's in all, whatever this host's speed): the
    # observed rates alone keep all 8, the measured capacity floors it to 1
    cap = profile_fit(prof)["decode_capacity_tok_s"]
    tokens = max(1, int(cap / 32))  # every 2 s
    assert 8 * tokens / 2 < cap

    async def run(hw_profile_path):
        obs = FpmObserver(make_subscriber("inproc", subjects=["fpm"]), window_s=30)
        cfg = PlannerConfig(mode="throughput", predictor="constant", headroom=1.0,
                            max_replicas=64, hw_profile=hw_profile_path)
        p = Planner(obs, VirtualConnector(str(tmp_path / "planner")), cfg)
        now = time.time()
        for w in range(1, 9):
            for i in range(10):
                obs.ingest(fpm(now - i * 2, tokens, w))
        return (await p.tick(now))["decode"]

    assert asyncio.run(run(path)) == 1
    assert asyncio.run(run(None)) > 1


def test_main_writes_the_artifact(tmp_path, capsys):
    out = str(tmp_path / "p.json")
    hw_profile.main(["--model", "tiny", "--device", "cpu", "--out", out, "--batches", "1,2",
                     "--prefill-chunks", "16", "--page-size", "4", "--num-pages", "32",
                     "--max-seq-len", "64", "--decode-steps", "2", "--iters", "1",
                     "--attn-impls", "kernel"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    prof = load_profile(out)
    assert printed["best_variant"] == prof["best_variant"] == "kernel"
    assert list(prof["variants"]) == ["kernel"]
