#!/usr/bin/env python3
"""Linear n-gram drafts from the device ring against the host scan, on
one card.

    python3 scripts/draft_ring_ab.py [--pairs 2]

Builds the kernels and the llama-3.2-3b runner as chip_smoke.py does,
then serves chip_smoke's `spec` workload (--spec-ngram, K 4) on fresh
engines over that runner in turns ring, host, host, ring, `--pairs`
times: `spec_device_draft` on (one device ring step a verify iteration)
or off (`ngram_draft.propose` a row). Each turn prints one JSON line
with chip_smoke's engine checks passed, its TTFT, median per-request
decode rate, overall output rate and wall, and the host's time inside
the engine's `_propose_drafts` (calls, total ms, ms a call; timed by a
perf_counter pair around it, the same for both modes). The streams of
every turn must equal the first turn's. Then the draft layer alone:
the runner's `draft_step` at 8 slots of the workload's prompts with 3
new tokens each a step, random or the motif's next ones (host wall ms a
call, readback included), against `ngram_propose` over the same 8
histories. The card's name and power
limit come first. Needs one CUDA device; exits 1 when a check fails.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402

from dynamo_tpu_torch.engine.ngram_draft import propose as ngram_propose  # noqa: E402

KEYS = ("ttft_s_median", "decode_tok_s_per_request_median",
        "output_tok_s_overall", "wall_s")
K = 4


def timed_propose(clock):
    """engine_phase's probe: time every `_propose_drafts` call."""
    def install(engine):
        propose = engine._propose_drafts

        def timed():
            t0 = time.perf_counter()
            propose()
            clock.append(time.perf_counter() - t0)

        engine._propose_drafts = timed
    return install


def turn(runner, mode):
    clock = []
    rec, _, results = cs.engine_phase(
        runner, "spec", spec=True, probe=timed_propose(clock),
        engine_kw={"spec_device_draft": mode == "ring"})
    st = rec["stats"]
    cs.check(st["ragged_verify_dispatches"] > 0
             and (st["draft_ring_steps"] > 0) == (mode == "ring"),
             f"{mode}: the turn did not draft as asked: {st}")
    out = {"mode": mode, **{k: rec[k] for k in KEYS},
           "spec_stats": rec["spec_stats"], "propose_calls": len(clock),
           "propose_ms": sum(clock) * 1e3,
           "propose_ms_per_call": sum(clock) * 1e3 / max(1, len(clock))}
    return out, [r[0] for r in results]


def layer(runner, steps=50):
    """draft_step against the host scan over the workload's 8 histories,
    each growing 3 tokens a step: random tokens (the suffix rarely
    matches, and the scan walks the whole history) or the scan's own
    proposal (the motif goes on, and the scan stops at its last copy)."""
    V = runner.config.vocab_size
    reqs, late = cs.spec_workload(V, 1)
    out = {}
    for kind in ("random", "repeat"):
        hists = [list(r["token_ids"]) for r in reqs + [late]]
        rng = np.random.default_rng(0)
        runner.ensure_draft_ring(len(hists), K)
        for slot, h in enumerate(hists):
            runner.draft_ring_reset(slot, h)
        runner.draft_step([], K)
        ring_s = scan_s = 0.0
        for _ in range(steps):
            upd = []
            for slot, h in enumerate(hists):
                new = (ngram_propose(h, 3) if kind == "repeat" else []) \
                    or rng.integers(0, V, 3).tolist()
                h.extend(new)
                upd.append((slot, new))
            t0 = time.perf_counter()
            drafts, n_prop = runner.draft_step(upd, K)
            t1 = time.perf_counter()
            [ngram_propose(h, K) for h in hists]
            t2 = time.perf_counter()
            ring_s += t1 - t0
            scan_s += t2 - t1
            got = [drafts[s][:int(n_prop[s])].tolist() for s in range(len(hists))]
            cs.check(got == [ngram_propose(h[-cs.DRAFT_RING_WINDOW:], K)
                             for h in hists],
                     f"layer ({kind}): ring proposals differ from the host scan")
        out[kind] = {"slots": len(hists), "steps": steps,
                     "history_tokens": [len(h) for h in hists],
                     "draft_step_ms_per_call": ring_s * 1e3 / steps,
                     "host_scan_ms_per_call": scan_s * 1e3 / steps}
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("draft_ring_ab: no CUDA device", file=sys.stderr)
        return 1
    p = argparse.ArgumentParser()
    p.add_argument("--pairs", type=int, default=2)
    args = p.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    cs._build.load()
    runner, _, _ = cs.timed_runner(cs.ENGINE_ARGS)
    turn(runner, "ring")  # warm both paths once, unreported
    turn(runner, "host")
    first = None
    for i, mode in enumerate(["ring", "host", "host", "ring"] * args.pairs):
        rec, streams = turn(runner, mode)
        first = first or streams
        cs.check(streams == first, f"turn {i} ({mode}): streams differ from turn 0")
        print(json.dumps({"turn": i, "nvidia_smi": smi, **rec}), flush=True)
    print(json.dumps({"layer": layer(runner), "nvidia_smi": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
