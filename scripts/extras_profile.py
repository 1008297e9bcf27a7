#!/usr/bin/env python3
"""Profile the sampling extras' decode loops on one card.

    python3 scripts/extras_profile.py

Builds the kernels and the llama-3.2-3b runner as chip_smoke.py does,
then runs each of chip_smoke's `extras_variants` (a 4-step decode loop at
B 8 with no extra, penalties, logprobs, the device guided tables, the
host mask callback) twice to warm it and once under torch.profiler, and
prints one JSON line a variant: its wall ms under the profiler, the
device time summed over kernels, the host syncs and copies by name, and
the top host ops by self time. The card's name and power limit come first.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402

SYNC_KEYS = ("aten::item", "aten::_local_scalar_dense", "aten::nonzero")


def main() -> int:
    if not torch.cuda.is_available():
        print("extras_profile: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    cs._build.load()
    runner, _, _ = cs.timed_runner(cs.ENGINE_ARGS)
    variants, T, _ = cs.extras_variants(runner)
    for name, fn in variants.items():
        fn()
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        ka = prof.key_averages()
        top = sorted(ka, key=lambda e: e.self_cpu_time_total, reverse=True)[:12]
        print(json.dumps({
            "variant": name, "steps": T, "nvidia_smi": smi, "wall_ms_profiled": wall,
            "device_ms": sum(e.self_device_time_total for e in ka) / 1e3,
            "syncs": {e.key: e.count for e in ka if "Synchronize" in e.key
                      or "Memcpy" in e.key or e.key in SYNC_KEYS},
            "top_host_ms": [[e.key, e.count, e.self_cpu_time_total / 1e3] for e in top],
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
