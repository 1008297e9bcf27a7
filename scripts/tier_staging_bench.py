#!/usr/bin/env python3
"""Time the host side of the KV tiers on one card, at llama-3.2-3b's page
shape (L 28, PS 16, Hk 8, D 128, bf16: 917,504 bytes a page a pool).

    python3 scripts/tier_staging_bench.py [--pages 64] [--groups 4] [--reps 5]

Offload of `--pages` pages a rep, as the engine offloads an alloc's
evictions: the runner's `export_page_blocks` (a gather per pool, the
pages made page-major, one copy a block into a host tensor, one wait),
then the host tier's `put_block`; with every block pinned (within the
runner's `pinned_block_cap`, memory the caching host allocator holds
after `reserve_host_memory`), and with every block pageable (the cap
spent, as in a host tier larger than its pinned reserve). Onboard of
`--pages` pages in `--groups` layer groups through the runner's
`import_page_tensors`, from pinned blocks, pageable blocks, half of each
(the blocks of a host tier whose reserve holds half of them), and one
pageable layer-major [L, n, ...] tensor (the pages of a remote pull's or
a wire payload), with the first onboard of the process apart. G3 reads
of the same blocks as files in a temporary directory (warm in the page
cache) through the pool's `get_block`. Every time is a host clock around
work that ends in `torch.cuda.synchronize()`, min and median over
`--reps`. Prints one JSON line, then the card's name and power limit.
Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from dynamo_tpu_torch.engine.model_runner import ModelRunner
from dynamo_tpu_torch.kvbm.disk_pool import DiskKvPool
from dynamo_tpu_torch.kvbm.host_pool import HostKvPool
from dynamo_tpu_torch.models.config import get_config
from dynamo_tpu_torch.ops import _build


def timed(fn, reps):
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return {"min_s": min(out), "median_s": statistics.median(out)}


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--pages", type=int, default=64)
    p.add_argument("--groups", type=int, default=4)
    p.add_argument("--reps", type=int, default=5)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("tier_staging_bench: no CUDA device", file=sys.stderr)
        return 1
    _build.load()
    n = args.pages
    runner = ModelRunner(get_config("llama-3.2-3b"), num_pages=2 * n + 8,
                         page_size=16, max_pages_per_seq=64, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    for pool in (runner.k_pool, runner.v_pool):
        pool.copy_(torch.randn(pool.shape, generator=gen, device="cuda").bfloat16())
    page_bytes = runner.k_pool[:, 0].numel() * 2
    rec = {"shape": list(runner.kv_page_shape), "page_bytes_per_pool": page_bytes,
           "pages": n, "groups": args.groups}

    t_reserve = time.perf_counter()
    runner.reserve_host_memory(n, 4 * n, 4 * n)
    rec["reserve_host_memory_s"] = time.perf_counter() - t_reserve
    rec["reserve_blocks"] = 4 * n
    stats = getattr(torch.cuda, "host_memory_stats", None)
    if stats is not None:
        rec["host_memory_stats"] = {k: v for k, v in stats().items()
                                    if k.endswith(".current") or k.endswith(".peak")}

    # -- offload: n pages a rep, all pinned, then all pageable -------------
    def offload():
        host = HostKvPool(capacity_blocks=4 * n)
        for i, (k, v) in enumerate(runner.export_page_blocks(list(range(n)))):
            host.put_block(i, None, k, v)

    cap = getattr(runner, "pinned_block_cap", 0)
    for name, cap_now in (("pinned", cap), ("pageable", 0)):
        runner.pinned_block_cap = cap_now
        offload()  # warm
        t = timed(offload, args.reps)
        rec[f"offload_{name}"] = dict(t, per_page_ms=t["median_s"] / n * 1e3)
    runner.pinned_block_cap = cap

    # -- onboard: n pages in `groups` layer groups --------------------------
    pinned = runner.export_page_blocks(list(range(n)))
    # half of the next n pages' blocks pinned (a runner before the cap
    # pins them all)
    runner.pinned_block_cap = getattr(runner, "_pinned_live", [0])[0] + n
    mixed = runner.export_page_blocks(list(range(n)))
    runner.pinned_block_cap = cap
    pageable = [(k.clone(), v.clone()) for k, v in pinned]
    rec["mixed_pinned_blocks"] = sum(k.is_pinned() for k, _ in mixed)
    onboard_bytes = 2 * n * page_bytes
    target = list(range(n, 2 * n))
    want = runner.k_pool[:, :n].cpu()
    layer_major = (want.clone(), runner.v_pool[:, :n].cpu())
    sources = {
        "pinned_blocks": ([b[0] for b in pinned], [b[1] for b in pinned]),
        "pageable_blocks": ([b[0] for b in pageable], [b[1] for b in pageable]),
        "mixed_blocks": ([b[0] for b in mixed], [b[1] for b in mixed]),
        "pageable_layer_major": layer_major,
    }
    for name, (ks, vs) in sources.items():
        def onboard():
            runner.import_page_tensors(target, ks, vs, layer_groups=args.groups)

        runner.k_pool[:, target] = 0
        first = timed(onboard, 1)["min_s"]
        t = timed(onboard, args.reps)
        equal = torch.equal(runner.k_pool[:, target].cpu(), want)
        rec[f"onboard_{name}"] = dict(t, first_s=first, pages_equal=bool(equal),
                                      gb_per_s=onboard_bytes / t["median_s"] / 1e9)
        if not equal:
            print(f"tier_staging_bench: {name}: onboarded pages differ", file=sys.stderr)
            return 1
    rec["onboard_bytes"] = onboard_bytes

    # -- G3 reads: the n blocks as files, read back -------------------------
    with tempfile.TemporaryDirectory(prefix="tier_bench_g3_") as root:
        disk = DiskKvPool(root, capacity_blocks=4 * n)
        for i, (k, v) in enumerate(pinned):
            disk.put_block(i, None, k, v)
        disk.flush()

        def get_blocks():
            for i in range(n):
                disk.get_block(i)

        get_blocks()
        t = timed(get_blocks, args.reps)
        rec["g3_get_block"] = dict(t, gb_per_s=onboard_bytes / t["median_s"] / 1e9)

    rec["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(rec), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
