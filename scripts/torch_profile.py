#!/usr/bin/env python3
"""Where the PyTorch port's engine spends its time on the card.

    python3 scripts/torch_profile.py [--model llama-3.2-3b|llama-3.1-8b|deepseek-v3|
        gemma-2-9b|qwen2.5-7b|phi-3-mini-4k|qwen3-30b-a3b] [--kv-quantize int8]
        [--trace PATH]

Builds the engine exactly as chip_smoke.py's engine phase does
(llama-3.2-3b, the default; llama-3.1-8b with the same flags, the
runner of chip_smoke.int8kv_phases when given --kv-quantize int8; with
--model deepseek-v3, the runner of chip_smoke.mla_phases: DeepSeek-V3's
three dense layers at full width, 2048 pages of 16; with --model
gemma-2-9b, chip_smoke.gemma_phases' runner and its two extra prompts
past the window; with --model qwen2.5-7b or phi-3-mini-4k, the runners of
chip_smoke.qwen2_phases (its biases left at 0) and phi3_phases, phi-3
with its two prompts past the window; with --model qwen3-30b-a3b, the
runner of chip_smoke.qwen3moe_phases, 48 MoE layers at full width, which
needs the card to itself; --kv-quantize int8 gives any of them int8 KV
pools) and
serves its workload three
times, each with fresh
prompts (another seed, so no run hits the previous run's prefix cache):
once cold, once warm with tracing off, once warm under torch.profiler
(CPU and CUDA activities). Prints one JSON line: wall time of the two
warm runs (their difference is the tracing overhead), and for the traced
run the device-busy time (union of kernel and copy intervals), the idle
share of the wall time, and device time by family (the GQA attention
kernels, the two MLA kernels, the MoE grouped GEMM, matrix products,
everything else) with the
top kernels by
device time. With --trace, also writes the Chrome trace there (about
100 MB for this workload). Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from dynamo_tpu_torch.engine.model_runner import ModelRunner  # noqa: E402
from dynamo_tpu_torch.worker import build_engine, parse_args  # noqa: E402

MODELS = ("llama-3.2-3b", "llama-3.1-8b", "deepseek-v3", "gemma-2-9b",
          "qwen2.5-7b", "phi-3-mini-4k", "qwen3-30b-a3b")


def family(name: str) -> str:
    if "mla_decode" in name:
        return "mla_decode"
    if "mla_prefill" in name:
        return "mla_prefill"
    if any(k in name for k in ("decode_kernel", "decode_split_kernel",
                               "decode_merge_kernel")):
        return "decode_attention"
    if "prefill_kernel" in name or "prefill_codes_kernel" in name:
        return "prefill_attention"
    if "ragged_kernel" in name or "ragged_merge_kernel" in name:
        return "ragged_attention"
    if "moe_gemm_kernel" in name:
        return "moe_grouped_gemm"
    low = name.lower()
    if any(k in low for k in ("gemm", "xmma", "cutlass", "nvjet", "cublas")):
        return "matmul"
    if low.startswith("memcpy") or low.startswith("memset"):
        return "copy"
    return "other"


def busy_us(intervals) -> float:
    """Length of the union of [start, end) intervals, in microseconds."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def timed_serve(engine, seed: int, extra=()) -> float:
    torch.cuda.synchronize()
    t0 = time.monotonic()
    chip_smoke.serve(engine, seed, extra=extra)
    torch.cuda.synchronize()
    return time.monotonic() - t0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", choices=MODELS, default=MODELS[0])
    ap.add_argument("--kv-quantize", choices=["int8"], default=None,
                    help="int8 KV pools (the runner's kv_quantize)")
    ap.add_argument("--trace", default=None, help="Chrome trace output path")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_profile: no CUDA device available", file=sys.stderr)
        return 1
    runner, extra = None, ()
    engine_args = ["--model", args.model] + chip_smoke.ENGINE_ARGS[2:]
    if args.model == "deepseek-v3":
        runner = ModelRunner(chip_smoke.MLA_CONFIG, num_pages=2048,
                             page_size=chip_smoke.PAGE_SIZE,
                             max_pages_per_seq=4096 // chip_smoke.PAGE_SIZE,
                             kv_quantize=args.kv_quantize)
    elif args.model == "gemma-2-9b":
        engine_args, extra = chip_smoke.GEMMA_ARGS, chip_smoke.GEMMA_LONG_PROMPTS
    elif args.model == "phi-3-mini-4k":
        engine_args, extra = chip_smoke.PHI3_ARGS, chip_smoke.PHI3_LONG_PROMPTS
    if args.kv_quantize:
        engine_args = engine_args + ["--kv-quantize", args.kv_quantize]
    engine = build_engine(parse_args(engine_args), runner=runner)
    try:
        cold_s = timed_serve(engine, seed=11, extra=extra)
        warm_s = timed_serve(engine, seed=12, extra=extra)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            traced_s = timed_serve(engine, seed=13, extra=extra)
    finally:
        engine.stop()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_family, by_name = {}, {}
    for e in events:
        us = e.time_range.elapsed_us()
        fam = family(e.name)
        by_family[fam] = by_family.get(fam, 0.0) + us
        n = by_name.setdefault(e.name[:80], [0, 0.0])
        n[0] += 1
        n[1] += us
    busy = busy_us((e.time_range.start, e.time_range.end) for e in events)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    if args.trace:
        Path(args.trace).parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(args.trace)
    print(json.dumps({
        "model": engine.runner.config.name,
        "kv_quantize": engine.runner.kv_quantize,
        "device": torch.cuda.get_device_name(0),
        "nvidia_smi": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip(),
        "wall_s": {"cold": cold_s, "warm": warm_s, "traced": traced_s},
        "traced_device_busy_s": busy / 1e6,
        "traced_idle_share": 1.0 - busy / 1e6 / traced_s,
        "traced_device_s_by_family": {k: v / 1e6 for k, v in sorted(by_family.items())},
        "traced_top_kernels": [
            {"name": k, "calls": n, "device_s": us / 1e6} for k, (n, us) in top],
        "n_device_events": len(events),
        "trace": args.trace,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
