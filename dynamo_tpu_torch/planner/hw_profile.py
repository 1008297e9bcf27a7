"""`python -m dynamo_tpu_torch.planner.hw_profile`: time the port's real
runner and write the planner's hardware profile.

Port of dynamo_tpu/planner/hw_profile.py `fit_line`, `run_hw_sweep`,
`save_profile`, `load_profile`, `profile_fit` and `main`. The sweep times
the ModelRunner's `decode_multi` (per step, by batch) and `prefill` (by
chunk tokens) for each variant, the forward's attention path (`kernel`:
the CUDA kernels; `ref`: their plain PyTorch versions) x KV quantization
(bf16 pools, or int8 with `--kv-int8`), each point the median of `iters`
timed calls after `warmup` untimed ones, `torch.cuda.synchronize` closing
each call. It fits the linear step-time model per variant and the
per-replica capacities, in the reference's artifact schema
(PROFILE_VERSION 1: the reference's `load_profile` / `profile_fit` read a
port artifact); `device` is the card's name. Each variant also records
its timed and untimed `passes` (forward passes by kind), so the kernels'
launch counts can be held to passes x layers. Run on the card:

    python -m dynamo_tpu_torch.planner.hw_profile --model llama-3.2-3b \\
        --kv-int8 --out profile.json
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

PROFILE_VERSION = 1
ATTN_VARIANTS = ("kernel", "ref")


def fit_line(points, d0: float, s0: float):
    """(intercept, slope) by least squares over (x, y) pairs; (d0, s0) with
    fewer than two distinct x."""
    points = list(points)
    if len(points) < 2 or len({p[0] for p in points}) < 2:
        return d0, s0
    xs = np.asarray([p[0] for p in points], float)
    ys = np.asarray([p[1] for p in points], float)
    slope, intercept = np.polyfit(xs, ys, 1)
    return max(float(intercept), 0.0), max(float(slope), 0.0)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_hw_sweep(
    model: str = "tiny",
    *,
    checkpoint: Optional[str] = None,
    batches: Sequence[int] = (1, 2, 4, 8, 16, 32),
    prefill_chunks: Sequence[int] = (64, 128, 256, 512),
    page_size: int = 16,
    num_pages: int = 512,
    max_seq_len: int = 2048,
    decode_steps: int = 8,
    attn_impls: Optional[Sequence[str]] = None,
    kv_quants: Sequence[Optional[str]] = (None,),
    warmup: int = 1,
    iters: int = 3,
    device=None,
    params: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """Time real prefill and decode dispatches across (batch, chunk, attn
    path, kv quant). Returns the profile artifact dict (save with
    save_profile). `params` (a params tree) skips the draw; with neither
    it nor a checkpoint the weights are random, from seed 0, drawn once
    and shared by every variant."""
    from dynamo_tpu_torch import resolve_device
    from dynamo_tpu_torch.engine.model_runner import ModelRunner
    from dynamo_tpu_torch.models.config import get_config

    if checkpoint:
        from dynamo_tpu_torch.engine.weights import config_from_hf, load_hf_checkpoint

        config = config_from_hf(checkpoint, name=model)
        params = load_hf_checkpoint(checkpoint, config, device=resolve_device(device))
    else:
        config = get_config(model)
    dev = resolve_device(device)
    attn_impls = tuple(attn_impls or ATTN_VARIANTS)
    max_pages_per_seq = -(-max_seq_len // page_size)
    # each sequence decodes decode_steps tokens from position 4: its table
    # covers every KV slot it touches (ids past the pool would alias)
    pos0 = 4
    seq_pages = -(-(pos0 + decode_steps + 1) // page_size)
    if seq_pages > max_pages_per_seq:
        raise ValueError(
            f"decode_steps={decode_steps} needs {seq_pages} pages/seq but "
            f"max_seq_len={max_seq_len} allows {max_pages_per_seq}")
    variants: Dict[str, Any] = {}
    for impl in attn_impls:
        for kvq in kv_quants:
            key = impl + (f"+kv_{kvq}" if kvq else "")
            runner = ModelRunner(
                config, num_pages=num_pages, page_size=page_size,
                max_pages_per_seq=max_pages_per_seq,
                decode_buckets=tuple(sorted(set(batches))),
                prefill_buckets=tuple(sorted(set(prefill_chunks))),
                params=params, device=dev, kv_quantize=kvq, attn_impl=impl)
            params = runner.params  # drawn once, shared by every variant

            def sampling(n):
                return {"temperature": [0.0] * n, "top_k": [0] * n,
                        "top_p": [1.0] * n, "seeds": [0] * n}

            decode_pts: List[List[float]] = []
            passes = {"decode": 0, "prefill": 0}
            for B in batches:
                if B * seq_pages > num_pages:
                    continue  # batches may be unsorted: a later one may fit
                tables = [list(range(i * seq_pages, (i + 1) * seq_pages))
                          for i in range(B)]
                ts = []
                for it in range(warmup + iters):
                    t0 = time.perf_counter()
                    runner.decode_multi(decode_steps, [1] * B, [pos0] * B, tables,
                                        sampling(B), 1)
                    dt = time.perf_counter() - t0
                    passes["decode"] += decode_steps
                    if it >= warmup:
                        ts.append(dt)
                decode_pts.append([float(B), float(np.median(ts)) / decode_steps])

            prefill_pts: List[List[float]] = []
            for chunk in prefill_chunks:
                chunk_pages = -(-chunk // page_size)
                if chunk > max_seq_len or chunk_pages > min(num_pages, max_pages_per_seq):
                    continue
                row = list(range(chunk_pages))
                toks = [i % config.vocab_size for i in range(chunk)]
                ts = []
                for it in range(warmup + iters):
                    t0 = time.perf_counter()
                    runner.prefill(toks, 0, row, 0)
                    _sync(dev)
                    dt = time.perf_counter() - t0
                    passes["prefill"] += 1
                    if it >= warmup:
                        ts.append(dt)
                prefill_pts.append([float(chunk), float(np.median(ts))])

            if not decode_pts or not prefill_pts:
                raise ValueError(
                    f"nothing measurable: batches={list(batches)} need "
                    f"B*{seq_pages} <= num_pages={num_pages}; chunks="
                    f"{list(prefill_chunks)} need <= max_seq_len={max_seq_len} "
                    f"and ceil(chunk/{page_size}) <= "
                    f"{min(num_pages, max_pages_per_seq)}")
            d_base, d_slope = fit_line(decode_pts, 0.004, 0.0003)
            p_base, p_slope = fit_line(prefill_pts, 0.004, 0.00004)
            cap_b, cap_t = max(decode_pts, key=lambda p: p[0])
            pre_b, pre_t = max(prefill_pts, key=lambda p: p[0])
            variants[key] = {
                "decode": decode_pts,  # [batch, s_per_step]
                "prefill": prefill_pts,  # [chunk_tokens, s]
                "fit": {
                    "decode_base_s": d_base,
                    "decode_per_seq_s": d_slope,
                    "prefill_base_s": p_base,
                    "prefill_per_token_s": p_slope,
                    # the best measured per-replica throughputs: the
                    # planner's cold-start capacity floors
                    "decode_capacity_tok_s": cap_b / cap_t if cap_t > 0 else 0.0,
                    "prefill_capacity_tok_s": pre_b / pre_t if pre_t > 0 else 0.0,
                },
                "passes": passes,
            }
            del runner

    best = max(variants, key=lambda k: variants[k]["fit"]["decode_capacity_tok_s"])
    return {
        "version": PROFILE_VERSION,
        "model": config.name,
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev),
        "page_size": page_size,
        "decode_steps": decode_steps,
        "best_variant": best,
        "variants": variants,
    }


def save_profile(profile: Dict[str, Any], path: str) -> None:
    with open(path, "w") as f:
        json.dump(profile, f, indent=1)


def load_profile(path: str) -> Dict[str, Any]:
    with open(path) as f:
        profile = json.load(f)
    if profile.get("version") != PROFILE_VERSION:
        raise ValueError(f"profile version {profile.get('version')} != {PROFILE_VERSION}")
    return profile


def profile_fit(profile: Dict[str, Any], variant: Optional[str] = None) -> Dict[str, float]:
    """The fitted step-time constants of `variant` (default: the
    best-throughput variant the artifact records)."""
    v = variant or profile["best_variant"]
    return profile["variants"][v]["fit"]


def main(argv=None) -> None:
    p = argparse.ArgumentParser("dynamo_tpu_torch.planner.hw_profile")
    p.add_argument("--model", default="tiny")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--out", required=True, help="profile artifact path (JSON)")
    p.add_argument("--batches", default="1,2,4,8,16,32")
    p.add_argument("--prefill-chunks", default="64,128,256,512")
    p.add_argument("--page-size", type=int, default=16)
    p.add_argument("--num-pages", type=int, default=512)
    p.add_argument("--max-seq-len", type=int, default=2048)
    p.add_argument("--decode-steps", type=int, default=8)
    p.add_argument("--attn-impls", default=",".join(ATTN_VARIANTS),
                   help="comma-separated forward paths: kernel, ref")
    p.add_argument("--kv-int8", action="store_true",
                   help="also sweep int8-quantized KV pools")
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)
    profile = run_hw_sweep(
        args.model, checkpoint=args.checkpoint,
        batches=[int(x) for x in args.batches.split(",")],
        prefill_chunks=[int(x) for x in args.prefill_chunks.split(",")],
        page_size=args.page_size, num_pages=args.num_pages,
        max_seq_len=args.max_seq_len, decode_steps=args.decode_steps,
        attn_impls=args.attn_impls.split(","),
        kv_quants=(None, "int8") if args.kv_int8 else (None,),
        iters=args.iters, device=args.device)
    save_profile(profile, args.out)
    fit = profile_fit(profile)
    print(json.dumps({"out": args.out, "best_variant": profile["best_variant"],
                      **{k: round(v, 6) for k, v in fit.items()}}))


if __name__ == "__main__":
    main()
