#!/usr/bin/env python3
"""Probe which collectives two tensor-parallel ranks can use when they share
one CUDA device.

    python scripts/tp_transport_probe.py [--ranks 2]

Each trial runs in fresh rank processes (torch.multiprocessing, spawn), all
on cuda:0, with a file rendezvous and a time limit; a trial that hangs is
killed and reported as such. Trials: NCCL's all_reduce (NCCL is expected to
refuse two ranks on one device), then gloo's all_reduce and all_gather on
CUDA and CPU tensors in float32 and bfloat16. Prints one JSON line a trial
and a summary line; needs a card.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import sys
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

TRIALS = (
    ("nccl", "all_reduce", "cuda", torch.float32),
    ("gloo", "all_reduce", "cuda", torch.float32),
    ("gloo", "all_reduce", "cuda", torch.bfloat16),
    ("gloo", "all_gather", "cuda", torch.float32),
    ("gloo", "all_gather", "cuda", torch.bfloat16),
    ("gloo", "all_reduce", "cpu", torch.bfloat16),
    ("gloo", "all_gather", "cpu", torch.bfloat16),
)


def _rank(rank: int, world: int, init: str, trial, out: str) -> None:
    backend, op, where, dtype = trial
    res = {"rank": rank}
    try:
        torch.cuda.set_device(0)
        dist.init_process_group(backend, init_method=init, rank=rank,
                                world_size=world,
                                timeout=datetime.timedelta(seconds=60))
        dev = torch.device("cuda", 0) if where == "cuda" else torch.device("cpu")
        x = torch.full((8, 4096), float(rank + 1), dtype=dtype, device=dev)
        t0 = time.monotonic()
        for _ in range(10):
            if op == "all_reduce":
                y = x.clone()
                dist.all_reduce(y)
                want = float(world * (world + 1) // 2)
                ok = bool((y.float() == want).all())
            else:
                parts = [torch.empty_like(x) for _ in range(world)]
                dist.all_gather(parts, x)
                ok = all(bool((p.float() == i + 1).all()) for i, p in enumerate(parts))
        if where == "cuda":
            torch.cuda.synchronize()
        res.update(ok=ok, ms_per_op=(time.monotonic() - t0) * 100.0)
        dist.destroy_process_group()
    except Exception as e:  # the probe's finding, reported as data
        res.update(ok=False, error=f"{type(e).__name__}: {e}"[:600])
    with open(f"{out}.{rank}", "w") as f:
        json.dump(res, f)


def run_trial(trial, world: int, limit_s: float) -> dict:
    d = tempfile.mkdtemp(prefix="tp_probe_")
    init = "file://" + os.path.join(d, "rdzv")
    out = os.path.join(d, "res")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank, args=(r, world, init, trial, out))
             for r in range(world)]
    for p in procs:
        p.start()
    end = time.monotonic() + limit_s
    for p in procs:
        p.join(max(0.0, end - time.monotonic()))
    hung = [p.pid for p in procs if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    ranks = []
    for r in range(world):
        try:
            with open(f"{out}.{r}") as f:
                ranks.append(json.load(f))
        except OSError:
            ranks.append({"rank": r, "ok": False, "exitcode": procs[r].exitcode})
    backend, op, where, dtype = trial
    return {"backend": backend, "op": op, "tensor": where,
            "dtype": str(dtype).replace("torch.", ""), "hung": bool(hung),
            "ok": all(x.get("ok") for x in ranks) and not hung, "ranks": ranks}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--limit-s", type=float, default=90.0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("tp_transport_probe: no CUDA device", file=sys.stderr)
        return 1
    summary = {}
    for trial in TRIALS:
        rec = run_trial(trial, args.ranks, args.limit_s)
        print(json.dumps(rec), flush=True)
        summary[f"{rec['backend']}:{rec['op']}:{rec['tensor']}:{rec['dtype']}"] = rec["ok"]
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "ranks_on_one_device": args.ranks, "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
