#!/usr/bin/env python3
"""Time the multi-LoRA delta alone on one card: one pass over every
target projection of every layer of a model, at its widths, bf16.

    python3 scripts/lora_delta_bench.py [--model llama-3.2-3b] [--rank 16]
        [--slots 3,15,31] [--rows 8] [--tokens 512] [--reps 3]

Two forms of the same delta x @ A[s] @ B[s], each token under its row's
slot s: the port's (models/lora.py `slot_mask` and `delta`: two products
over every slot, masked to each token's slot) and the reference's
per-row gathered form (dynamo_tpu/models/llama.py `lproj`: A and B
gathered on the slot axis, here `index_select`, then two `bmm`), on a
stacked tree of `--slots` adapters plus the base slot, rank `--rank`,
all seven targets. Shapes: `--rows` decode rows of
one token, and 4 prefill rows of `--tokens` / 4 tokens; the rows' slots
cycle over 0..slots. Each time is the device time of one pass, from
CUDA-graph replays between CUDA events (chip_smoke.graph_ms), the forms
alternated masked, gathered, gathered, masked over `--reps` rounds, min
and all. Also the largest difference between the two forms' outputs.
Prints one JSON line, then the card's name and power limit. Needs one
CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import graph_ms  # noqa: E402
from dynamo_tpu_torch.models import lora  # noqa: E402
from dynamo_tpu_torch.models.config import get_config  # noqa: E402

TARGETS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def one_pass(tree, L, xs, idx, form):
    """The delta of every target of every layer; returns the last."""
    layers = tree["layers"]
    n = next(iter(layers.values())).shape[1]
    mask = lora.slot_mask(idx.view(-1, 1), n, torch.bfloat16)
    out = None
    for l in range(L):
        for t in TARGETS:
            a, b = layers[t + "_a"][l], layers[t + "_b"][l]
            if form == "masked":
                out = lora.delta(xs[t], a, b, mask)
            else:
                out = torch.bmm(torch.bmm(xs[t], a.index_select(0, idx)),
                                b.index_select(0, idx))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", default="llama-3.2-3b")
    ap.add_argument("--rank", type=int, default=16)
    ap.add_argument("--slots", default="3,15,31")
    ap.add_argument("--rows", type=int, default=8)
    ap.add_argument("--tokens", type=int, default=512)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("lora_delta_bench needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    cfg = get_config(args.model)
    dims = lora._target_dims(cfg)
    gen = torch.Generator(device="cpu").manual_seed(0)
    results = []
    for slots in (int(s) for s in args.slots.split(",")):
        n = slots + 1
        tree = lora.init_lora_params(cfg, n, args.rank, TARGETS, torch.bfloat16, dev)
        for s in range(1, n):
            lora.set_adapter_slot(tree, s, lora.random_adapter(
                cfg, args.rank, TARGETS, seed=s, scale=0.25))
        for shape, (B, S) in (("decode", (args.rows, 1)),
                              ("prefill", (4, args.tokens // 4))):
            xs = {t: torch.randn(B, S, dims[t][0], generator=gen).to(dev, torch.bfloat16)
                  for t in TARGETS}
            idx = (torch.arange(B, device=dev) % n).to(torch.int32)
            ms = {"masked": [], "gathered": []}
            for _ in range(args.reps):
                for form in ("masked", "gathered", "gathered", "masked"):
                    ms[form].append(graph_ms(
                        lambda: one_pass(tree, cfg.n_layers, xs, idx, form),
                        iters=3, replays=3))
            diff = (one_pass(tree, cfg.n_layers, xs, idx, "masked").float()
                    - one_pass(tree, cfg.n_layers, xs, idx, "gathered").float())
            results.append({
                "slots": slots, "shape": shape, "rows": B, "tokens_a_row": S,
                "masked_ms_min": min(ms["masked"]), "gathered_ms_min": min(ms["gathered"]),
                "masked_ms": ms["masked"], "gathered_ms": ms["gathered"],
                "max_abs_diff": diff.abs().max().item(),
                "factors_mb": lora.lora_bytes(cfg, n, args.rank, TARGETS) / 1e6})
        del tree
        torch.cuda.empty_cache()
    print(json.dumps({"model": args.model, "rank": args.rank, "layers": cfg.n_layers,
                      "targets": list(TARGETS), "results": results}))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
