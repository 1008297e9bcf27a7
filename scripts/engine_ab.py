#!/usr/bin/env python3
"""chip_smoke's `engine_fused` phase from two or more checkouts on one
card, in turns, for an A/B of the in-process engine's TTFT and decode
rate.

    python3 scripts/engine_ab.py --source parent=build/parent \
        [--order parent,here,here,parent] [--reps 2]

Each turn is a process of its own, run from that checkout (`here` is this
one): it loads the checkout's kernels, builds llama-3.2-3b with
chip_smoke's ENGINE_ARGS and serves chip_smoke's 8-request workload
`--reps` times on one runner, each with chip_smoke's checks. Kernel
libraries this checkout built are copied into another checkout's build
directory first when the names match (a name is the hash of its source),
so an unchanged kernel is not built twice. Prints one JSON line a turn
(TTFT min / median / max, the median per-request decode rate, overall
output tokens/s, wall), then the card's name and power limit. Needs one
CUDA device; exits 1 when a turn fails.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
KEYS = ("ttft_s_min", "ttft_s_median", "ttft_s_max",
        "decode_tok_s_per_request_median", "output_tok_s_overall", "wall_s")

TURN = """
import json, sys
import chip_smoke as cs
from dynamo_tpu_torch.ops import _build
_build.load()
runner = cs.build_runner(cs.parse_args(cs.ENGINE_ARGS))[0]
for _ in range({reps}):
    rec = cs.engine_phase(runner, "fused")[0]
    print("TURN " + json.dumps({{k: rec[k] for k in {keys!r}}}), flush=True)
"""


def share_builds(src: Path) -> None:
    """Copy this checkout's built kernel libraries into `src`'s build
    directory where `src` has none of that name."""
    here_build = HERE / "build" / "dynamo_tpu_torch"
    dst = src / "build" / "dynamo_tpu_torch"
    dst.mkdir(parents=True, exist_ok=True)
    for lib in here_build.glob("lib*.so"):
        if not (dst / lib.name).exists():
            shutil.copy2(lib, dst / lib.name)


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--source", action="append", default=[], metavar="NAME=DIR",
                   help="another checkout to run (e.g. the parent's git archive)")
    p.add_argument("--order", default=None,
                   help="comma-separated turn names (default: each source, "
                        "here, here, each source)")
    p.add_argument("--reps", type=int, default=2)
    args = p.parse_args()
    sources = {"here": HERE}
    for s in args.source:
        name, _, path = s.partition("=")
        sources[name] = Path(path).resolve()
    others = [n for n in sources if n != "here"]
    order = (args.order.split(",") if args.order
             else others + ["here", "here"] + others[::-1])
    # build this checkout's kernels once, then lend them to the others
    subprocess.run([sys.executable, "-c",
                    "from dynamo_tpu_torch.ops import _build; _build.load()"],
                   cwd=HERE, check=True)
    for name in others:
        share_builds(sources[name])
    failed = False
    for i, name in enumerate(order):
        code = TURN.format(reps=args.reps, keys=KEYS)
        out = subprocess.run([sys.executable, "-c", code], cwd=sources[name],
                             env=dict(os.environ, PYTHONPATH=str(sources[name])),
                             capture_output=True, text=True)
        recs = [json.loads(ln[5:]) for ln in out.stdout.splitlines()
                if ln.startswith("TURN ")]
        print(json.dumps({"turn": i, "source": name, "rc": out.returncode,
                          "runs": recs}), flush=True)
        if out.returncode != 0:
            failed = True
            print(out.stderr[-3000:], file=sys.stderr)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout else "nvidia-smi: none")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
