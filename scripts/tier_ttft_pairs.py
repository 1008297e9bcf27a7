#!/usr/bin/env python3
"""A2's TTFT onboarded from the G2 host tier against A2's cold prefill,
in pairs whose first side alternates, on llama-3.2-3b at full depth with
random weights from chip_smoke's seed (chip_smoke.py `g2_pairs`: each
onboarded stream is held to the cold one, the onboard's launch
identities and page bytes are checked).

    python3 scripts/tier_ttft_pairs.py [--pairs 6]

Prints chip_smoke's per-case records, then one JSON line with every
pair, then the card's name and power limit. Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--pairs", type=int, default=6)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("tier_ttft_pairs: no CUDA device", file=sys.stderr)
        return 1
    cs._build.load()
    runner, _ = cs.build_runner(cs.parse_args(cs.TIER_ARGS))
    prompts = cs._tier_prompts(runner.config.vocab_size)
    try:
        pairs, cases, _, _ = cs.g2_pairs(runner, prompts, args.pairs)
    except cs.CheckFailed as e:
        print(f"tier_ttft_pairs: check failed: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"pairs": pairs,
                      "onboard_s": [c["onboard"]["seconds"] for c in cases],
                      "offload": [c["offload"] for c in cases]}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
