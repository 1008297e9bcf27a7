#!/usr/bin/env python3
"""What the D 96 int8 ragged bodies' register spills cost, on the card.

    python3 scripts/ragged_spill.py

ptxas gives the ragged kernel's D 96 bodies 168 registers a thread and
spills three int8 ones (ops/csrc/ragged_paged_attention.cu has only
`__launch_bounds__(128)`; 168 is ptxas's own choice, which lets three
128-thread blocks share an SM's registers). This builds the shipped source
(as the package does) and versions of it whose ragged kernel declares a
least number of resident blocks (`__launch_bounds__(128, N)`, N = 1, 2,
3: at most 255, 255 and 168 registers), one nvcc each, all started
together, and prints each version's ptxas registers and spills for the
D 96 and D 128 bodies. Then it drives the package's own
ragged_paged_attention with each library in turn at chip_smoke.py's
head_shape_kernels cases that the engines' ragged steps run: phi-3's
(Hk 32, G 1, D 96, window 2047) over bf16 and int8 pools, and
qwen2.5-7b's (Hk 4, G 7, D 128). Each output is compared with the shipped
library's (max abs difference), and each is timed as a CUDA-graph replay,
in turns, in order and then in reverse; both passes are printed, one
JSON line per version and pass, then the card's name and power limit.
Needs one CUDA device and nvcc.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from dynamo_tpu_torch.ops import _build  # noqa: E402
from dynamo_tpu_torch.ops.ragged_paged_attention import ragged_paged_attention  # noqa: E402

STEM = "ragged_paged_attention"
BOUNDS = "__launch_bounds__(kThreads)\nragged_kernel("
MIN_BLOCKS = (1, 2, 3)


def build():
    """{version: (bound library, {instantiation: registers and spills})}."""
    libs = {"shipped": (_build.load()[STEM],
                        cs.ptxas_entries(_build.build_log.get(STEM, "")))}
    src = (_build.CSRC / f"{STEM}.cu").read_text()
    if src.count(BOUNDS) != 1:
        raise RuntimeError(f"{STEM}.cu: the ragged kernel's launch bounds moved")
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n in MIN_BLOCKS:
        name = f"min_blocks_{n}"
        path = out_dir / f"{STEM}_{name}.cu"
        path.write_text(src.replace(
            BOUNDS, f"__launch_bounds__(kThreads, {n})\nragged_kernel("))
        out = out_dir / f"lib{STEM}_{name}.so"
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, f"-I{_build.CSRC}",
               "-o", str(out), str(path)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), out)
    for name, (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = (_build._bind(STEM, out), cs.ptxas_entries(log))
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("ragged_spill: no CUDA device available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    libs = build()
    for name, (_, ptxas) in libs.items():
        print(json.dumps({"version": name, "ptxas": {
            k: v for k, v in ptxas.items() if re.match(r"ragged_kernel<(96|128),", k)}}),
            flush=True)
    gen = torch.Generator(device="cpu").manual_seed(17)
    dgen = torch.Generator(device=dev).manual_seed(17)
    cases = {}
    for shape, kinds in (("phi3_G1_D96", ("bf16", "int8")), ("qwen2_G7_D128", ("bf16",))):
        (Hk, G, D), (contexts, window, _, _, q_mul) = cs.HEAD_SHAPES[shape]
        NP = 2 * len(contexts) * cs.GEMMA_MP + 1
        bf = tuple(torch.randn(NP, cs.PAGE_SIZE, Hk, D, generator=dgen,
                               device=dev).bfloat16() for _ in range(2))
        for kind in kinds:
            pools = bf if kind == "bf16" else tuple(cs.int8_pool(x)[0] for x in bf)
            inp = cs.gemma_case_inputs("ragged", contexts, Hk, G, D, q_mul, pools,
                                       gen, dgen, dev)
            cases[f"{shape}_{kind}"] = (inp["args"], window, inp["rows"])
    libs_now = _build.load()
    shipped = libs_now[STEM]
    outs = {}
    try:
        for name, (lib, _) in libs.items():
            libs_now[STEM] = lib
            outs[name] = {c: ragged_paged_attention(*a, w)[:n].float()
                          for c, (a, w, n) in cases.items()}
        order = list(libs)
        for p, names in enumerate((order, order[::-1])):
            for name in names:
                libs_now[STEM] = libs[name][0]
                rec = {"version": name, "pass": p}
                for c, (a, w, _) in cases.items():
                    rec[f"{c}_device_ms"] = cs.graph_ms(
                        lambda: ragged_paged_attention(*a, w))
                    rec[f"{c}_max_abs_diff"] = (
                        outs[name][c] - outs["shipped"][c]).abs().max().item()
                print(json.dumps(rec), flush=True)
    finally:
        libs_now[STEM] = shipped
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
