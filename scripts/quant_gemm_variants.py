#!/usr/bin/env python3
"""Versions of the weight-only GEMM's tile configurations, timed against
each other on the card.

    python3 scripts/quant_gemm_variants.py [--set NAME=ARGS;NAME=ARGS ...]
        [--m M ...] [--nk]

Builds ops/csrc/quant_gemm.cu as it is (`shipped`) and, for each --set, a
copy in which each named configuration (`using NAME = Tile<ARGS>;`:
Small, SmallWide, Mid, MidWide or Large; ARGS are the template's m16
tiles a warp, warps along M, N and K, ring stages and stage depth) takes
the given arguments, e.g. --set "Small=1,1,1,4,5,256". One nvcc a
version, all started together; each version's ptxas registers and
spills are printed.

Every version runs llama-3.1-8b's matrices (wq, wk, w_gate, w_down,
lm_head; KN int8, or with --nk the same shapes as NK tables) at each M
(default 8 and 64), held against the plain version (max abs error within
chip_smoke's KERNEL_TOL at x RMS 0.25; a miss exits 1), and timed as
CUDA-graph replays that cycle through copies of the weight (200 MB of
codes in all, four times the L2), so that each call finds its weight in
device memory as a decode step does; versions in order, then in reverse,
the lesser time kept; beside cuBLAS on the dequantized bf16 weight and
the byte bound. One JSON line a matrix and M; the card's name and power
limit close the output. Needs one CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from dynamo_tpu_torch.models.quant import quantize_embed, quantize_weight  # noqa: E402
from dynamo_tpu_torch.ops import _build  # noqa: E402
from dynamo_tpu_torch.ops import quant_gemm as qg  # noqa: E402

SHAPES = {"wq": (4096, 4096), "wk": (4096, 1024), "w_gate": (4096, 14336),
          "w_down": (14336, 4096), "lm_head": (4096, 128256)}
COPY_BYTES = 200 << 20


def variant_source(src: str, sets: str) -> str:
    for item in filter(None, sets.split(";")):
        name, args = item.split("=")
        pat = re.compile(rf"using {name} = Tile<[^>]*>;")
        if not pat.search(src):
            raise SystemExit(f"no configuration {name} in quant_gemm.cu")
        src = pat.sub(f"using {name} = Tile<{args}>;", src)
    return src


def build(versions):
    out_dir = _build.BUILD_DIR / "quant_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "quant_gemm.cu").read_text()
    procs = {}
    for name, sets in versions.items():
        cu = out_dir / f"{name}.cu"
        cu.write_text(variant_source(src, sets))
        so = out_dir / f"lib{name}.so"
        procs[name] = (subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(so),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{log[-3000:]}")
        print(json.dumps({"version": name, "set": versions[name],
                          "ptxas": cs.ptxas_entries(log)}), flush=True)
        lib = ctypes.CDLL(str(so))
        lib.quant_gemm.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.quant_gemm.restype = ctypes.c_int
        libs[name] = lib
    return libs


def rotated_ms(calls, reps: int = 3) -> float:
    """Device ms of one call, the calls cycled (each on its own weight
    copy) in one CUDA graph, replayed."""
    for c in calls:
        c()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    n = max(len(calls), 16)
    with torch.cuda.stream(side):
        with torch.cuda.graph(graph, stream=side):
            for j in range(n):
                calls[j % len(calls)]()
    torch.cuda.synchronize()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (reps * n)
    del graph
    return ms


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--set", action="append", default=[],
                   help="NAME=ARGS;NAME=ARGS: one version's configurations")
    p.add_argument("--m", type=int, action="append", default=None)
    p.add_argument("--nk", action="store_true", help="the NK layout (tied tables)")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("quant_gemm_variants: no CUDA device", file=sys.stderr)
        return 1
    versions = {"shipped": ""}
    versions.update({f"v{i}": s for i, s in enumerate(args.set)})
    libs = build(versions)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    ok = True
    for what, (K, N) in SHAPES.items():
        copies = max(1, -(-COPY_BYTES // (K * N)))
        ws = []
        for _ in range(copies):
            w = (torch.randn(N, K, generator=gen, device=dev) * K ** -0.5).bfloat16()
            ws.append(quantize_embed(w, "int8") if args.nk
                      else quantize_weight(w.T.contiguous(), "int8"))
        for M in args.m or (8, 64):
            x = (torch.randn(M, K, generator=gen, device=dev) * cs.MOE_X_RMS).bfloat16()
            b_ms, b_by = cs.bound(K * N + 4 * N + 2 * M * K + 2 * M * N, 2 * M * K * N)
            rec = {"matrix": what, "K": K, "N": N, "M": M, "layout": "nk" if args.nk else "kn",
                   "copies": copies, "bound_ms": b_ms, "bound_by": b_by, "device_ms": {}}
            want = qg.quant_matmul_ref(x, ws[0]["q"], ws[0]["s"], args.nk)
            for order in (list(libs), list(libs)[::-1]):
                for name in order:
                    lib = libs[name]
                    ys = [torch.empty(M, N, dtype=torch.bfloat16, device=dev) for _ in ws]

                    def one(w, y, lib=lib):
                        def call():
                            rc = lib.quant_gemm(x.data_ptr(), w["q"].data_ptr(),
                                                w["s"].data_ptr(), y.data_ptr(), M, N, K,
                                                int(args.nk), 0,
                                                torch.cuda.current_stream().cuda_stream)
                            if rc:
                                raise RuntimeError(f"{name}: CUDA error {rc}")
                        return call

                    calls = [one(w, y) for w, y in zip(ws, ys)]
                    calls[0]()
                    torch.cuda.synchronize()
                    err = (ys[0].float() - want.float()).abs().max().item()
                    if err > cs.KERNEL_TOL:
                        print(json.dumps({"version": name, "matrix": what, "M": M,
                                          "max_abs_err": err, "ok": False}), flush=True)
                        ok = False
                    t = rotated_ms(calls)
                    rec["device_ms"][name] = min(rec["device_ms"].get(name, t), t)
            dq = [(w["q"].float() * w["s"]).T.bfloat16().contiguous() if args.nk
                  else (w["q"].float() * w["s"]).bfloat16() for w in ws[:max(1, copies // 2)]]
            rec["cublas_bf16_device_ms"] = rotated_ms(
                [(lambda wb=wb: torch.matmul(x, wb)) for wb in dq])
            del dq
            print(json.dumps(rec), flush=True)
        del ws
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
