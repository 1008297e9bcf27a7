#!/usr/bin/env python3
"""Versions of the chunked-prefill and ragged kernels' int8 bodies, timed
against each other on the card.

    python3 scripts/int8_body_variants.py [--source NAME=DIR ...] [--stages N ...]
        [--min-blocks P,R ...]

Builds ops/csrc/flash_prefill.cu and ops/csrc/ragged_paged_attention.cu as
the package does (`shipped`); each --source directory's copies of the two
(DIR holds a whole ops/csrc: the .cu files and the paged_flash.cuh they
include, e.g. an earlier commit's, unpacked with `git archive`); and, for
each --stages N, copies of the shipped sources whose int8 ring is N stages
deep at every head dim (`kCodeStages`, both kernels); and, for each
--min-blocks P,R, copies whose int8 prefill kernel (`prefill_codes_kernel`,
shipped with 1) and ragged kernel (shipped with none: ptxas's own choice
of 128-211 registers) declare at least P and R resident blocks
(`__launch_bounds__(threads, N)`: at most 65536 / (threads x N) registers
a thread). One nvcc a source, all started together; each version's
ptxas registers and spills are printed. Each
version's library is swapped in turn under the package's
prefill_paged_attention and ragged_paged_attention, and driven at the int8
and bf16 cases of chip_smoke.py's kernel rows: the 3B shape (Hk 8, G 3, D
128: a 450-token chunk over 700 prior tokens, and `kernels`' 264-token
ragged step), Gemma-2's (D 256, G 2, window 4096, cap 50, scale 1/16),
phi-3's (Hk 32, G 1, D 96, window 2047), qwen2.5-7b's G 7 and
llama-3.2-1b's D 64 (HEAD_SHAPES). Every output is held against the plain
version in f32 (max abs error and row error, chip_smoke's KERNEL_TOL and
ROW_REL_TOL; a version that misses either is reported, and the script
exits 1). Then each case is timed as a CUDA-graph replay, version by
version in turns, in order and then in reverse; both passes are printed
(one JSON line a version and pass), then the card's name and power limit.
Needs one CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from dynamo_tpu_torch.ops import _build  # noqa: E402
from dynamo_tpu_torch.ops.flash_prefill import prefill_paged_attention  # noqa: E402
from dynamo_tpu_torch.ops.ragged_paged_attention import (  # noqa: E402
    ragged_paged_attention, ragged_paged_attention_ref)

STEMS = ("flash_prefill", "ragged_paged_attention")
STAGES = re.compile(r"constexpr int kCodeStages = [^;]+;")
BOUNDS = {"flash_prefill": "__launch_bounds__(32 * kWarps, 1)\nprefill_codes_kernel(",
          "ragged_paged_attention": "__launch_bounds__(kThreads)\nragged_kernel("}
FNS = {"prefill": prefill_paged_attention, "ragged": ragged_paged_attention}


def build(sources, stages, min_blocks):
    """{version: {stem: bound library}}, printing each version's ptxas
    entries of the two kernels."""
    libs = _build.load()
    out = {"shipped": {s: libs[s] for s in STEMS}}
    logs = {"shipped": {s: _build.build_log.get(s, "") for s in STEMS}}
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, d in sources.items():
        for s in STEMS:
            jobs[(name, s)] = (Path(d) / f"{s}.cu", [f"-I{d}"])
    for n in stages:
        name = f"stages_{n}"
        for s in STEMS:
            src = (_build.CSRC / f"{s}.cu").read_text()
            if len(STAGES.findall(src)) != 1:
                raise RuntimeError(f"{s}.cu: kCodeStages moved")
            path = out_dir / f"{s}_{name}.cu"
            path.write_text(STAGES.sub(f"constexpr int kCodeStages = {n};", src))
            jobs[(name, s)] = (path, [f"-I{_build.CSRC}"])
    for pr in min_blocks:
        name = f"min_blocks_{pr.replace(',', '_')}"
        for s, n in zip(STEMS, pr.split(",")):
            src = (_build.CSRC / f"{s}.cu").read_text()
            if src.count(BOUNDS[s]) != 1:
                raise RuntimeError(f"{s}.cu: the kernel's launch bounds moved")
            path = out_dir / f"{s}_{name}.cu"
            path.write_text(src.replace(
                BOUNDS[s], re.sub(r"(\(kThreads|kWarps)(, \d+)?\)", rf"\1, {n})", BOUNDS[s])))
            jobs[(name, s)] = (path, [f"-I{_build.CSRC}"])
    procs = {}
    for (name, s), (path, inc) in jobs.items():
        lib = out_dir / f"lib{s}_{name}.so"
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, *inc, "-o", str(lib), str(path)]
        procs[(name, s)] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True), lib)
    for (name, s), (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name} {s}:\n{log}")
        out.setdefault(name, {})[s] = _build._bind(s, lib)
        logs.setdefault(name, {})[s] = log
    for name, by_stem in logs.items():
        print(json.dumps({"version": name, "ptxas": {
            k: v for s, log in by_stem.items()
            for k, v in cs.ptxas_entries(log).items() if "merge" not in k}}), flush=True)
    return out


def cases(dev):
    """{case: (kernel, args, window, kw, rows, plain)}: plain() is the f32
    plain version on the same operands."""
    gen = torch.Generator(device="cpu").manual_seed(12)
    dgen = torch.Generator(device=dev).manual_seed(12)
    out = {}

    def rnd(*shape):
        return torch.randn(*shape, generator=dgen, device=dev).bfloat16()

    # the 3B shape: int8_kernels' and kernels' prefill and ragged rows
    Hk, G, D, PS = 8, 3, 128, cs.PAGE_SIZE
    S, prior, q_len = 512, 700, 450
    kv = prior + q_len
    MP = -(-kv // PS) + 2
    bf = (rnd(MP + 1, PS, Hk, D), rnd(MP + 1, PS, Hk, D))
    q = rnd(1, S, Hk, G, D)
    pt = cs.random_pages(gen, 1, MP, MP + 1, dev)
    ints = [torch.tensor([x], dtype=torch.int32, device=dev) for x in (prior, q_len, kv)]
    for kind in ("bf16", "int8"):
        pools = bf if kind == "bf16" else tuple(cs.int8_pool(x)[0] for x in bf)
        p32 = tuple(x.float() for x in bf) if kind == "bf16" else pools
        out[f"3b_prefill_{kind}"] = (
            "prefill", (q, *pools, pt, *ints), 0, {}, [q_len],
            lambda p32=p32: cs.prefill_paged_attention_ref(q.float(), *p32, pt, *ints))
    segs = [(1, k - 1) for k in cs.RAGGED_DECODE_KV] + cs.RAGGED_CHUNKS
    args, _ = cs.ragged_inputs(gen, segs, cs.RAGGED_T, Hk, G, D, PS, 4096 // PS, dev)
    n = sum(q for q, _ in segs)
    for kind in ("bf16", "int8"):
        pools = tuple(args[1:3]) if kind == "bf16" else tuple(
            cs.int8_pool(x)[0] for x in args[1:3])
        p32 = tuple(x.float() for x in pools) if kind == "bf16" else pools
        a = (args[0], *pools) + tuple(args[3:])
        out[f"3b_ragged_{kind}"] = (
            "ragged", a, 0, {}, n,
            lambda a=a, p32=p32: ragged_paged_attention_ref(a[0].float(), *p32, *a[3:]))

    # gemma_kernels' Gemma-2 case and head_shape_kernels' shapes
    shapes = {"gemma2": (cs.GEMMA_SHAPES["D256_G2"], cs.GEMMA_CASES["gemma2"])}
    shapes.update({k: cs.HEAD_SHAPES[k] for k in
                   ("phi3_G1_D96", "qwen2_G7_D128", "llama1b_G4_D64")})
    for name, ((Hk, G, D), case) in shapes.items():
        contexts, window, softcap, scale, q_mul = case
        NP = 2 * len(contexts) * cs.GEMMA_MP + 1
        bf = tuple(torch.randn(NP, PS, Hk, D, generator=dgen, device=dev).bfloat16()
                   for _ in range(2))
        for kind in ("bf16", "int8"):
            pools = bf if kind == "bf16" else tuple(cs.int8_pool(x)[0] for x in bf)
            p32 = tuple(x.float() for x in bf) if kind == "bf16" else pools
            for kernel in ("prefill", "ragged"):
                inp = cs.gemma_case_inputs(kernel, contexts, Hk, G, D, q_mul, pools,
                                           gen, dgen, dev, lib_pools=bf)
                inp["kp32"], inp["vp32"] = p32
                out[f"{name}_{kernel}_{kind}"] = (
                    kernel, inp["args"], window, dict(scale=scale, softcap=softcap),
                    inp["rows"],
                    lambda k=kernel, i=inp, w=window, s=scale, c=softcap:
                        cs.gemma_plain_f32(k, i, w, s, c))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--source", action="append", default=[],
                    help="NAME=DIR: a directory holding a copy of ops/csrc")
    ap.add_argument("--stages", action="append", type=int, default=[])
    ap.add_argument("--min-blocks", action="append", default=[],
                    help="P,R: least resident blocks of the prefill and ragged kernels")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("int8_body_variants: no CUDA device available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    versions = build(dict(s.split("=", 1) for s in a.source), a.stages, a.min_blocks)
    todo = cases(dev)
    libs_now = _build.load()
    shipped = {s: libs_now[s] for s in STEMS}
    ok = True
    try:
        def use(name):
            for s in STEMS:
                libs_now[s] = versions[name][s]

        for case, (kernel, args, window, kw, rows, plain) in todo.items():
            want = plain()
            rec = {"case": case}
            for name in versions:
                use(name)
                got = FNS[kernel](*args, window, **kw)
                torch.cuda.synchronize()
                err, rel = cs.case_errors(kernel, got, want, rows)
                fine = (torch.isfinite(got.float()).all().item() and err <= cs.KERNEL_TOL
                        and rel <= cs.ROW_REL_TOL)
                ok &= fine
                rec[name] = {"max_abs_err": err, "row_rel_err": rel, "ok": fine}
            print(json.dumps(rec), flush=True)
            del want
            torch.cuda.empty_cache()
        order = list(versions)
        for p, names in enumerate((order, order[::-1])):
            for name in names:
                use(name)
                rec = {"version": name, "pass": p}
                for case, (kernel, args, window, kw, _, _) in todo.items():
                    rec[case] = cs.graph_ms(lambda: FNS[kernel](*args, window, **kw))
                print(json.dumps(rec), flush=True)
    finally:
        for s in STEMS:
            libs_now[s] = shipped[s]
    print(smi, flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
