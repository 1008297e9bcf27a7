#!/usr/bin/env python3
"""Versions of the GQA kernels' int8 bodies (decode, chunked prefill,
ragged), timed against each other and beside their bf16 bodies on the
card.

    python3 scripts/int8_body_variants.py [--source NAME=DIR[:S] ...] [--stages N ...]
        [--min-blocks P,R ...] [--decode-config W[:S] ...] [--kernels decode,prefill,ragged]

Builds ops/csrc/paged_attention.cu, flash_prefill.cu and
ragged_paged_attention.cu as the package does (`shipped`); each --source
directory's copies of them (DIR holds a whole ops/csrc: the .cu files and
the paged_flash.cuh they include, e.g. an earlier commit's, unpacked with
`git archive`; with :S its int8 decode launches run at split S, e.g. the
split that source was written for); for each --stages N, copies of the
shipped prefill and ragged sources whose int8 ring is N stages deep at
every head dim (`kCodeStages`); for each --min-blocks P,R, copies whose
int8 prefill kernel (`prefill_codes_kernel`, shipped with 1) and ragged
kernel (shipped with none: ptxas's own choice of 128-211 registers)
declare at least P and R resident blocks (`__launch_bounds__(threads,
N)`: at most 65536 / (threads x N) registers a thread); for each
--decode-config, a copy of the shipped decode source whose int8 kernel
(`decode_codes_kernel`) has W warps a block (`code_warps`) at every head
dim, its int8 launches at split S (tokens, a multiple of 64) when given.
One nvcc a source, all started together; each version's ptxas registers
and spills are printed. Each version's libraries are swapped in turn
under the package's decode_paged_attention, prefill_paged_attention and
ragged_paged_attention (a version that does not rebuild a source runs the
shipped one), and driven at the int8 and bf16 cases of chip_smoke.py's
kernel rows: the 3B shape (Hk 8, G 3, D 128: `kernels`' and
int8_kernels' eight decode rows up to 4096 tokens, a 450-token chunk
over 700 prior tokens, and `kernels`' 264-token ragged step), Gemma-2's
(D 256, G 2, window 4096, cap 50, scale 1/16), phi-3's (Hk 32, G 1, D
96, window 2047), qwen2.5-7b's G 7 and llama-3.2-1b's D 64
(HEAD_SHAPES); --kernels keeps only the named kernels' cases. Every
output is held against the plain version in f32 (max abs error and row
error, chip_smoke's KERNEL_TOL and ROW_REL_TOL; a version that misses
either is reported, and the script exits 1). Then each case is timed as
a CUDA-graph replay, version by version in turns, in order and then in
reverse; both passes are printed (one JSON line a version and pass),
then the card's name and power limit. Needs one CUDA device and nvcc.
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
from dynamo_tpu_torch.ops import paged_attention as pa  # noqa: E402
from dynamo_tpu_torch.ops.flash_prefill import prefill_paged_attention  # noqa: E402
from dynamo_tpu_torch.ops.ragged_paged_attention import (  # noqa: E402
    ragged_paged_attention, ragged_paged_attention_ref)

STEM = {"decode": "paged_attention", "prefill": "flash_prefill",
        "ragged": "ragged_paged_attention"}
STEMS = tuple(STEM.values())
STAGES = re.compile(r"constexpr int kCodeStages = [^;]+;")
BOUNDS = {"flash_prefill": "__launch_bounds__(32 * kWarps, 1)\nprefill_codes_kernel(",
          "ragged_paged_attention": "__launch_bounds__(kThreads)\nragged_kernel("}
WARPS = re.compile(r"constexpr int code_warps\(\) \{ return [^;]+; \}")
FNS = {"decode": pa.decode_paged_attention, "prefill": prefill_paged_attention,
       "ragged": ragged_paged_attention}
# decode_paged_attention's C arguments: k_scales (NULL for bf16), the
# split scratch, the pool's pages (NP) and the split
K_SCALES_ARG, PART_ARG, NP_ARG, SPLIT_ARG = 2, 8, 15, 16


class OldAbiLib:
    """A paged_attention library from a source whose decode_paged_attention
    takes no NP (before its int8 kernel's page boxes): called with the
    package's arguments less NP."""

    def __init__(self, lib):
        self.lib = lib
        argtypes, _ = _build.SIGNATURES["paged_attention"]["decode_paged_attention"]
        lib.decode_paged_attention.argtypes = argtypes[:NP_ARG] + argtypes[NP_ARG + 1:]

    def decode_paged_attention(self, *args):
        return self.lib.decode_paged_attention(*args[:NP_ARG], *args[NP_ARG + 1:])

    def __getattr__(self, name):
        return getattr(self.lib, name)


class SplitLib:
    """A paged_attention library with the int8 launches' split set to
    `split`, on a split scratch of its own (allocated at the first call of
    each size, outside graph capture: graph_ms calls once before it
    captures)."""

    def __init__(self, lib, split: int):
        if split % 64:
            raise ValueError(f"split {split}: not a multiple of 64")
        self.lib, self.split, self.scratch = lib, split, {}

    def decode_paged_attention(self, *args):
        args = list(args)
        if args[K_SCALES_ARG] is not None:
            args[SPLIT_ARG] = self.split
            B, Hk, G, D, PS, MP = args[9:NP_ARG]
            n = pa.decode_split_count(MP, PS, self.split) * B * Hk * G * (D + 4)
            if n not in self.scratch:
                self.scratch[n] = torch.empty(n, dtype=torch.float32, device="cuda")
            args[PART_ARG] = self.scratch[n].data_ptr()
        return self.lib.decode_paged_attention(*args)

    def __getattr__(self, name):
        return getattr(self.lib, name)


def variant_source(stem: str, pattern, text: str) -> str:
    """The shipped source of `stem` with its one match of `pattern`
    replaced by `text`."""
    src = (_build.CSRC / f"{stem}.cu").read_text()
    if len(pattern.findall(src)) != 1:
        raise RuntimeError(f"{stem}.cu: {pattern.pattern} moved")
    return pattern.sub(lambda _: text, src)


def build(sources, stages, min_blocks, configs, stems):
    """{version: {stem: bound library}} (stems a version does not rebuild:
    the shipped ones), printing each version's ptxas entries of the
    kernels."""
    libs = _build.load()
    shipped = {s: libs[s] for s in STEMS}
    out = {"shipped": dict(shipped)}
    logs = {"shipped": {s: _build.build_log.get(s, "") for s in stems}}
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}  # (version, stem): (source path, include flags)

    def copy(name, stem, text):
        path = out_dir / f"{stem}_{name}.cu"
        path.write_text(text)
        jobs[(name, stem)] = (path, [f"-I{_build.CSRC}"])

    config_split = {}
    for name, spec in sources.items():
        d, _, split = spec.partition(":")
        for s in stems:
            jobs[(name, s)] = (Path(d) / f"{s}.cu", [f"-I{d}"])
        if split:
            config_split[name] = int(split)
    for n in stages:
        for s in set(stems) & set(BOUNDS):
            copy(f"stages_{n}", s, variant_source(
                s, STAGES, f"constexpr int kCodeStages = {n};"))
    for pr in min_blocks:
        for s, n in zip(BOUNDS, pr.split(",")):
            if s in stems:
                copy(f"min_blocks_{pr.replace(',', '_')}", s, variant_source(
                    s, re.compile(re.escape(BOUNDS[s])),
                    re.sub(r"(\(kThreads|kWarps)(, \d+)?\)", rf"\1, {n})", BOUNDS[s])))
    for spec in configs:
        cfg, _, split = spec.partition(":")
        name = f"w{cfg}" + (f"_s{split}" if split else "")
        src = variant_source("paged_attention", WARPS,
                             f"constexpr int code_warps() {{ return {int(cfg)}; }}")
        copy(name, "paged_attention", src)
        if split:
            config_split[name] = int(split)
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
        bound = _build._bind(s, lib)
        if s == "paged_attention" and "int NP" not in jobs[(name, s)][0].read_text():
            bound = OldAbiLib(bound)
        if name in config_split and s == "paged_attention":
            bound = SplitLib(bound, config_split[name])
        out.setdefault(name, dict(shipped))[s] = bound
        logs.setdefault(name, {})[s] = log
    for name, by_stem in logs.items():
        print(json.dumps({"version": name, "ptxas": {
            k: v for s, log in by_stem.items()
            for k, v in cs.ptxas_entries(log).items() if "merge" not in k}}), flush=True)
    return out


def cases(dev, kernels):
    """{case: (kernel, args, window, kw, rows, plain)} of the kernels named
    in `kernels`: plain() is the f32 plain version on the same operands."""
    gen = torch.Generator(device="cpu").manual_seed(12)
    dgen = torch.Generator(device=dev).manual_seed(12)
    out = {}

    def rnd(*shape):
        return torch.randn(*shape, generator=dgen, device=dev).bfloat16()

    # the 3B shape: int8_kernels' and kernels' decode, prefill and ragged rows
    Hk, G, D, PS = 8, 3, 128, cs.PAGE_SIZE
    kv_list = [4096, 0, 1, 17, 1000, 2048, 3333, 513]
    B, MP = len(kv_list), 4096 // PS
    bf = (rnd(B * MP + 1, PS, Hk, D), rnd(B * MP + 1, PS, Hk, D))
    q = rnd(B, Hk, G, D)
    pt = cs.random_pages(gen, B, MP, B * MP + 1, dev)
    kvl = torch.tensor(kv_list, dtype=torch.int32, device=dev)
    for kind in ("bf16", "int8"):
        pools = bf if kind == "bf16" else tuple(cs.int8_pool(x)[0] for x in bf)
        p32 = tuple(x.float() for x in bf) if kind == "bf16" else pools
        out[f"3b_decode_{kind}"] = (
            "decode", (q, *pools, pt, kvl), 0, {}, B,
            lambda p32=p32, q=q, pt=pt: cs.decode_paged_attention_ref(
                q.float(), *p32, pt, kvl))
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
            for kernel in ("decode", "prefill", "ragged"):
                inp = cs.gemma_case_inputs(kernel, contexts, Hk, G, D, q_mul, pools,
                                           gen, dgen, dev, lib_pools=bf)
                inp["kp32"], inp["vp32"] = p32
                out[f"{name}_{kernel}_{kind}"] = (
                    kernel, inp["args"], window, dict(scale=scale, softcap=softcap),
                    inp["rows"],
                    lambda k=kernel, i=inp, w=window, s=scale, c=softcap:
                        cs.gemma_plain_f32(k, i, w, s, c))
    return {k: v for k, v in out.items() if v[0] in kernels}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--source", action="append", default=[],
                    help="NAME=DIR[:S]: a directory holding a copy of ops/csrc[, its "
                         "int8 decode split]")
    ap.add_argument("--stages", action="append", type=int, default=[])
    ap.add_argument("--min-blocks", action="append", default=[],
                    help="P,R: least resident blocks of the prefill and ragged kernels")
    ap.add_argument("--decode-config", action="append", default=[],
                    help="W[:S]: int8 decode warps a block at every D[, split]")
    ap.add_argument("--kernels", default="decode,prefill,ragged",
                    help="the kernels whose cases run, comma-separated")
    a = ap.parse_args()
    kernels = a.kernels.split(",")
    if not set(kernels) <= set(STEM):
        ap.error(f"--kernels: {a.kernels}")
    if not torch.cuda.is_available():
        print("int8_body_variants: no CUDA device available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    versions = build(dict(s.split("=", 1) for s in a.source), a.stages, a.min_blocks,
                     a.decode_config,
                     [STEM[k] for k in kernels])
    todo = cases(dev, kernels)
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
