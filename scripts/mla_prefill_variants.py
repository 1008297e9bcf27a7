#!/usr/bin/env python3
"""Versions of the MLA kernel source, timed against each other on the card.

    python3 scripts/mla_prefill_variants.py [--source NAME=PATH[:S] ...]

Builds ops/csrc/mla_attention.cu (as the package does, `shipped`) and each
--source file beside it (one nvcc per source, all started together; a
source includes the paged_flash.cuh beside it, e.g. an earlier commit's
ops/csrc unpacked with `git archive`, or csrc's own) and drives the
package's own prefill_mla_attention and decode_mla_attention with each
library in turn in place of the shipped one. A source whose
decode_mla_attention takes no NP (before the int8 kernel's tensor maps) is
called without it; with :S its int8 decode launches run at split S (e.g.
the split that source was written for), on a scratch of their own. Each
prefill is held against the plain version (max abs err, padding rows
exactly 0) at chip_smoke.py's timed shape and its packed [4, 256] batch,
and timed there as a CUDA-graph replay, with the decode kernel at
chip_smoke's decode batch (11,008 tokens) and its engine-shaped batch
(MLA_ENGINE_KV), each over the bf16 latent and over its int8 quantization,
decode held row by row too (max abs err, row error: chip_smoke's
KERNEL_TOL and ROW_REL_TOL; a version that misses either is reported and
the script exits 1, as a copy with a phase cut out does). The sources are
timed in turns, in order and then in reverse, and both passes are printed.
Prints each source's ptxas lines, one JSON line per source and pass, then
the card's name and power limit. Needs one CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from dynamo_tpu_torch.ops import _build  # noqa: E402
from dynamo_tpu_torch.ops import mla_attention as mla  # noqa: E402
from dynamo_tpu_torch.ops.paged_attention import decode_split_count  # noqa: E402

STEM = "mla_attention"
# decode_mla_attention's C arguments: lat_scales (NULL for bf16), the split
# scratch, B, H, the page size, table width, the pool's pages (NP) and the
# split
SCALES_ARG, PART_ARG, B_ARG, H_ARG, PS_ARG, MP_ARG, NP_ARG, SPLIT_ARG = 2, 6, 7, 8, 11, 12, 13, 14


class VersionLib:
    """A version's library under the package's calls: without NP for a
    source that takes none; its int8 launches at `split` (None: the
    package's), on a scratch of their own (allocated at the first call of
    each size, outside graph capture: graph_ms calls once before it
    captures)."""

    def __init__(self, lib, old_abi: bool, split=None):
        self.lib, self.old_abi, self.split, self.scratch = lib, old_abi, split, {}
        if old_abi:
            argtypes, _ = _build.SIGNATURES[STEM]["decode_mla_attention"]
            lib.decode_mla_attention.argtypes = argtypes[:NP_ARG] + argtypes[NP_ARG + 1:]

    def decode_mla_attention(self, *args):
        args = list(args)
        if self.split is not None and args[SCALES_ARG] is not None:
            args[SPLIT_ARG] = self.split
            B, H, PS, MP = args[B_ARG], args[H_ARG], args[PS_ARG], args[MP_ARG]
            n = decode_split_count(MP, PS, self.split) * B * H * (mla.KERNEL_DIMS[0] + 4)
            if n not in self.scratch:
                self.scratch[n] = torch.empty(n, dtype=torch.float32, device="cuda")
            args[PART_ARG] = self.scratch[n].data_ptr()
        if self.old_abi:
            del args[NP_ARG]
        return self.lib.decode_mla_attention(*args)

    def __getattr__(self, name):
        return getattr(self.lib, name)


def build(sources):
    """{name: bound library}: the shipped one from the package, the others
    one nvcc each (including the headers beside their source), all started
    together."""
    libs = {"shipped": _build.load()[STEM]}
    print(json.dumps({"source": "shipped",
                      "ptxas": cs.ptxas_lines(_build.build_log.get(STEM, ""))}), flush=True)
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, spec in sources.items():
        path, _, split = spec.rpartition(":") if spec.rpartition(":")[2].isdigit() \
            else (spec, "", "")
        path = Path(path)
        out = out_dir / f"lib{STEM}_{name}.so"
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, f"-I{path.parent}",
               f"-I{_build.CSRC}", "-o", str(out), str(path)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), out, path,
                       int(split) if split else None)
    for name, (proc, out, path, split) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        print(json.dumps({"source": name, "path": str(path), "int8_split": split,
                          "ptxas": cs.ptxas_lines(log),
                          "wgmma_notes": [ln.strip() for ln in log.splitlines()
                                          if "wgmma" in ln]}), flush=True)
        old_abi = "int NP" not in path.read_text()
        libs[name] = VersionLib(_build._bind(STEM, out), old_abi, split)
    return libs


@contextlib.contextmanager
def swapped(lib):
    """The package's wrappers launch from `lib` inside the block."""
    libs = _build.load()
    shipped = libs[STEM]
    libs[STEM] = lib
    try:
        yield
    finally:
        libs[STEM] = shipped


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", action="append", default=[],
                    help="NAME=PATH[:S] of a version of mla_attention.cu[, its int8 "
                         "decode split]")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("mla_prefill_variants: no CUDA device available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    libs = build(dict(s.split("=", 1) for s in args.source))
    gen = torch.Generator(device="cpu").manual_seed(7)
    cases = {"timed": cs.mla_prefill_args(gen, cs.MLA_PS, cs.MLA_H, cs.MLA_TIMED_S,
                                          [cs.MLA_TIMED_SEG], dev),
             "packed": cs.mla_prefill_args(gen, *cs.MLA_PREFILL_CASES["packed"], dev)}
    decs = {}
    for dname, kv in (("decode", cs.MLA_DECODE_KV), ("decode_engine", cs.MLA_ENGINE_KV)):
        d = cs.mla_decode_args(gen, dev, kv)
        decs[dname] = d
        decs[dname + "_int8"] = (d[0], cs.int8_pool(d[1])[0]) + tuple(d[2:])
    dc = cs.MLA_DC
    scale = cs.attn_score_scale(cs.MLA_CONFIG, cs.MLA_CONFIG.qk_nope_head_dim + cs.MLA_DR)

    def prefill(pargs):
        return mla.prefill_mla_attention(*pargs, dc=dc, scale=scale)

    def decode(d):
        return mla.decode_mla_attention(*d, dc=dc, scale=scale)

    errs = {}
    ok = True
    for name, lib in libs.items():
        errs[name] = {}
        with swapped(lib):
            for cname, pargs in cases.items():
                got = prefill(pargs)
                want = mla.prefill_mla_attention_ref(*pargs, dc=dc, scale=scale)
                ql = pargs[4].tolist()
                errs[name][cname] = max(
                    (got[b, :n].float() - want[b, :n].float()).abs().max().item()
                    for b, n in enumerate(ql) if n > 0)
                errs[name][cname + "_padding_zero"] = all(
                    got[b, n:].float().abs().max().item() == 0.0
                    for b, n in enumerate(ql) if n < got.shape[1])
            for dname, d in decs.items():
                q32 = (d[0].float(),) + tuple(d[1:])
                want = mla.decode_mla_attention_ref(*q32, dc=dc, scale=scale)
                got = decode(d)
                err = (got.float() - want.float()).abs().max().item()
                rel = cs.row_rel_err(got, want)
                errs[name][dname] = {"max_abs_err": err, "row_rel_err": rel}
                ok &= err <= cs.KERNEL_TOL and rel <= cs.ROW_REL_TOL
    order = list(libs)
    for p, names in enumerate((order, order[::-1])):
        for name in names:
            rec = {"source": name, "pass": p, "max_abs_err": errs[name]}
            with swapped(libs[name]):
                for cname, pargs in cases.items():
                    rec[f"{cname}_device_ms"] = cs.graph_ms(lambda: prefill(pargs))
                for dname, d in decs.items():
                    rec[f"{dname}_device_ms"] = cs.graph_ms(lambda d=d: decode(d))
            print(json.dumps(rec), flush=True)
    print(smi, flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
