#!/usr/bin/env python3
"""Versions of the MLA kernel source, timed against each other on the card.

    python3 scripts/mla_prefill_variants.py [--source NAME=PATH ...]

Builds ops/csrc/mla_attention.cu (as the package does, `shipped`) and each
--source file beside it (one nvcc per source, all started together; a
source may include csrc/paged_flash.cuh) and drives the package's own
prefill_mla_attention and decode_mla_attention with each library in turn
in place of the shipped one. Each prefill is held against the plain
version (max abs err, padding rows exactly 0) at chip_smoke.py's timed
shape and its packed [4, 256] batch, and timed there as a CUDA-graph
replay, with the decode kernel at chip_smoke's decode batch over the bf16
latent and over its int8 quantization (int8_kernels' MLA row). The sources
are timed in turns, in order and then in reverse, and both passes are
printed. Prints each source's ptxas lines, one JSON line per source and
pass, then the card's name and power limit. Needs one CUDA device and nvcc.
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

STEM = "mla_attention"


def build(sources):
    """{name: bound library}: the shipped one from the package, the others
    one nvcc each, all started together."""
    libs = {"shipped": _build.load()[STEM]}
    print(json.dumps({"source": "shipped",
                      "ptxas": cs.ptxas_lines(_build.build_log.get(STEM, ""))}), flush=True)
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, path in sources.items():
        out = out_dir / f"lib{STEM}_{name}.so"
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, f"-I{_build.CSRC}",
               "-o", str(out), str(path)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), out)
    for name, (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        print(json.dumps({"source": name, "path": str(sources[name]),
                          "ptxas": cs.ptxas_lines(log)}), flush=True)
        libs[name] = _build._bind(STEM, out)
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
                    help="NAME=PATH of a version of mla_attention.cu")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("mla_prefill_variants: no CUDA device available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    libs = build({n: Path(p) for n, p in (s.split("=", 1) for s in args.source)})
    gen = torch.Generator(device="cpu").manual_seed(7)
    cases = {"timed": cs.mla_prefill_args(gen, cs.MLA_PS, cs.MLA_H, cs.MLA_TIMED_S,
                                          [cs.MLA_TIMED_SEG], dev),
             "packed": cs.mla_prefill_args(gen, *cs.MLA_PREFILL_CASES["packed"], dev)}
    dec = cs.mla_decode_args(gen, dev)
    dec8 = (dec[0], cs.int8_pool(dec[1])[0]) + tuple(dec[2:])
    dc = cs.MLA_DC
    scale = cs.attn_score_scale(cs.MLA_CONFIG, cs.MLA_CONFIG.qk_nope_head_dim + cs.MLA_DR)

    def prefill(pargs):
        return mla.prefill_mla_attention(*pargs, dc=dc, scale=scale)

    def decode(d=dec):
        return mla.decode_mla_attention(*d, dc=dc, scale=scale)

    errs = {}
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
            for dname, d in (("decode", dec), ("decode_int8", dec8)):
                q32 = (d[0].float(),) + tuple(d[1:])
                want = mla.decode_mla_attention_ref(*(q32 if d is dec8 else d), dc=dc,
                                                    scale=scale)
                errs[name][dname] = (decode(d).float() - want.float()).abs().max().item()
    order = list(libs)
    for p, names in enumerate((order, order[::-1])):
        for name in names:
            rec = {"source": name, "pass": p, "max_abs_err": errs[name]}
            with swapped(libs[name]):
                for cname, pargs in cases.items():
                    rec[f"{cname}_device_ms"] = cs.graph_ms(lambda: prefill(pargs))
                rec["decode_device_ms"] = cs.graph_ms(decode)
                rec["decode_int8_device_ms"] = cs.graph_ms(lambda: decode(dec8))
            print(json.dumps(rec), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
