#!/usr/bin/env python3
"""Versions of the MoE grouped GEMM, timed against each other on the card.

    python3 scripts/moe_gemm_variants.py [--source NAME=DIR ...]
        [--set NAME=VALUE[,NAME=VALUE...] ...]

Builds ops/csrc/moe_grouped_gemm.cu as the package does (`shipped`); each
--source directory's copy (DIR holds a whole ops/csrc: the .cu file and
the paged_flash.cuh it includes, e.g. an earlier commit's, unpacked with
`git archive`); and, for each --set, a copy of the shipped source with
those of its constants changed (TUNABLE: the ring depths `kStagesGated`,
`kStagesDown`, `kSmallStagesGated` and `kSmallStagesDown`; `kSmallPairs`
and `kSmallItems`, which launches take the 64 x 64 configuration; and
`kBoxRows`, the rows above which a contiguous A tile comes by TMA boxes;
e.g. --set kSmallPairs=0 for the 128 x 128 configuration at every size).
One nvcc
a version, all started together; each version's
ptxas registers and spills are printed. A library that exports
`moe_tile_rows` takes the shipped C interface and tiles of that many
rows, and is swapped in under the package's moe_gate_up / moe_down; one
that does not is the earlier mma.sync kernel (64-row tiles, no row count
or expert count in its arguments) and is called through that interface,
with a tile map routed at 64 rows.

Every version runs chip_smoke.py's `moe_kernels` cases: each model of
MOE_SHAPES (qwen3-30b-a3b's and DeepSeek-V3's expert shapes, random bf16
weights at the init's scale) at each of its T under each routing of
MOE_ROUTINGS, x at RMS MOE_X_RMS. Each output is held against the plain
version in f32 (chip_smoke's gate_up_plain32 / down_plain32; down on the
same bf16 h for every version): max abs error within KERNEL_TOL and the
row error within ROW_REL_TOL (gate/up in the row-max form, down in the
RMS form, as chip_smoke gates them). A version that misses either is
reported and the script exits 1. Then each case is timed as a CUDA-graph
replay, version by version, in order and then in reverse, beside
torch._grouped_mm over the same sorted rows (down: one call; gate/up: two,
with no SwiGLU) and the byte bound; one JSON line a version, pass and
model. The card's name and power limit close the output. Needs one CUDA
device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from dynamo_tpu_torch.ops import _build  # noqa: E402
from dynamo_tpu_torch.ops import moe_dispatch as md  # noqa: E402

STEM = "moe_grouped_gemm"
TUNABLE = ("kStagesGated", "kStagesDown", "kSmallStagesGated", "kSmallStagesDown",
           "kSmallPairs", "kSmallItems", "kBoxRows")
_P, _I = ctypes.c_void_p, ctypes.c_int
# the earlier kernel's C interface: x, tok, w_gate, w_up, tiles, h,
# n_tiles, K, N, stream; h, w_down, tiles, y, n_tiles, K, N, stream
OLD_SIGNATURES = {"moe_gate_up": ([_P] * 6 + [_I] * 3 + [_P], _I),
                  "moe_down": ([_P] * 4 + [_I] * 3 + [_P], _I)}
OLD_TILE_ROWS = 64


class Version:
    """One build of the grouped GEMM and how to call it."""

    def __init__(self, name: str, path: Path, log: str):
        self.name, self.log = name, log
        lib = ctypes.CDLL(str(path))
        self.shipped_abi = hasattr(lib, "moe_tile_rows")
        if self.shipped_abi:
            self.lib = _build._bind(STEM, path)
            self.tile_rows = self.lib.moe_tile_rows()
        else:
            for fn, (argtypes, restype) in OLD_SIGNATURES.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            lib.kernel_error_string.argtypes = [_I]
            lib.kernel_error_string.restype = ctypes.c_char_p
            self.lib, self.tile_rows = lib, OLD_TILE_ROWS

    def route(self, sel, n):
        """The tile map at this version's tile size."""
        saved = md.MOE_BM
        md.MOE_BM = self.tile_rows
        try:
            return md.route(sel, n)
        finally:
            md.MOE_BM = saved

    def use(self):
        if self.shipped_abi:
            _build.load()[STEM] = self.lib

    def gate_up(self, x, tok, wg, wu, tiles):
        if self.shipped_abi:
            return md.moe_gate_up(x, tok, wg, wu, tiles)
        h = torch.empty((tok.shape[0], wg.shape[-1]), dtype=x.dtype, device=x.device)
        rc = self.lib.moe_gate_up(x.data_ptr(), tok.data_ptr(), wg.data_ptr(),
                                  wu.data_ptr(), tiles.data_ptr(), h.data_ptr(),
                                  tiles.shape[0], wg.shape[1], wg.shape[2],
                                  torch.cuda.current_stream().cuda_stream)
        _build.check(self.lib, rc, f"{self.name} moe_gate_up")
        return h

    def down(self, h, wd, tiles):
        if self.shipped_abi:
            return md.moe_down(h, wd, tiles)
        y = torch.empty((h.shape[0], wd.shape[-1]), dtype=h.dtype, device=h.device)
        rc = self.lib.moe_down(h.data_ptr(), wd.data_ptr(), tiles.data_ptr(),
                               y.data_ptr(), tiles.shape[0], wd.shape[1], wd.shape[2],
                               torch.cuda.current_stream().cuda_stream)
        _build.check(self.lib, rc, f"{self.name} moe_down")
        return y


def build(sources, settings):
    """{name: Version}: the shipped build first, then the others, each
    compiled by its own nvcc, all at once."""
    libs = _build.load()
    out = {"shipped": Version("shipped", _build.library_path(STEM),
                              _build.build_log.get(STEM, ""))}
    _build.load()[STEM] = libs[STEM]
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {name: (Path(d) / f"{STEM}.cu", [f"-I{d}"]) for name, d in sources.items()}
    for setting in settings:
        src = (_build.CSRC / f"{STEM}.cu").read_text()
        for kv in setting.split(","):
            key, value = kv.split("=")
            pat = re.compile(rf"constexpr int {key} = \d+;")
            if key not in TUNABLE or len(pat.findall(src)) != 1:
                raise RuntimeError(f"{STEM}.cu: no one constant {key} to set")
            src = pat.sub(f"constexpr int {key} = {int(value)};", src)
        name = setting.replace("=", "").replace(",", "_")
        path = out_dir / f"{STEM}_{name}.cu"
        path.write_text(src)
        jobs[name] = (path, [f"-I{_build.CSRC}"])
    procs = {}
    for name, (path, inc) in jobs.items():
        lib = out_dir / f"lib{STEM}_{name}.so"
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, *inc, "-o", str(lib), str(path)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), lib)
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        out[name] = Version(name, lib, log)
    for name, v in out.items():
        print(json.dumps({"version": name, "tile_rows": v.tile_rows,
                          "shipped_interface": v.shipped_abi,
                          "ptxas": cs.ptxas_entries(v.log)}), flush=True)
    return out


def model_cases(model, dev, gen, dgen):
    """(weights, {case: (x, sel)}) of one model of MOE_SHAPES."""
    (E, F_, n, k), Ts = cs.MOE_SHAPES[model]

    def w(*shape):
        return torch.randn(shape, generator=dgen, device=dev,
                           dtype=torch.bfloat16).mul_(shape[-2] ** -0.5)

    weights = (w(n, E, F_), w(n, E, F_), w(n, F_, E))
    cases = {}
    for T in Ts:
        x = (torch.randn(T, E, generator=dgen, device=dev) * cs.MOE_X_RMS).bfloat16()
        for how in cs.MOE_ROUTINGS:
            cases[f"T{T}_{how}"] = (x, cs.moe_routing(gen, T, k, n, how).to(dev))
    return weights, cases


def bound_ms(x, sel, weights):
    """chip_smoke.moe_case's byte bounds (ms) of gate/up and down."""
    wg, _, _ = weights
    n, E, F_ = wg.shape
    T, k = sel.shape
    P = T * k
    touched = int((torch.bincount(sel.reshape(-1), minlength=n) > 0).sum())
    tiles = md.tile_count(P, n) * 3 * 4
    gu = touched * 2 * E * F_ * 2 + T * E * 2 + P * F_ * 2 + P * 4 + tiles
    dn = touched * F_ * E * 2 + P * F_ * 2 + P * E * 2 + tiles
    return {"moe_gate_up": cs.bound(gu, 2 * P * E * F_ * 2)[0],
            "moe_down": cs.bound(dn, 2 * P * F_ * E)[0]}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--source", action="append", default=[],
                    help="NAME=DIR: a directory holding a copy of ops/csrc")
    ap.add_argument("--set", action="append", default=[], dest="settings",
                    help="NAME=VALUE[,NAME=VALUE...]: constants of a copy")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("moe_gemm_variants: no CUDA device available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    versions = build(dict(s.split("=", 1) for s in a.source), a.settings)
    shipped_lib = _build.load()[STEM]
    gen = torch.Generator(device="cpu").manual_seed(13)
    dgen = torch.Generator(device=dev).manual_seed(13)
    ok = True
    try:
        for model in cs.MOE_SHAPES:
            weights, cases = model_cases(model, dev, gen, dgen)
            wg, wu, wd = weights
            n = wg.shape[0]
            runs = {}  # case -> {version: (gate_up call, down call)}
            yard = {}  # case -> (gate/up, down) torch._grouped_mm calls
            for case, (x, sel) in cases.items():
                ref = md.route(sel, n)
                h32 = cs.gate_up_plain32(x, ref.tok, wg, wu, ref.tiles)
                hb = h32.bfloat16()
                y32 = cs.down_plain32(hb, wd, ref.tiles)
                rec = {"model": model, "case": case, "bound_ms": bound_ms(x, sel, weights)}
                runs[case] = {}
                for name, v in versions.items():
                    v.use()
                    r = v.route(sel, n)
                    got_h = v.gate_up(x, r.tok, wg, wu, r.tiles)
                    got_y = v.down(hb, wd, r.tiles)
                    torch.cuda.synchronize()
                    res = {}
                    for entry, got, want, form in (("moe_gate_up", got_h, h32, "max"),
                                                   ("moe_down", got_y, y32, "rms")):
                        err = (got.float() - want).abs().max().item()
                        rel = cs.row_errs(got, want)[form]
                        fine = (torch.isfinite(got.float()).all().item()
                                and err <= cs.KERNEL_TOL and rel <= cs.ROW_REL_TOL)
                        ok &= fine
                        res[entry] = {"max_abs_err": err, f"row_rel_err_{form}": rel,
                                      "ok": fine}
                    rec[name] = res
                    runs[case][name] = (
                        lambda v=v, r=r: v.gate_up(x, r.tok, wg, wu, r.tiles),
                        lambda v=v, r=r: v.down(hb, wd, r.tiles))
                offs = torch.cumsum(torch.bincount(sel.reshape(-1), minlength=n), 0
                                    ).to(torch.int32)
                xs = x[ref.tok.long()]
                yard[case] = (
                    lambda xs=xs, offs=offs: (torch._grouped_mm(xs, wg, offs=offs),
                                              torch._grouped_mm(xs, wu, offs=offs)),
                    lambda offs=offs: torch._grouped_mm(hb, wd, offs=offs))
                print(json.dumps(rec), flush=True)
            order = list(versions)
            for p, names in enumerate((order, order[::-1])):
                for name in names:
                    versions[name].use()
                    rec = {"model": model, "version": name, "pass": p}
                    for case, calls in runs.items():
                        rec[case] = {e: cs.graph_ms(fn) for e, fn in
                                     zip(("moe_gate_up", "moe_down"), calls[name])}
                    print(json.dumps(rec), flush=True)
                rec = {"model": model, "version": "torch._grouped_mm", "pass": p}
                for case, calls in yard.items():
                    rec[case] = {e: cs.graph_ms(fn) for e, fn in
                                 zip(("moe_gate_up", "moe_down"), calls)}
                print(json.dumps(rec), flush=True)
            del weights, wg, wu, wd, cases, runs, yard
            torch.cuda.empty_cache()
    finally:
        _build.load()[STEM] = shipped_lib
    print(smi, flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
