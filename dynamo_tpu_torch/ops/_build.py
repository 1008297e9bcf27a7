"""Build and bind the port's CUDA kernels.

Each source under ops/csrc/ is compiled by its own `nvcc` process (all
started together) into a shared library with a plain C interface, then
loaded with ctypes. Libraries land in `build/dynamo_tpu_torch/` at the
repository root, named by a hash of the source, the shared headers
(csrc/*.cuh) and the flags, so an edited source or header rebuilds and an
unchanged one loads at once. Nothing is built when this module is
imported: the first launch (or an explicit `load()`) builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "dynamo_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# source stem -> {C function: (argtypes, restype)}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES: Dict[str, Dict[str, tuple]] = {
    # q, k_pool, k_scales, v_pool, v_scales (the scales NULL for bf16
    # pools), page_table, kv_lens, out, part,
    # B, Hk, G, D, PS, MP, NP, split, window, scale, softcap, stream
    "paged_attention": {
        "decode_paged_attention": (
            [_P] * 9 + [_I] * 9 + [_F, _F, _P], _I),
    },
    # q, k_pool, k_scales, v_pool, v_scales, page_table, q_start, q_len,
    # kv_lens, out, B, S, Hk, G, D, PS, MP, q_block, window, scale,
    # softcap, stream
    "flash_prefill": {
        "prefill_paged_attention": (
            [_P] * 10 + [_I] * 9 + [_F, _F, _P], _I),
    },
    # q, k_pool, k_scales, v_pool, v_scales, seg_page_table, seg_kv_lens,
    # meta, out, part, NW, Hk, G, D, PS, MP, q_block, split, window, scale,
    # softcap, stream
    "ragged_paged_attention": {
        "ragged_paged_attention": (
            [_P] * 10 + [_I] * 9 + [_F, _F, _P], _I),
    },
    "mla_attention": {
        # q, lat_pool, lat_scales (NULL for bf16), page_table, kv_lens,
        # out, part, B, H, dc, dr, PS, MP, NP, split, scale, stream
        "decode_mla_attention": ([_P] * 7 + [_I] * 8 + [_F, _P], _I),
        # q, lat_pool, page_table, q_start, q_len, kv_lens, out,
        # B, S, H, dc, dr, PS, MP, scale, stream
        "prefill_mla_attention": ([_P] * 7 + [_I] * 7 + [_F, _P], _I),
    },
    "moe_grouped_gemm": {
        # x, tok, w_gate, w_up, tiles, h, P, n_experts, n_tiles, K, N, stream
        "moe_gate_up": ([_P] * 6 + [_I] * 5 + [_P], _I),
        # h, w_down, tiles, y, P, n_experts, n_tiles, K, N, stream
        "moe_down": ([_P] * 4 + [_I] * 5 + [_P], _I),
        # quantized experts: x, tok, w_gate, w_up (codes), s_gate, s_up,
        # tiles, h, P, n_experts, n_tiles, K, N, code (1 int8, 2 e4m3), stream
        "moe_gate_up_codes": ([_P] * 8 + [_I] * 6 + [_P], _I),
        # h, w_down (codes), s_down, tiles, y, P, n_experts, n_tiles, K, N,
        # code, stream
        "moe_down_codes": ([_P] * 5 + [_I] * 6 + [_P], _I),
        # the rows of a tile the kernel takes (MOE_BM)
        "moe_tile_rows": ([], _I),
    },
    "quant_gemm": {
        # x, codes, scales, y, M, N, K, nk, fp8, stream
        "quant_gemm": ([_P] * 4 + [_I] * 5 + [_P], _I),
        # the rows at or below which a launch takes the small tiles
        "quant_gemm_small_m": ([], _I),
    },
    "tier_codec": {
        # x, q, s, rows, D, dtype (0 f32, 1 bf16, 2 f16), stream
        "tier_quantize": ([_P] * 3 + [_I] * 3 + [_P], _I),
        # q, s, out, rows, D, dtype, stream
        "tier_dequantize": ([_P] * 3 + [_I] * 3 + [_P], _I),
    },
    "block_copy": {
        # pool, idx, out, L, NP, n, PS, Hk, R (16-byte vectors per D row),
        # head_major, stream
        "gather_pages": ([_P] * 3 + [_I] * 7 + [_P], _I),
        # pool, idx, pages, L, NP, n, page_vecs, stream
        "scatter_pages": ([_P] * 3 + [_I] * 4 + [_P], _I),
        # pool, idx, layer_off, pages, Lg, NP, n, page_vecs, stream
        "scatter_pages_layers": ([_P] * 4 + [_I] * 4 + [_P], _I),
    },
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
build_log: Dict[str, str] = {}  # source stem -> nvcc's output (ptxas -v)
# libraries nvcc compiled in this process (the sanitizer's build tripwire)
nvcc_builds = [0]


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def library_path(stem: str) -> Path:
    """Keyed by the source, every shared header in csrc/ and the flags."""
    h = hashlib.sha256((CSRC / f"{stem}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{stem}_{h.hexdigest()[:16]}.so"


def nvcc_command(stem: str, out: Path) -> List[str]:
    return [nvcc_path(), *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{stem}.cu")]


def _bind(stem: str, path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for fn, (argtypes, restype) in SIGNATURES[stem].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    lib.kernel_error_string.argtypes = [_I]
    lib.kernel_error_string.restype = ctypes.c_char_p
    return lib


def load() -> Dict[str, ctypes.CDLL]:
    """Build whatever is missing (one nvcc per source, in parallel) and
    return {source stem: bound library}."""
    with _lock:
        missing = [s for s in SIGNATURES if s not in _libs]
        if not missing:
            return _libs
        to_build = [s for s in missing if not library_path(s).exists()]
        if to_build:
            nvcc_path()  # fail before touching the build directory
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for stem in to_build:
            out = library_path(stem)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            procs[stem] = (subprocess.Popen(
                nvcc_command(stem, tmp), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True), tmp, out)
        failed = []
        for stem, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            build_log[stem] = log
            if proc.returncode != 0:
                failed.append(f"{stem}.cu (rc {proc.returncode}):\n{log}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, out)
                nvcc_builds[0] += 1
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        for stem in missing:
            _libs[stem] = _bind(stem, library_path(stem))
        return _libs


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if rc != 0:
        msg = lib.kernel_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")
