"""The C++ block index (native/block_index.cpp), built with g++ and bound
with ctypes.

Port of dynamo_tpu/native/block_index.py: `CppBlockIndex` has the
interface of router/radix_tree.py's `BlockIndex` for the event mode.
Worker tuples (instance_id, dp_rank) are interned to dense u32 ids here;
block hashes cross as u64 arrays. The library is built at first use into
`build/dynamo_tpu_torch/` at the repository root, named by a hash of the
source and the flags (the scheme of ops/_build.py), so an edited source
rebuilds and an unchanged one loads at once. A build that fails raises:
the port has no fallback to the Python index in event mode.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from dynamo_tpu_torch.router.protocols import OverlapScores, RouterEvent

Worker = Tuple[int, int]

SOURCE = Path(__file__).resolve().parent / "block_index.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "dynamo_tpu_torch"
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_P, _U32, _U64, _I = ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint64, ctypes.c_int
_U64P, _U32P = ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint32)
SIGNATURES = {
    "bi_new": ([], _P),
    "bi_free": ([_P], None),
    # index, worker, parent0, has_parent0, hashes, n
    "bi_apply_store": ([_P, _U32, _U64, _I, _U64P, _I], None),
    # index, worker, hashes, n
    "bi_apply_remove": ([_P, _U32, _U64P, _I], None),
    "bi_remove_worker": ([_P, _U32], None),
    # index, hashes, n, out_workers, out_scores, max_out
    "bi_find_matches": ([_P, _U64P, _I, _U32P, _U32P, _I], _I),
    "bi_len": ([_P], _U64),
    "bi_worker_block_count": ([_P, _U32], _U64),
}


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libblock_index_{h.hexdigest()[:16]}.so"


def load() -> ctypes.CDLL:
    """Build the library if it is missing, bind it and return it. Raises
    RuntimeError when g++ is missing or the build fails."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        out = library_path()
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            try:
                proc = subprocess.run(["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                                      capture_output=True, text=True, timeout=300)
            except FileNotFoundError:
                raise RuntimeError("g++ not found: the KV router's block index "
                                   "builds with g++") from None
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"g++ failed for {SOURCE.name} "
                                   f"(rc {proc.returncode}):\n{proc.stderr}")
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        for fn, (argtypes, restype) in SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _lib = lib
        return lib


def _u64_array(values: List[int]):
    return (ctypes.c_uint64 * len(values))(*[v & 0xFFFFFFFFFFFFFFFF for v in values])


class CppBlockIndex:
    """The router's BlockIndex in event mode (the TTL mode uses the
    Python index)."""

    MAX_WORKERS_OUT = 1024

    def __init__(self):
        self._lib = load()
        self._h = self._lib.bi_new()
        self._worker_ids: Dict[Worker, int] = {}
        self._worker_by_id: Dict[int, Worker] = {}

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.bi_free(self._h)
            self._h = None

    def _wid(self, worker: Worker) -> int:
        w = tuple(worker)
        i = self._worker_ids.get(w)
        if i is None:
            i = len(self._worker_ids)
            self._worker_ids[w] = i
            self._worker_by_id[i] = w
        return i

    # -- BlockIndex interface ----------------------------------------------
    def apply_event(self, ev: RouterEvent, ttl: Optional[float] = None) -> None:
        worker = self._wid(ev.worker)
        if ev.kind == "store":
            parent = ev.parent_hash
            self._lib.bi_apply_store(
                self._h, worker, (parent or 0) & 0xFFFFFFFFFFFFFFFF,
                1 if parent is not None else 0,
                _u64_array(ev.block_hashes), len(ev.block_hashes))
        elif ev.kind == "remove":
            self._lib.bi_apply_remove(self._h, worker, _u64_array(ev.block_hashes),
                                      len(ev.block_hashes))
        elif ev.kind == "clear":
            self.remove_worker(ev.worker)

    def find_matches(self, block_hashes: List[int], now=None) -> OverlapScores:
        if not block_hashes:
            return OverlapScores(total_blocks=0)
        out_w = (ctypes.c_uint32 * self.MAX_WORKERS_OUT)()
        out_s = (ctypes.c_uint32 * self.MAX_WORKERS_OUT)()
        n = self._lib.bi_find_matches(self._h, _u64_array(block_hashes),
                                      len(block_hashes), out_w, out_s,
                                      self.MAX_WORKERS_OUT)
        scores = {self._worker_by_id[out_w[i]]: int(out_s[i])
                  for i in range(n) if out_s[i] > 0}
        return OverlapScores(scores=scores, total_blocks=len(block_hashes))

    def remove_worker(self, worker: Worker) -> None:
        self._lib.bi_remove_worker(self._h, self._wid(worker))

    def worker_block_count(self, worker: Worker) -> int:
        return int(self._lib.bi_worker_block_count(self._h, self._wid(worker)))

    def __len__(self) -> int:
        return int(self._lib.bi_len(self._h))


def make_block_index(ttl_mode: bool = False):
    """The index for the mode: C++ in event mode, Python in TTL mode."""
    if ttl_mode:
        from dynamo_tpu_torch.router.radix_tree import BlockIndex

        return BlockIndex()
    return CppBlockIndex()
