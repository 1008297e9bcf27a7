"""Host shared-memory weight staging: a restarting worker attaches the
params a peer (or its own earlier self) staged in /dev/shm, and reads no
checkpoint.

Port of dynamo_tpu/engine/shm_weights.py with its segment layout exactly,
so a stage published by either package attaches in the other:
`dynshm_<name>`, [u64 big-endian index length][msgpack index {version 2,
meta, entries: [(key, shape, dtype, offset, nbytes)], total}][64-byte
aligned leaf bytes], keys such as "layers/wq", dtype names as numpy
writes them ("bfloat16" for bf16). The index is packed by the port's
runtime/codec.py (the reference's msgpack bytes). A stage is committed by
`os.rename` of a per-pid temp segment (atomic on tmpfs: an attacher sees
a whole stage or none); a publisher that died mid-write leaves its temp,
which a later publish collects. Segments are detached from Python's
resource tracker on both sides, so a stage outlives its creator and its
attachers.

Without ml_dtypes a bf16 leaf crosses as its bytes: `Stage.params` holds
read-only numpy views (uint16 for bf16, the dtype name kept in
`Stage.dtypes`), and `Stage.tensors(device)` reads each leaf's bytes into
a torch tensor of its type, never by value (a row range at a time,
weights.fill_tree: quantized under `quantize`, and passed on to sinks).
`StageWriter` writes a stage a row range at a time (a sink of a load);
`publish` writes a tree of torch tensors (on any device) or numpy arrays
through it. Both move the bytes by positioned reads and writes on the
segment's file descriptor (through a pinned buffer for a card), not
through the mapping: a host may pay a page fault a page for a
mapping's first touch.
"""

from __future__ import annotations

import logging
import math
import os
import struct
from multiprocessing import shared_memory
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from dynamo_tpu_torch.engine.st_io import Entry, HostBounce
from dynamo_tpu_torch.engine.weights import alloc_tree, fill_tree, flatten, unflatten, write_tree
from dynamo_tpu_torch.runtime import codec

log = logging.getLogger("dynamo_tpu_torch.shm_weights")

VERSION = 2
_ALIGN = 64
_HDR = struct.Struct(">Q")
SHM_DIR = "/dev/shm"

# torch types -> the numpy names the index carries, and back (bf16 as its
# uint16 bytes on this side)
_NAMES = {torch.bfloat16: "bfloat16", torch.float32: "float32",
          torch.float16: "float16", torch.int8: "int8", torch.uint8: "uint8",
          torch.int32: "int32", torch.int64: "int64",
          torch.float8_e4m3fn: "float8_e4m3fn"}
_TORCH = {v: k for k, v in _NAMES.items()}
_RAW = {"bfloat16": np.uint16, "float8_e4m3fn": np.uint8}


def _seg_name(name: str) -> str:
    safe = "".join(c if c.isalnum() or c in "-_" else "_" for c in name)
    return f"dynshm_{safe}"


def available() -> bool:
    return os.path.isdir(SHM_DIR)


def _keep_after_exit(shm: shared_memory.SharedMemory) -> None:
    """Detach the segment from the resource tracker: a stage must outlive
    the process that made it (and, before Python 3.13, every attacher,
    whose exit would otherwise unlink it). Cleanup is `unlink` or a later
    publish."""
    try:
        from multiprocessing import resource_tracker

        resource_tracker.unregister(shm._name, "shared_memory")
    except Exception:
        # the tracker's internals moved: the stage then dies with its creator
        log.debug("resource_tracker unregister failed for %s", shm._name, exc_info=True)


def _leaves(params: Any) -> Dict[str, torch.Tensor]:
    """A tree's leaves (torch tensors, or numpy arrays viewed as torch)."""
    out = {}
    for key, leaf in flatten(params):
        out[key] = (torch.from_numpy(np.ascontiguousarray(leaf))
                    if isinstance(leaf, np.ndarray) else leaf)
    return out


def _gc_temp_segments(seg: str) -> None:
    """Remove temp segments of dead publishers (the name carries the
    writer's pid; a live writer's temp is never touched)."""
    prefix = f"{seg}.p"
    try:
        names = os.listdir(SHM_DIR)
    except OSError:
        return
    for n in names:
        if not n.startswith(prefix):
            continue
        try:
            pid = int(n[len(prefix):])
        except ValueError:
            continue
        if not os.path.exists(f"/proc/{pid}"):
            try:
                os.unlink(os.path.join(SHM_DIR, n))
                log.info("collected abandoned shm temp %s (pid %d dead)", n, pid)
            except OSError:
                pass


class StageWriter:
    """A stage written a row range at a time (a sink of weights.fill_tree,
    or publish's leaves): `begin(entries)` lays out a per-pid temp
    segment and writes its index, `write` puts a leaf's rows, `commit`
    renames the segment into place (attachers see the previous whole
    stage or this one), `abort` removes it. `seconds` is the time spent
    in its copies and writes."""

    def __init__(self, name: str, meta: Optional[Dict[str, Any]] = None):
        self.name = name
        self.meta = meta or {}
        self._shm = None
        self._bounce = HostBounce("cpu")  # pinned at its first device tensor

    def begin(self, entries: Sequence[Entry]) -> None:
        for key, dt, _ in entries:
            if dt not in _NAMES:
                raise TypeError(f"{key}: dtype {dt} cannot be staged")
        seg = self._seg = _seg_name(self.name)
        _gc_temp_segments(seg)
        sizes = [math.prod(shape) * torch.empty((), dtype=dt).element_size()
                 for _, dt, shape in entries]
        guess = codec.packb({"version": VERSION, "meta": self.meta, "total": 0,
                             "entries": [(k, list(shape), _NAMES[dt], 0, n)
                                         for (k, dt, shape), n in zip(entries, sizes)]})
        # the guess packed every offset and the total as 0 (one byte each);
        # the real values take at most 9 bytes: reserve that growth
        base = (_HDR.size + len(guess) + 9 * (len(entries) + 1) + _ALIGN - 1) \
            // _ALIGN * _ALIGN
        index = []
        self._spans = {}
        off = base
        for (key, dt, shape), n in zip(entries, sizes):
            off = (off + _ALIGN - 1) // _ALIGN * _ALIGN
            index.append((key, list(shape), _NAMES[dt], off, n))
            self._spans[key] = (off, n, tuple(shape))
            off += n
        self.total = max(off, _HDR.size + 1)
        blob = codec.packb({"version": VERSION, "meta": self.meta, "total": self.total,
                            "entries": index})
        if _HDR.size + len(blob) > base:
            raise RuntimeError("shm index overran its reserved space")
        self._tmp = f"{seg}.p{os.getpid()}"
        try:
            self._shm = shared_memory.SharedMemory(name=self._tmp, create=True,
                                                   size=self.total)
        except FileExistsError:
            # this pid's own leftover from an interrupted publish
            os.unlink(os.path.join(SHM_DIR, self._tmp))
            self._shm = shared_memory.SharedMemory(name=self._tmp, create=True,
                                                   size=self.total)
        _keep_after_exit(self._shm)
        os.pwrite(self._shm._fd, _HDR.pack(len(blob)) + blob, 0)

    def write(self, key: str, t: torch.Tensor, row0: int = 0) -> None:
        off, n, shape = self._spans[key]
        row = n // shape[0] if shape and shape[0] else 0
        if t.numel() * t.element_size() + row0 * row > n:
            raise ValueError(f"{key}: {tuple(t.shape)} at row {row0} overruns {shape}")
        if t.numel():
            self._bounce.write_from(self._shm._fd, off + row0 * row, t)

    @property
    def seconds(self) -> float:
        return self._bounce.stats["d2h_s"] + self._bounce.stats["write_s"]

    def commit(self) -> None:
        # the commit: attachers see the previous whole stage or this one
        os.rename(os.path.join(SHM_DIR, self._tmp), os.path.join(SHM_DIR, self._seg))
        self._shm.close()
        self._shm = None
        log.info("staged %d arrays (%.1f MB) in shm as %s in %.1fs", len(self._spans),
                 self.total / 1e6, self.name, self.seconds)

    def abort(self) -> None:
        if self._shm is not None:
            try:
                os.unlink(os.path.join(SHM_DIR, self._tmp))
            except OSError:
                pass
            self._shm.close()
            self._shm = None


def publish(name: str, params: Any, meta: Optional[Dict[str, Any]] = None) -> bool:
    """Stage `params` under `name`, replacing any stage there atomically.
    False when shared memory is missing, or when a stage with the same
    (non-empty) `meta` is already there (peers booting together stage
    once)."""
    if not available():
        log.warning("%s missing: shm weight staging disabled", SHM_DIR)
        return False
    if meta:
        existing = attach(name)
        if existing is not None:
            same = existing.meta == meta
            existing.close()
            if same:
                return False
    write_tree(StageWriter(name, meta), _leaves(params))
    return True


class Stage:
    """An attached stage: `params`, a tree of read-only numpy views into
    the segment (bf16 leaves as uint16), `dtypes` by flattened key,
    `meta`, the publisher's fingerprint. Keep it alive while its views
    are used (it pins the mapping, across a replacing publish too)."""

    def __init__(self, shm: shared_memory.SharedMemory, params: Any,
                 dtypes: Dict[str, str], layout: Dict[str, tuple],
                 meta: Dict[str, Any], n_arrays: int, nbytes: int):
        self._shm = shm
        self._layout = layout  # key -> (shape, offset)
        self.params = params
        self.dtypes = dtypes
        self.meta = meta
        self.n_arrays = n_arrays
        self.nbytes = nbytes

    def tensors(self, device, quantize: Optional[str] = None,
                sinks: Sequence[Any] = ()) -> Dict[str, Any]:
        """The staged tree as new torch tensors on `device`, each leaf's
        bytes read from the segment as they are (bf16 as bf16), a row
        range at a time (weights.fill_tree): quantized under `quantize`,
        each range also written to `sinks`."""
        entries = [(key, _TORCH[self.dtypes[key]], shape)
                   for key, (shape, _) in sorted(self._layout.items())]
        tree = alloc_tree(entries, device, quantize)
        bounce = HostBounce(device)

        def read(key, rows, out):
            shape, off = self._layout[key]
            if rows is not None:
                off += rows[0] * math.prod(shape[1:]) * out.element_size()
            if out.numel():
                bounce.read_into(self._shm._fd, off, out)

        for s in sinks:
            s.begin(entries)
        fill_tree(tree, entries, read, quantize, sinks)
        return tree

    def close(self) -> None:
        self.params = None
        self._shm.close()


def attach(name: str) -> Optional[Stage]:
    """Attach to a published stage; None when absent or unreadable (a
    corrupt segment is logged and treated as absent; the next publish
    replaces it)."""
    if not available():
        return None
    try:
        shm = shared_memory.SharedMemory(name=_seg_name(name))
    except FileNotFoundError:
        return None
    # before Python 3.13 attaching registers with the tracker too, whose
    # exit handler would unlink the stage
    _keep_after_exit(shm)
    try:
        (blob_len,) = _HDR.unpack(bytes(shm.buf[:_HDR.size]))
        index = codec.unpackb(bytes(shm.buf[_HDR.size:_HDR.size + blob_len]))
        if not isinstance(index, dict) or index.get("version") != VERSION:
            raise ValueError(f"version {index.get('version')!r}"
                             if isinstance(index, dict) else "not a map")
        entries: Dict[str, np.ndarray] = {}
        dtypes: Dict[str, str] = {}
        layout: Dict[str, tuple] = {}
        for key, shape, dtype, off, _nb in index["entries"]:
            if dtype not in _TORCH:
                raise ValueError(f"{key}: dtype {dtype!r}")
            raw = _RAW[dtype] if dtype in _RAW else np.dtype(dtype)
            arr = np.ndarray(tuple(shape), dtype=raw, buffer=shm.buf, offset=off)
            # the mapping is every co-hosted worker's: a write to it raises
            arr.flags.writeable = False
            entries[key] = arr
            dtypes[key] = dtype
            layout[key] = (tuple(shape), off)
    except Exception as e:
        log.warning("shm stage %s unreadable (%s); treating as absent", name, e)
        shm.close()
        return None
    return Stage(shm, unflatten(entries), dtypes, layout, index.get("meta") or {},
                 len(entries), index["total"])


def unlink(name: str) -> None:
    """Remove a stage (publish replaces one without this)."""
    try:
        os.unlink(os.path.join(SHM_DIR, _seg_name(name)))
    except OSError:
        pass
    _gc_temp_segments(_seg_name(name))
