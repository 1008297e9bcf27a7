"""Read and write safetensors files without the `safetensors` package.

The format: an 8-byte little-endian header length N, N bytes of JSON
({name: {"dtype", "shape", "data_offsets": [begin, end]}, "__metadata__"?},
padded with spaces to a multiple of 8 bytes), then the tensors' bytes,
packed in order, each at its offsets past the header.

- `SafetensorsFile.read` copies one tensor, or a range of its rows (the
  leading axis), into a tensor anywhere: on a card through a pinned host
  buffer of `CHUNK_BYTES`, a chunk at a time (`HostBounce`), so a
  checkpoint crosses without a host copy of its own; `HostBounce.stats`
  splits the seconds into file reads and host-to-device copies.
- `load_file` reads every tensor of a file into CPU tensors of their own
  (BF16, F16 and F32 among them, and the integer types);
  models/lora.py `load_peft_adapter` reads PEFT adapters through it.
- `Writer` writes a file whose tensors are known up front (names, types,
  shapes) a tensor, or a row range of one, at a time and in any order,
  under a temp name until `commit` renames it into place; `save_file`
  writes a mapping of tensors through it. Tensors on a card go to the
  file through the bounce buffer. Reads and writes are positioned system
  calls, never stores into a mapping (a host may pay a page fault a
  page for those).
"""

from __future__ import annotations

import json
import os
import struct
import time
from pathlib import Path
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union

import torch

# safetensors' dtype names -> torch types
DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
    "F8_E4M3": torch.float8_e4m3fn, "F8_E5M2": torch.float8_e5m2,
}
NAMES = {dt: name for name, dt in DTYPES.items()}

# bytes a bounce buffer carries at a time between a file and a card
CHUNK_BYTES = 64 << 20

Header = Dict[str, Tuple[torch.dtype, Tuple[int, ...], int, int]]


def _itemsize(dt: torch.dtype) -> int:
    return torch.empty((), dtype=dt).element_size()


def read_header(path: Union[str, Path], size: int, head: bytes,
                read=None) -> Tuple[Header, Dict[str, str], int]:
    """Parse and check a header: ({name: (dtype, shape, begin, end)}
    with absolute byte offsets, the metadata, the data's base offset).
    `head` holds the file's first 8 bytes; `read(n)` returns the next n."""
    if size < 8:
        raise ValueError(f"{path}: not a safetensors file ({size} bytes)")
    (n,) = struct.unpack("<Q", head[:8])
    if 8 + n > size:
        raise ValueError(f"{path}: header of {n} bytes past the file's end")
    raw = json.loads(read(n))
    base = 8 + n
    meta = raw.pop("__metadata__", None) or {}
    out: Header = {}
    for name, ent in raw.items():
        dt = DTYPES.get(ent["dtype"])
        if dt is None:
            raise ValueError(f"{path}: {name} has dtype {ent['dtype']}, not one "
                             f"of {sorted(DTYPES)}")
        begin, end = ent["data_offsets"]
        shape = tuple(int(d) for d in ent["shape"])
        count = 1
        for d in shape:
            count *= d
        if end - begin != count * _itemsize(dt) or begin < 0 or base + end > size:
            raise ValueError(f"{path}: {name} spans [{begin}, {end}), "
                             f"{shape} {ent['dtype']} needs {count * _itemsize(dt)} bytes")
        out[name] = (dt, shape, base + begin, base + end)
    return out, meta, base


def _flat_bytes(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor's bytes as a 1-D uint8 view."""
    if not t.is_contiguous():
        raise ValueError("a contiguous tensor is needed")
    return t.reshape(-1).view(torch.uint8) if t.dim() else t.reshape(1).view(torch.uint8)


class HostBounce:
    """The pinned host buffer that carries bytes between files and a card
    (none on the CPU, where reads land in place), and the seconds spent:
    `read_s` in file reads, `h2d_s` in host-to-device copies, `d2h_s` and
    `write_s` the other way, `bytes` moved."""

    def __init__(self, device):
        self.buf = None
        if torch.device(device).type == "cuda":
            self.buf = torch.empty(CHUNK_BYTES, dtype=torch.uint8, pin_memory=True)
        self.stats = {"read_s": 0.0, "h2d_s": 0.0, "d2h_s": 0.0, "write_s": 0.0,
                      "bytes": 0}

    def _pread(self, fd: int, dst, offset: int) -> None:
        mv = memoryview(dst)
        t0 = time.monotonic()
        while len(mv):
            n = os.preadv(fd, [mv], offset)
            if n <= 0:
                raise OSError(f"short read at byte {offset} ({len(mv)} left)")
            mv, offset = mv[n:], offset + n
        self.stats["read_s"] += time.monotonic() - t0

    def read_into(self, fd: int, offset: int, out: torch.Tensor) -> None:
        """The file's bytes at `offset` into the contiguous `out`."""
        flat = _flat_bytes(out)
        n = flat.numel()
        self.stats["bytes"] += n
        if flat.device.type == "cpu":
            self._pread(fd, flat.numpy(), offset)
            return
        host = self.buf.numpy()
        step = self.buf.numel()
        for o in range(0, n, step):
            k = min(step, n - o)
            self._pread(fd, host[:k], offset + o)
            t0 = time.monotonic()
            flat[o:o + k].copy_(self.buf[:k])  # from pinned memory: waits
            self.stats["h2d_s"] += time.monotonic() - t0

    def _pwrite(self, fd: int, src, offset: int) -> None:
        mv = memoryview(src)
        t0 = time.monotonic()
        while len(mv):
            n = os.pwrite(fd, mv, offset)
            mv, offset = mv[n:], offset + n
        self.stats["write_s"] += time.monotonic() - t0

    def write_from(self, fd: int, offset: int, t: torch.Tensor) -> None:
        """`t`'s bytes (contiguous) into the file at `offset`."""
        flat = _flat_bytes(t)
        n = flat.numel()
        self.stats["bytes"] += n
        if flat.device.type == "cpu":
            self._pwrite(fd, flat.numpy(), offset)
            return
        buf = self.buf
        if buf is None:  # a CPU bounce given a device tensor
            buf = self.buf = torch.empty(CHUNK_BYTES, dtype=torch.uint8, pin_memory=True)
        host = buf.numpy()
        step = buf.numel()
        for o in range(0, n, step):
            k = min(step, n - o)
            t0 = time.monotonic()
            buf[:k].copy_(flat[o:o + k])
            self.stats["d2h_s"] += time.monotonic() - t0
            self._pwrite(fd, host[:k], offset + o)


class SafetensorsFile:
    """A safetensors file opened for reads into tensors anywhere: its
    `header` ({name: (dtype, shape, begin, end)}) and `metadata`. Close it
    (or use it as a context manager) when done."""

    def __init__(self, path: Union[str, Path]):
        self.path = Path(path)
        self._fd = os.open(self.path, os.O_RDONLY)
        try:
            size = os.fstat(self._fd).st_size
            self.header, self.metadata, _ = read_header(
                self.path, size, os.pread(self._fd, 8, 0),
                lambda n: os.pread(self._fd, n, 8))
        except BaseException:
            os.close(self._fd)
            raise

    def close(self) -> None:
        if self._fd >= 0:
            os.close(self._fd)
            self._fd = -1

    def __enter__(self) -> "SafetensorsFile":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def keys(self):
        return self.header.keys()

    def __contains__(self, name: str) -> bool:
        return name in self.header

    def dtype(self, name: str) -> torch.dtype:
        return self.header[name][0]

    def shape(self, name: str) -> Tuple[int, ...]:
        return self.header[name][1]

    def read(self, name: str, out: torch.Tensor, bounce: HostBounce,
             rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        """Tensor `name`, or its rows [r0, r1) along the leading axis
        (only those bytes are read), into `out`, which must have that
        shape and the file's dtype and be contiguous. Returns `out`."""
        dt, shape, begin, _ = self.header[name]
        if rows is not None:
            r0, r1 = rows
            if not 0 <= r0 <= r1 <= shape[0]:
                raise ValueError(f"{self.path}: rows [{r0}, {r1}) of {name} {shape}")
            row_bytes = _itemsize(dt)
            for d in shape[1:]:
                row_bytes *= d
            begin += r0 * row_bytes
            shape = (r1 - r0,) + tuple(shape[1:])
        if tuple(out.shape) != tuple(shape) or out.dtype != dt:
            raise ValueError(f"{self.path}: {name} is {tuple(shape)} {dt}, the "
                             f"target {tuple(out.shape)} {out.dtype}")
        bounce.read_into(self._fd, begin, out)
        return out


def load_file(path: Union[str, Path]) -> Dict[str, torch.Tensor]:
    """Every tensor of a safetensors file, by name, as CPU tensors of
    their own."""
    bounce = HostBounce("cpu")
    with SafetensorsFile(path) as f:
        return {name: f.read(name, torch.empty(shape, dtype=dt), bounce)
                for name, (dt, shape, _, _) in f.header.items()}


Entry = Tuple[str, torch.dtype, Tuple[int, ...]]


class Writer:
    """A safetensors file of the tensors `entries` [(name, dtype, shape)]
    names, in that order: its header is written first, each tensor's
    bytes (or a row range's) by `write`, in any order; `commit` renames
    the file from its temp name into place, `abort` removes it. The types
    are BF16, F16, F32, the integer types and F8_E4M3."""

    def __init__(self, path: Union[str, Path], entries: Sequence[Entry],
                 metadata: Optional[Mapping[str, str]] = None,
                 bounce: Optional[HostBounce] = None):
        self.path = Path(path)
        header: Dict[str, Any] = {}
        if metadata:
            header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
        off = 0
        spans = {}
        for name, dt, shape in entries:
            if dt not in NAMES:
                raise ValueError(f"{name}: dtype {dt} has no safetensors name")
            n = _itemsize(dt)
            for d in shape:
                n *= d
            header[name] = {"dtype": NAMES[dt], "shape": list(shape),
                            "data_offsets": [off, off + n]}
            spans[name] = (off, n, dt, tuple(shape))
            off += n
        blob = json.dumps(header, separators=(",", ":")).encode()
        blob += b" " * (-len(blob) % 8)
        base = 8 + len(blob)
        self._spans = {name: (base + o, *rest) for name, (o, *rest) in spans.items()}
        self.bounce = bounce if bounce is not None else HostBounce("cpu")
        self._tmp = self.path.with_name(f".{self.path.name}.tmp{os.getpid()}")
        self._fd = os.open(self._tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
        try:
            os.ftruncate(self._fd, base + off)
            os.pwrite(self._fd, struct.pack("<Q", len(blob)) + blob, 0)
        except BaseException:
            self.abort()
            raise

    def write(self, name: str, t: torch.Tensor, row0: int = 0) -> None:
        """`t` (contiguous, of the entry's type) as tensor `name`'s rows
        from `row0` on."""
        begin, n, dt, shape = self._spans[name]
        row = n // shape[0] if shape and shape[0] else 0
        nb = t.numel() * t.element_size()
        if t.dtype != dt or row0 * row + nb > n:
            raise ValueError(f"{self.path}: {tuple(t.shape)} {t.dtype} at row {row0} "
                             f"does not fit {name} {shape} {dt}")
        if nb:
            self.bounce.write_from(self._fd, begin + row0 * row, t)

    def commit(self) -> None:
        os.close(self._fd)
        self._fd = -1
        os.replace(self._tmp, self.path)

    def abort(self) -> None:
        if self._fd >= 0:
            os.close(self._fd)
            self._fd = -1
        try:
            os.unlink(self._tmp)
        except OSError:
            pass


def save_file(tensors: Mapping[str, torch.Tensor], path: Union[str, Path],
              metadata: Optional[Mapping[str, str]] = None,
              bounce: Optional[HostBounce] = None) -> None:
    """Write `tensors` (contiguous, on any device) as a safetensors file at
    `path`: the header JSON padded with spaces to a multiple of 8 bytes,
    then the tensors' bytes packed in the mapping's order, under a temp
    name renamed into place."""
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name}: a contiguous tensor is needed")
    w = Writer(path, [(n, t.dtype, tuple(t.shape)) for n, t in tensors.items()],
               metadata, bounce)
    try:
        for name, t in tensors.items():
            w.write(name, t)
        w.commit()
    except BaseException:
        w.abort()
        raise
