"""Read safetensors files without the `safetensors` package.

The format: an 8-byte little-endian header length N, N bytes of JSON
({name: {"dtype", "shape", "data_offsets": [begin, end]}, "__metadata__"?}),
then the tensors' bytes, each at its offsets past the header. `load_file`
maps the file copy-on-write and views each tensor's bytes as a torch
tensor of its type (BF16, F16 and F32 among them, and the integer types),
so nothing is read before a tensor is used and nothing is written back.
models/lora.py `load_peft_adapter` reads PEFT adapters through it.
"""

from __future__ import annotations

import json
import mmap
import struct
from pathlib import Path
from typing import Dict, Union

import torch

# safetensors' dtype names -> torch types
DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
    "F8_E4M3": torch.float8_e4m3fn, "F8_E5M2": torch.float8_e5m2,
}


def load_file(path: Union[str, Path]) -> Dict[str, torch.Tensor]:
    """Every tensor of a safetensors file, by name, as CPU tensors over a
    copy-on-write map of the file (writes to them never reach the
    file)."""
    path = Path(path)
    with open(path, "rb") as f:
        size = path.stat().st_size
        if size < 8:
            raise ValueError(f"{path}: not a safetensors file ({size} bytes)")
        buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    (n,) = struct.unpack("<Q", buf[:8])
    if 8 + n > size:
        raise ValueError(f"{path}: header of {n} bytes past the file's end")
    header = json.loads(bytes(buf[8:8 + n]))
    base = 8 + n
    out: Dict[str, torch.Tensor] = {}
    for name, ent in header.items():
        if name == "__metadata__":
            continue
        dt = DTYPES.get(ent["dtype"])
        if dt is None:
            raise ValueError(f"{path}: {name} has dtype {ent['dtype']}, not one "
                             f"of {sorted(DTYPES)}")
        begin, end = ent["data_offsets"]
        shape = tuple(int(d) for d in ent["shape"])
        count = 1
        for d in shape:
            count *= d
        item = torch.empty((), dtype=dt).element_size()
        if end - begin != count * item or base + end > size:
            raise ValueError(f"{path}: {name} spans [{begin}, {end}), "
                             f"{shape} {ent['dtype']} needs {count * item} bytes")
        if count == 0:
            out[name] = torch.empty(shape, dtype=dt)
            continue
        out[name] = torch.frombuffer(buf, dtype=dt, count=count,
                                     offset=base + begin).view(shape)
    return out
