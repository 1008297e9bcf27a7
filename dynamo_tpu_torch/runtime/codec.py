"""MessagePack in pure Python, for the subset the request and event planes
send: nil, bool, int (int64 and uint64), float64 (float32 decoded too),
str, bin, array and map.

`packb(obj)` writes the bytes `msgpack.packb(obj, use_bin_type=True)`
writes, and `unpackb(data)` returns what `msgpack.unpackb(data, raw=False)`
returns, so the port's frames are byte-compatible with the reference's.
Tuples pack as arrays; map keys must be str or bytes on decode (msgpack's
`strict_map_key`). Bytes values larger than `_INLINE_BIN` are not copied
into a staging buffer: `pack_parts` hands them out as parts of their own,
and only the final join copies them (a 16-page KV chunk of a 3B model is
about 29 MB).
"""

from __future__ import annotations

import struct
from typing import Any, List

_INLINE_BIN = 4096  # bin values at most this long are copied into the buffer

_B = struct.Struct(">B")
_H = struct.Struct(">H")
_I = struct.Struct(">I")
_Q = struct.Struct(">Q")
_b = struct.Struct(">b")
_h = struct.Struct(">h")
_i = struct.Struct(">i")
_q = struct.Struct(">q")
_d = struct.Struct(">d")
_f = struct.Struct(">f")


def _pack_int(buf: bytearray, n: int) -> None:
    if n < -(1 << 5):
        if n < -(1 << 15):
            if n < -(1 << 31):
                if n < -(1 << 63):
                    raise OverflowError("int too small to pack")
                buf += b"\xd3" + _q.pack(n)
            else:
                buf += b"\xd2" + _i.pack(n)
        elif n < -(1 << 7):
            buf += b"\xd1" + _h.pack(n)
        else:
            buf += b"\xd0" + _b.pack(n)
    elif n < (1 << 7):
        buf += _b.pack(n) if n < 0 else _B.pack(n)
    elif n < (1 << 16):
        buf += (b"\xcc" + _B.pack(n)) if n < (1 << 8) else (b"\xcd" + _H.pack(n))
    elif n < (1 << 32):
        buf += b"\xce" + _I.pack(n)
    elif n < (1 << 64):
        buf += b"\xcf" + _Q.pack(n)
    else:
        raise OverflowError("int too big to pack")


def _pack_len(buf: bytearray, n: int, fix: int, fix_max: int, codes) -> None:
    """A str/array/map header: the fix form up to `fix_max`, else the
    8- (str only), 16- or 32-bit length form in `codes`."""
    if n <= fix_max:
        buf.append(fix | n)
    elif codes[0] is not None and n < (1 << 8):
        buf += codes[0] + _B.pack(n)
    elif n < (1 << 16):
        buf += codes[1] + _H.pack(n)
    elif n < (1 << 32):
        buf += codes[2] + _I.pack(n)
    else:
        raise ValueError("object too large to pack")


_STR = (b"\xd9", b"\xda", b"\xdb")
_ARR = (None, b"\xdc", b"\xdd")
_MAP = (None, b"\xde", b"\xdf")


def pack_parts(obj: Any) -> List[bytes]:
    """The encoding of `obj` as a list of byte strings whose join is
    `packb(obj)`. Large bytes values appear in it uncopied."""
    parts: List[bytes] = []
    buf = bytearray()

    def pack(o: Any, depth: int) -> None:
        nonlocal buf
        if depth > 512:
            raise ValueError("object nested too deeply to pack")
        if o is None:
            buf.append(0xC0)
        elif o is True:
            buf.append(0xC3)
        elif o is False:
            buf.append(0xC2)
        elif isinstance(o, int):
            _pack_int(buf, int(o))
        elif isinstance(o, float):
            buf += b"\xcb" + _d.pack(o)
        elif isinstance(o, str):
            raw = o.encode("utf-8")
            _pack_len(buf, len(raw), 0xA0, 31, _STR)
            buf += raw
        elif isinstance(o, (bytes, bytearray, memoryview)):
            n = o.nbytes if isinstance(o, memoryview) else len(o)
            if n < (1 << 8):
                buf += b"\xc4" + _B.pack(n)
            elif n < (1 << 16):
                buf += b"\xc5" + _H.pack(n)
            elif n < (1 << 32):
                buf += b"\xc6" + _I.pack(n)
            else:
                raise ValueError("bytes too large to pack")
            if n <= _INLINE_BIN:
                buf += o
            else:
                parts.append(bytes(buf))
                parts.append(o if isinstance(o, bytes) else bytes(o))
                buf = bytearray()
        elif isinstance(o, (list, tuple)):
            _pack_len(buf, len(o), 0x90, 15, _ARR)
            for x in o:
                pack(x, depth + 1)
        elif isinstance(o, dict):
            _pack_len(buf, len(o), 0x80, 15, _MAP)
            for k, v in o.items():
                pack(k, depth + 1)
                pack(v, depth + 1)
        else:
            raise TypeError(f"can not serialize {type(o).__name__!r} object")

    pack(obj, 0)
    if buf:
        parts.append(bytes(buf))
    return parts


def packb(obj: Any) -> bytes:
    """`msgpack.packb(obj, use_bin_type=True)`."""
    parts = pack_parts(obj)
    return parts[0] if len(parts) == 1 else b"".join(parts)


def unpackb(data) -> Any:
    """`msgpack.unpackb(data, raw=False)` for the subset this codec packs
    (and float32): one object, no trailing bytes."""
    mv = memoryview(data).cast("B")
    obj, pos = _unpack(mv, 0, 0)
    if pos != len(mv):
        raise ValueError("extra data after the msgpack object")
    return obj


def _take(mv: memoryview, pos: int, n: int) -> int:
    end = pos + n
    if end > len(mv):
        raise ValueError("truncated msgpack data")
    return end


def _unpack(mv: memoryview, pos: int, depth: int):
    if depth > 512:
        raise ValueError("msgpack object nested too deeply")
    if pos >= len(mv):
        raise ValueError("truncated msgpack data")
    c = mv[pos]
    pos += 1
    if c <= 0x7F:
        return c, pos
    if c >= 0xE0:
        return c - 0x100, pos
    if 0xA0 <= c <= 0xBF:
        return _str(mv, pos, c & 0x1F)
    if 0x90 <= c <= 0x9F:
        return _array(mv, pos, c & 0x0F, depth)
    if 0x80 <= c <= 0x8F:
        return _map(mv, pos, c & 0x0F, depth)
    if c == 0xC0:
        return None, pos
    if c == 0xC2:
        return False, pos
    if c == 0xC3:
        return True, pos
    fixed = _FIXED.get(c)
    if fixed is not None:
        end = _take(mv, pos, fixed.size)
        return fixed.unpack_from(mv, pos)[0], end
    sized = _SIZED.get(c)
    if sized is not None:
        kind, width = sized
        end = _take(mv, pos, width.size)
        n = width.unpack_from(mv, pos)[0]
        if kind == "str":
            return _str(mv, end, n)
        if kind == "bin":
            stop = _take(mv, end, n)
            return bytes(mv[end:stop]), stop
        if kind == "array":
            return _array(mv, end, n, depth)
        return _map(mv, end, n, depth)
    raise ValueError(f"unsupported msgpack type byte 0x{c:02x}")


_FIXED = {0xCC: _B, 0xCD: _H, 0xCE: _I, 0xCF: _Q, 0xD0: _b, 0xD1: _h,
          0xD2: _i, 0xD3: _q, 0xCA: _f, 0xCB: _d}
_SIZED = {0xD9: ("str", _B), 0xDA: ("str", _H), 0xDB: ("str", _I),
          0xC4: ("bin", _B), 0xC5: ("bin", _H), 0xC6: ("bin", _I),
          0xDC: ("array", _H), 0xDD: ("array", _I),
          0xDE: ("map", _H), 0xDF: ("map", _I)}


def _str(mv: memoryview, pos: int, n: int):
    end = _take(mv, pos, n)
    try:
        return str(mv[pos:end], "utf-8"), end
    except UnicodeDecodeError as e:
        raise ValueError(f"invalid utf-8 in msgpack str: {e}") from None


def _array(mv: memoryview, pos: int, n: int, depth: int):
    out = []
    for _ in range(n):
        x, pos = _unpack(mv, pos, depth + 1)
        out.append(x)
    return out, pos


def _map(mv: memoryview, pos: int, n: int, depth: int):
    out = {}
    for _ in range(n):
        k, pos = _unpack(mv, pos, depth + 1)
        if not isinstance(k, (str, bytes)):
            raise ValueError(f"{type(k).__name__} is not allowed for map key")
        v, pos = _unpack(mv, pos, depth + 1)
        out[k] = v
    return out, pos
