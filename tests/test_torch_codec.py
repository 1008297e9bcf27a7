"""The port's pure-Python msgpack (dynamo_tpu_torch/runtime/codec.py)
against msgpack itself, which the reference's request plane frames with:
the same bytes out for the same object, the same object back from
msgpack's bytes, at every width boundary of ints, strs, bins, arrays and
maps."""

import math

import msgpack
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from dynamo_tpu_torch.runtime import codec
from dynamo_tpu_torch.runtime.request_plane import frame_bytes

# every boundary of msgpack's int forms, both sides of each
INT_EDGES = sorted({s * (b + d) for b in (0, 1 << 5, 1 << 7, 1 << 8, 1 << 15, 1 << 16,
                                          1 << 31, 1 << 32, 1 << 63)
                    for d in (-1, 0, 1) for s in (1, -1)
                    if -(1 << 63) <= s * (b + d) < (1 << 64)} | {(1 << 64) - 1})
LEN_EDGES = [0, 1, 15, 16, 31, 32, 255, 256, 65535, 65536]

scalars = (st.none() | st.booleans()
           | st.integers(min_value=-(1 << 63), max_value=(1 << 64) - 1)
           | st.sampled_from(INT_EDGES)
           | st.floats(allow_nan=False) | st.text() | st.binary())
objects = st.recursive(
    scalars,
    lambda inner: (st.lists(inner, max_size=20)
                   | st.tuples(inner, inner)
                   | st.dictionaries(st.text(max_size=40), inner, max_size=20)),
    max_leaves=60)


def _ref_pack(o):
    return msgpack.packb(o, use_bin_type=True)


def _ref_unpack(b):
    return msgpack.unpackb(b, raw=False)


@settings(max_examples=300, deadline=None)
@given(objects)
def test_packb_bytes_equal_msgpack(obj):
    want = _ref_pack(obj)
    assert codec.packb(obj) == want
    assert b"".join(codec.pack_parts(obj)) == want
    assert codec.unpackb(want) == _ref_unpack(want)


@pytest.mark.parametrize("n", INT_EDGES)
def test_int_edges(n):
    assert codec.packb(n) == _ref_pack(n)
    assert codec.unpackb(_ref_pack(n)) == n


@pytest.mark.parametrize("kind", ["str", "bin", "array", "map"])
def test_length_edges(kind):
    """Each container at the lengths where msgpack changes its header."""
    for n in LEN_EDGES:
        obj = {"str": "x" * n, "bin": b"\x01" * n, "array": [1] * n,
               "map": {f"k{i}": i for i in range(n)}}[kind]
        assert codec.packb(obj) == _ref_pack(obj), (kind, n)
        assert codec.unpackb(_ref_pack(obj)) == _ref_unpack(_ref_pack(obj))


def test_floats_and_float32_decode():
    for x in (0.0, -0.0, 1.5, math.inf, -math.inf, 1e308, 5e-324):
        assert codec.packb(x) == _ref_pack(x)
    nan = codec.unpackb(codec.packb(math.nan))
    assert math.isnan(nan) and codec.packb(math.nan) == _ref_pack(math.nan)
    f32 = msgpack.packb(1.25, use_single_float=True)
    assert f32[0] == 0xCA and codec.unpackb(f32) == 1.25


def test_large_bin_is_its_own_part():
    """A KV chunk's bytes are handed to the join, not copied into the
    staging buffer; the frame is the length prefix + msgpack's bytes."""
    blob = bytes(range(256)) * 4096  # 1 MiB
    payload = {"data": True, "k": blob, "v": blob, "n_pages": 16}
    parts = codec.pack_parts(payload)
    assert sum(p is blob for p in parts) == 2
    frame = frame_bytes({"t": "item", "id": "r", "data": payload})
    body = _ref_pack({"t": "item", "id": "r", "data": payload})
    assert frame == len(body).to_bytes(4, "big") + body
    assert codec.unpackb(body) == _ref_unpack(body)


@pytest.mark.parametrize("bad,err", [
    (object(), TypeError), ({1, 2}, TypeError), (1 << 64, OverflowError),
    (-(1 << 63) - 1, OverflowError)])
def test_unpackable_raises_like_msgpack(bad, err):
    with pytest.raises(err):
        codec.packb(bad)
    with pytest.raises(err):
        _ref_pack(bad)


@pytest.mark.parametrize("data", [
    _ref_pack({1: 2}),  # int map key: msgpack's strict_map_key refuses it
    _ref_pack([1, 2])[:-1],  # truncated
    _ref_pack(1) + b"\x00",  # trailing bytes
    b"\xc1",  # never used
])
def test_bad_bytes_raise_value_error_like_msgpack(data):
    with pytest.raises(ValueError):
        codec.unpackb(data)
    with pytest.raises(ValueError):
        _ref_unpack(data)
