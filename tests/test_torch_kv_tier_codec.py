"""The int8 tier codec and the block file codec of the port against the
reference's (dynamo_tpu/kvbm/quant.py, disk_pool.py encode_block /
decode_block), on numpy inputs from a seed.

The codec's scales and codes equal the reference's bit for bit on f32 and
bf16 data whose scales spread over ten decades, on zero vectors (the 1e-8
floor) and on ties at .5; the block files are the same bytes both ways;
the reference's errors for truncated and other-layout blocks are kept.
The tier codec divides by 127 and the device pool quantizer multiplies by
its reciprocal, as the reference's two do: the port keeps both.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

from dynamo_tpu.kvbm import disk_pool as rdisk
from dynamo_tpu.kvbm import quant as rq
from dynamo_tpu.models import quant as jquant
from dynamo_tpu_torch.kvbm import disk_pool as tdisk
from dynamo_tpu_torch.kvbm import quant as tq
from dynamo_tpu_torch.models import quant as tquant

BF16 = np.dtype(ml_dtypes.bfloat16)


def _data(seed, shape=(3, 4, 2, 16), decades=10):
    """Vectors whose scales spread over `decades` decades, with a zero
    vector and one whose amax sits where x / s lands on .5."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    x *= (10.0 ** rng.uniform(-decades / 2, decades / 2, shape[:-1] + (1,))).astype(np.float32)
    x[0, 0, 0] = 0.0  # the 1e-8 floor
    # ties: x / s == k + .5 exactly for s = 127 / 127 = 1
    x[0, 1, 0] = 0.0
    x[0, 1, 0, 0] = 127.0
    x[0, 1, 0, 1:4] = [2.5, -3.5, 0.5]
    return x


def _to_torch(x):
    if x.dtype == BF16:
        return torch.from_numpy(x.view(np.uint16).astype(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(x))


def _to_numpy(t):
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy().view(np.uint16).view(BF16)
    return t.numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_block_matches_reference_bit_for_bit(dtype, seed):
    x = _data(seed).astype(BF16 if dtype == "bfloat16" else np.float32)
    ref = rq.quantize_block(x)
    got = tq.quantize_block(_to_torch(x))
    assert got["dt"] == ref["dt"] == dtype
    assert got["q"].dtype == torch.int8 and got["s"].dtype == torch.float32
    np.testing.assert_array_equal(got["q"].numpy(), ref["q"])
    np.testing.assert_array_equal(got["s"].numpy().view(np.uint32),
                                  ref["s"].view(np.uint32))
    # the zero vector takes the floor's scale and all-zero codes
    assert float(got["s"][0, 0, 0]) == np.float32(np.float32(1e-8) / np.float32(127.0))
    assert not got["q"][0, 0, 0].any()
    # ties at .5 round half to even: 2.5 -> 2, -3.5 -> -4, 0.5 -> 0
    assert got["q"][0, 1, 0, :4].tolist() == ref["q"][0, 1, 0, :4].tolist() == [127, 2, -4, 0]
    back = tq.dequantize_block(got)
    want = rq.dequantize_block(ref)
    assert back.dtype == tq.dtype_of(dtype)
    np.testing.assert_array_equal(_to_numpy(back).view(np.uint8), want.view(np.uint8))
    # an explicit dtype override, by name and by torch dtype
    np.testing.assert_array_equal(
        tq.dequantize_block(got, "float32").numpy(),
        rq.dequantize_block(ref, "float32"))
    assert tq.dequantize_block(got, torch.float32).dtype == torch.float32


def test_codec_helpers_match_reference():
    x = _data(4)
    xt = torch.from_numpy(x)
    qd = tq.quantize_block(xt)
    rd = rq.quantize_block(x)
    assert tq.block_nbytes(qd) == rq.block_nbytes(rd)
    assert tq.block_nbytes(xt) == rq.block_nbytes(x)
    assert tq.block_nbytes(None) == rq.block_nbytes(None) == 0
    assert tq.pair_nbytes(qd, qd) == rq.pair_nbytes(rd, rd)
    assert tq.quantized_ratio(128) == rq.quantized_ratio(128)
    assert tq.roundtrip_error_bound(xt) == pytest.approx(rq.roundtrip_error_bound(x), rel=1e-7)
    assert tq.maybe_quantize(None) is None and tq.maybe_quantize(qd) is qd
    assert tq.maybe_dequantize(xt) is xt
    assert tq.is_quantized_block(qd) and not tq.is_quantized_block(xt)
    stacked = torch.from_numpy(np.stack([x, x + 1], axis=1))
    kb, vb = tq.stacked_to_blocks(stacked, stacked, 1)
    rk, rv = rq.stacked_to_blocks(stacked.numpy(), stacked.numpy(), 1)
    np.testing.assert_array_equal(kb.numpy(), rk)
    assert kb.is_contiguous() and kb.data_ptr() != stacked.data_ptr()
    one = stacked[:, :1].contiguous()  # one page: its block is a view
    assert tq.stacked_to_blocks(one, one, 0)[0].data_ptr() == one.data_ptr()
    # the roundtrip stays within the bound the reference states
    err = (tq.dequantize_block(qd) - xt).abs().max()
    assert float(err) <= tq.roundtrip_error_bound(xt) * (1 + 1e-6)


def test_tier_scale_differs_from_pool_quantizer_and_both_are_kept():
    """The reference's tier codec divides max(amax, 1e-8) by 127; its jitted
    pool quantizer multiplies amax by the f32 reciprocal of 127 (XLA's
    rewrite). Some vectors get scales one ulp apart; the codes agree. The
    port's codec and pool quantizer each equal their own reference."""
    rng = np.random.default_rng(11)
    x = (rng.standard_normal((512, 64)) * 10.0 ** rng.uniform(-3.5, 3.5, (512, 1))
         ).astype(np.float32)
    tier = rq.quantize_block(x)
    pool = jquant.kv_quantize(x)
    pool_s = np.asarray(pool["s"])
    differ = tier["s"].view(np.uint32) != pool_s.view(np.uint32)
    assert differ.any(), "the two reference quantizers agreed on every scale"
    assert not differ.all()
    np.testing.assert_array_equal(np.asarray(pool["q"]), tier["q"])
    # the port keeps each as its reference computes it
    got_tier = tq.quantize_block(torch.from_numpy(x))
    got_pool = tquant.kv_quantize(torch.from_numpy(x))
    np.testing.assert_array_equal(got_tier["s"].numpy().view(np.uint32),
                                  tier["s"].view(np.uint32))
    np.testing.assert_array_equal(got_pool["s"].numpy().view(np.uint32),
                                  pool_s.view(np.uint32))


def _blocks(kind, seed=3):
    """A (parent, k, v) triple of each kind for both packages."""
    x = _data(seed, shape=(2, 4, 2, 8), decades=4)
    y = _data(seed + 1, shape=(2, 4, 2, 8), decades=4)
    if kind == "f32":
        return (x, y), (torch.from_numpy(x), torch.from_numpy(y))
    xb, yb = x.astype(BF16), y.astype(BF16)
    if kind == "bf16":
        return (xb, yb), (_to_torch(xb), _to_torch(yb))
    return ((rq.quantize_block(xb), rq.quantize_block(yb)),
            (tq.quantize_block(_to_torch(xb)), tq.quantize_block(_to_torch(yb))))


@pytest.mark.parametrize("kind", ["f32", "bf16", "quant"])
@pytest.mark.parametrize("parent", [None, 12345678901234567890])
def test_block_files_are_the_same_bytes_both_ways(kind, parent):
    (rk, rv), (tk, tv) = _blocks(kind)
    ref = rdisk.encode_block(parent, rk, rv)
    got = tdisk.encode_block(parent, tk, tv)
    assert got == ref
    # each package decodes the other's bytes to the same block
    p, k, v = tdisk.decode_block(ref)
    rp, rk2, rv2 = rdisk.decode_block(got)
    assert p == rp == parent
    if kind == "quant":
        for t, r in ((k, rk2), (v, rv2)):
            assert t["dt"] == r["dt"] == "bfloat16"
            np.testing.assert_array_equal(t["q"].numpy(), r["q"])
            np.testing.assert_array_equal(t["s"].numpy(), r["s"])
        assert tdisk.encode_block(p, k, v) == ref
    else:
        np.testing.assert_array_equal(_to_numpy(k).view(np.uint8), rk2.view(np.uint8))
        np.testing.assert_array_equal(_to_numpy(v).view(np.uint8), rv2.view(np.uint8))
        assert tdisk.encode_block(p, k, v) == ref


@pytest.mark.parametrize("kind", ["bf16", "quant"])
def test_truncated_and_wrong_layout_errors_are_the_references(kind):
    (rk, rv), (tk, tv) = _blocks(kind)
    data = tdisk.encode_block(7, tk, tv)
    for cut in (len(data) - 1, len(data) - 40):
        with pytest.raises(ValueError) as ref_err:
            rdisk.decode_block(data[:cut])
        with pytest.raises(ValueError) as got_err:
            tdisk.decode_block(data[:cut])
        assert str(got_err.value) == str(ref_err.value)
        assert not isinstance(got_err.value, tdisk.BlockLayoutMismatch)
    # a block of another layout version
    hlen = int.from_bytes(data[:8], "little")
    header = data[8:8 + hlen].replace(b'"layout": 2', b'"layout": 1')
    stale = data[:8] + header + data[8 + hlen:]
    with pytest.raises(rdisk.BlockLayoutMismatch) as ref_err:
        rdisk.decode_block(stale)
    with pytest.raises(tdisk.BlockLayoutMismatch) as got_err:
        tdisk.decode_block(stale)
    assert str(got_err.value) == str(ref_err.value) == "block layout 1 != 2"
    assert tdisk.BLOCK_LAYOUT_VERSION == rdisk.BLOCK_LAYOUT_VERSION


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_device_codec_wrappers_run_the_plain_codec_on_the_cpu(dtype):
    """ops/tier_codec.py on CPU tensors is the codec: bit for bit the
    reference's, over a page-major [n, L, PS, Hk, D] batch."""
    from dynamo_tpu_torch.ops import tier_codec as tc

    x = _data(7).reshape(3, 2, 2, 2, 16).astype(BF16 if dtype == "bfloat16" else np.float32)
    before = (tc.tier_quantize.launches, tc.tier_dequantize.launches)
    q, s = tc.tier_quantize(_to_torch(x))
    ref = rq.quantize_block(x)
    np.testing.assert_array_equal(q.numpy(), ref["q"])
    np.testing.assert_array_equal(s.numpy().view(np.uint32), ref["s"].view(np.uint32))
    back = tc.tier_dequantize(q, s, tq.dtype_of(dtype))
    np.testing.assert_array_equal(_to_numpy(back).view(np.uint8),
                                  rq.dequantize_block(ref).view(np.uint8))
    assert (tc.tier_quantize.launches, tc.tier_dequantize.launches) == before


def test_device_codec_wrappers_raise_unless_on_the_cpu(monkeypatch):
    """On tensors that are not on the CPU (the meta device, with no CUDA
    toolkit) the wrappers build the kernel or raise: they never run the
    plain codec instead, and count no launch."""
    from dynamo_tpu_torch.ops import _build
    from dynamo_tpu_torch.ops import tier_codec as tc

    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda p: False)
    monkeypatch.setattr(_build, "_libs", {})
    before = (tc.tier_quantize.launches, tc.tier_dequantize.launches)
    x = torch.zeros(4, 128, dtype=torch.bfloat16, device="meta")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        tc.tier_quantize(x)
    q = torch.zeros(4, 128, dtype=torch.int8, device="meta")
    s = torch.zeros(4, dtype=torch.float32, device="meta")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        tc.tier_dequantize(q, s, torch.bfloat16)
    with pytest.raises(TypeError):
        tc.tier_quantize(x.to(torch.int32))
    with pytest.raises(ValueError, match="do not match"):
        tc.tier_dequantize(q, s[:2], torch.bfloat16)
    assert (tc.tier_quantize.launches, tc.tier_dequantize.launches) == before
