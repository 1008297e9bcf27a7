"""The two decode kernels' context split, in plain PyTorch: the GQA
decode partials (dynamo_tpu_torch/ops/paged_attention.py) and the MLA
decode partials (ops/mla_attention.py), each per context split and then
merged by log-sum-exp, against the plain decode ops and the JAX package's
Pallas decode kernels in interpret mode.

Inputs are made with numpy from a seed. Everything is f32, tolerance
atol = rtol = 1e-5: the same f32 math summed in another order. Rows sit
at kv_len split - 1, split, split + 1, 2 * split and 0 (exact zeros).
Pages of 64 tokens keep the contexts past 2 * split to a few page-table
columns, so the interpret-mode kernels stay quick. Over int8 pools the GQA
kernel splits at its own split (decode_split_tokens), which the plain
partials and the wrapper's scratch and launch follow.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.ops import mla_attention as jmla
from dynamo_tpu.ops.paged_attention import decode_paged_attention as jax_decode
from dynamo_tpu_torch.models.toolkit import NEG_INF
from dynamo_tpu_torch.ops import _build
from dynamo_tpu_torch.ops import mla_attention as mla
from dynamo_tpu_torch.ops import paged_attention as pa

TOL = dict(atol=1e-5, rtol=1e-5)
PS = 64


def _edges(split):
    return [split - 1, split, split + 1, 2 * split, 0]


def _pages(rng, B, MP):
    NP = B * MP + 1
    return NP, rng.permutation(NP)[: B * MP].reshape(B, MP).astype(np.int32)


@pytest.mark.parametrize("G,D", [(1, 16), (3, 32), (8, 16)])
def test_gqa_decode_split_merge_matches_plain_and_jax(G, D):
    split = pa.DECODE_SPLIT_TOKENS
    kv = np.asarray(_edges(split), np.int32)
    B, Hk = len(kv), 2
    MP = -(-(2 * split + 1) // PS)  # 3 splits of the table's width
    rng = np.random.default_rng(40 + G)
    NP, pt = _pages(rng, B, MP)
    q = rng.standard_normal((B, Hk, G, D)).astype(np.float32)
    kp = rng.standard_normal((NP, PS, Hk, D)).astype(np.float32)
    vp = rng.standard_normal((NP, PS, Hk, D)).astype(np.float32)
    t = [torch.from_numpy(a) for a in (q, kp, vp, pt, kv)]
    m, l, o = pa.decode_split_partials_ref(*t)
    assert m.shape == (pa.decode_split_count(MP, PS), B, Hk, G)
    assert o.shape == (3, B, Hk, G, D)
    got = pa.merge_split_partials_ref(m, l, o).numpy()
    want = pa.decode_paged_attention(*t).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    jax_out = np.asarray(jax_decode(*map(jnp.asarray, (q, kp, vp, pt, kv)),
                                    interpret=True))
    np.testing.assert_allclose(got, jax_out, **TOL)
    assert np.all(got[kv == 0] == 0.0)  # not NaN


def test_gqa_decode_partials_of_splits_a_row_cannot_see():
    """A row of kv_len split has no key in split 1: m = -1e30, l = 0,
    o = 0 there, so the merge weighs it exactly 0; kv_len split + 1 sees
    one key of split 1; the kv_len-0 row sees none anywhere."""
    split = pa.DECODE_SPLIT_TOKENS
    rng = np.random.default_rng(41)
    kv = np.asarray(_edges(split), np.int32)
    MP = -(-(2 * split + 1) // PS)
    NP, pt = _pages(rng, len(kv), MP)
    q = rng.standard_normal((len(kv), 1, 2, 16)).astype(np.float32)
    kp = rng.standard_normal((NP, PS, 1, 16)).astype(np.float32)
    m, l, o = pa.decode_split_partials_ref(*map(torch.from_numpy, (q, kp, kp, pt, kv)))
    assert torch.all(m[1, :2] == NEG_INF) and torch.all(l[1, :2] == 0)
    assert torch.all(o[1, :2] == 0)
    assert torch.all(l[1, 2] > 0) and torch.all(l[2, :4] == 0)
    assert torch.all(l[:, 4] == 0) and torch.all(m[:, 4] == NEG_INF)


def _int8_pool(rng, NP, Hk, D):
    """Random codes with scales log-uniform in [0.004, 0.02], as
    tests/test_torch_kv_int8.py draws them."""
    return {"q": rng.integers(-127, 128, (NP, PS, Hk, D)).astype(np.int8),
            "s": np.exp(rng.uniform(np.log(0.004), np.log(0.02), (NP, PS, Hk)))
            .astype(np.float32)}


@pytest.mark.parametrize("window", [None, 100], ids=["global", "window_100"])
@pytest.mark.parametrize("D", [64, 96, 128, 256])
def test_gqa_int8_decode_split_merge_matches_plain_and_jax(D, window):
    """The int8 kernel's split (decode_split_tokens(D, True)): the plain
    partials at that split (their default for int8 pools) merged equal the
    unsplit plain int8 op and the Pallas int8 body, with rows ending one
    before, at and one past the split and at twice it; a 100-token window
    puts rows split + 1 and 2 split across a split edge."""
    split = pa.decode_split_tokens(D, True)
    kv = np.asarray(_edges(split), np.int32)
    B, Hk, G = len(kv), 1, 2
    MP = -(-(2 * split + 1) // PS)
    rng = np.random.default_rng(60 + D)
    NP, pt = _pages(rng, B, MP)
    q = (rng.standard_normal((B, Hk, G, D)) * (16 / D) ** 0.5).astype(np.float32)
    kp, vp = _int8_pool(rng, NP, Hk, D), _int8_pool(rng, NP, Hk, D)
    t = [torch.from_numpy(q), {k: torch.from_numpy(v) for k, v in kp.items()},
         {k: torch.from_numpy(v) for k, v in vp.items()}, torch.from_numpy(pt),
         torch.from_numpy(kv)]
    m, l, o = pa.decode_split_partials_ref(*t, window=window)
    assert m.shape == (pa.decode_split_count(MP, PS, split), B, Hk, G)
    got = pa.merge_split_partials_ref(m, l, o).numpy()
    want = pa.decode_paged_attention(*t, window).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    jax_out = np.asarray(jax_decode(
        jnp.asarray(q), {k: jnp.asarray(v) for k, v in kp.items()},
        {k: jnp.asarray(v) for k, v in vp.items()}, jnp.asarray(pt), jnp.asarray(kv),
        None if window is None else jnp.int32(window), interpret=True))
    np.testing.assert_allclose(got, jax_out, **TOL)
    assert np.all(got[kv == 0] == 0.0)


class _FakeLibrary:
    """Stands in for the built library: records decode's arguments."""

    def __init__(self):
        self.calls = []

    def decode_paged_attention(self, *args):
        self.calls.append(args)
        return 0


@pytest.mark.parametrize("int8", [True, False], ids=["int8", "bf16"])
@pytest.mark.parametrize("D", [64, 96, 128, 256])
def test_decode_wrapper_takes_its_pools_split(monkeypatch, D, int8):
    """The wrapper's scratch and the kernel's split and pool size (meta
    tensors, a recording library in place of the build): an int8 pool
    launches at decode_split_tokens(D, True) over decode_split_count(MP,
    PS, that split) splits, a bf16 one at DECODE_SPLIT_TOKENS."""
    fake = _FakeLibrary()
    monkeypatch.setattr(_build, "load", lambda: {"paged_attention": fake})
    monkeypatch.setattr(pa.torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 7})())
    B, Hk, G, NP, PS16, MP = 3, 2, 4, 37, 16, 40
    meta = dict(device="meta")
    if int8:
        pool = {"q": torch.zeros(NP, PS16, Hk, D, dtype=torch.int8, **meta),
                "s": torch.zeros(NP, PS16, Hk, dtype=torch.float32, **meta)}
    else:
        pool = torch.zeros(NP, PS16, Hk, D, dtype=torch.bfloat16, **meta)
    q = torch.zeros(B, Hk, G, D, dtype=torch.bfloat16, **meta)
    pt = torch.zeros(B, MP, dtype=torch.int32, **meta)
    kvl = torch.zeros(B, dtype=torch.int32, **meta)
    scratch = []
    empty = torch.empty

    def recording_empty(*shape, **kw):  # the wrapper's f32 scratch
        if kw.get("dtype") == torch.float32:
            scratch.append(tuple(shape[0]) if len(shape) == 1 else shape)
        return empty(*shape, **kw)

    monkeypatch.setattr(pa.torch, "empty", recording_empty)
    out = pa.decode_paged_attention(q, pool, pool, pt, kvl)
    assert out.shape == q.shape
    split = pa.decode_split_tokens(D, int8)
    assert split == (pa.DECODE_INT8_SPLIT_TOKENS[D] if int8 else pa.DECODE_SPLIT_TOKENS)
    (args,) = fake.calls
    assert args[9:] == (B, Hk, G, D, PS16, MP, NP, split, 0, D ** -0.5, 0.0, 7)
    assert (args[2] is None) == (not int8) and (args[4] is None) == (not int8)
    assert scratch == [(pa.decode_split_count(MP, PS16, split), B, Hk, G, D + 4)]


@pytest.mark.parametrize("H", [4, 16])
def test_mla_decode_split_merge_matches_plain_and_jax(H):
    split = mla.MLA_SPLIT_TOKENS
    kv = np.asarray(_edges(split), np.int32)
    B, dc, dr = len(kv), 32, 16
    MP = -(-(2 * split + 1) // PS)
    rng = np.random.default_rng(50 + H)
    NP, pt = _pages(rng, B, MP)
    q = rng.standard_normal((B, H, dc + dr)).astype(np.float32)
    lat = rng.standard_normal((NP, PS, 1, dc + dr)).astype(np.float32)
    scale = (24 + dr) ** -0.5
    t = [torch.from_numpy(a) for a in (q, lat, pt, kv)]
    m, l, o = mla.decode_mla_split_partials_ref(*t, dc=dc, scale=scale)
    assert m.shape == (3, B, H) and o.shape == (3, B, H, dc)
    got = pa.merge_split_partials_ref(m, l, o).numpy()
    want = mla.decode_mla_attention(*t, dc=dc, scale=scale).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    jax_out = np.asarray(jmla.decode_mla_attention(
        *map(jnp.asarray, (q, lat, pt, kv)), dc=dc, scale=scale, interpret=True))
    np.testing.assert_allclose(got, jax_out, **TOL)
    assert np.all(got[kv == 0] == 0.0)


def test_mla_int8_decode_split_merge_matches_jax():
    """The int8 kernel's own split (MLA_INT8_SPLIT_TOKENS): the plain
    partials at that split over the int8 dict, merged, equal the unsplit
    plain int8 op and the Pallas int8 body in interpret mode, with rows at
    the edges of the split and of a 64-token tile (one before, at, one
    past), a zero-length row and a one-token row."""
    split, tile = mla.MLA_INT8_SPLIT_TOKENS, mla.INT8_TILE_TOKENS
    kv = np.asarray([0, 1, tile - 1, tile, tile + 1, split - 1, split, split + 1,
                     2 * split + 1], np.int32)
    B, H, dc, dr = len(kv), 4, 32, 16
    MP = -(-(2 * split + 1) // PS)
    rng = np.random.default_rng(70)
    NP, pt = _pages(rng, B, MP)
    q = (rng.standard_normal((B, H, dc + dr)) * (16 / (dc + dr)) ** 0.5).astype(np.float32)
    lat = {"q": rng.integers(-127, 128, (NP, PS, 1, dc + dr)).astype(np.int8),
           "s": np.exp(rng.uniform(np.log(0.004), np.log(0.02), (NP, PS, 1)))
           .astype(np.float32)}
    scale = (dc + dr) ** -0.5
    t = [torch.from_numpy(q), {k: torch.from_numpy(v) for k, v in lat.items()},
         torch.from_numpy(pt), torch.from_numpy(kv)]
    m, l, o = mla.decode_mla_split_partials_ref(*t, dc=dc, scale=scale, split=split)
    assert o.shape == (pa.decode_split_count(MP, PS, split), B, H, dc)
    got = pa.merge_split_partials_ref(m, l, o).numpy()
    np.testing.assert_allclose(got, mla.decode_mla_attention(*t, dc=dc, scale=scale).numpy(),
                               **TOL)
    jax_out = np.asarray(jmla.decode_mla_attention(
        jnp.asarray(q), {k: jnp.asarray(v) for k, v in lat.items()}, jnp.asarray(pt),
        jnp.asarray(kv), dc=dc, scale=scale, interpret=True))
    np.testing.assert_allclose(got, jax_out, **TOL)
    assert np.all(got[kv == 0] == 0.0)


class _FakeMlaLibrary:
    """Stands in for the built library: records MLA decode's arguments."""

    def __init__(self):
        self.calls = []

    def decode_mla_attention(self, *args):
        self.calls.append(args)
        return 0


@pytest.mark.parametrize("int8", [True, False], ids=["int8", "bf16"])
def test_mla_decode_wrapper_takes_its_pools_split(monkeypatch, int8):
    """The MLA wrapper's scratch and the kernel's split and pool size (meta
    tensors, a recording library in place of the build): an int8 pool
    launches at MLA_INT8_SPLIT_TOKENS over decode_split_count(MP, PS, that
    split) splits with its scales and the pool's pages (NP, for the
    kernel's tensor map), a bf16 one at MLA_SPLIT_TOKENS with no scales."""
    fake = _FakeMlaLibrary()
    monkeypatch.setattr(_build, "load", lambda: {"mla_attention": fake})
    monkeypatch.setattr(mla.torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 7})())
    B, H, NP, PS16, MP = 3, 32, 37, 16, 40
    dc, dr = mla.KERNEL_DIMS
    meta = dict(device="meta")
    if int8:
        pool = {"q": torch.zeros(NP, PS16, 1, dc + dr, dtype=torch.int8, **meta),
                "s": torch.zeros(NP, PS16, 1, dtype=torch.float32, **meta)}
    else:
        pool = torch.zeros(NP, PS16, 1, dc + dr, dtype=torch.bfloat16, **meta)
    q = torch.zeros(B, H, dc + dr, dtype=torch.bfloat16, **meta)
    pt = torch.zeros(B, MP, dtype=torch.int32, **meta)
    kvl = torch.zeros(B, dtype=torch.int32, **meta)
    scratch = []
    empty = torch.empty

    def recording_empty(*shape, **kw):  # the wrapper's f32 scratch
        if kw.get("dtype") == torch.float32:
            scratch.append(tuple(shape[0]) if len(shape) == 1 else shape)
        return empty(*shape, **kw)

    monkeypatch.setattr(mla.torch, "empty", recording_empty)
    out = mla.decode_mla_attention(q, pool, pt, kvl, dc=dc, scale=0.125)
    assert out.shape == (B, H, dc)
    split = mla.mla_split_tokens(int8)
    assert split == (mla.MLA_INT8_SPLIT_TOKENS if int8 else mla.MLA_SPLIT_TOKENS)
    (args,) = fake.calls
    assert args[7:] == (B, H, dc, dr, PS16, MP, NP, split, 0.125, 7)
    assert (args[2] is None) == (not int8)
    assert scratch == [(pa.decode_split_count(MP, PS16, split), B, H, dc + 4)]


@pytest.mark.parametrize("max_pages,page_size,split,want", [
    (256, 16, 256, 16), (1, 16, 256, 1), (16, 16, 256, 1), (17, 16, 256, 2),
    (9, 64, 256, 3), (256, 16, 512, 8)])
def test_decode_split_count_follows_the_table_width(max_pages, page_size,
                                                     split, want):
    assert pa.decode_split_count(max_pages, page_size, split) == want
    assert pa.DECODE_SPLIT_TOKENS % 64 == 0  # whole 64-token tiles
    assert all(s % 64 == 0 for s in pa.DECODE_INT8_SPLIT_TOKENS.values())
    assert sorted(pa.DECODE_INT8_SPLIT_TOKENS) == list(pa.KERNEL_HEAD_DIMS)
    assert mla.MLA_SPLIT_TOKENS % 32 == 0  # whole 32-token tiles
    # the int8 kernel's split: whole 64-token tiles
    assert mla.MLA_INT8_SPLIT_TOKENS % mla.INT8_TILE_TOKENS == 0
    assert mla.mla_split_tokens(True) == mla.MLA_INT8_SPLIT_TOKENS
    assert mla.mla_split_tokens(False) == mla.MLA_SPLIT_TOKENS
