"""The two decode kernels' context split, in plain PyTorch: the GQA
decode partials (dynamo_tpu_torch/ops/paged_attention.py) and the MLA
decode partials (ops/mla_attention.py), each per context split and then
merged by log-sum-exp, against the plain decode ops and the JAX package's
Pallas decode kernels in interpret mode.

Inputs are made with numpy from a seed. Everything is f32, tolerance
atol = rtol = 1e-5: the same f32 math summed in another order. Rows sit
at kv_len split - 1, split, split + 1, 2 * split and 0 (exact zeros).
Pages of 64 tokens keep the contexts past 2 * split to a few page-table
columns, so the interpret-mode kernels stay quick.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.ops import mla_attention as jmla
from dynamo_tpu.ops.paged_attention import decode_paged_attention as jax_decode
from dynamo_tpu_torch.models.toolkit import NEG_INF
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


@pytest.mark.parametrize("max_pages,page_size,split,want", [
    (256, 16, 256, 16), (1, 16, 256, 1), (16, 16, 256, 1), (17, 16, 256, 2),
    (9, 64, 256, 3), (256, 16, 512, 8)])
def test_decode_split_count_follows_the_table_width(max_pages, page_size,
                                                     split, want):
    assert pa.decode_split_count(max_pages, page_size, split) == want
    assert pa.DECODE_SPLIT_TOKENS % 64 == 0  # whole 64-token tiles
    assert mla.MLA_SPLIT_TOKENS % 32 == 0  # whole 32-token tiles
