"""The ragged kernel's context split, in plain PyTorch
(dynamo_tpu_torch/ops/ragged_paged_attention.py): partials per
SPLIT_TOKENS-long context split, then the log-sum-exp merge, against the
plain ragged attention and, through it, the JAX package's Pallas kernel
in interpret mode.

Inputs are made with numpy from a seed. Everything is f32, tolerance
atol = rtol = 1e-5: the same f32 math summed in another order. Pages of
64 tokens keep the contexts past 2 * SPLIT_TOKENS to a few page-table
columns, so the interpret-mode kernel stays quick.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.ops import ragged_paged_attention as jrag
from dynamo_tpu_torch.models.toolkit import NEG_INF
from dynamo_tpu_torch.ops import ragged_paged_attention as rag

TOL = dict(atol=1e-5, rtol=1e-5)
L_S = rag.SPLIT_TOKENS
PS, MP, Hk, G, D = 64, 18, 2, 2, 16  # 1152 addressable tokens: 3 splits

# (q_lens, q_starts, kv_lens, t_bucket); kv_len = start + q_len unless
# the layout says otherwise
LAYOUTS = {
    # decode rows whose last position is at a split boundary or beside it
    "boundary": ([1, 1, 1, 1], [L_S - 2, L_S - 1, L_S, 2 * L_S - 1],
                 [L_S - 1, L_S, L_S + 1, 2 * L_S], 8),
    # an 8-token chunk from L_S - 3: its rows straddle the boundary, and
    # the first three see no key in split 1
    "straddle": ([8, 1], [L_S - 3, 100], [L_S + 5, 101], 16),
    # one q block whose last row alone reaches split 1
    "no_key_in_split": ([8], [L_S - 7], [L_S + 1], 8),
    # the second segment's kv_len is forced to 0: its rows come out 0
    "kv_len_0": ([1, 3, 1], [700, 40, 1100], [701, 0, 1101], 8),
    # a decode row over two splits, a chunk, and the dummy tail segment
    "tail": ([1, 5], [1000, 600], [1001, 605], 16),
}


def _case(layout, seed):
    q_lens, q_starts, kv_lens, tb = LAYOUTS[layout]
    rng = np.random.default_rng(seed)
    NP = len(q_lens) * MP + 1
    perm = rng.permutation(NP)
    rows = [perm[i * MP:(i + 1) * MP].astype(np.int32).tolist()
            for i in range(len(q_lens))]
    md = rag.build_ragged_metadata(q_lens, q_starts, kv_lens, rows, tb,
                                   max_pages=MP)
    q = rng.standard_normal((tb, Hk, G, D)).astype(np.float32)
    kp = rng.standard_normal((NP, PS, Hk, D)).astype(np.float32)
    vp = rng.standard_normal((NP, PS, Hk, D)).astype(np.float32)
    ops = [md[k] for k in ("seg_page_table", "seg_kv_lens", "meta")]
    return (q, kp, vp, *ops), sum(q_lens)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_split_merge_matches_plain_and_jax(layout):
    args, n = _case(layout, 30)
    t = [torch.from_numpy(a) for a in args]
    m, l, o = rag.ragged_split_partials_ref(*t)
    got = rag.merge_split_partials_ref(m, l, o).numpy()
    want = rag.ragged_paged_attention_ref(*t).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    jax_out = np.asarray(jrag.ragged_paged_attention(
        *map(jnp.asarray, args), interpret=True))
    np.testing.assert_allclose(want, jax_out, **TOL)
    assert np.all(got[n:] == 0.0)  # tail rows: exactly 0, not NaN
    kv_lens = LAYOUTS[layout][2]
    seg_of = np.repeat(np.arange(len(kv_lens)), LAYOUTS[layout][0])
    for i in np.flatnonzero(np.asarray(kv_lens)[seg_of] == 0):
        assert np.all(got[i] == 0.0)  # a segment with no context


def test_split_partials_of_a_split_a_row_cannot_see():
    """The straddling chunk's first three rows (positions L_S - 3 ..
    L_S - 1) have no key in split 1: m = -1e30, l = 0, o = 0 there, so
    the merge weighs that split exactly 0; its later rows do see split 1."""
    args, _ = _case("straddle", 31)
    m, l, o = rag.ragged_split_partials_ref(*map(torch.from_numpy, args))
    assert m.shape == (3, 16, Hk, G) and o.shape == (3, 16, Hk, G, D)
    assert torch.all(m[1, :3] == NEG_INF) and torch.all(l[1, :3] == 0)
    assert torch.all(o[1, :3] == 0)
    assert torch.all(l[1, 3:8] > 0)
    assert torch.all(l[2, :8] == 0)  # nothing past 2 * L_S is visible
    assert torch.all(l[0, :8] > 0)


@pytest.mark.parametrize("max_pages,page_size,want", [
    (256, 16, 8), (1, 16, 1), (32, 16, 1), (33, 16, 2), (18, 64, 3)])
def test_split_count_follows_the_table_width(max_pages, page_size, want):
    assert rag.split_count(max_pages, page_size) == want
    assert L_S % 64 == 0  # a whole number of the kernel's 64-token tiles


def test_split_scratch_shape():
    # the chip engine's step: T 264 (NW 130), Hk 8, G 3, D 128, 256 pages of 16
    nw = rag.ragged_work_cap(264)
    assert rag.split_scratch_shape(nw, 8, 3, 128, 256, 16) == (8, 130, 8, 24, 132)
    assert rag.split_scratch_shape(10, 2, 8, 64, 4, 16, q_block=4) == (1, 10, 2, 32, 68)
