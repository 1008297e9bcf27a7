"""The MLA prefill kernel's blocks and tiles in plain PyTorch
(dynamo_tpu_torch/ops/mla_attention.py `prefill_mla_tiles_ref`): blocks of
4 query tokens x 16 heads walk 32-token latent tiles up to the block's last
causal limit, with an online softmax in base 2.

Held three ways on inputs made with numpy from a seed, at DeepSeek's widths
(d_c 512, d_rh 64) and H 16:
  - unrounded, against the plain `prefill_mla_attention_ref`, atol = rtol =
    1e-5 (the same f32 math summed in another order);
  - against the JAX package's Pallas `prefill_mla_attention` in interpret
    mode: 1e-5 unrounded, and atol 2e-2 with P rounded to bf16 as the kernel
    does (one bf16 rounding of p, relative 2^-9, over outputs of size ~1);
  - the tiles each block walked: ceil((last + 1) / 32), 0 for a block whose
    tokens are all padding.
Cases: the four of tests/test_torch_mla.py's prefill test, pages of 4, 8,
32 and 64 tokens (smaller and larger than a tile), kv_len past the chunk,
S not a multiple of 4, and q_start not a multiple of 32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.ops import mla_attention as jmla
from dynamo_tpu_torch.ops import mla_attention as mla

DC, DR, H = 512, 64, 16
SCALE = 0.045
TOL = dict(atol=1e-5, rtol=1e-5)
ROUNDED_ATOL = 2e-2

# name: (q_start, q_len, kv past the chunk, S, PS)
CASES = {
    "fresh_padded_row": ([0, 0], [8, 5], [0, 0], 8, 4),
    "chunked_prior": ([12, 4], [8, 8], [0, 0], 8, 4),
    "prior_kv_past": ([0, 16], [8, 8], [0, 3], 8, 4),
    "all_padding_row": ([5, 0], [3, 0], [0, 0], 8, 4),
    "ps8": ([33, 0], [8, 6], [0, 0], 8, 8),
    "ps32": ([70, 10], [8, 2], [0, 0], 8, 32),
    "ps64": ([100, 0], [5, 8], [20, 0], 8, 64),
    "kv_past_chunk": ([30, 0], [6, 4], [40, 5], 8, 16),
    "s_not_mult_4": ([37, 2], [11, 7], [0, 0], 11, 16),
    "q_start_37_63": ([37, 63], [8, 8], [0, 0], 8, 16),
}


def _inputs(q_start, q_len, kv_extra, S, PS, seed):
    rng = np.random.default_rng(seed)
    qs, ql = np.asarray(q_start, np.int32), np.asarray(q_len, np.int32)
    kv = qs + ql + np.asarray(kv_extra, np.int32)
    B, Dl = len(qs), DC + DR
    MP = -(-int(kv.max()) // PS) + 1  # a table tail past every kv_len
    NP = B * MP + 1
    q = rng.standard_normal((B, S, H, Dl)).astype(np.float32)
    lat = rng.standard_normal((NP, PS, 1, Dl)).astype(np.float32)
    pt = rng.permutation(NP)[: B * MP].reshape(B, MP).astype(np.int32)
    return q, lat, pt, qs, ql, kv


def _case(name):
    return _inputs(*CASES[name], seed=sorted(CASES).index(name))


def _tiles(*arrays, round_p):
    out, tiles = mla.prefill_mla_tiles_ref(*map(torch.from_numpy, arrays),
                                           dc=DC, scale=SCALE, round_p=round_p)
    return out.numpy(), tiles.numpy()


@pytest.mark.parametrize("name", sorted(CASES))
def test_tiles_ref_unrounded_matches_plain(name):
    arrays = _case(name)
    got, _ = _tiles(*arrays, round_p=False)
    want = mla.prefill_mla_attention_ref(*map(torch.from_numpy, arrays),
                                         dc=DC, scale=SCALE).numpy()
    assert got.shape == want.shape == arrays[0].shape[:3] + (DC,)
    np.testing.assert_allclose(got, want, **TOL)
    for b, n in enumerate(arrays[4]):
        assert np.all(got[b, n:] == 0.0)


@pytest.mark.parametrize("name", sorted(CASES))
def test_tiles_ref_matches_pallas(name):
    arrays = _case(name)
    want = np.asarray(jmla.prefill_mla_attention(
        *map(jnp.asarray, arrays), dc=DC, scale=SCALE, interpret=True))
    exact, _ = _tiles(*arrays, round_p=False)
    rounded, _ = _tiles(*arrays, round_p=True)
    for b, n in enumerate(arrays[4]):
        np.testing.assert_allclose(exact[b, :n], want[b, :n], **TOL)
        np.testing.assert_allclose(rounded[b, :n], want[b, :n], atol=ROUNDED_ATOL)
        assert np.all(rounded[b, n:] == 0.0) and np.all(want[b, n:] == 0.0)


@pytest.mark.parametrize("name", sorted(CASES))
def test_tiles_walked(name):
    q, lat, pt, qs, ql, kv = arrays = _case(name)
    _, tiles = _tiles(*arrays, round_p=True)
    B, S = q.shape[:2]
    n_sb = -(-S // mla.PREFILL_BLOCK_TOKENS)
    assert tiles.shape == (B, n_sb, H // mla.HEADS_PER_BLOCK)
    for b in range(B):
        for sb in range(n_sb):
            toks = [s for s in range(sb * 4, sb * 4 + 4) if s < ql[b]]
            if not toks:
                want = 0
            else:
                last = max(min(qs[b] + s, kv[b] - 1) for s in toks)
                want = -(-(last + 1) // 32)
            assert np.all(tiles[b, sb] == want), (b, sb)
