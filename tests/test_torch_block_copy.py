"""The port's page-copy ops (dynamo_tpu_torch/ops/block_copy.py) against
the JAX package's Pallas kernels in interpret mode.

Inputs are f32 numpy arrays from a seed; the plain versions (what the
wrappers run on CPU tensors) must equal the Pallas kernels exactly: token-
and head-major gathers from one-layer and stacked pools, scatters into
both, and layer-group scatters at several layer offsets. The CUDA kernels
are held against the same plain versions on the card by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.ops import block_copy as jbc
from dynamo_tpu_torch.ops import block_copy as bc

L, NP, PS, HK, D = 3, 12, 4, 2, 8


def _pool(rng, stacked):
    shape = (L, NP, PS, HK, D) if stacked else (NP, PS, HK, D)
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("head_major", [False, True])
def test_gather_matches_jax(stacked, head_major):
    rng = np.random.default_rng(0)
    pool = _pool(rng, stacked)
    idx = np.array([7, 0, 3, 11, 3], np.int32)  # repeats are fine to read
    want = jbc.gather_pages(jnp.asarray(pool), jnp.asarray(idx),
                            head_major=head_major, interpret=True)
    got = bc.gather_pages(torch.from_numpy(pool), torch.from_numpy(idx),
                          head_major=head_major)
    assert got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("stacked", [False, True])
def test_scatter_matches_jax(stacked):
    rng = np.random.default_rng(1)
    pool = _pool(rng, stacked)
    idx = np.array([5, 1, 10], np.int32)
    pages = rng.standard_normal(
        ((L,) if stacked else ()) + (3, PS, HK, D)).astype(np.float32)
    want = np.asarray(jbc.scatter_pages(jnp.asarray(pool), jnp.asarray(idx),
                                        jnp.asarray(pages), interpret=True))
    t_pool = torch.from_numpy(pool.copy())
    out = bc.scatter_pages(t_pool, torch.from_numpy(idx), torch.from_numpy(pages))
    assert out is t_pool  # in place
    np.testing.assert_array_equal(t_pool.numpy(), want)


@pytest.mark.parametrize("layer_off,Lg", [(0, 1), (1, 2), (2, 1), (0, 3)])
def test_scatter_layers_matches_jax(layer_off, Lg):
    rng = np.random.default_rng(2)
    pool = _pool(rng, True)
    idx = np.array([4, 9], np.int32)
    pages = rng.standard_normal((Lg, 2, PS, HK, D)).astype(np.float32)
    off = np.array([layer_off], np.int32)
    want = np.asarray(jbc.scatter_pages_layers(
        jnp.asarray(pool), jnp.asarray(idx), jnp.asarray(pages),
        jnp.asarray(off), interpret=True))
    t_pool = torch.from_numpy(pool.copy())
    bc.scatter_pages_layers(t_pool, torch.from_numpy(idx),
                            torch.from_numpy(pages), torch.from_numpy(off))
    np.testing.assert_array_equal(t_pool.numpy(), want)
    # layers outside the group are untouched
    others = [l for l in range(L) if not layer_off <= l < layer_off + Lg]
    np.testing.assert_array_equal(t_pool.numpy()[others], pool[others])


def test_transfer_round_trip_between_pools():
    """The transfer pattern: gather pages of pool A, scatter them into
    other slots of pool B, bit for bit, in bf16 too."""
    rng = np.random.default_rng(3)
    for dtype in (torch.float32, torch.bfloat16):
        a = torch.from_numpy(_pool(rng, True)).to(dtype)
        b = torch.zeros_like(a)
        wire = bc.gather_pages(a, torch.tensor([2, 6, 8], dtype=torch.int32))
        bc.scatter_pages(b, torch.tensor([0, 4, 11], dtype=torch.int32), wire)
        assert torch.equal(b[:, [0, 4, 11]], a[:, [2, 6, 8]])
        assert not b[:, [1, 2, 3]].any()


def test_cpu_tensors_never_count_launches():
    """Launch counters move only where a kernel launches: CPU tensors run
    the plain versions."""
    before = (bc.gather_pages.launches, bc.scatter_pages.launches,
              bc.scatter_pages_layers.launches)
    pool = torch.zeros(L, NP, PS, HK, D)
    idx = torch.tensor([1, 2], dtype=torch.int32)
    pages = bc.gather_pages(pool, idx)
    bc.scatter_pages(pool, idx, pages)
    bc.scatter_pages_layers(pool, idx, pages[:1], torch.tensor([2], dtype=torch.int32))
    assert (bc.gather_pages.launches, bc.scatter_pages.launches,
            bc.scatter_pages_layers.launches) == before


def test_operand_checks():
    """What the wrappers refuse before a launch (checked here on CPU
    tensors; the same code runs on CUDA ones)."""
    pool = torch.zeros(L, NP, PS, HK, D)
    idx = torch.tensor([3, 5], dtype=torch.int32)
    bc._check(pool, idx)
    with pytest.raises(TypeError):
        bc._check(pool.to(torch.int32), idx)
    with pytest.raises(TypeError):
        bc._check(pool, idx.long())
    with pytest.raises(ValueError, match="contiguous"):
        bc._check(pool.transpose(2, 3), idx)
    with pytest.raises(ValueError, match="16-byte"):
        bc._check(torch.zeros(NP, PS, HK, 2), idx)  # 8-byte D rows
    bc._check_ids(idx, NP, unique=True)
    for bad in ([3, 12], [-1, 2]):
        with pytest.raises(ValueError, match="page ids span"):
            bc._check_ids(torch.tensor(bad, dtype=torch.int32), NP, unique=False)
    with pytest.raises(ValueError, match="unique"):
        bc._check_ids(torch.tensor([4, 1, 4], dtype=torch.int32), NP, unique=True)
    off = torch.tensor([2], dtype=torch.int32)
    bc._check_ids(idx, NP, unique=True, layer_off=off, L=L, Lg=1)
    with pytest.raises(ValueError, match="layer group"):
        bc._check_ids(idx, NP, unique=True, layer_off=off, L=L, Lg=2)
