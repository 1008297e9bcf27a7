"""The port's attention ops (dynamo_tpu_torch/ops) against the JAX package.

Inputs are made with numpy from a seed and handed to both sides. The JAX
side runs the Pallas kernels in interpret mode on the CPU, as
tests/test_ops.py does; the port's wrappers, given CPU tensors, run their
plain PyTorch versions (the CUDA kernels run only on the card, where
chip_smoke.py holds them against these same plain versions). Everything
here is f32, tolerance atol = rtol = 1e-5: the same f32 math summed in a
different order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.ops.flash_prefill import prefill_paged_attention as jax_prefill
from dynamo_tpu.ops.paged_attention import decode_paged_attention as jax_decode
from dynamo_tpu_torch.ops import _build
from dynamo_tpu_torch.ops.flash_prefill import (
    prefill_paged_attention,
    prefill_paged_attention_ref,
    q_block_for,
)
from dynamo_tpu_torch.ops.paged_attention import (
    decode_paged_attention,
    decode_paged_attention_ref,
)

TOL = dict(atol=1e-5, rtol=1e-5)


def _pools(rng, NP, PS, Hk, D):
    kp = rng.standard_normal((NP, PS, Hk, D)).astype(np.float32)
    vp = rng.standard_normal((NP, PS, Hk, D)).astype(np.float32)
    return kp, vp


@pytest.mark.parametrize(
    "kv_lens", [[5, 17, 32, 1], [0, 9, 32, 16], [32, 32, 32, 32]])
def test_decode_plain_matches_jax(kv_lens):
    rng = np.random.default_rng(0)
    B, Hk, G, D, NP, PS, MP = 4, 2, 3, 32, 16, 8, 4
    q = rng.standard_normal((B, Hk, G, D)).astype(np.float32)
    kp, vp = _pools(rng, NP, PS, Hk, D)
    pt = rng.permutation(NP)[: B * MP].reshape(B, MP).astype(np.int32)
    kv = np.asarray(kv_lens, np.int32)

    ref = np.asarray(jax_decode(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(pt),
        jnp.asarray(kv), interpret=True))
    t = torch.from_numpy
    before = decode_paged_attention.launches
    out = decode_paged_attention(t(q), t(kp), t(vp), t(pt), t(kv)).numpy()
    np.testing.assert_allclose(out, ref, **TOL)
    # a kv_len = 0 row comes out 0, not NaN
    for b in np.flatnonzero(kv == 0):
        assert np.all(out[b] == 0.0)
    # CPU tensors run the plain version: no kernel launch is counted
    assert decode_paged_attention.launches == before


def test_decode_plain_ignores_table_tail():
    """Entries past kv_len may point anywhere (even shared page 0)."""
    rng = np.random.default_rng(1)
    B, Hk, G, D, NP, PS, MP = 2, 2, 2, 16, 8, 4, 4
    q = torch.from_numpy(rng.standard_normal((B, Hk, G, D)).astype(np.float32))
    kp, vp = (torch.from_numpy(a * 100) for a in _pools(rng, NP, PS, Hk, D))
    kv = torch.tensor([3, 6], dtype=torch.int32)
    pt_a = torch.tensor([[1, 2, 0, 0], [2, 4, 0, 0]], dtype=torch.int32)
    pt_b = torch.tensor([[1, 7, 6, 5], [2, 4, 6, 5]], dtype=torch.int32)
    out_a = decode_paged_attention_ref(q, kp, vp, pt_a, kv)
    out_b = decode_paged_attention_ref(q, kp, vp, pt_b, kv)
    torch.testing.assert_close(out_a, out_b, atol=0, rtol=0)


@pytest.mark.parametrize(
    "q_start,q_len,kv_extra",
    [
        ([0, 0], [16, 9], [0, 0]),  # fresh prefill, one padded seq
        ([24, 8], [16, 16], [0, 0]),  # chunked prefill (prior context)
        ([0, 40], [16, 5], [0, 3]),  # prior ctx, q_len < S, garbage tail
    ],
)
def test_prefill_plain_matches_jax(q_start, q_len, kv_extra):
    rng = np.random.default_rng(2)
    B, S, Hk, G, D, NP, PS, MP = 2, 16, 2, 3, 32, 16, 8, 8
    q = rng.standard_normal((B, S, Hk, G, D)).astype(np.float32)
    kp, vp = _pools(rng, NP, PS, Hk, D)
    pt = rng.permutation(NP)[: B * MP].reshape(B, MP).astype(np.int32)
    qs = np.asarray(q_start, np.int32)
    ql = np.asarray(q_len, np.int32)
    # kv_extra > 0: kv_len admits tokens past the last query position —
    # the causal mask (not kv_len) must exclude them
    kv = qs + ql + np.asarray(kv_extra, np.int32)

    ref = np.asarray(jax_prefill(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(pt),
        jnp.asarray(qs), jnp.asarray(ql), jnp.asarray(kv), q_block=8,
        interpret=True))
    t = torch.from_numpy
    before = prefill_paged_attention.launches
    out = prefill_paged_attention(
        t(q), t(kp), t(vp), t(pt), t(qs), t(ql), t(kv)).numpy()
    np.testing.assert_allclose(out, ref, **TOL)
    for b in range(B):  # padding rows are zero
        assert np.all(out[b, ql[b]:] == 0.0)
    assert prefill_paged_attention.launches == before


@pytest.mark.parametrize("G,want", [(1, 64), (2, 32), (3, 16), (4, 16), (8, 8)])
def test_prefill_q_block_fits_rows(G, want):
    assert q_block_for(G) == want
    assert q_block_for(G) * G <= 64


def test_prefill_plain_keeps_bf16():
    rng = np.random.default_rng(3)
    B, S, Hk, G, D, NP, PS, MP = 1, 8, 1, 2, 16, 4, 4, 2
    q = torch.from_numpy(rng.standard_normal((B, S, Hk, G, D))).bfloat16()
    kp, vp = (torch.from_numpy(a).bfloat16() for a in _pools(rng, NP, PS, Hk, D))
    pt = torch.tensor([[2, 0]], dtype=torch.int32)
    z = torch.tensor([0], dtype=torch.int32)
    out = prefill_paged_attention_ref(
        q, kp, vp, pt, z, torch.tensor([5], dtype=torch.int32),
        torch.tensor([5], dtype=torch.int32))
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    assert torch.isfinite(out.float()).all()
    assert torch.all(out[:, 5:] == 0)


def test_kernel_build_is_keyed_by_source_and_flags(monkeypatch):
    for stem in _build.SIGNATURES:
        assert (_build.CSRC / f"{stem}.cu").exists()
        path = _build.library_path(stem)
        assert path.parent == _build.BUILD_DIR and path.suffix == ".so"
        monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ["-G"])
        assert _build.library_path(stem) != path
        monkeypatch.undo()
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


def test_kernel_build_needs_nvcc(monkeypatch):
    """Where there is no nvcc, building raises instead of falling back."""
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda p: False)
    monkeypatch.setattr(_build, "_libs", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load()
