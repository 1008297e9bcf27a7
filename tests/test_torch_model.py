"""The port's model (dynamo_tpu_torch/models) against the JAX package.

The tiny config runs in f32 with the JAX init_params tree carried across
by params_from_numpy. One script of steps (a two-sequence prefill, a
second chunk over that prior context with padding rows, two decode steps
with a padding row) goes through JAX `llama.forward(attn_impl="jnp")` and
the port's `forward`, on both of the port's attention paths. Logits must
agree to atol 1e-4 and the written KV pools to atol 1e-5 (f32 math in
another order; the logits sum over a 64-wide residual stream).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.models import llama as jllama
from dynamo_tpu.models.config import get_config as jax_get_config
from dynamo_tpu.models.toolkit import rope as jax_rope
from dynamo_tpu.models.toolkit import rope_inv_freq as jax_rope_inv_freq
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.models import llama
from dynamo_tpu_torch.models.config import PRESETS, get_config
from dynamo_tpu_torch.models.toolkit import make_kv_pool, rope, rope_inv_freq_np

NP, PS, MP = 16, 4, 8
PAGES = np.array([[3, 7, 1, 12, 9, 0, 0, 0],
                  [5, 2, 14, 8, 11, 6, 4, 0],
                  [0, 0, 0, 0, 0, 0, 0, 0]], np.int32)


def _steps(rng, V):
    """(tokens [B, S], positions [B, S], page rows, kv_lens, last_index)."""
    steps = []
    # 1. fresh prefill of both sequences (seq 0 padded past 10 tokens)
    pos = np.full((2, 16), -1, np.int32)
    pos[0, :10] = np.arange(10)
    pos[1, :16] = np.arange(16)
    steps.append((pos, [0, 1], [10, 16], None))
    # 2. a second chunk over that prior context, per-row last positions
    pos = np.full((2, 8), -1, np.int32)
    pos[0, :5] = np.arange(10, 15)
    pos[1, :8] = np.arange(16, 24)
    steps.append((pos, [0, 1], [15, 24], np.array([4, 7], np.int32)))
    # 3-4. two decode steps, third row is bucket padding
    for t in range(2):
        pos = np.array([[15 + t], [24 + t], [-1]], np.int32)
        steps.append((pos, [0, 1, 2], [16 + t, 25 + t, 0], None))
    out = []
    for pos, rows, kvl, last in steps:
        tok = rng.integers(0, V, size=pos.shape).astype(np.int32)
        out.append((tok, pos, PAGES[rows], np.asarray(kvl, np.int32), last))
    return out


@pytest.fixture(scope="module")
def tiny():
    cfg = jax_get_config("tiny")
    params = jax.device_get(jllama.init_params(cfg, jax.random.PRNGKey(0),
                                               jnp.float32))
    return cfg, params


@pytest.mark.parametrize("attn_impl", ["kernel", "ref"])
def test_forward_matches_jax(tiny, attn_impl):
    jcfg, jparams = tiny
    cfg = get_config("tiny")
    tparams = params_from_numpy(jparams, cfg, "cpu", torch.float32)
    jk, jv = jllama.make_kv_pool(jcfg, NP, PS, jnp.float32)
    # one extra page: the port writes padding rows there
    tk, tv = make_kv_pool(cfg, NP + 1, PS, torch.float32, "cpu")
    rng = np.random.default_rng(0)
    t = torch.from_numpy
    for tok, pos, pt, kvl, last in _steps(rng, cfg.vocab_size):
        jl, jk, jv = jllama.forward(
            jcfg, jparams, jnp.asarray(tok), jnp.asarray(pos), jk, jv,
            jnp.asarray(pt), jnp.asarray(kvl),
            None if last is None else jnp.asarray(last), attn_impl="jnp")
        tl = llama.forward(
            cfg, tparams, t(tok), t(pos), tk, tv, t(pt), t(kvl),
            None if last is None else t(last), attn_impl=attn_impl)
        jl = np.asarray(jl)
        tl = tl.numpy()
        assert tl.shape == jl.shape and tl.dtype == np.float32
        # padding rows differ by design (JAX's gather path attends them to
        # position 0, the port's prefill op zeroes them): compare real rows
        real = pos >= 0 if last is None else np.ones((pos.shape[0], 1), bool)
        if pos.shape[1] == 1:
            real = np.ones_like(real)  # decode padding rows: both give 0 attn
        np.testing.assert_allclose(tl[real], jl[real], atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(tk[:, :NP].numpy(), np.asarray(jk), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tv[:, :NP].numpy(), np.asarray(jv), atol=1e-5, rtol=1e-5)


def test_forward_tied_embeddings_match_jax():
    jcfg = jax_get_config("tiny").with_(tie_embeddings=True)
    cfg = get_config("tiny").with_(tie_embeddings=True)
    jparams = jax.device_get(jllama.init_params(jcfg, jax.random.PRNGKey(1),
                                                jnp.float32))
    assert "lm_head" not in jparams
    tparams = params_from_numpy(jparams, cfg, "cpu", torch.float32)
    jk, jv = jllama.make_kv_pool(jcfg, NP, PS, jnp.float32)
    tk, tv = make_kv_pool(cfg, NP + 1, PS, torch.float32, "cpu")
    tok, pos, pt, kvl, _ = _steps(np.random.default_rng(1), cfg.vocab_size)[0]
    jl, _, _ = jllama.forward(jcfg, jparams, jnp.asarray(tok), jnp.asarray(pos),
                              jk, jv, jnp.asarray(pt), jnp.asarray(kvl),
                              jnp.int32(9), attn_impl="jnp")
    t = torch.from_numpy
    tl = llama.forward(cfg, tparams, t(tok), t(pos), tk, tv, t(pt), t(kvl), 9)
    np.testing.assert_allclose(tl[0].numpy(), np.asarray(jl)[0], atol=1e-4, rtol=1e-4)


def test_presets_match_jax_configs():
    for name, cfg in PRESETS.items():
        ref = jax_get_config(name)
        for f in cfg.__dataclass_fields__:
            assert getattr(cfg, f) == getattr(ref, f), (name, f)
        assert cfg.head_dim == ref.head_dim


@pytest.mark.parametrize("name", ["tiny", "llama-3.2-3b", "llama-3.1-8b"])
def test_rope_inv_freq_matches_jax(name):
    cfg, ref = get_config(name), jax_get_config(name)
    np.testing.assert_array_equal(
        rope_inv_freq_np(cfg, cfg.head_dim, cfg.rope_theta),
        np.asarray(jax_rope_inv_freq(ref, ref.head_dim, ref.rope_theta)))


@pytest.mark.parametrize("name", ["tiny", "llama-3.2-3b"])
def test_rope_matches_jax(name):
    """f32 rotation at positions up to the 4096-token context: same
    tables, same half-rotation (atol covers cos/sin of large angles)."""
    cfg, ref = get_config(name), jax_get_config(name)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 3, cfg.head_dim)).astype(np.float32)
    pos = rng.integers(0, 4096, size=(2, 5)).astype(np.int32)
    want = np.asarray(jax_rope(jnp.asarray(x), jnp.asarray(pos),
                               ref.rope_theta, config=ref))
    got = rope(torch.from_numpy(x), torch.from_numpy(pos), cfg.rope_theta,
               config=cfg).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-5)


def test_params_from_numpy_checks_shapes(tiny):
    _, jparams = tiny
    bad = dict(jparams, layers=dict(jparams["layers"]))
    bad["layers"]["wq"] = np.zeros((1, 2, 3), np.float32)
    with pytest.raises(ValueError, match="wq"):
        params_from_numpy(bad, get_config("tiny"), "cpu")
    missing = dict(jparams)
    del missing["norm_f"]
    with pytest.raises(KeyError, match="norm_f"):
        params_from_numpy(missing, get_config("tiny"), "cpu")
    ok = params_from_numpy(jparams, get_config("tiny"), "cpu", torch.bfloat16)
    assert ok["layers"]["wq"].dtype == torch.bfloat16
    assert ok["layers"]["attn_norm"].dtype == torch.float32  # norms stay f32
