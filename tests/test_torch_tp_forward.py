"""Tensor parallelism with ranks as processes, on the CPU: one forward pass
at TP 2 against the JAX package, for every dense family whose KV heads
divide by 2 and for the MLA and MoE presets (against the JAX runner at
`MeshConfig(model=2)`), and int8 pools written per rank (the engine:
tests/test_torch_tp.py; the KV wire and the worker:
tests/test_torch_tp_served.py).

One follower (rank 1) is spawned for the module and serves every runner
the tests build through parallel/group.py MirroredRunner (rank 0 is this
process); gloo carries the collectives. The JAX side runs as its own tests
run it, with `MeshConfig(model=2)` on the host CPU devices of
tests/conftest.py. Params are the JAX init trees at f32, carried across
with params_from_numpy; each rank cuts its own slices.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.model_runner import ModelRunner as JaxRunner
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.models.config import ModelConfig as JaxConfig
from dynamo_tpu.models.config import get_config as jax_get_config
from dynamo_tpu.parallel.mesh import MeshConfig as JaxMesh
from dynamo_tpu_torch.engine.model_runner import ModelRunner
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.models.config import ModelConfig, get_config
from dynamo_tpu_torch.parallel.group import (
    MirroredRunner,
    shutdown_followers,
    spawn_followers,
)

pytestmark = pytest.mark.skipif(len(jax.devices()) < 2, reason="needs 2 CPU devices")

PS = 4
GEOMETRY = dict(num_pages=96, page_size=PS, max_pages_per_seq=16,
                decode_buckets=(1, 2, 4, 8), prefill_buckets=(8, 16, 32))
_rng = np.random.default_rng(7)
PROMPTS = [_rng.integers(1, 500, size=n).tolist() for n in (6, 4, 9, 5, 13)]


@pytest.fixture(scope="module")
def group():
    g, procs = spawn_followers(2, "cpu")
    yield g, procs
    assert shutdown_followers(g, procs) == [0]


def _jtree(jcfg, seed):
    return jax.device_get(jllama.init_params(jcfg, jax.random.PRNGKey(seed), jnp.float32))


def _tp_runner(group, cfg, jp, **kw):
    g, procs = group
    return MirroredRunner(g, procs, config=cfg, device="cpu", dtype=torch.float32,
                          params=params_from_numpy(jp, cfg, "cpu", torch.float32),
                          **dict(GEOMETRY, **kw))


# -- the forward pass --------------------------------------------------------------
# the dense families whose KV heads divide by 2: Llama, Qwen2 (biases),
# Qwen3 (per-head qk-norm), Gemma-2 (tied head, caps, window, post norms),
# Gemma-3 (per-layer window, dual RoPE), OLMo-2 (full-width qk-norm, post
# norms only), Granite (multipliers)
FAMILIES = {
    "tiny": None, "tiny-qwen2": None, "tiny-qwen3": None, "tiny-gemma2": None,
    "tiny-gemma3": None,
    "olmo2": dict(qk_norm=True, qk_norm_wide=True, pre_norms=False, post_norms=True),
    "granite": dict(embed_multiplier=12.0, residual_multiplier=0.22, attn_scale=0.0078125,
                    logits_divider=8.0, tie_embeddings=True),
}


def _family(name):
    kw = FAMILIES[name]
    if kw is None:
        return jax_get_config(name), get_config(name)
    kw = dict(name=f"tiny-{name}", **kw)
    return JaxConfig(**kw), ModelConfig(**kw)


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_forward_logits_and_rank_pools_match_jax(group, name):
    """A prefill chunk and a decode step at TP 2: the logits equal the JAX
    runner's single-device pass, each rank's pools its head slice of the
    JAX runner's."""
    jcfg, cfg = _family(name)
    jp = _jtree(jcfg, 1)
    jrun = JaxRunner(jcfg, params=jp, dtype=jnp.float32, **GEOMETRY)
    trun = _tp_runner(group, cfg, jp)
    try:
        prompt, table = PROMPTS[4], [5, 2, 9, 11]
        want = np.asarray(jrun.prefill(prompt, 0, table, 0))
        got = trun.prefill(prompt, 0, table, 0).numpy()
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
        tok = int(np.argmax(want))
        samp = {"temperature": [0.0], "top_k": [0], "top_p": [1.0], "seeds": [0]}
        jt = jrun.decode_multi(3, [tok], [len(prompt)], [table], samp, 0)
        tt = trun.decode_multi(3, [tok], [len(prompt)], [table], samp, 0)
        np.testing.assert_array_equal(tt, np.asarray(jt))
        pools = trun.rank_pools()
        hk = cfg.n_kv_heads // 2
        for r, rp in enumerate(pools):
            for key, jpool in (("k", jrun.k_pool), ("v", jrun.v_pool)):
                ref = np.asarray(jpool)[:, table][..., r * hk:(r + 1) * hk, :]
                np.testing.assert_allclose(rp[key][:, table], ref, atol=1e-5, rtol=1e-5)
        reps = trun.rank_reports()
        assert reps[0]["digest"] == reps[1]["digest"] and reps[1]["outputs"] == 1
        assert reps[1]["stats"]["prefill_chunks"] == 1 and reps[1]["stats"]["decode_steps"] == 3
    finally:
        trun.close()


# MLA (a rank's heads over the whole latent pool), MLA with q compression,
# MoE (F cut, the block's sum all-reduced), with shared experts, and both
# with a leading dense layer
MLA_MOE = ("tiny-mla", "tiny-mla-q", "tiny-moe", "tiny-moe-shared", "tiny-mla-moe")


@pytest.mark.parametrize("name", MLA_MOE)
def test_mla_and_moe_forward_matches_jax_mesh(group, name):
    """A prefill chunk and decode steps at TP 2 against the JAX runner at
    MeshConfig(model=2): the logits within 1e-4, the greedy tokens equal,
    and each rank's pools the JAX runner's (an MLA latent pool whole on
    every rank, a GQA pool the rank's heads)."""
    jcfg, cfg = jax_get_config(name), get_config(name)
    jp = _jtree(jcfg, 3)
    jrun = JaxRunner(jcfg, params=jp, dtype=jnp.float32, mesh_config=JaxMesh(model=2),
                     **GEOMETRY)
    trun = _tp_runner(group, cfg, jp)
    try:
        prompt, table = PROMPTS[4], [5, 2, 9, 11]
        want = np.asarray(jrun.prefill(prompt, 0, table, 0))
        got = trun.prefill(prompt, 0, table, 0).numpy()
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
        tok = int(np.argmax(want))
        samp = {"temperature": [0.0], "top_k": [0], "top_p": [1.0], "seeds": [0]}
        jt = jrun.decode_multi(3, [tok], [len(prompt)], [table], samp, 0)
        tt = trun.decode_multi(3, [tok], [len(prompt)], [table], samp, 0)
        np.testing.assert_array_equal(tt, np.asarray(jt))
        hk = 1 if cfg.is_mla else cfg.n_kv_heads // 2
        for r, rp in enumerate(trun.rank_pools()):
            for key, jpool in (("k", jrun.k_pool), ("v", jrun.v_pool)):
                ref = np.asarray(jpool)[:, table]
                if not cfg.is_mla:
                    ref = ref[..., r * hk:(r + 1) * hk, :]
                np.testing.assert_allclose(rp[key][:, table], ref, atol=1e-5, rtol=1e-5)
            assert rp["k"][:, table].any()
        reps = trun.rank_reports()
        assert reps[0]["digest"] == reps[1]["digest"] and reps[1]["outputs"] == 1
    finally:
        trun.close()


def test_mla_int8_latent_at_tp2_matches_jax_mesh(group):
    """tiny-mla over int8 latent pools at TP 2 against the JAX runner on
    one device: the logits within 1e-4, every rank's whole pool the JAX
    one (a code may round the other way), each layer's codes and scales
    16-byte aligned on rank 0, as the int8 decode kernel needs. (The JAX
    runner at MeshConfig(model=2) rounds one latent code of this tree the
    other way in its own sums, moving its logits by 0.0078 from its
    single-device run; the port's TP 2 run is the single-device one's.)"""
    from dynamo_tpu_torch.models.toolkit import pool_layer

    jcfg, cfg = jax_get_config("tiny-mla"), get_config("tiny-mla")
    jp = _jtree(jcfg, 4)
    jrun = JaxRunner(jcfg, params=jp, dtype=jnp.float32, kv_quantize="int8", **GEOMETRY)
    trun = _tp_runner(group, cfg, jp, kv_quantize="int8")
    try:
        table = [3, 4, 8, 9]
        want = np.asarray(jrun.prefill(PROMPTS[4], 0, table, 0))
        np.testing.assert_allclose(trun.prefill(PROMPTS[4], 0, table, 0).numpy(), want,
                                   atol=1e-4, rtol=1e-4)
        for rp in trun.rank_pools():
            ref = {k: np.asarray(v)[:, table] for k, v in jrun.k_pool.items()}
            assert np.abs(rp["k"]["q"][:, table].astype(int) - ref["q"].astype(int)).max() <= 1
            np.testing.assert_allclose(rp["k"]["s"][:, table], ref["s"], rtol=1e-5)
        for l in range(cfg.n_layers):
            lat = pool_layer(trun.runner.k_pool, l)
            assert lat["q"].data_ptr() % 16 == 0 and lat["s"].data_ptr() % 16 == 0
    finally:
        trun.close()


def test_int8_pools_quantize_on_write_per_rank(group):
    jcfg, cfg = jax_get_config("tiny"), get_config("tiny")
    jp = _jtree(jcfg, 2)
    jrun = JaxRunner(jcfg, params=jp, dtype=jnp.float32, kv_quantize="int8", **GEOMETRY)
    trun = _tp_runner(group, cfg, jp, kv_quantize="int8")
    try:
        table = [3, 4, 8]
        want = np.asarray(jrun.prefill(PROMPTS[2], 0, table, 0))
        np.testing.assert_allclose(trun.prefill(PROMPTS[2], 0, table, 0).numpy(), want,
                                   atol=1e-4, rtol=1e-4)
        for r, rp in enumerate(trun.rank_pools()):
            for key, jpool in (("k", jrun.k_pool), ("v", jrun.v_pool)):
                for part in ("q", "s"):
                    ref = np.asarray(jpool[part])[:, table][:, :, :, r:r + 1]
                    got = rp[key][part][:, table]
                    if part == "q":  # a code may round the other way
                        assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1
                    else:
                        np.testing.assert_allclose(got, ref, rtol=1e-5)
    finally:
        trun.close()


def test_ranks_read_their_slices_of_a_checkpoint(group, tmp_path):
    """`checkpoint_dir` (the worker's --checkpoint under TP): every rank
    reads its own slices of the HF directory, and the TP 2 prefill equals
    the TP 1 runner's on the same checkpoint."""
    from dynamo_tpu_torch.engine import st_io, weights
    from dynamo_tpu_torch.models import llama

    cfg = get_config("tiny-qwen2")
    params = llama.init_params(cfg, 5, torch.float32, "cpu")
    st_io.save_file(weights.hf_state_dict(params, cfg), tmp_path / "model.safetensors")
    whole = ModelRunner(cfg, device="cpu", dtype=torch.float32, **GEOMETRY,
                        params=weights.load_hf_checkpoint(str(tmp_path), cfg, "cpu",
                                                          torch.float32))
    g, procs = group
    trun = MirroredRunner(g, procs, config=cfg, device="cpu", dtype=torch.float32,
                          checkpoint_dir=str(tmp_path), **GEOMETRY)
    try:
        table = [3, 4, 8, 9]
        want = whole.prefill(PROMPTS[4], 0, table, 0)
        got = trun.prefill(PROMPTS[4], 0, table, 0)
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
        assert trun.runner.params["layers"]["wq"].shape[-1] == cfg.n_heads * cfg.head_dim // 2
    finally:
        trun.close()


def test_attribute_sets_reach_every_rank(group):
    """A bucket list set on rank 0's handle is set on the follower too (a
    forward's shapes must agree across ranks)."""
    cfg = get_config("tiny")
    trun = _tp_runner(group, cfg, _jtree(jax_get_config("tiny"), 9))
    try:
        # 6 tokens: the 32 bucket now, the 8 bucket of GEOMETRY on a rank
        # that missed the set (its collectives would not match)
        trun.prefill_buckets = (32,)
        got = trun.prefill(PROMPTS[0], 0, [1, 2], 0)
        assert trun.runner.prefill_buckets == (32,) and got.shape == (cfg.vocab_size,)
        reps = trun.rank_reports()
        assert reps[0]["digest"] == reps[1]["digest"]
        assert reps[1]["stats"]["prefill_chunks"] == 1
    finally:
        trun.close()
