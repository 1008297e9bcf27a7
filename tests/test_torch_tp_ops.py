"""Tensor parallelism's pieces that need no second process: the port's seven
sharded ops against the JAX `*_sharded` functions (the MLA pair's int8
latent, which the reference's shard_map does not take, against its
unsharded int8 decode), the split rule against the reference's
ShardingPolicy (MLA's wq_up and wkv_b cut where the reference keeps them
whole), rank slices drawn, cut and loaded (MLA and MoE checkpoints too),
the fit check, and the refusals.

The JAX side runs its shard_map wrappers over `make_mesh(MeshConfig(model=
2))` on the host CPU devices tests/conftest.py sets, with the Pallas
kernels in interpret mode, as tests/test_ops.py runs them. The port's side
calls each sharded wrapper once a rank on that rank's KV heads (CPU
tensors: the plain versions) and concatenates the ranks' results over the
head cut. Inputs come from numpy with a seed; f32, atol = rtol = 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.models import llama as jllama
from dynamo_tpu.models.config import ModelConfig as JaxConfig
from dynamo_tpu.models.config import get_config as jax_get_config
from dynamo_tpu.ops import block_copy as jbc
from dynamo_tpu.ops import flash_prefill as jfp
from dynamo_tpu.ops import mla_attention as jmla
from dynamo_tpu.ops import paged_attention as jpa
from dynamo_tpu.ops import ragged_paged_attention as jrag
from dynamo_tpu.parallel.mesh import MeshConfig as JaxMesh
from dynamo_tpu.parallel.mesh import ShardingPolicy, make_mesh
from dynamo_tpu_torch.engine import st_io, weights
from dynamo_tpu_torch.engine.model_runner import ModelRunner
from dynamo_tpu_torch.models import llama
from dynamo_tpu_torch.models.config import ModelConfig, get_config
from dynamo_tpu_torch.models.toolkit import make_kv_pool
from dynamo_tpu_torch.ops import block_copy as bc
from dynamo_tpu_torch.ops import flash_prefill as fp
from dynamo_tpu_torch.ops import mla_attention as mla
from dynamo_tpu_torch.ops import paged_attention as pa
from dynamo_tpu_torch.ops import ragged_paged_attention as rag
from dynamo_tpu_torch.parallel import mesh as tmesh
from dynamo_tpu_torch.parallel.group import choose_transport, slice_manifest

pytestmark = pytest.mark.skipif(len(jax.devices()) < 2, reason="needs 2 CPU devices")

TOL = dict(atol=1e-5, rtol=1e-5)
TP = 2
# (softcap, window, scale): Llama's defaults, and Gemma-like extras
VARIANTS = {"plain": (0.0, None, None), "gemma": (20.0, 6, 0.25)}


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(JaxMesh(model=TP))


def _pool(rng, shape, int8):
    if int8:
        return {"q": rng.integers(-127, 128, shape).astype(np.int8),
                "s": np.exp(rng.uniform(np.log(0.004), np.log(0.02),
                                        shape[:-1])).astype(np.float32)}
    return rng.standard_normal(shape).astype(np.float32)


def _jax(x):
    return ({k: jnp.asarray(v) for k, v in x.items()} if isinstance(x, dict)
            else jnp.asarray(x))


def _rank(x, r, axis):
    """Rank r's head slice of a numpy operand (an int8 pool's codes and
    scales each), as torch."""
    if isinstance(x, dict):
        return {k: _rank(v, r, axis) for k, v in x.items()}
    w = x.shape[axis] // TP
    return torch.from_numpy(np.ascontiguousarray(np.take(x, range(r * w, (r + 1) * w), axis)))


def _jwin(w):
    return None if w is None else jnp.int32(w)


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_decode_sharded_matches_jax(mesh, variant, int8):
    softcap, window, scale = VARIANTS[variant]
    rng = np.random.default_rng(0)
    B, Hk, G, D, PS, MP = 3, 4, 2, 32, 4, 6
    NP = B * MP + 1
    q = (rng.standard_normal((B, Hk, G, D)) * 0.7).astype(np.float32)
    kp, vp = _pool(rng, (NP, PS, Hk, D), int8), _pool(rng, (NP, PS, Hk, D), int8)
    pt = rng.permutation(NP)[:B * MP].reshape(B, MP).astype(np.int32)
    kv = np.asarray([5, 23, 13], np.int32)
    ref = np.asarray(jpa.decode_paged_attention_sharded(
        *map(_jax, (q, kp, vp, pt, kv)), mesh, window=_jwin(window), scale=scale,
        softcap=softcap, interpret=True))
    outs = [pa.decode_paged_attention_sharded(
        _rank(q, r, 1), _rank(kp, r, 2), _rank(vp, r, 2), torch.from_numpy(pt),
        torch.from_numpy(kv), window, scale=scale, softcap=softcap)
        for r in range(TP)]
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), ref, **TOL)
    assert pa.decode_paged_attention_sharded.launches == 0  # CPU: no launch


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_prefill_sharded_matches_jax(mesh, variant, int8):
    softcap, window, scale = VARIANTS[variant]
    rng = np.random.default_rng(1)
    B, S, Hk, G, D, PS, MP = 2, 16, 4, 2, 32, 4, 8
    NP = B * MP + 1
    q = (rng.standard_normal((B, S, Hk, G, D)) * 0.7).astype(np.float32)
    kp, vp = _pool(rng, (NP, PS, Hk, D), int8), _pool(rng, (NP, PS, Hk, D), int8)
    pt = rng.permutation(NP)[:B * MP].reshape(B, MP).astype(np.int32)
    q_start = np.asarray([0, 9], np.int32)
    q_len = np.asarray([16, 11], np.int32)
    kv = q_start + q_len
    ref = np.asarray(jfp.prefill_paged_attention_sharded(
        *map(_jax, (q, kp, vp, pt, q_start, q_len, kv)), mesh,
        window=_jwin(window), scale=scale, softcap=softcap, interpret=True))
    t = torch.from_numpy
    outs = [fp.prefill_paged_attention_sharded(
        _rank(q, r, 2), _rank(kp, r, 2), _rank(vp, r, 2), t(pt), t(q_start),
        t(q_len), t(kv), window, scale=scale, softcap=softcap) for r in range(TP)]
    got = torch.cat(outs, 2).numpy()
    np.testing.assert_allclose(got[0], ref[0], **TOL)
    np.testing.assert_allclose(got[1, :11], ref[1, :11], **TOL)
    assert np.all(got[1, 11:] == 0.0)


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_ragged_sharded_matches_jax(mesh, variant, int8):
    softcap, window, scale = VARIANTS[variant]
    rng = np.random.default_rng(2)
    q_lens, q_starts, kv_lens, tb = [1, 1, 9, 16], [11, 0, 0, 8], [12, 1, 9, 24], 32
    Hk, G, D, PS, MP = 4, 2, 32, 4, 8
    NP = len(q_lens) * MP + 1
    perm = rng.permutation(NP)
    rows = [perm[i * MP:(i + 1) * MP].astype(np.int32).tolist() for i in range(len(q_lens))]
    md = rag.build_ragged_metadata(q_lens, q_starts, kv_lens, rows, tb, max_pages=MP)
    q = (rng.standard_normal((tb, Hk, G, D)) * 0.7).astype(np.float32)
    kp, vp = _pool(rng, (NP, PS, Hk, D), int8), _pool(rng, (NP, PS, Hk, D), int8)
    meta = [md[k] for k in ("seg_page_table", "seg_kv_lens", "meta")]
    ref = np.asarray(jrag.ragged_paged_attention_sharded(
        *map(_jax, (q, kp, vp, *meta)), mesh, window=_jwin(window), scale=scale,
        softcap=softcap, interpret=True))
    outs = [rag.ragged_paged_attention_sharded(
        _rank(q, r, 1), _rank(kp, r, 2), _rank(vp, r, 2),
        *map(torch.from_numpy, meta), window, scale=scale, softcap=softcap)
        for r in range(TP)]
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), ref, **TOL)


def _latent(rng, shape, int8):
    """An MLA latent pool [NP, PS, 1, Dl], or its int8 dict (s [NP, PS, 1])."""
    if int8:
        return {"q": rng.integers(-127, 128, shape).astype(np.int8),
                "s": np.exp(rng.uniform(np.log(0.004), np.log(0.02),
                                        shape[:-1])).astype(np.float32)}
    return rng.standard_normal(shape).astype(np.float32)


def _whole(x):
    """A numpy operand every rank holds whole, as torch."""
    if isinstance(x, dict):
        return {k: torch.from_numpy(v) for k, v in x.items()}
    return torch.from_numpy(x)


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_decode_mla_sharded_matches_jax(mesh, int8):
    """Each rank's H / 2 heads against the whole latent pool, the ranks'
    results concatenated over the heads: the JAX shard_map's (bf16 and
    f32 latents; the int8 latent against the reference's int8 decode on
    every head, which its shard_map does not take)."""
    rng = np.random.default_rng(8)
    B, H, dc, dr, PS, MP = 3, 8, 32, 16, 4, 6
    NP = B * MP + 1
    q = (rng.standard_normal((B, H, dc + dr)) * 0.7).astype(np.float32)
    lat = _latent(rng, (NP, PS, 1, dc + dr), int8)
    pt = rng.permutation(NP)[:B * MP].reshape(B, MP).astype(np.int32)
    kv = np.asarray([5, 23, 0], np.int32)
    scale = 0.11
    jargs = tuple(map(_jax, (q, lat, pt, kv)))
    ref = np.asarray(
        jmla.decode_mla_attention(*jargs, dc=dc, scale=scale, interpret=True) if int8
        else jmla.decode_mla_attention_sharded(*jargs, mesh, dc=dc, scale=scale,
                                               interpret=True))
    outs = [mla.decode_mla_attention_sharded(
        _rank(q, r, 1), _whole(lat), torch.from_numpy(pt), torch.from_numpy(kv),
        dc=dc, scale=scale) for r in range(TP)]
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), ref, **TOL)
    assert not torch.cat(outs, 1)[2].any()  # kv_len 0
    assert mla.decode_mla_attention_sharded.launches == 0  # CPU: no launch


def test_prefill_mla_sharded_matches_jax(mesh):
    rng = np.random.default_rng(9)
    B, S, H, dc, dr, PS, MP = 2, 8, 8, 32, 16, 4, 8
    NP = B * MP + 1
    q = (rng.standard_normal((B, S, H, dc + dr)) * 0.7).astype(np.float32)
    lat = _latent(rng, (NP, PS, 1, dc + dr), False)
    pt = rng.permutation(NP)[:B * MP].reshape(B, MP).astype(np.int32)
    q_start, q_len = np.asarray([0, 12], np.int32), np.asarray([8, 5], np.int32)
    kv = q_start + q_len + np.asarray([0, 3], np.int32)
    ref = np.asarray(jmla.prefill_mla_attention_sharded(
        *map(_jax, (q, lat, pt, q_start, q_len, kv)), mesh, dc=dc, scale=0.13,
        interpret=True))
    t = torch.from_numpy
    outs = [mla.prefill_mla_attention_sharded(
        _rank(q, r, 2), t(lat), t(pt), t(q_start), t(q_len), t(kv), dc=dc, scale=0.13)
        for r in range(TP)]
    got = torch.cat(outs, 2).numpy()
    np.testing.assert_allclose(got[0], ref[0], **TOL)
    np.testing.assert_allclose(got[1, :5], ref[1, :5], **TOL)
    assert np.all(got[1, 5:] == 0.0)


def test_sharded_mla_refuses_a_cut_latent_pool():
    q = torch.zeros(2, 4, 48)
    pool = torch.zeros(5, 4, 2, 48)  # two heads: not the one whole latent
    pt, kv = torch.zeros(2, 1, dtype=torch.int32), torch.ones(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="whole"):
        mla.decode_mla_attention_sharded(q, pool, pt, kv, dc=32, scale=0.1)
    with pytest.raises(ValueError, match="whole"):
        mla.prefill_mla_attention_sharded(q[:, None], pool, pt, kv, kv, kv, dc=32,
                                          scale=0.1)


@pytest.mark.parametrize("head_major", [False, True])
@pytest.mark.parametrize("dtype", [np.float32, np.int8])
def test_gather_pages_sharded_matches_jax(mesh, head_major, dtype):
    rng = np.random.default_rng(3)
    L, NP, PS, Hk, D = 3, 12, 4, 4, 16
    pool = (rng.standard_normal((L, NP, PS, Hk, D)) * 50).astype(dtype)
    idx = np.asarray([7, 2, 11, 0, 5], np.int32)
    ref = np.asarray(jbc.gather_pages_sharded(
        jnp.asarray(pool), jnp.asarray(idx), mesh, head_major=head_major,
        interpret=True))
    outs = [bc.gather_pages_sharded(_rank(pool, r, 3), torch.from_numpy(idx),
                                    head_major=head_major) for r in range(TP)]
    got = torch.cat(outs, 2 if head_major else 3).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("dtype", [np.float32, np.int8])
def test_scatter_pages_sharded_matches_jax(mesh, dtype):
    rng = np.random.default_rng(4)
    L, NP, PS, Hk, D = 3, 12, 4, 4, 16
    pool = (rng.standard_normal((L, NP, PS, Hk, D)) * 50).astype(dtype)
    idx = np.asarray([9, 1, 4], np.int32)
    pages = (rng.standard_normal((L, 3, PS, Hk, D)) * 50).astype(dtype)
    ref = np.asarray(jbc.scatter_pages_sharded(
        jnp.asarray(pool), jnp.asarray(idx), jnp.asarray(pages), mesh,
        interpret=True))
    got = [bc.scatter_pages_sharded(_rank(pool, r, 3), torch.from_numpy(idx),
                                    _rank(pages, r, 3)) for r in range(TP)]
    np.testing.assert_array_equal(torch.cat(got, 3).numpy(), ref)
    with pytest.raises(ValueError, match="KV heads"):
        bc.scatter_pages_sharded(_rank(pool, 0, 3), torch.from_numpy(idx),
                                 torch.from_numpy(pages))


def test_sharded_attention_refuses_mismatched_heads():
    q = torch.zeros(2, 2, 2, 16)
    pool = torch.zeros(5, 4, 4, 16)  # the whole pool, not the rank's slice
    with pytest.raises(ValueError, match="KV heads"):
        pa.decode_paged_attention_sharded(q, pool, pool, torch.zeros(2, 1, dtype=torch.int32),
                                          torch.ones(2, dtype=torch.int32))


# -- the split rule --------------------------------------------------------------
# tiny, Qwen2's biases, and a tied head with OLMo-2's full-width qk-norm
SPLIT_CONFIGS = {
    "tiny": {},
    "moe-shared": {"n_experts": 4, "n_experts_active": 2, "moe_ffn_dim": 96,
                   "n_shared_experts": 1, "moe_scoring": "sigmoid"},
    "tiny-qwen2": {"attn_bias": True},
    "tied-olmo2": {"tie_embeddings": True, "qk_norm": True, "qk_norm_wide": True,
                   "pre_norms": False, "post_norms": True},
}


def _configs(name):
    kw = dict(name=name, **SPLIT_CONFIGS[name])
    return JaxConfig(**kw), ModelConfig(**kw)


def _shard(arr, r):
    dev = {s.device: s for s in arr.addressable_shards}
    return np.asarray(dev[arr.sharding.mesh.devices.reshape(-1)[r]].data)


@pytest.mark.parametrize("name", sorted(SPLIT_CONFIGS))
def test_rank_params_are_the_reference_shards(mesh, name):
    jcfg, cfg = _configs(name)
    tree = jax.device_get(jllama.init_params(jcfg, jax.random.PRNGKey(5), jnp.float32))
    policy = ShardingPolicy(mesh)
    placed = jax.device_put(tree, policy.params_sharding(tree))
    for r in range(TP):
        port = weights.params_from_numpy(tree, cfg, "cpu", torch.float32, rank=r, tp=TP)
        flat = dict(weights.flatten(port))
        jflat = {"/".join(str(getattr(k, "key", k)) for k in path): leaf
                 for path, leaf in jax.tree_util.tree_flatten_with_path(placed)[0]}
        assert set(flat) == set(jflat)
        for key, leaf in flat.items():
            np.testing.assert_array_equal(leaf.numpy(), _shard(jflat[key], r), err_msg=key)


@pytest.mark.parametrize("name", ["tiny-mla", "tiny-mla-q", "tiny-mla-moe"])
def test_mla_rank_params_are_the_reference_shards_but_two(mesh, name):
    """An MLA tree's rank slices are the reference's shards, but wq_up /
    wkv_b (and wq without q compression), which the reference keeps whole
    and the port cuts on their head-major columns: the rank's heads."""
    jcfg, cfg = jax_get_config(name), get_config(name)
    tree = jax.device_get(jllama.init_params(jcfg, jax.random.PRNGKey(5), jnp.float32))
    placed = jax.device_put(tree, ShardingPolicy(mesh).params_sharding(tree))
    jflat = {"/".join(str(getattr(k, "key", k)) for k in path): leaf
             for path, leaf in jax.tree_util.tree_flatten_with_path(placed)[0]}
    H, w = cfg.n_heads, cfg.qk_nope_head_dim + cfg.v_head_dim
    cut_here = {"wkv_b", "wq_up"}
    for r in range(TP):
        flat = dict(weights.flatten(weights.params_from_numpy(
            tree, cfg, "cpu", torch.float32, rank=r, tp=TP)))
        assert set(flat) == set(jflat)
        for key, leaf in flat.items():
            whole = np.asarray(jflat[key])
            if key.split("/")[-1] in cut_here:
                n = whole.shape[-1] // TP
                np.testing.assert_array_equal(leaf.numpy(), whole[..., r * n:(r + 1) * n])
            else:
                np.testing.assert_array_equal(leaf.numpy(), _shard(jflat[key], r), err_msg=key)
        heads = flat["layers/wkv_b"].reshape(-1, cfg.kv_lora_rank, H // TP, w)
        ref = np.asarray(jflat["layers/wkv_b"]).reshape(-1, cfg.kv_lora_rank, H, w)
        np.testing.assert_array_equal(heads.numpy(), ref[:, :, r * H // TP:(r + 1) * H // TP])


@pytest.mark.parametrize("int8", [False, True])
def test_rank_pools_are_the_reference_shards(mesh, int8):
    rng = np.random.default_rng(6)
    pool = _pool(rng, (2, 9, 4, 4, 8), int8)
    policy = ShardingPolicy(mesh)
    placed = jax.device_put(_jax(pool), policy.kv_pool_sharding_tree(_jax(pool)))
    full = ({k: torch.from_numpy(v) for k, v in pool.items()} if int8
            else torch.from_numpy(pool))
    cfg = ModelConfig(n_kv_heads=4, n_heads=8, dim=64, n_layers=2)
    for r in range(TP):
        got = ({k: tmesh.cut(v, tmesh.KV_CUT, r, TP) for k, v in full.items()} if int8
               else tmesh.cut(full, tmesh.KV_CUT, r, TP))
        if int8:
            for k in ("q", "s"):
                np.testing.assert_array_equal(got[k].numpy(), _shard(placed[k], r))
        else:
            np.testing.assert_array_equal(got.numpy(), _shard(placed, r))
        made = make_kv_pool(cfg, 9, 4, torch.float32, "cpu",
                            kv_quantize="int8" if int8 else None, tp=TP)[0]
        want = got if not int8 else got
        if int8:
            assert all(made[k].shape == want[k].shape for k in ("q", "s"))
        else:
            assert made.shape == want.shape


@pytest.mark.parametrize("name", ["tiny", "tiny-qwen2", "tiny-mla-q", "tiny-mla-moe"])
def test_rank_draw_is_the_whole_draw_cut(name):
    """init_params on a rank equals the TP 1 tree's slices bit for bit."""
    cfg = get_config(name)
    whole = llama.init_params(cfg, 3, torch.bfloat16, "cpu")
    shapes = llama.param_shapes(cfg)
    for r in range(TP):
        part = llama.init_params(cfg, 3, torch.bfloat16, "cpu", rank=r, tp=TP)
        cut = tmesh.shard_tree(whole, shapes, r, TP)
        for (k, a), (_, b) in zip(weights.flatten(part), weights.flatten(cut)):
            assert torch.equal(a, b), k
    assert (llama.param_bytes(cfg, torch.bfloat16, tp=TP) * TP
            > llama.param_bytes(cfg, torch.bfloat16))  # norms stay whole


@pytest.mark.parametrize("case", ["mla", "mla_q", "mla_moe", "moe_mixtral",
                                  "moe_shared_gate"])
def test_rank_mla_and_moe_checkpoint_load_is_the_whole_load_cut(tmp_path, case):
    """MLA (its RoPE columns permuted within each of a rank's heads) and
    MoE checkpoints (each expert's F read in slices) at TP 2: the whole
    load's slices, bit for bit."""
    from tests.test_torch_checkpoint import _configs, _write

    _, cfg = _configs(case)
    _write(tmp_path, case, np.float32)
    whole = weights.load_hf_checkpoint(str(tmp_path), cfg, "cpu", torch.float32)
    shapes = llama.param_shapes(cfg)
    for r in range(TP):
        part = weights.load_hf_checkpoint(str(tmp_path), cfg, "cpu", torch.float32,
                                          rank=r, tp=TP)
        cut = tmesh.shard_tree(whole, shapes, r, TP)
        assert [k for k, _ in weights.flatten(part)] == [k for k, _ in weights.flatten(cut)]
        for (k, a), (_, b) in zip(weights.flatten(part), weights.flatten(cut)):
            assert torch.equal(a, b), k


@pytest.mark.parametrize("name", ["tiny", "tiny-qwen2", "tiny-gemma2"])
def test_rank_checkpoint_load_is_the_whole_load_cut(tmp_path, name):
    cfg = get_config(name)
    params = llama.init_params(cfg, 4, torch.float32, "cpu")
    st_io.save_file(weights.hf_state_dict(params, cfg), tmp_path / "model.safetensors")
    whole = weights.load_hf_checkpoint(str(tmp_path), cfg, "cpu", torch.float32)
    shapes = llama.param_shapes(cfg)
    for r in range(TP):
        part = weights.load_hf_checkpoint(str(tmp_path), cfg, "cpu", torch.float32,
                                          rank=r, tp=TP)
        cut = tmesh.shard_tree(whole, shapes, r, TP)
        for (k, a), (_, b) in zip(weights.flatten(part), weights.flatten(cut)):
            assert torch.equal(a, b), k


def test_tp_fit_check_counts_every_rank_on_the_card():
    cfg = get_config("llama-3.1-70b")
    per_rank = weights.serving_bytes(cfg, 512, 16, tp=TP)
    assert per_rank < weights.serving_bytes(cfg, 512, 16)
    with pytest.raises(MemoryError, match=r"2 rank\(s\) on this device"):
        weights.check_fits(cfg.name, per_rank, 80 * 10**9, ranks=2, tp=TP)
    weights.check_fits(cfg.name, per_rank, 80 * 10**9, ranks=1, tp=TP)


def test_tp_fit_check_charges_the_latent_pool_once_a_rank():
    """An MLA latent pool is whole on every rank: two ranks on one card
    are charged it twice, beside their halves of the heads' params."""
    cfg = get_config("deepseek-v3").with_(n_layers=3, n_experts=0)
    pool = weights.kv_pool_bytes(cfg, 2049, 16, torch.bfloat16)  # + the spare page
    assert pool == weights.kv_pool_bytes(cfg, 2049, 16, torch.bfloat16, tp=TP)
    per_rank = weights.serving_bytes(cfg, 2048, 16, tp=TP)
    assert per_rank == llama.param_bytes(cfg, tp=TP) + pool
    seen = []
    free = 2 * per_rank - 1  # a byte short of the two ranks
    with pytest.raises(MemoryError, match=r"2 rank\(s\) on this device"):
        _fit_kw(cfg, free, seen)
    assert seen == [per_rank]
    _fit_kw(cfg, 2 * per_rank, seen)


def _fit_kw(cfg, free, seen):
    """group.tp_check_fits over 2 ranks on one card with `free` bytes free
    (the card's query stubbed); `seen` gets the bytes charged a rank."""
    from unittest import mock

    from dynamo_tpu_torch.parallel import group as tgroup

    real = weights.check_fits

    def check(name, need, free_b, ranks=1, tp=1):
        seen.append(need)
        return real(name, need, free_b, ranks=ranks, tp=tp)

    with mock.patch.object(torch.cuda, "mem_get_info", lambda dev: (free, free)), \
            mock.patch.object(torch.cuda, "device_count", lambda: 1), \
            mock.patch.object(weights, "check_fits", check):
        tgroup.tp_check_fits(TP, torch.device("cuda", 0), dict(
            config=cfg, num_pages=2048, page_size=16, dtype=torch.bfloat16))


def test_a_given_tree_is_whole_and_each_follower_gets_its_slices():
    """slice_manifest takes a whole tree only (a rank's slices cannot give
    another rank's) and lists each leaf at a rank's shape, in the tree's
    order."""
    cfg = get_config("tiny-qwen2")
    whole = llama.init_params(cfg, 0, torch.float32, "cpu")
    man = slice_manifest(whole, cfg, TP)
    shapes = {"/".join(p): sh for p, sh, _ in man}
    local = tmesh.local_param_shapes(llama.param_shapes(cfg), TP)
    assert shapes["layers/wq"] == local["layers"]["wq"]
    assert shapes["layers/bk"] == local["layers"]["bk"]
    assert shapes["embed"] == local["embed"] and len(man) == len(shapes)
    with pytest.raises(ValueError, match="whole"):
        slice_manifest(llama.init_params(cfg, 0, torch.float32, "cpu", rank=1, tp=TP),
                       cfg, TP)


def test_llama_70b_preset_is_the_reference():
    import dataclasses

    want = dataclasses.asdict(jax_get_config("llama-3.1-70b"))
    got = dataclasses.asdict(get_config("llama-3.1-70b"))
    # every field, the EP capacity factor included
    assert got == want


# -- refusals --------------------------------------------------------------------


def test_mesh_refuses_other_axes():
    """data, model and expert are served; seq and pipe, alone or beside
    them, are refused naming A.15."""
    tmesh.MeshConfig(model=4).check_supported()
    tmesh.MeshConfig(data=2, model=2, expert=2).check_supported()
    for kw in ({"seq": 2}, {"pipe": 2}, {"model": 2, "seq": 2}, {"expert": 2, "pipe": 2}):
        with pytest.raises(NotImplementedError, match="A.15"):
            tmesh.MeshConfig(**kw).check_supported()
    assert tmesh.MeshConfig(model=2).n_devices == 2
    assert tmesh.MeshConfig(data=2, model=2, expert=2).n_devices == 8


# what an MLA or a MoE config must divide beside the dense widths
FAMILY_WIDTH = {"MLA": ("n_heads", 6), "MoE": ("moe_ffn_dim", 90)}


@pytest.mark.parametrize("name,match", [("tiny-mla", "MLA"), ("tiny-moe", "MoE"),
                                        ("tiny-mla-moe", "MLA")])
def test_check_tp_refuses_mla_and_moe(name, match):
    """MLA and MoE configs serve at TP 2 and are refused where the width
    their family cuts (MLA: the heads; MoE: the experts' F) does not
    divide."""
    tmesh.check_tp(get_config(name), TP)
    tmesh.check_tp(get_config(name), 1)
    width, value = FAMILY_WIDTH[match]
    bad = get_config(name).with_(**{width: value})
    with pytest.raises(ValueError, match=width):
        tmesh.check_tp(bad, 4)


@pytest.mark.parametrize("name", ["tiny-mla-q", "tiny-moe-shared", "deepseek-v3",
                                  "qwen3-30b-a3b", "mla-config"])
def test_check_tp_accepts_the_mla_and_moe_presets(name):
    cfg = (get_config("deepseek-v3").with_(n_layers=3, n_experts=0) if name == "mla-config"
           else get_config(name))
    tmesh.check_tp(cfg, TP)


def test_check_tp_refuses_an_undividable_shared_expert():
    cfg = get_config("tiny-moe-shared").with_(shared_expert_ffn_dim=90)
    with pytest.raises(ValueError, match="shared_ffn_dim"):
        tmesh.check_tp(cfg, 4)


def test_check_tp_refuses_what_does_not_divide():
    with pytest.raises(ValueError, match="n_kv_heads"):
        tmesh.check_tp(ModelConfig(n_kv_heads=3, n_heads=6, dim=48), 2)


@pytest.mark.parametrize("key,value", [("quantize", "int8"), ("lora_slots", 2),
                                       ("draft_config", object()),
                                       ("draft_params", {"embed": 0})])
def test_runner_refuses_what_the_slice_does_not_serve(key, value):
    with pytest.raises(NotImplementedError, match="A.14"):
        tmesh.check_tp(get_config("tiny"), TP, {key: value})
    tmesh.check_tp(get_config("tiny"), 1, {key: value})


def _worker_args(argv):
    from dynamo_tpu_torch.worker import parse_args
    return parse_args(["--device", "cpu", "--tensor-parallel", "2", *argv])


@pytest.mark.parametrize("argv,flag", [
    (["--quantize", "int8"], "--quantize"), (["--lora", "a"], "--lora"),
    (["--lora-slots", "2"], "--lora-slots"),
    (["--draft-model", "tiny"], "--draft-model"),
    (["--draft-checkpoint", "/x"], "--draft-checkpoint"),
    (["--host-kv-blocks", "8"], "--host-kv-blocks"),
    (["--disk-kv-blocks", "8"], "--disk-kv-blocks"),
    (["--obj-kv-root", "/x"], "--obj-kv-root"),
    (["--kv-tier-quantize"], "--kv-tier-quantize"), (["--prefetch"], "--prefetch"),
    (["--shm-weights", "x"], "--shm-weights"), (["--orbax-cache", "/x"], "--orbax-cache"),
    # beside data or expert parallelism the refusal names the mesh
    (["--data-parallel", "2", "--quantize", "int8"], "data parallelism"),
    (["--expert-parallel", "2", "--quantize", "int8"], "expert parallelism"),
])
def test_worker_refuses_flags_under_tp(argv, flag):
    from dynamo_tpu_torch.worker import mesh_config
    with pytest.raises(NotImplementedError, match=f"{flag}.*A.14"):
        mesh_config(_worker_args(argv))


class _Spawned(Exception):
    pass


@pytest.mark.parametrize("model", ["tiny-mla", "tiny-moe"])
def test_worker_refuses_mla_and_moe_under_tp(model, monkeypatch):
    """The worker takes tiny-mla and tiny-moe at --tensor-parallel 2 (its
    build reaches the followers' spawn, stubbed here) and refuses them
    where the family's width does not divide, before any spawn."""
    from dynamo_tpu_torch import worker

    def spawn(*a, **kw):
        raise _Spawned

    monkeypatch.setattr(worker, "spawn_followers", spawn)
    with pytest.raises(_Spawned):
        worker.build_runner(_worker_args(["--model", model]))
    # tiny-mla's 4 heads do not divide over 8 ranks, nor tiny-moe's F 96
    # over 64
    width, tp = {"tiny-mla": ("n_heads", "8"), "tiny-moe": ("moe_ffn_dim", "64")}[model]
    args = worker.parse_args(["--device", "cpu", "--tensor-parallel", tp, "--model", model])
    with pytest.raises(ValueError, match=width):
        worker.build_runner(args)


def test_transport_follows_the_device_layout():
    cpu, c0, c1 = torch.device("cpu"), torch.device("cuda", 0), torch.device("cuda", 1)
    assert choose_transport([cpu, cpu]) == "gloo"
    assert choose_transport([c0, c0]) == "gloo"  # ranks sharing a card
    assert choose_transport([c0, c1]) == "nccl"


def test_runner_card_carries_the_mesh():
    from dynamo_tpu_torch.worker import model_card
    args = _worker_args([])
    assert model_card(args, get_config("tiny")).runtime_config["mesh"] == [1, 2, 1, 1, 1]
    runner = ModelRunner(get_config("tiny"), num_pages=8, device="cpu")
    assert runner.mesh_config.n_devices == 1 and runner.tp is None
