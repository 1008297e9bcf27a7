"""Tensor parallelism's pieces that need no second process: the port's five
sharded ops against the JAX `*_sharded` functions, the split rule against
the reference's ShardingPolicy, rank slices drawn, cut and loaded, and the
refusals.

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


@pytest.mark.parametrize("name", ["tiny", "tiny-qwen2"])
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
    common = sorted(set(want) & set(got))  # the port's config has no MoE capacity
    assert {k: got[k] for k in common} == {k: want[k] for k in common}
    assert set(want) - set(got) == {"moe_capacity_factor"}


# -- refusals --------------------------------------------------------------------


def test_mesh_refuses_other_axes():
    tmesh.MeshConfig(model=4).check_supported()
    for kw, item in (({"data": 2}, "A.14"), ({"expert": 2}, "A.14"),
                     ({"seq": 2}, "A.15"), ({"pipe": 2}, "A.15")):
        with pytest.raises(NotImplementedError, match=item):
            tmesh.MeshConfig(model=2, **kw).check_supported()
    assert tmesh.MeshConfig(model=2).n_devices == 2


@pytest.mark.parametrize("name,match", [("tiny-mla", "MLA"), ("tiny-moe", "MoE"),
                                        ("tiny-mla-moe", "MLA")])
def test_check_tp_refuses_mla_and_moe(name, match):
    with pytest.raises(NotImplementedError, match=f"{match}.*A.14"):
        tmesh.check_tp(get_config(name), TP)
    tmesh.check_tp(get_config(name), 1)


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
    (["--data-parallel", "2"], "data parallelism"),
    (["--expert-parallel", "2"], "expert parallelism"),
])
def test_worker_refuses_flags_under_tp(argv, flag):
    from dynamo_tpu_torch.worker import mesh_config
    with pytest.raises(NotImplementedError, match=f"{flag}.*A.14"):
        mesh_config(_worker_args(argv))


@pytest.mark.parametrize("model", ["tiny-mla", "tiny-moe"])
def test_worker_refuses_mla_and_moe_under_tp(model):
    from dynamo_tpu_torch.worker import build_runner
    with pytest.raises(NotImplementedError, match="A.14"):
        build_runner(_worker_args(["--model", model]))


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
