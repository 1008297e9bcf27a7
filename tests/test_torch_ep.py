"""Expert and data parallelism's pieces on the CPU: the port's `moe_ep`
(its plain version, and the dispatch over rank processes) against the
reference's `moe_ep`, the ranks' coordinates against the reference's
device mesh, rank params and pools against the JAX mesh's shards, rank
draws and checkpoint reads against the whole tree cut, the fit check and
the refusals (the runner and the engine: tests/test_torch_ep_engine.py).

The JAX side runs as its own tests run it, on the host CPU devices of
tests/conftest.py (`make_mesh` over `MeshConfig(expert=..., data=...,
model=...)`). The port's rank path runs on spawned gloo ranks
(parallel/group.py spawn_followers, TPGroup.run_on_ranks with
tests/torch_ep_rank_fns.py); a world is laid out as each case's mesh
(TPGroup.remesh). Inputs come from numpy with a seed; f32, atol 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.models.config import get_config as jax_get_config
from dynamo_tpu.ops import moe_dispatch as jdisp
from dynamo_tpu.parallel.mesh import MeshConfig as JaxMesh
from dynamo_tpu.parallel.mesh import ShardingPolicy, make_mesh
from dynamo_tpu_torch.engine import weights
from dynamo_tpu_torch.models import llama
from dynamo_tpu_torch.models.config import get_config
from dynamo_tpu_torch.models.toolkit import make_kv_pool
from dynamo_tpu_torch.ops import moe_dispatch as md
from dynamo_tpu_torch.parallel import mesh as tmesh
from dynamo_tpu_torch.parallel.group import shutdown_followers, spawn_followers
from tests.torch_ep_rank_fns import rank_moe_ep

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 CPU devices")

TOL = dict(atol=1e-5, rtol=0)
# the meshes of the reference's moe_ep tests, and EP x TP
MESHES = {"ep2": dict(expert=2), "ep4_dp2": dict(expert=4, data=2),
          "ep2_tp2": dict(expert=2, model=2)}
# the model meshes: EP 2, EP 2 x TP 2, DP 2 x EP 2
MODEL_MESHES = {"ep2": dict(expert=2), "ep2_tp2": dict(expert=2, model=2),
                "dp2_ep2": dict(data=2, expert=2)}
# softmax over the chosen logits, and DeepSeek-V3's routing: sigmoid gates,
# a selection bias, group-limited choice, a routed scale
ROUTINGS = {"softmax": {}, "deepseek": dict(scoring="sigmoid", routed_scale=2.5,
                                            n_groups=4, topk_groups=2)}
N_EXP, K, T, E, F = 8, 2, 64, 32, 48
CAPACITIES = {"lossless": N_EXP / K, "cf0.5": 0.5}


def _operands(routing, seed=0):
    rng = np.random.default_rng(seed)

    def rnd(*shape, s=0.2):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    bias = rnd(N_EXP, s=0.5) if routing == "deepseek" else None
    return (rnd(T, E, s=0.5), rnd(E, N_EXP), rnd(N_EXP, E, F), rnd(N_EXP, E, F),
            rnd(N_EXP, F, E), bias)


def _reference(mesh, ops, cf, routing):
    """The reference's moe_ep over its mesh, under jit as its forward runs
    it (one compile, not one a primitive)."""
    x, wr, wg, wu, wd, bias = ops
    jmesh = make_mesh(JaxMesh(**MESHES[mesh]))
    model_axis = "model" if MESHES[mesh].get("model", 1) > 1 else None

    @jax.jit
    def run(x, wr, wg, wu, wd, bias):
        return jdisp.moe_ep(x, wr, wg, wu, wd, jmesh, n_experts_active=K, capacity_factor=cf,
                            model_axis=model_axis, router_bias=bias, **ROUTINGS[routing])

    return np.asarray(run(*(None if a is None else jnp.asarray(a)
                            for a in (x, wr, wg, wu, wd, bias))))


def _dense(ops, routing):
    """The lossless function: the port's every-expert form on one device."""
    x, wr, wg, wu, wd, bias = (None if a is None else torch.from_numpy(a) for a in ops)
    r = ROUTINGS[routing]
    weights_, sel = md.router_topk((x @ wr).float(), K, r.get("scoring", "softmax"),
                                   bias=bias, routed_scale=r.get("routed_scale", 1.0),
                                   n_groups=r.get("n_groups", 0),
                                   topk_groups=r.get("topk_groups", 0))
    return md.dense_experts(x, sel, weights_, wg, wu, wd).numpy()


@pytest.mark.parametrize("routing", sorted(ROUTINGS))
@pytest.mark.parametrize("cap", sorted(CAPACITIES))
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_plain_moe_ep_matches_the_reference(mesh, cap, routing):
    """The plain version (every rank's shards in one process) equals the
    reference's moe_ep: lossless, and at capacity factor 0.5, where the
    same pairs drop (the output is far from the lossless one)."""
    ops = _operands(routing)
    cf = CAPACITIES[cap]
    want = _reference(mesh, ops, cf, routing)
    x, wr, wg, wu, wd, bias = (None if a is None else torch.from_numpy(a) for a in ops)
    kw = MESHES[mesh]
    got = md.moe_ep_ref(x, wr, wg, wu, wd, kw["expert"], K, cf, n_model=kw.get("model", 1),
                        router_bias=bias, **ROUTINGS[routing])
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    dense = _dense(ops, routing)
    if cap == "lossless":
        np.testing.assert_allclose(got.numpy(), dense, atol=1e-5)
    else:  # pairs dropped: whole rows lost
        assert np.abs(got.numpy() - dense).max() > 1e-2


@pytest.fixture(scope="module")
def worlds():
    """Worlds of spawned gloo ranks by size, made on first use."""
    made = {}

    def get(size):
        if size not in made:
            made[size] = spawn_followers(size, "cpu")
        return made[size][0]

    yield get
    for g, procs in made.values():
        assert shutdown_followers(g, procs) == [0] * (g.size - 1)


def _world(worlds, **kw):
    mesh = tmesh.MeshConfig(**kw)
    g = worlds(mesh.n_devices)
    if g.mesh != mesh:
        g.remesh(mesh)
    return g


@pytest.mark.parametrize("routing", sorted(ROUTINGS))
@pytest.mark.parametrize("cap", sorted(CAPACITIES))
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_rank_moe_ep_matches_the_reference(worlds, mesh, cap, routing):
    """moe_ep on the ranks (counts, then the kept rows, over gloo; each
    rank's rows through its own experts, its F columns summed over the
    model group; the results back, combined in f32) equals the
    reference's, every replica alike, and each rank dispatched once."""
    ops = _operands(routing, seed=1)
    cf = CAPACITIES[cap]
    want = _reference(mesh, ops, cf, routing)
    g = _world(worlds, **MESHES[mesh])
    outs = g.run_on_ranks(rank_moe_ep, ops, K, cf, ROUTINGS[routing])
    n = MESHES[mesh]["expert"]
    t = T // n
    for e, out, counts in outs:
        np.testing.assert_allclose(out, want[e * t:(e + 1) * t], **TOL)
        assert counts["dispatches"] == 1 and counts["fallbacks"] == 0
    sent = sum(c["rows_sent"] for _, _, c in outs) // (g.size // n)
    assert sent <= T * K and (cap == "cf0.5" or sent == T * K)


def test_plan_orders_the_wire_and_drops_past_capacity():
    """ep_plan: kept pairs by destination, local expert and pair order;
    the running count per destination drops exactly the pairs at or past
    the capacity."""
    sel = torch.tensor([[0, 3], [1, 0], [2, 1], [3, 2], [0, 1]])  # 4 experts, 2 ranks
    plan = md.ep_plan(sel, 2, 2, 3)
    # pairs bound for rank 0 (experts 0, 1): 0, 2, 3, 5, 9 -> the first 3 kept
    # pairs bound for rank 1 (experts 2, 3): 1, 4, 6, 7 -> 1, 4, 6 kept
    assert plan.pair.tolist() == [0, 3, 2, 4, 1, 6]
    assert plan.tok.tolist() == [0, 1, 1, 2, 0, 3]
    assert plan.counts.tolist() == [[2, 1], [1, 2]]


def test_rank_coordinates_are_the_reference_device_mesh():
    """Rank r sits where make_mesh puts device r: row-major over (data,
    model, expert, seq, pipe); its groups are the mesh's rows."""
    mc = tmesh.MeshConfig(data=2, model=2, expert=2)
    devices = make_mesh(JaxMesh(data=2, model=2, expert=2)).devices
    for r in range(mc.n_devices):
        c = mc.coords(r)
        assert devices[tuple(c[a] for a in tmesh.AXES)].id == jax.devices()[r].id
        for axis in ("data", "model", "expert"):
            peers = mc.peers(r, axis)
            assert r in peers and len(peers) == getattr(mc, axis)
            assert all(mc.coords(p)[a] == c[a] for p in peers for a in tmesh.AXES
                       if a != axis)


def _shard(arr, r):
    dev = {s.device: s for s in arr.addressable_shards}
    return np.asarray(dev[arr.sharding.mesh.devices.reshape(-1)[r]].data)


def _flat(placed):
    return {"/".join(str(getattr(k, "key", k)) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(placed)[0]}


@pytest.mark.parametrize("mesh", sorted(MODEL_MESHES))
@pytest.mark.parametrize("name", ["tiny-moe", "tiny-moe-shared", "tiny-mla-moe"])
def test_rank_params_and_pools_are_the_reference_shards(name, mesh):
    """Each rank's params slice (its experts, each F / model wide; the
    rest cut over model alone, whole over data and expert) and its KV pool
    slice are the JAX mesh's addressable shards of device r (MLA's wq_up
    and wkv_b cut on their head-major columns, which the reference keeps
    whole; the latent pool whole)."""
    jcfg, cfg = jax_get_config(name), get_config(name)
    mc = tmesh.MeshConfig(**MODEL_MESHES[mesh])
    jmesh = make_mesh(JaxMesh(**MODEL_MESHES[mesh]))
    policy = ShardingPolicy(jmesh)
    tree = jax.device_get(jllama.init_params(jcfg, jax.random.PRNGKey(5), jnp.float32))
    jflat = _flat(jax.device_put(tree, policy.params_sharding(tree)))
    pool_shape = make_kv_pool(cfg, 9, 4, torch.float32, "cpu")[0].shape
    pool = np.random.default_rng(6).standard_normal(pool_shape).astype(np.float32)
    jpool = jax.device_put(jnp.asarray(pool), policy.kv_pool_sharding_tree(jnp.asarray(pool)))
    for r in range(mc.n_devices):
        c = mc.coords(r)
        port = dict(weights.flatten(weights.params_from_numpy(
            tree, cfg, "cpu", torch.float32, rank=c["model"], tp=mc.model,
            ep_rank=c["expert"], ep=mc.expert)))
        assert set(port) == set(jflat)
        for key, leaf in port.items():
            if key.split("/")[-1] in ("wkv_b", "wq_up") and mc.model > 1:
                whole = np.asarray(jflat[key])
                n = whole.shape[-1] // mc.model
                ref = whole[..., c["model"] * n:(c["model"] + 1) * n]
            else:
                ref = _shard(jflat[key], r)
            np.testing.assert_array_equal(leaf.numpy(), ref, err_msg=f"rank {r} {key}")
        got = tmesh.cut(torch.from_numpy(pool), tmesh.kv_cut(cfg), c["model"], mc.model)
        np.testing.assert_array_equal(got.numpy(), _shard(jpool, r))
        assert make_kv_pool(cfg, 9, 4, torch.float32, "cpu", tp=mc.model)[0].shape == got.shape


@pytest.mark.parametrize("mesh", ["ep2", "ep2_tp2"])
@pytest.mark.parametrize("name", ["tiny-moe", "tiny-mla-moe"])
def test_rank_draw_is_the_whole_draw_cut_over_experts(name, mesh):
    """init_params on a rank of an expert mesh equals the whole tree's
    slices bit for bit (another rank's experts drawn and dropped)."""
    cfg = get_config(name)
    mc = tmesh.MeshConfig(**MODEL_MESHES[mesh])
    whole = llama.init_params(cfg, 3, torch.bfloat16, "cpu")
    shapes = llama.param_shapes(cfg)
    for r in range(mc.n_devices):
        c = mc.coords(r)
        part = llama.init_params(cfg, 3, torch.bfloat16, "cpu", rank=c["model"],
                                 tp=mc.model, ep_rank=c["expert"], ep=mc.expert)
        cut = tmesh.shard_tree(whole, shapes, c["model"], mc.model, c["expert"], mc.expert)
        assert [k for k, _ in weights.flatten(part)] == [k for k, _ in weights.flatten(cut)]
        for (k, a), (_, b) in zip(weights.flatten(part), weights.flatten(cut)):
            assert torch.equal(a, b), (r, k)
        assert part["layers"]["we_gate"].shape[1] == cfg.n_experts // mc.expert


@pytest.mark.parametrize("mesh", ["ep2", "ep2_tp2"])
@pytest.mark.parametrize("case", ["moe_mixtral", "moe_shared_gate", "mla_moe"])
def test_rank_checkpoint_read_is_the_whole_read_cut_over_experts(tmp_path, case, mesh):
    """An HF checkpoint read on a rank of an expert mesh: the whole read's
    slices bit for bit, and the other ranks' experts are not read."""
    from tests.test_torch_checkpoint import _configs, _write

    _, cfg = _configs(case)
    _write(tmp_path, case, np.float32)
    mc = tmesh.MeshConfig(**MODEL_MESHES[mesh])
    whole_stats, stats = {}, {}
    whole = weights.load_hf_checkpoint(str(tmp_path), cfg, "cpu", torch.float32,
                                       stats=whole_stats)
    shapes = llama.param_shapes(cfg)
    for r in range(mc.n_devices):
        c = mc.coords(r)
        part = weights.load_hf_checkpoint(
            str(tmp_path), cfg, "cpu", torch.float32, stats=stats, rank=c["model"],
            tp=mc.model, ep_rank=c["expert"], ep=mc.expert)
        cut = tmesh.shard_tree(whole, shapes, c["model"], mc.model, c["expert"], mc.expert)
        assert [k for k, _ in weights.flatten(part)] == [k for k, _ in weights.flatten(cut)]
        for (k, a), (_, b) in zip(weights.flatten(part), weights.flatten(cut)):
            assert torch.equal(a, b), (r, k)
        expert_bytes = llama.param_bytes(cfg, torch.float32, only=tmesh.ROUTED_EXPERTS)
        assert stats["bytes"] <= whole_stats["bytes"] - expert_bytes // 2


def test_fit_check_counts_each_ranks_experts():
    """A rank of an expert mesh is charged its n_experts / ep experts (each
    F / tp wide) beside the whole rest; qwen3-30b-a3b at 48 layers at EP 2
    is 35.3 GB a rank with 2048 pages, DeepSeek-V3 at EP 2 far over a card."""
    from unittest import mock

    from dynamo_tpu_torch.parallel import group as tgroup

    cfg = get_config("qwen3-30b-a3b")
    experts = llama.param_bytes(cfg, only=tmesh.ROUTED_EXPERTS)
    assert llama.param_bytes(cfg, only=tmesh.ROUTED_EXPERTS, ep=2) * 2 == experts
    assert llama.param_bytes(cfg, only=tmesh.ROUTED_EXPERTS, tp=2, ep=2) * 4 == experts
    whole = weights.serving_bytes(cfg, 2048, 16)
    rank = weights.serving_bytes(cfg, 2048, 16, ep=2)
    assert whole - rank == experts // 2
    assert 35e9 < rank < 36e9
    seen = []
    real = weights.check_fits

    def check(name, need, free, ranks=1, tp=1):
        seen.append((need, ranks, tp))
        return real(name, need, free, ranks=ranks, tp=tp)

    def fits(config, mesh, free):
        with mock.patch.object(torch.cuda, "mem_get_info", lambda dev: (free, free)), \
                mock.patch.object(torch.cuda, "device_count", lambda: 1), \
                mock.patch.object(weights, "check_fits", check):
            tgroup.tp_check_fits(mesh, torch.device("cuda", 0), dict(
                config=config, num_pages=2048, page_size=16, dtype=torch.bfloat16))

    fits(cfg, tmesh.MeshConfig(expert=2), 2 * rank)
    assert seen[-1] == (rank, 2, 2)
    with pytest.raises(MemoryError, match=r"2 rank\(s\) on this device"):
        fits(cfg, tmesh.MeshConfig(expert=2), 2 * rank - 1)
    fits(cfg, tmesh.MeshConfig(data=2, expert=2), 4 * rank)
    assert seen[-1] == (rank, 4, 4)
    with pytest.raises(MemoryError, match=r"2 rank\(s\) on this device"):
        fits(get_config("deepseek-v3"), tmesh.MeshConfig(expert=2), 80 * 10**9)


def _worker_args(argv):
    from dynamo_tpu_torch.worker import parse_args
    return parse_args(["--device", "cpu", *argv])


@pytest.mark.parametrize("argv", [["--expert-parallel", "2"],
                                  ["--expert-parallel", "2", "--tensor-parallel", "2"],
                                  ["--data-parallel", "2", "--expert-parallel", "2"]])
def test_quantized_experts_under_ep_are_refused(argv):
    """--quantize on an expert (or any) mesh names A.14 (c) (quantized
    experts take the reference's dense fallback there), as does a
    quantized runner argument."""
    from dynamo_tpu_torch.worker import mesh_config

    with pytest.raises(NotImplementedError, match=r"--quantize.*A\.14 \(c\).*under EP"):
        mesh_config(_worker_args(argv + ["--quantize", "int8"]))
    mesh = mesh_config(_worker_args(argv))
    with pytest.raises(NotImplementedError, match=r"A\.14 \(c\)"):
        tmesh.check_tp(get_config("tiny-moe"), mesh, {"quantize": "int8"})


@pytest.mark.parametrize("kw", [dict(seq=2), dict(pipe=2), dict(expert=2, seq=2),
                                dict(data=2, pipe=2)])
def test_seq_and_pipe_are_refused_naming_a15(kw):
    with pytest.raises(NotImplementedError, match="A.15"):
        tmesh.check_tp(get_config("tiny-moe"), tmesh.MeshConfig(**kw))


class _Spawned(Exception):
    pass


def test_worker_builds_ep_meshes_and_refuses_undividable_experts(monkeypatch):
    """The worker takes --expert-parallel and --data-parallel with
    --tensor-parallel (its build reaches the followers' spawn, stubbed,
    with the whole mesh), and refuses tiny-moe's 4 experts over 3 expert
    ranks before any spawn."""
    from dynamo_tpu_torch import worker

    seen = []

    def spawn(size, device, timeout_s=None, mesh=None):
        seen.append((size, mesh))
        raise _Spawned

    monkeypatch.setattr(worker, "spawn_followers", spawn)
    for argv, mesh in ((["--expert-parallel", "2"], tmesh.MeshConfig(expert=2)),
                       (["--expert-parallel", "2", "--tensor-parallel", "2",
                         "--data-parallel", "2"],
                        tmesh.MeshConfig(data=2, model=2, expert=2))):
        with pytest.raises(_Spawned):
            worker.build_runner(_worker_args(["--model", "tiny-moe", *argv]))
        assert seen[-1] == (mesh.n_devices, mesh)
        card = worker.model_card(_worker_args(argv), get_config("tiny-moe"))
        assert card.runtime_config["mesh"] == list(mesh.shape)
    with pytest.raises(ValueError, match="n_experts"):
        worker.build_runner(_worker_args(["--model", "tiny-moe", "--expert-parallel", "3"]))
    assert len(seen) == 2
    with pytest.raises(ValueError, match="--expert-parallel 0"):
        worker.mesh_config(_worker_args(["--expert-parallel", "0"]))
