"""Fast restart and weight reloads in the port against the JAX package.

The counterparts of tests/test_shm_weights.py and tests/test_rl.py:
- shm stages (engine/shm_weights.py): one published by the port attaches
  in the reference and one published by the reference in the port, arrays
  and meta equal; views are read-only; a corrupt segment reads as absent
  and is replaced; a stage outlives its creator's and an attacher's exit
  (subprocesses); build_runner attaches on its second build and replaces
  a stage whose fingerprint differs, and under --quantize reads every
  tier quantized and writes the stage and the snapshot unquantized;
- the params snapshot (engine/weights.py): bit for bit round trips, a
  reference orbax directory refused by name, the reference's orbax tree
  written as a port snapshot loads equal to it;
- update_weights: a paused engine refuses requests; after a reload the
  greedy streams equal the JAX engine's on the new params token for token;
  the in-flight request ends with the reference's error item; the prefix
  cache and the host tier are emptied and the removals published;
  weights_version counts; an int8 runner's reload equals quantize_params
  of the new tree; a reload whose read fails after its first copy stops
  the engine serving until a reload succeeds; a self-draft follows the reload and a draft of its own
  does not; the rl endpoint answers as the reference's over the request
  plane; after a swap the stage is unlinked and the snapshot refreshed;
- the worker: --draft-checkpoint and --lora NAME=PEFT_DIR over
  --checkpoint stream what the reference worker streams on the same files
  (both in f32), and the three restart tiers as worker processes.
Every test names its /dev/shm segments by its pid and unlinks them in a
`finally`.
"""

import asyncio
import functools
import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file as st_save

import dynamo_tpu.engine.weights as jweights
import dynamo_tpu.worker as jworker
from dynamo_tpu.engine import shm_weights as jshm
from dynamo_tpu.engine.engine import InferenceEngine as JaxEngine
from dynamo_tpu.engine.model_runner import ModelRunner as JaxRunner
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.models.config import get_config as jax_get_config
from dynamo_tpu.runtime.context import Context as JaxContext
from dynamo_tpu_torch import worker
from dynamo_tpu_torch.engine import shm_weights, weights
from dynamo_tpu_torch.engine.engine import InferenceEngine
from dynamo_tpu_torch.engine.model_runner import ModelRunner
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.models.config import get_config
from dynamo_tpu_torch.models.quant import quantize_params
from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.runtime.discovery import FileDiscovery, MemDiscovery
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.worker_common import serve_worker

ROOT = Path(__file__).resolve().parents[1]
CFG = get_config("tiny")
BF16 = np.dtype(ml_dtypes.bfloat16)
T = 60  # bound on every awaited scenario, seconds
GEOMETRY = dict(num_pages=64, page_size=4, max_pages_per_seq=16,
                decode_buckets=(1, 2, 4, 8), prefill_buckets=(8, 16, 32))
SMALL = ["--num-pages", "64", "--page-size", "4", "--max-seq-len", "64",
         "--max-batch", "4", "--chunk-size", "16"]
ERROR = "weights updated mid-flight; retry"


def _seg(tag):
    return f"t{os.getpid()}{tag}"


@pytest.fixture(autouse=True)
def _fresh_registries():
    yield
    MemDiscovery.reset()


def _jparams(seed):
    return jax.device_get(jllama.init_params(jax_get_config("tiny"), jax.random.PRNGKey(seed),
                                             jnp.float32))


def _tree(seed, dtype=torch.float32):
    return params_from_numpy(_jparams(seed), CFG, "cpu", dtype)


def _assert_trees_equal(got, want, prefix=""):
    assert sorted(got) == sorted(want), prefix
    for k in want:
        if isinstance(want[k], dict):
            _assert_trees_equal(got[k], want[k], f"{prefix}{k}/")
        else:
            assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), prefix + k


def _bits(x):
    """A leaf's bytes: a torch tensor, or a numpy array (the reference's
    bf16, or the port's uint16 view of it)."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy()
    return np.ascontiguousarray(x).view(np.uint8)


# -- shm stages --------------------------------------------------------------

def _stage_tree():
    g = torch.Generator().manual_seed(0)
    return {"embed": torch.randn(32, 16, generator=g).to(torch.bfloat16),
            "norm_f": torch.ones(16),
            "layers": {"wq": torch.arange(2 * 16 * 16, dtype=torch.float32).reshape(2, 16, 16),
                       "attn_norm": torch.randn(2, 16, generator=g)}}


@pytest.mark.parametrize("direction", ["port_to_reference", "reference_to_port"])
def test_stage_attaches_across_packages(direction):
    name = _seg("x")
    tree = _stage_tree()
    meta = {"model": "tiny", "dim": 16}
    try:
        if direction == "port_to_reference":
            assert shm_weights.publish(name, tree, meta=meta) is True
            stage = jshm.attach(name)
            assert str(stage.params["embed"].dtype) == "bfloat16"
        else:
            ref_tree = jax.tree_util.tree_map(
                lambda t: (t.view(torch.int16).numpy().view(BF16) if t.dtype == torch.bfloat16
                           else t.numpy()), tree)
            assert jshm.publish(name, ref_tree, meta=meta) is True
            stage = shm_weights.attach(name)
            assert stage.dtypes["embed"] == "bfloat16"
            _assert_trees_equal(stage.tensors("cpu"), tree)
        assert stage.meta == meta and stage.n_arrays == 4
        got = dict(weights.flatten(stage.params))
        for key, want in weights.flatten(tree):
            np.testing.assert_array_equal(_bits(got[key]), _bits(want))
        stage.close()
    finally:
        shm_weights.unlink(name)


def test_attached_views_are_read_only():
    name = _seg("r")
    try:
        shm_weights.publish(name, _stage_tree())
        stage = shm_weights.attach(name)
        with pytest.raises(ValueError):
            stage.params["layers"]["wq"][0, 0, 0] = 1.0
        t = stage.tensors("cpu")
        t["layers"]["wq"] += 1  # a copy: the stage keeps its bytes
        np.testing.assert_array_equal(stage.params["layers"]["wq"],
                                      _stage_tree()["layers"]["wq"].numpy())
        del t
        stage.close()
    finally:
        shm_weights.unlink(name)


def test_corrupt_segment_is_absent_and_replaced():
    name = _seg("c")
    try:
        with open(os.path.join(shm_weights.SHM_DIR, shm_weights._seg_name(name)), "wb") as f:
            f.write(b"\x00\x00\x00\x00\x00\x00\x00\x05garbage-not-msgpack")
        assert shm_weights.attach(name) is None
        assert shm_weights.publish(name, _stage_tree(), meta={"v": 1}) is True
        stage = shm_weights.attach(name)
        assert stage is not None and stage.meta == {"v": 1}
        # the same meta again: already staged, nothing written
        assert shm_weights.publish(name, _stage_tree(), meta={"v": 1}) is False
        stage.close()
    finally:
        shm_weights.unlink(name)


@pytest.mark.parametrize("who", ["creator", "attacher"])
def test_stage_survives_a_process_exit(who):
    name = _seg(who[0])
    body = ("import torch\nfrom dynamo_tpu_torch.engine import shm_weights as s\n"
            + (f"assert s.publish({name!r}, {{'w': torch.ones(8)}})\n" if who == "creator"
               else f"assert s.attach({name!r}) is not None\n")
            + "print('DONE')\n")
    try:
        if who == "attacher":
            shm_weights.publish(name, {"w": torch.ones(8)})
        out = subprocess.run([sys.executable, "-c", body], cwd=ROOT,
                             env=dict(os.environ, PYTHONPATH=str(ROOT)),
                             capture_output=True, text=True, timeout=120)
        assert "DONE" in out.stdout, out.stdout + out.stderr
        stage = shm_weights.attach(name)
        assert stage is not None, f"the stage died with its {who}"
        assert torch.equal(stage.tensors("cpu")["w"], torch.ones(8))
        stage.close()
    finally:
        shm_weights.unlink(name)


# -- a checkpoint directory and the worker's build ---------------------------

def _hf_dir(path, jparams, config):
    """The tiny tree as an HF directory (bf16 matrices, f32 norms), with a
    config.json config_from_hf derives `config` from."""
    path.mkdir(parents=True, exist_ok=True)
    t = {"model.embed_tokens.weight": jparams["embed"], "model.norm.weight": jparams["norm_f"],
         "lm_head.weight": jparams["lm_head"].T}
    L = jparams["layers"]
    names = {"wq": "self_attn.q_proj", "wk": "self_attn.k_proj", "wv": "self_attn.v_proj",
             "wo": "self_attn.o_proj", "w_gate": "mlp.gate_proj", "w_up": "mlp.up_proj",
             "w_down": "mlp.down_proj", "attn_norm": "input_layernorm",
             "mlp_norm": "post_attention_layernorm"}
    for leaf, hf in names.items():
        for i in range(config.n_layers):
            w = np.asarray(L[leaf][i])
            t[f"model.layers.{i}.{hf}.weight"] = w.T if w.ndim == 2 else w
    st_save({k: np.ascontiguousarray(np.asarray(v, np.float32)) for k, v in t.items()},
            str(path / "model.safetensors"))
    (path / "config.json").write_text(json.dumps({
        "model_type": "llama", "vocab_size": config.vocab_size,
        "hidden_size": config.dim, "num_hidden_layers": config.n_layers,
        "num_attention_heads": config.n_heads, "num_key_value_heads": config.n_kv_heads,
        "intermediate_size": config.ffn_dim, "max_position_embeddings": config.max_seq_len,
        "rope_theta": config.rope_theta, "rms_norm_eps": config.norm_eps,
        "tie_word_embeddings": False}))
    return str(path)


def test_config_from_the_hf_dir_is_the_preset(tmp_path):
    d = _hf_dir(tmp_path, _jparams(0), CFG)
    assert weights.config_from_hf(d, name="tiny") == CFG


def test_build_runner_attaches_its_stage_and_replaces_a_stale_one(tmp_path):
    name = _seg("b")
    ckpt = _hf_dir(tmp_path / "ckpt", _jparams(3), CFG)
    argv = ["--checkpoint", ckpt, "--device", "cpu", "--shm-weights", name] + SMALL
    try:
        args1 = worker.parse_args(argv)
        r1, cfg = worker.build_runner(args1)
        assert args1._weights_source == "checkpoint" and cfg == CFG
        stage = shm_weights.attach(name)
        assert stage.meta == weights.weights_fingerprint(CFG)
        stage.close()
        args2 = worker.parse_args(argv)
        r2, _ = worker.build_runner(args2)
        assert args2._weights_source == "shm"
        _assert_trees_equal(r2.params, r1.params)
        # another model's stage under the name: loaded cold, then replaced
        shm_weights.publish(name, _stage_tree(), meta={"model": "other"})
        args3 = worker.parse_args(argv)
        r3, _ = worker.build_runner(args3)
        assert args3._weights_source == "checkpoint"
        _assert_trees_equal(r3.params, r1.params)
        stage = shm_weights.attach(name)
        assert stage.meta == weights.weights_fingerprint(CFG)
        stage.close()
    finally:
        shm_weights.unlink(name)


def test_quantized_worker_writes_and_reads_the_warm_tiers(tmp_path):
    """Under --quantize each tier is quantized a row range at a time as it
    is read, and the tiers it writes hold the unquantized tree: cold (the
    checkpoint; the stage and the snapshot written as it reads), from the
    stage, and from the snapshot after the stage is unlinked (the stage
    written again as it reads), each tree quantize_params of the plain
    load."""
    name = _seg("q")
    ckpt = _hf_dir(tmp_path / "ckpt", _jparams(3), CFG)
    cache = str(tmp_path / "cache")
    argv = ["--checkpoint", ckpt, "--device", "cpu", "--quantize", "int8",
            "--shm-weights", name, "--orbax-cache", cache] + SMALL
    plain = weights.load_hf_checkpoint(ckpt, CFG, "cpu")
    want = quantize_params(plain, "int8")
    try:
        for tier in ("checkpoint", "shm", "snapshot"):
            if tier == "snapshot":
                shm_weights.unlink(name)
            args = worker.parse_args(argv)
            runner, _ = worker.build_runner(args)
            assert args._weights_source == tier
            _assert_trees_equal(runner.params, want)
            _assert_trees_equal(weights.load_snapshot(cache, CFG, "cpu"), plain)
            stage = shm_weights.attach(name)
            try:
                _assert_trees_equal(stage.tensors("cpu"), plain)
            finally:
                stage.close()
    finally:
        shm_weights.unlink(name)


def test_build_runner_refuses_what_it_cannot_load(tmp_path):
    with pytest.raises(FileNotFoundError, match="hub"):
        worker.build_runner(worker.parse_args(
            ["--checkpoint", "meta-llama/Llama-3.2-3B", "--device", "cpu"] + SMALL))
    snap = tmp_path / "snap"
    weights.save_snapshot(_tree(0), str(snap), CFG)
    with pytest.raises(SystemExit, match="does not match"):
        worker.build_runner(worker.parse_args(
            ["--model", "tiny-qwen3", "--orbax-cache", str(snap), "--device", "cpu"] + SMALL))


# -- the params snapshot -----------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_snapshot_round_trip(tmp_path, dtype):
    tree = _tree(1, dtype)
    weights.save_snapshot(tree, str(tmp_path / "snap"), CFG)
    _assert_trees_equal(weights.load_snapshot(str(tmp_path / "snap"), CFG, "cpu", dtype), tree)
    # written again over itself: replaced whole
    weights.save_snapshot(_tree(2, dtype), str(tmp_path / "snap"), CFG)
    _assert_trees_equal(weights.load_snapshot(str(tmp_path / "snap"), CFG, "cpu", dtype),
                        _tree(2, dtype))
    assert os.listdir(tmp_path) == ["snap"]
    with pytest.raises(ValueError, match="quantized"):
        weights.save_snapshot(quantize_params(tree), str(tmp_path / "q"), CFG)


def test_reference_orbax_snapshot_is_refused_and_its_tree_carries(tmp_path):
    jp = _jparams(5)
    jweights.save_orbax(jp, str(tmp_path / "orbax"))
    with pytest.raises(ValueError, match=weights.SNAPSHOT_FORMAT):
        weights.load_snapshot(str(tmp_path / "orbax"), CFG, "cpu")
    restored = jweights.load_orbax(str(tmp_path / "orbax"))
    want = params_from_numpy(restored, CFG, "cpu", torch.float32)
    weights.save_snapshot(want, str(tmp_path / "snap"), CFG)
    got = weights.load_snapshot(str(tmp_path / "snap"), CFG, "cpu", torch.float32)
    _assert_trees_equal(got, want)
    _assert_trees_equal(got, params_from_numpy(jp, CFG, "cpu", torch.float32))
    with pytest.raises(ValueError, match="does not match"):
        weights.load_snapshot(str(tmp_path / "snap"), CFG.with_(n_layers=3), "cpu")


# -- update_weights ----------------------------------------------------------

def _req(prompt, n=6):
    return {"token_ids": list(prompt), "sampling": {"temperature": 0.0},
            "stop": {"max_tokens": n, "stop_ids": []}}


async def _collect(engine, req, ctx_cls=Context):
    toks, items = [], []
    async for item in engine.generate(req, ctx_cls()):
        items.append(item)
        toks.extend(item["token_ids"])
    return toks, items


def _prompts(seed, lens=(3, 17, 11, 9)):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 500, size=n).tolist() for n in lens]


async def test_update_weights_flushes_and_serves_the_new_weights(tmp_path):
    snap = str(tmp_path / "v1")
    weights.save_snapshot(_tree(1), snap, CFG)
    runner = ModelRunner(CFG, device="cpu", dtype=torch.float32, params=_tree(0),
                         **dict(GEOMETRY, num_pages=24))
    engine = InferenceEngine(runner, max_batch=4, chunk_size=16, host_kv_blocks=32)
    events = []
    engine.on_kv_event(events.extend)
    jeng = JaxEngine(JaxRunner(jax_get_config("tiny"), params=_jparams(1), dtype=jnp.float32,
                               **GEOMETRY), max_batch=4, chunk_size=16)
    try:
        # fill the prefix cache and, through evictions, the host tier
        for p in _prompts(7, (20,) * 6):
            await _collect(engine, _req(p, 2))
        assert engine.pool.by_hash and len(engine.host_pool.host) > 0
        engine.paused = True
        _, items = await _collect(engine, _req([1, 2, 3], 2))
        assert items[-1]["finish_reason"] == "error" and "paused" in items[-1]["error"]
        engine.paused = False
        # a request in flight when the weights change
        stream = engine.generate(_req(_prompts(8, (12,))[0], 40), Context())
        first = await stream.__anext__()
        assert first["token_ids"] and not first["finish_reason"]
        n_events = len(events)
        assert await engine.update_weights(snap) == 1 and engine.weights_version == 1
        rest = [item async for item in stream]
        assert rest[-1]["finish_reason"] == "error" and rest[-1]["error"] == ERROR
        assert rest[-1]["token_ids"] == []
        assert not engine.pool.by_hash and len(engine.host_pool.host) == 0
        removed = {h for e in events[n_events:] if e.kind == "remove" for h in e.block_hashes}
        assert removed and {e.tier for e in events[n_events:] if e.kind == "remove"} >= {
            "device", "host"}
        _assert_trees_equal(runner.params, _tree(1))
        # a prompt served before the reload: no prefix reused after it
        before = engine.scheduler.reused_prefix_tokens
        prompts = _prompts(7, (20,)) + _prompts(9)
        got = [await _collect(engine, _req(p)) for p in prompts]
        want = [await _collect(jeng, _req(p), JaxContext) for p in prompts]
        assert engine.scheduler.reused_prefix_tokens == before
        assert [t for t, _ in got] == [t for t, _ in want]
        assert await engine.update_weights(snap) == 2
        with pytest.raises(ValueError, match="snapshot"):
            await engine.update_weights(str(tmp_path / "missing"))
        assert engine.weights_version == 2
    finally:
        engine.stop()
        jeng.stop()


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_quantized_reload_requantizes(tmp_path, mode):
    weights.save_snapshot(_tree(1), str(tmp_path / "snap"), CFG)
    runner = ModelRunner(CFG, device="cpu", dtype=torch.float32, params=_tree(0),
                         quantize=mode, **GEOMETRY)
    held = {k: v for k, v in weights.flatten(runner.params)}
    runner.reload_params(str(tmp_path / "snap"))
    _assert_trees_equal(runner.params, quantize_params(_tree(1), mode))
    # in place: every leaf is the tensor the runner held
    assert all(v is held[k] for k, v in weights.flatten(runner.params))


def test_reload_and_the_draft_trees(tmp_path):
    """A self-draft sharing the target's tensors follows the reload (a
    departure: the reference's draft keeps its old arrays); a draft tree
    of its own keeps its weights, as there."""
    weights.save_snapshot(_tree(1), str(tmp_path / "snap"), CFG)
    own = ModelRunner(CFG, device="cpu", dtype=torch.float32, params=_tree(0),
                      draft_config=CFG, draft_params=_tree(2), **GEOMETRY)
    shared_params = _tree(0)
    shared = ModelRunner(CFG, device="cpu", dtype=torch.float32, params=shared_params,
                         draft_config=CFG, draft_params=shared_params, **GEOMETRY)
    for r in (own, shared):
        r.draft_k_pool.fill_(1.0)
        r.reload_params(str(tmp_path / "snap"))
        r.reset_kv_pools()
        assert not r.draft_k_pool.any() and not r.k_pool.any()
    _assert_trees_equal(own.params, _tree(1))
    _assert_trees_equal(own.draft_params, _tree(2))
    _assert_trees_equal(shared.draft_params, _tree(1))


async def test_a_reload_failing_mid_copy_stops_serving(tmp_path, monkeypatch):
    """A read that fails after the reload's first copy leaves the served
    tree a mix of old and new leaves: the in-flight request ends with the
    reload's error item, every request after it is refused, rl answers the
    failure and describe reports it, weights_version stays; a reload that
    succeeds serves again."""
    from dynamo_tpu_torch.engine import st_io
    from dynamo_tpu_torch.worker_common import rl_admin

    snap = str(tmp_path / "v1")
    weights.save_snapshot(_tree(1), snap, CFG)
    engine = InferenceEngine(ModelRunner(CFG, device="cpu", dtype=torch.float32,
                                         params=_tree(0), **GEOMETRY),
                             max_batch=4, chunk_size=16)
    card = worker.model_card(worker.parse_args(SMALL), CFG)
    read_into = st_io.HostBounce.read_into
    reads = []

    def failing(self, fd, offset, out):
        reads.append(offset)
        if len(reads) == 5:
            raise OSError(f"short read at byte {offset}")
        read_into(self, fd, offset, out)

    try:
        stream = engine.generate(_req(_prompts(8, (12,))[0], 40), Context())
        first = await stream.__anext__()
        assert first["token_ids"] and not first["finish_reason"]
        monkeypatch.setattr(st_io.HostBounce, "read_into", failing)
        got = await rl_admin(engine, card, {"op": "update_weights", "orbax": snap},
                             None, 7)
        monkeypatch.setattr(st_io.HostBounce, "read_into", read_into)
        assert got["error"].startswith("weight reload failed: ") and "mix" in got["error"]
        rest = [item async for item in stream]
        assert rest[-1]["finish_reason"] == "error" and rest[-1]["error"] == ERROR
        leaves = dict(weights.flatten(engine.runner.params))
        old, new = dict(weights.flatten(_tree(0))), dict(weights.flatten(_tree(1)))
        assert any(torch.equal(leaves[k], new[k]) and not torch.equal(leaves[k], old[k])
                   for k in leaves), "no leaf took the new weights"
        assert any(not torch.equal(leaves[k], new[k]) for k in leaves), "nothing stayed old"
        _, items = await _collect(engine, _req([1, 2, 3], 2))
        assert items[-1]["finish_reason"] == "error"
        assert items[-1]["error"].startswith("weights incomplete after a failed reload")
        described = await rl_admin(engine, card, {}, None, 7)
        assert described["weights_version"] == 0 and "short read" in described["weights_error"]
        got = await rl_admin(engine, card, {"op": "update_weights", "orbax": snap}, None, 7)
        assert got["weights_version"] == 1 and engine.weights_error is None
        _assert_trees_equal(engine.runner.params, _tree(1))
        toks, items = await _collect(engine, _req([1, 2, 3], 4))
        assert len(toks) == 4 and items[-1]["finish_reason"] == "length"
        assert "weights_error" not in await rl_admin(engine, card, {}, None, 7)
    finally:
        engine.stop()


async def test_rl_update_weights_over_the_request_plane(tmp_path):
    snap = str(tmp_path / "v1")
    weights.save_snapshot(_tree(1), snap, CFG)
    rt = DistributedRuntime(discovery=MemDiscovery(realm="rl-reload"))
    engine = InferenceEngine(ModelRunner(CFG, device="cpu", dtype=torch.float32,
                                         params=_tree(0), **GEOMETRY),
                             max_batch=4, chunk_size=16)
    w = await serve_worker(rt, engine, worker.model_card(worker.parse_args(SMALL), CFG))
    client_rt = DistributedRuntime(discovery=MemDiscovery(realm="rl-reload"))
    try:
        rl = client_rt.client("dyn/tpu-worker/rl")
        await rl.wait_ready(timeout=T)

        async def call(req):
            return [item async for item in rl.generate(req, Context())][0]

        got = await call({"op": "update_weights", "orbax": snap})
        assert got == {"model": "tiny", "paused": False, "weights_version": 1,
                       "instance": w.instance.instance_id}
        bad = await call({"op": "update_weights", "orbax": str(tmp_path / "none")})
        assert bad["error"].startswith("weight reload failed: ")
        assert "needs 'orbax'" in (await call({"op": "update_weights"}))["error"]
        assert (await call({}))["weights_version"] == 1
        _assert_trees_equal(engine.runner.params, _tree(1))
    finally:
        await client_rt.shutdown(drain_timeout=1)
        await rt.shutdown(drain_timeout=1)
        await w.stop()


async def test_a_swap_unlinks_the_stage_and_refreshes_the_snapshot(tmp_path):
    name = _seg("s")
    ckpt = _hf_dir(tmp_path / "ckpt", _jparams(0), CFG)
    cache, new = str(tmp_path / "cache"), str(tmp_path / "v1")
    weights.save_snapshot(_tree(1), new, CFG)
    args = worker.parse_args(["--checkpoint", ckpt, "--device", "cpu", "--shm-weights", name,
                              "--orbax-cache", cache] + SMALL)
    try:
        engine = worker.build_engine(args)
        try:
            assert shm_weights.attach(name) is not None  # published at boot
            _assert_trees_equal(weights.load_snapshot(cache, CFG, "cpu"),
                                engine.runner.params)  # written at boot
            assert await engine.update_weights(new) == 1
            assert shm_weights.attach(name) is None, "the stale stage survived the swap"
            _assert_trees_equal(weights.load_snapshot(cache, CFG, "cpu", torch.float32),
                                _tree(1))
        finally:
            engine.stop()
    finally:
        shm_weights.unlink(name)


# -- the worker against the reference worker ---------------------------------

def _peft_dir(path, rank=4, seed=0):
    rng = np.random.default_rng(seed)
    dims = {"q_proj": (CFG.dim, CFG.n_heads * CFG.head_dim),
            "v_proj": (CFG.dim, CFG.n_kv_heads * CFG.head_dim),
            "down_proj": (CFG.ffn_dim, CFG.dim)}
    t = {}
    for layer in range(CFG.n_layers):
        for proj, (din, dout) in dims.items():
            sub = "mlp" if proj == "down_proj" else "self_attn"
            pre = f"base_model.model.model.layers.{layer}.{sub}.{proj}"
            t[f"{pre}.lora_A.weight"] = (0.3 * rng.standard_normal((rank, din))).astype(np.float32)
            t[f"{pre}.lora_B.weight"] = (0.3 * rng.standard_normal((dout, rank))).astype(np.float32)
    path.mkdir(parents=True, exist_ok=True)
    st_save(t, str(path / "adapter_model.safetensors"))
    (path / "adapter_config.json").write_text(json.dumps({"r": rank, "lora_alpha": 8.0}))
    return str(path)


@pytest.mark.parametrize("flags", ["draft", "lora"])
async def test_checkpoint_worker_streams_match_reference_worker(tmp_path, monkeypatch, flags):
    """Both workers built from the same argv over the same files, both in
    f32 (the loaders' and runners' dtype patched), step their engines
    themselves: greedy streams equal."""
    ckpt = _hf_dir(tmp_path / "ckpt", _jparams(0), CFG)
    argv = ["--checkpoint", ckpt, "--model-name", "tiny"] + SMALL
    if flags == "draft":
        argv += ["--draft-checkpoint", _hf_dir(tmp_path / "draft", _jparams(1), CFG),
                 "--spec-gamma", "3"]
    else:
        argv += ["--lora", f"ad={_peft_dir(tmp_path / 'peft')}"]
    monkeypatch.setattr(weights, "load_hf_checkpoint",
                        functools.partial(weights.load_hf_checkpoint, dtype=torch.float32))
    monkeypatch.setattr(worker, "ModelRunner",
                        functools.partial(ModelRunner, dtype=torch.float32))
    monkeypatch.setattr(jweights, "load_hf_checkpoint",
                        functools.partial(jweights.load_hf_checkpoint, dtype="float32"))
    monkeypatch.setattr(jworker, "ModelRunner",
                        functools.partial(JaxRunner, dtype=jnp.float32))
    teng = worker.build_engine(worker.parse_args(argv + ["--device", "cpu"]))
    jeng, _ = jworker.build_engine(jworker.parse_args(argv))
    try:
        assert teng.runner.config == CFG.with_(name="tiny")
        reqs = [_req(p, 8) for p in _prompts(11)]
        if flags == "lora":
            reqs += [dict(r, adapter="ad") for r in reqs]
        got = [await _collect(teng, r) for r in reqs]
        want = [await _collect(jeng, r, JaxContext) for r in reqs]
        assert [t for t, _ in got] == [t for t, _ in want]
        if flags == "lora":  # the adapter changes the streams
            assert [t for t, _ in got[:4]] != [t for t, _ in got[4:]]
    finally:
        teng.stop()
        jeng.stop()


async def test_restart_tiers_as_worker_processes(tmp_path):
    """`python -m dynamo_tpu_torch.worker --checkpoint DIR --orbax-cache
    SNAP --shm-weights NAME`, three times: cold (publishes, writes the
    snapshot), from the stage, and from the snapshot after the stage is
    unlinked; each serves the same greedy tokens."""
    name = _seg("p")
    ckpt = _hf_dir(tmp_path / "ckpt", _jparams(0), CFG)
    snap = str(tmp_path / "snap")

    async def run(i):
        log = open(tmp_path / f"w{i}.log", "wb")
        proc = await asyncio.create_subprocess_exec(
            sys.executable, "-m", "dynamo_tpu_torch.worker", "--device", "cpu",
            "--checkpoint", ckpt, "--orbax-cache", snap, "--shm-weights", name, *SMALL,
            "--discovery-backend", "file", "--discovery-root", str(tmp_path / f"d{i}"),
            cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT)),
            stdout=asyncio.subprocess.PIPE, stderr=log)
        rt = DistributedRuntime(discovery=FileDiscovery(str(tmp_path / f"d{i}"),
                                                        poll_interval=0.05),
                                event_transport="inproc")
        try:
            line = b""
            while b"worker serving" not in line:
                line = await proc.stdout.readline()
                assert line, "the worker exited before serving"
            client = rt.client("dyn/tpu-worker/generate")
            await client.wait_ready(timeout=T)
            toks = []
            async for item in client.generate(_req(_prompts(3)[1], 5), Context()):
                toks.extend(item["token_ids"])
            await client.close()
            proc.send_signal(signal.SIGTERM)
            assert await proc.wait() == 0
        finally:
            if proc.returncode is None:
                proc.kill()
                await proc.wait()
            await rt.shutdown(drain_timeout=1)
            log.close()
        return toks, (tmp_path / f"w{i}.log").read_text()

    try:
        cold, log0 = await asyncio.wait_for(run(0), 2 * T)
        assert "loading HF checkpoint" in log0 and "writing params snapshot" in log0
        shm, log1 = await asyncio.wait_for(run(1), 2 * T)
        assert "fast restart: attached" in log1 and "loading HF checkpoint" not in log1
        assert "params snapshot" not in log1
        shm_weights.unlink(name)
        warm, log2 = await asyncio.wait_for(run(2), 2 * T)
        assert "fast restart: loading params snapshot" in log2
        assert "loading HF checkpoint" not in log2
        assert len(cold) == 5 and cold == shm == warm
    finally:
        shm_weights.unlink(name)
