"""Expert and data parallelism with ranks as processes, on the CPU: the
runner's forward at EP 2, EP 2 x TP 2 and DP 2 x EP 2 against the JAX
runner on the same mesh (the prefill's token dispatch, decode at one row
on the dense fallback, decode at two rows dispatched, a tight capacity),
each rank's pools, greedy engine streams against the JAX engine on the
meshes of the reference's own engine tests, and KV pages between EP and
EP 1 runners (the moe_ep op and the pieces: tests/test_torch_ep.py).

Worlds of 2 and 4 ranks are spawned for the module (parallel/group.py
spawn_followers; rank 0 is this process, gloo carries the collectives)
and laid out as each case's mesh (TPGroup.remesh). The JAX side runs as
its own tests run it, on the host CPU devices of tests/conftest.py. Params
are the JAX init trees at f32, carried across with params_from_numpy;
each rank cuts its own slices.
"""

import asyncio
import os
import signal
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.engine import InferenceEngine as JaxEngine
from dynamo_tpu.engine.model_runner import ModelRunner as JaxRunner
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.models.config import get_config as jax_get_config
from dynamo_tpu.parallel.mesh import MeshConfig as JaxMesh
from dynamo_tpu.runtime.context import Context as JaxContext
from dynamo_tpu_torch.engine.engine import InferenceEngine
from dynamo_tpu_torch.engine.model_runner import ModelRunner
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.models.config import get_config
from dynamo_tpu_torch.parallel.group import (
    MirroredRunner,
    shutdown_followers,
    spawn_followers,
)
from dynamo_tpu_torch.parallel.mesh import MeshConfig
from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.runtime.discovery import FileDiscovery
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime

ROOT = Path(__file__).resolve().parents[1]
pytestmark = pytest.mark.skipif(len(jax.devices()) < 4, reason="needs 4 CPU devices")

GEOMETRY = dict(num_pages=96, page_size=4, max_pages_per_seq=16,
                decode_buckets=(1, 2, 4, 8), prefill_buckets=(8, 16, 32))
_rng = np.random.default_rng(7)
PROMPTS = [_rng.integers(1, 500, size=n).tolist() for n in (6, 4, 9, 5, 13)]
GREEDY = {"temperature": [0.0], "top_k": [0], "top_p": [1.0], "seeds": [0]}


@pytest.fixture(scope="module")
def worlds():
    """Worlds of spawned gloo ranks by size, made on first use."""
    made = {}

    def get(size):
        if size not in made:
            made[size] = spawn_followers(size, "cpu")
        return made[size]

    yield get
    for g, procs in made.values():
        assert shutdown_followers(g, procs) == [0] * (g.size - 1)


def _mirrored(worlds, mesh_kw, cfg, jp, **kw):
    mesh = MeshConfig(**mesh_kw)
    g, procs = worlds(mesh.n_devices)
    if g.mesh != mesh:
        g.remesh(mesh)
    return MirroredRunner(g, procs, config=cfg, device="cpu", dtype=torch.float32,
                          params=params_from_numpy(jp, cfg, "cpu", torch.float32), **kw)


def _jtree(jcfg, seed):
    return jax.device_get(jllama.init_params(jcfg, jax.random.PRNGKey(seed), jnp.float32))


# (preset, mesh, config changes): every MoE family on each mesh shape, and
# a capacity that drops pairs
CASES = {
    "moe-ep2": ("tiny-moe", dict(expert=2), {}),
    "moe-ep2_tp2": ("tiny-moe", dict(expert=2, model=2), {}),
    "moe_shared-dp2_ep2": ("tiny-moe-shared", dict(data=2, expert=2), {}),
    "mla_moe-ep2": ("tiny-mla-moe", dict(expert=2), {}),
    "mla_moe-ep2_tp2": ("tiny-mla-moe", dict(expert=2, model=2), {}),
    "moe_tight-ep2": ("tiny-moe", dict(expert=2), dict(moe_capacity_factor=0.5)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_logits_and_rank_pools_match_jax_mesh(worlds, case):
    """A 13-token prefill (bucket 16: the token dispatch), three decode
    steps at one row (the dense fallback) and two at two rows (bucket 2:
    dispatched) against the JAX runner on the same mesh: the logits within
    1e-4, the tokens equal, each rank's pools the JAX pools' slice of its
    model coordinate (an MLA latent pool whole), every rank's digest and
    counters alike, and both MoE paths taken on every rank."""
    name, mesh_kw, cfg_kw = CASES[case]
    jcfg, cfg = jax_get_config(name).with_(**cfg_kw), get_config(name).with_(**cfg_kw)
    jp = _jtree(jcfg, 3)
    jrun = JaxRunner(jcfg, JaxMesh(**mesh_kw), params=jp, dtype=jnp.float32, **GEOMETRY)
    trun = _mirrored(worlds, mesh_kw, cfg, jp, **GEOMETRY)
    try:
        trun.reset_counters()
        prompt, table = PROMPTS[4], [5, 2, 9, 11]
        want = np.asarray(jrun.prefill(prompt, 0, table, 0))
        got = trun.prefill(prompt, 0, table, 0).numpy()
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
        tok = int(np.argmax(want))
        jt = np.asarray(jrun.decode_multi(3, [tok], [len(prompt)], [table], GREEDY, 0))
        tt = trun.decode_multi(3, [tok], [len(prompt)], [table], GREEDY, 0)
        np.testing.assert_array_equal(tt, jt)
        # a second sequence beside it: decode at two rows
        p2, t2 = PROMPTS[2], [20, 21, 22]
        tok2 = int(np.argmax(np.asarray(jrun.prefill(p2, 0, t2, 0))))
        trun.prefill(p2, 0, t2, 0)
        two = {k: v * 2 for k, v in GREEDY.items()}
        args = (2, [int(jt[0, -1]), tok2], [len(prompt) + 3, len(p2)], [table, t2], two, 0)
        np.testing.assert_array_equal(trun.decode_multi(*args),
                                      np.asarray(jrun.decode_multi(*args)))
        mc = MeshConfig(**mesh_kw)
        pages = table + t2
        for r, rp in enumerate(trun.rank_pools()):
            m = mc.coords(r)["model"]
            for key, jpool in (("k", jrun.k_pool), ("v", jrun.v_pool)):
                ref = np.asarray(jpool)[:, pages]
                if not cfg.is_mla:
                    hk = cfg.n_kv_heads // mc.model
                    ref = ref[..., m * hk:(m + 1) * hk, :]
                np.testing.assert_allclose(rp[key][:, pages], ref, atol=1e-5, rtol=1e-5)
        reps = trun.rank_reports()
        for rep in reps:
            assert rep["digest"] == reps[0]["digest"] and rep["stats"] == reps[0]["stats"]
            assert rep["coords"] == {**mc.coords(rep["rank"])}
            # the prefills and the two-row steps dispatch; one-row steps fall back
            assert rep["ep"]["dispatches"] > 0 and rep["ep"]["fallbacks"] > 0, rep["ep"]
            assert rep["collectives"]["expert"]["all_to_all_calls"] == 3 * rep["ep"][
                "dispatches"]
        # the pairs of the dispatched steps (two 16-token prefills, two
        # 2-row steps), k = 2 each a MoE layer: every one sent but past a
        # tight capacity
        sent = sum(rep["ep"]["rows_sent"] for rep in reps) * mc.expert // mc.n_devices
        pairs = 2 * (16 + 16 + 2 + 2) * trun.moe_layers
        assert sent < pairs if cfg_kw else sent == pairs
    finally:
        trun.close()


class _Stepped:
    """Stands in for the engine's step thread: the test steps the engine."""

    def join(self, timeout=None):
        pass


async def _generate(engine, prompt, n, ctx_cls):
    """The reference's _generate, the engine stepped from the test."""
    engine._thread = _Stepped()
    req = {"token_ids": prompt, "sampling": {"temperature": 0.0},
           "stop": {"max_tokens": n, "stop_ids": []}}

    async def one():
        toks = []
        async for item in engine.generate(req, ctx_cls()):
            toks.extend(item["token_ids"])
            if item["finish_reason"]:
                return toks

    try:
        task = asyncio.ensure_future(one())
        while not task.done():
            for _ in range(4):
                await asyncio.sleep(0)
            engine._loop_once()
        return task.result()
    finally:
        engine.stop()


# the reference's engine tests (tests/test_parallel.py): tiny-moe at EP 2
# and EP 2 x TP 2 with a lossless capacity, tiny at DP 2 x TP 2
STREAMS = {
    "moe_ep2": ("tiny-moe", dict(expert=2), [1, 2, 3, 4, 5, 6], 4, 3),
    "moe_ep2_tp2": ("tiny-moe", dict(expert=2, model=2), [1, 2, 3, 4, 5, 6], 4, 3),
    "dp2_tp2": ("tiny", dict(data=2, model=2), [2, 7, 1, 8, 2, 8], 5, 7),
}


@pytest.mark.parametrize("case", sorted(STREAMS))
async def test_greedy_streams_match_the_reference_engine_tests(worlds, case):
    name, mesh_kw, prompt, n, seed = STREAMS[case]
    jcfg, cfg = jax_get_config(name), get_config(name)
    if jcfg.is_moe:  # lossless: capacity covers every routed token
        cf = jcfg.n_experts / jcfg.n_experts_active
        jcfg, cfg = jcfg.with_(moe_capacity_factor=cf), cfg.with_(moe_capacity_factor=cf)
    jp = _jtree(jcfg, seed)
    geometry = dict(num_pages=32, page_size=4, max_pages_per_seq=8, decode_buckets=(1, 2, 4),
                    prefill_buckets=(8,))
    jrun = JaxRunner(jcfg, JaxMesh(**mesh_kw), params=jp, dtype=jnp.float32, **geometry)
    want = await _generate(JaxEngine(jrun, max_batch=4, chunk_size=16), prompt, n, JaxContext)
    trun = _mirrored(worlds, mesh_kw, cfg, jp, **geometry)
    try:
        got = await _generate(InferenceEngine(trun, max_batch=4, chunk_size=16), prompt, n,
                              Context)
        assert got == want and len(got) == n
        reps = trun.rank_reports()
        assert len({r["digest"] for r in reps}) == 1 and reps[0]["outputs"] > 0
    finally:
        trun.close()


@pytest.mark.parametrize("mesh", ["ep2", "ep2_tp2"])
def test_ep_pages_cross_to_an_ep1_runner_bit_for_bit(worlds, mesh):
    """Pages an EP runner exports (whole heads, from the ranks at expert
    and data 0, gathered over the model group) import into an EP 1 runner
    and export back bit for bit, and the EP 1 runner's pages into the EP
    runner (each rank keeping its model coordinate's heads) likewise."""
    mesh_kw = {"ep2": dict(expert=2), "ep2_tp2": dict(expert=2, model=2)}[mesh]
    jcfg, cfg = jax_get_config("tiny-moe"), get_config("tiny-moe")
    jp = _jtree(jcfg, 4)
    one = ModelRunner(cfg, device="cpu", dtype=torch.float32,
                      params=params_from_numpy(jp, cfg, "cpu", torch.float32), **GEOMETRY)
    trun = _mirrored(worlds, mesh_kw, cfg, jp, **GEOMETRY)
    try:
        prompt, table = PROMPTS[4], [5, 2, 9, 11]
        trun.prefill(prompt, 0, table, 0)
        one.prefill(prompt, 0, table, 0)
        payload, own = trun.export_pages(table), one.export_pages(table)
        assert payload["tp"] == mesh_kw.get("model", 1) and own["tp"] == 1
        assert payload["shape"] == own["shape"]
        np.testing.assert_allclose(np.frombuffer(payload["k"], np.float32),
                                   np.frombuffer(own["k"], np.float32), atol=1e-5)
        dst = [40, 41, 42, 43]
        one.import_pages(dst, 0, payload)
        back = one.export_pages(dst)
        assert back["k"] == payload["k"] and back["v"] == payload["v"]
        trun.import_pages(dst, 0, own)
        again = trun.export_pages(dst)
        assert again["k"] == own["k"] and again["v"] == own["v"]
    finally:
        trun.close()


async def test_ep_dp_worker_serves_and_exits_0_on_sigterm(tmp_path):
    """`python -m dynamo_tpu_torch.worker --expert-parallel 2 --data-parallel
    2`: four rank processes, the mesh printed and on the model card, a
    greedy request served, every rank gone after SIGTERM."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))

    async def run():
        proc = await asyncio.create_subprocess_exec(
            sys.executable, "-m", "dynamo_tpu_torch.worker", "--device", "cpu",
            "--model", "tiny-moe", "--expert-parallel", "2", "--data-parallel", "2",
            "--num-pages", "64", "--page-size", "4", "--max-seq-len", "64",
            "--max-batch", "4", "--chunk-size", "16", "--discovery-backend", "file",
            "--discovery-root", str(tmp_path), cwd=ROOT, env=env,
            stdout=asyncio.subprocess.PIPE, stderr=asyncio.subprocess.DEVNULL)
        rt = DistributedRuntime(discovery=FileDiscovery(str(tmp_path), poll_interval=0.05),
                                event_transport="inproc")
        lines = []
        try:
            while not lines or b"worker serving" not in lines[-1]:
                line = await proc.stdout.readline()
                assert line, f"the worker exited before serving: {lines}"
                lines.append(line)
            client = rt.client("dyn/tpu-worker/generate")
            await client.wait_ready(timeout=60)
            toks, finish = [], None
            async for item in client.generate(
                    {"token_ids": PROMPTS[0], "sampling": {"temperature": 0.0},
                     "stop": {"max_tokens": 4, "stop_ids": []}}, Context()):
                toks.extend(item["token_ids"])
                finish = item.get("finish_reason") or finish
            cards = [i.metadata["model_card"] for i in client.instances.values()]
            await client.close()
            proc.send_signal(signal.SIGTERM)
            rc = await proc.wait()
        finally:
            if proc.returncode is None:
                proc.kill()
                await proc.wait()
            await rt.shutdown(drain_timeout=1)
        return toks, finish, rc, lines, cards

    toks, finish, rc, lines, cards = await asyncio.wait_for(run(), 120)
    assert rc == 0 and finish == "length" and len(toks) == 4
    head = next(ln for ln in lines if b"follower pids" in ln).decode()
    assert head.startswith("data parallelism 2 x expert parallelism 2: 4 ranks")
    assert [c["runtime_config"]["mesh"] for c in cards] == [[2, 1, 2, 1, 1]]
    for pid in (int(x) for x in head.split("[")[-1].strip(" ]\n").split(",")):
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)
